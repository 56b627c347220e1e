"""Audio container/codec support beyond WAV/PCM: the port's copy of
`fish_speech_tpu/audio/transcode.py` (held to it by
`tests/test_torch_hostcopy.py`), its native FLAC encoder built from the
port's own copy of the C source (`native/`).

The reference serves `format: wav|pcm|mp3|opus` (`schema.py:85`) by calling
`soundfile.write` (`views.py:184-188`), i.e. it delegates to whatever
libsndfile was compiled with. This module is the TPU framework's equivalent
dispatch layer:

  - wav / pcm: native (utils/audio/io.py)
  - flac:      native, implemented here from scratch (subset encoder with
               fixed predictors + rice coding; full-spec decoder incl. LPC
               and stereo decorrelation) — lossless, no dependencies
  - mp3/opus:  native ctypes bindings to the system `libmp3lame` /
               `libopus` with an Ogg container written from scratch
               (audio/libcodec.py); falls back to `lameenc` / `ffmpeg`
               when the system libraries are stripped, and raises
               TranscodeUnavailable with the available list otherwise

FLAC format per the public spec (RFC 9639). Bit packing is vectorized with
numpy so encode runs at >10x realtime on a single CPU core.
"""

from __future__ import annotations

import hashlib
import io
import shutil
import struct
import subprocess
from typing import List, Optional, Tuple

import numpy as np


class TranscodeUnavailable(RuntimeError):
    """Requested format has no encoder backend in this environment."""


# ---------------------------------------------------------------------------
# Bit-field stream -> bytes (vectorized)
# ---------------------------------------------------------------------------


def _pack_fields(vals: np.ndarray, nbits: np.ndarray) -> np.ndarray:
    """Concatenate variable-width big-endian bit fields into a byte array.

    vals uint64 (top bits beyond nbits must be 0), nbits int64 >= 1.
    """
    nbits = nbits.astype(np.int64)
    total = int(nbits.sum())
    offsets = np.concatenate([[0], np.cumsum(nbits)[:-1]])
    max_nb = int(nbits.max())
    ar = np.arange(max_nb, dtype=np.int64)
    # bit j (MSB-first) of field i lives at offsets[i] + j
    shift = nbits[:, None] - 1 - ar[None, :]
    valid = ar[None, :] < nbits[:, None]
    bits = (vals[:, None] >> np.maximum(shift, 0).astype(np.uint64)) & 1
    out = np.zeros(-(-total // 8) * 8, dtype=np.uint8)
    pos = (offsets[:, None] + ar[None, :])[valid]
    out[pos] = bits[valid].astype(np.uint8)
    return np.packbits(out)


# ---------------------------------------------------------------------------
# CRCs (FLAC frame header CRC-8 poly 0x07; frame CRC-16 poly 0x8005)
# ---------------------------------------------------------------------------


def _make_crc_table(poly: int, width: int) -> np.ndarray:
    top = 1 << (width - 1)
    mask = (1 << width) - 1
    table = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        c = i << (width - 8)
        for _ in range(8):
            c = ((c << 1) ^ poly) if (c & top) else (c << 1)
        table[i] = c & mask
    return table


_CRC8_TABLE = _make_crc_table(0x07, 8)
_CRC16_TABLE = _make_crc_table(0x8005, 16)


def crc8(data: bytes) -> int:
    c = 0
    for b in data:
        c = int(_CRC8_TABLE[c ^ b])
    return c


def crc16(data: bytes) -> int:
    c = 0
    for b in data:
        c = int(_CRC16_TABLE[((c >> 8) ^ b) & 0xFF]) ^ ((c << 8) & 0xFFFF)
    return c


def _utf8_number(n: int) -> bytes:
    """FLAC's UTF-8-style coded number (frame index)."""
    if n < 0x80:
        return bytes([n])
    out = []
    for lead_bits, prefix in ((11, 0xC0), (16, 0xE0), (21, 0xF0), (26, 0xF8),
                              (31, 0xFC)):
        if n < (1 << lead_bits):
            n_cont = (lead_bits - 6) // 5  # continuation byte count
            out = [prefix | (n >> (6 * n_cont))]
            for i in range(n_cont - 1, -1, -1):
                out.append(0x80 | ((n >> (6 * i)) & 0x3F))
            return bytes(out)
    raise ValueError("frame number too large")


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

_FIXED_COEFFS = {
    0: np.array([], dtype=np.int64),
    1: np.array([1], dtype=np.int64),
    2: np.array([2, -1], dtype=np.int64),
    3: np.array([3, -3, 1], dtype=np.int64),
    4: np.array([4, -6, 4, -1], dtype=np.int64),
}


def _fixed_residual(x: np.ndarray, order: int) -> np.ndarray:
    e = x.astype(np.int64)
    for _ in range(order):
        e = np.diff(e)
    return e


def _rice_fields(res: np.ndarray) -> Tuple[np.ndarray, np.ndarray, int]:
    """Rice-code residuals -> (vals, nbits, k). One codeword per sample:
    q zeros + 1 + k remainder bits == integer (1<<k)|rem of width q+1+k."""
    u = (res.astype(np.int64) << 1) ^ (res >> 63)  # zigzag
    mean = max(float(u.mean()), 0.1) if len(u) else 0.1
    k = max(0, min(30, int(np.floor(np.log2(mean))) if mean >= 1 else 0))
    # refine: pick k in a small window minimizing total bits
    best_k, best_bits = k, None
    for kk in range(max(0, k - 1), min(30, k + 2) + 1):
        bits = int((u >> kk).sum()) + len(u) * (1 + kk)
        if best_bits is None or bits < best_bits:
            best_k, best_bits = kk, bits
    k = best_k
    q = u >> k
    rem = u & ((1 << k) - 1)
    vals = ((np.int64(1) << k) | rem).astype(np.uint64)
    nbits = q + 1 + k
    return vals, nbits, k


def _encode_subframe(x: np.ndarray, bps: int) -> Tuple[List[int], List[int]]:
    """One channel of one frame -> (vals, nbits) field lists."""
    vals: List[int] = []
    nbits: List[int] = []
    n = len(x)
    mask = (1 << bps) - 1

    if n and np.all(x == x[0]):  # constant
        vals += [0, 0b000000, 0, int(x[0]) & mask]
        nbits += [1, 6, 1, bps]
        return vals, nbits

    # best fixed order by residual magnitude
    best_o, best_cost, best_res = 0, None, None
    for o in range(0, 5):
        if n <= o:
            break
        res = _fixed_residual(x, o)
        cost = float(np.abs(res).sum())
        if best_cost is None or cost < best_cost:
            best_o, best_cost, best_res = o, cost, res
    res = best_res
    _, res_nbits, k = _rice_fields(res)
    est = best_o * bps + int(res_nbits.sum())

    if est >= n * bps or int(res_nbits.max(initial=0)) > 60:
        # verbatim beats prediction (noise-like or pathological residuals)
        vals += [0, 0b000001, 0]
        nbits += [1, 6, 1]
        vals += [int(v) & mask for v in x]
        nbits += [bps] * n
        return vals, nbits

    vals += [0, 0b001000 | best_o, 0]  # fixed subframe, no wasted bits
    nbits += [1, 6, 1]
    for w in x[:best_o]:  # warmup
        vals.append(int(w) & mask)
        nbits.append(bps)
    vals += [0b00, 0b0000, k]  # rice method, partition order 0, param
    nbits += [2, 4, 4]
    res_vals, res_nbits, _ = _rice_fields(res)
    return (vals + [int(v) for v in res_vals],
            nbits + [int(b) for b in res_nbits])


_flac_native = None
_flac_native_tried = False


def _flac_lib():
    """ctypes handle to the native frame encoder (built on first use into
    build/native/); None when no C compiler is there — callers fall back
    to the numpy path."""
    global _flac_native, _flac_native_tried
    if _flac_native is not None or _flac_native_tried:
        return _flac_native
    _flac_native_tried = True
    try:
        import ctypes

        from fish_speech_tpu_torch.native import build_flac

        lib = ctypes.CDLL(str(build_flac()))
        lib.fs_flac_encode_frames.restype = ctypes.c_int64
        lib.fs_flac_encode_frames.argtypes = [
            ctypes.POINTER(ctypes.c_int16), ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ]
        _flac_native = lib
    except Exception:  # noqa: BLE001 — any build/load failure -> numpy path
        _flac_native = None
    return _flac_native


def encode_flac(audio: np.ndarray, sample_rate: int,
                block_size: int = 4096, _force_python: bool = False) -> bytes:
    """Encode int16 (N,) or (N, C) samples (float input in [-1,1] is
    quantized) into a spec-conformant FLAC stream. Lossless for int16.

    Frames are produced by the native encoder (`native/flac_encode.c`,
    byte-identical output, ~60x the numpy path — the numpy encoder's
    0.4x-chip-rate ceiling was the one serving format that couldn't keep
    up with the chip); the numpy path remains the no-toolchain fallback
    and the correctness oracle (`_force_python=True`)."""
    if audio.dtype.kind == "f":
        audio = np.clip(audio, -1.0, 1.0)
        audio = (audio * 32767.0).round().astype(np.int16)
    audio = np.asarray(audio, dtype=np.int16)
    if audio.ndim == 1:
        audio = audio[:, None]
    n_total, n_ch = audio.shape
    if not 1 <= n_ch <= 8:
        raise ValueError(f"unsupported channel count {n_ch}")
    bps = 16

    md5 = hashlib.md5(audio.astype("<i2").tobytes()).digest()

    out = io.BytesIO()
    out.write(b"fLaC")
    # STREAMINFO (last metadata block, type 0, length 34)
    si = io.BytesIO()
    si.write(struct.pack(">HH", block_size, block_size))
    si.write(b"\x00\x00\x00" * 2)  # min/max framesize unknown
    # 20 bits sr | 3 bits ch-1 | 5 bits bps-1 | 36 bits total  (8 bytes)
    packed = (sample_rate << 44) | ((n_ch - 1) << 41) | ((bps - 1) << 36) | n_total
    si.write(packed.to_bytes(8, "big"))
    si.write(md5)
    body = si.getvalue()
    out.write(bytes([0x80]) + len(body).to_bytes(3, "big") + body)

    lib = None if _force_python else _flac_lib()
    if lib is not None and n_total > 0:
        import ctypes

        inter = np.ascontiguousarray(audio, dtype=np.int16)
        # worst case is all-verbatim frames + headers
        n_frames = -(-n_total // block_size)
        cap = n_total * n_ch * 2 + 64 * n_frames + 1024
        buf = np.empty(cap, dtype=np.uint8)
        n = lib.fs_flac_encode_frames(
            inter.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            n_total, n_ch, block_size, sample_rate,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
        )
        if n > 0:
            out.write(buf[:n].tobytes())
            return out.getvalue()
        # n <= 0: capacity/arg surprise — fall through to the numpy path

    for f_idx, start in enumerate(range(0, n_total, block_size)):
        block = audio[start:start + block_size]
        bs = len(block)
        # header: sync(14) 0 blocking(0) | bs code 0111 (16-bit at end)
        # | sr code 0000 (STREAMINFO) | chan = independent | bps 100 | 0
        hdr = bytearray([0xFF, 0xF8])
        hdr.append((0b0111 << 4) | 0b0000)
        hdr.append(((n_ch - 1) << 4) | (0b100 << 1))
        hdr += _utf8_number(f_idx)
        hdr += struct.pack(">H", bs - 1)
        hdr.append(crc8(bytes(hdr)))

        vals: List[int] = []
        nbits: List[int] = []
        for c in range(n_ch):
            v, b = _encode_subframe(block[:, c].astype(np.int64), bps)
            vals += v
            nbits += b
        sub = _pack_fields(
            np.asarray(vals, dtype=np.uint64), np.asarray(nbits, dtype=np.int64)
        ).tobytes()
        frame = bytes(hdr) + sub
        out.write(frame + struct.pack(">H", crc16(frame)))
    return out.getvalue()


# ---------------------------------------------------------------------------
# Decoder (full spec subset used in practice: constant/verbatim/fixed/LPC
# subframes, rice partitions, stereo decorrelation)
# ---------------------------------------------------------------------------


class _BitReader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.byte = pos
        self.bit = 0

    def read(self, n: int) -> int:
        v = 0
        while n > 0:
            avail = 8 - self.bit
            take = min(n, avail)
            cur = self.data[self.byte]
            v = (v << take) | ((cur >> (avail - take)) & ((1 << take) - 1))
            self.bit += take
            if self.bit == 8:
                self.bit = 0
                self.byte += 1
            n -= take
        return v

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if v >= (1 << (n - 1)) else v

    def read_unary(self) -> int:
        q = 0
        while self.read(1) == 0:
            q += 1
        return q

    def align(self):
        if self.bit:
            self.bit = 0
            self.byte += 1

    def read_utf8(self) -> int:
        b0 = self.read(8)
        if b0 < 0x80:
            return b0
        n_cont, probe = 0, 0x40
        while b0 & probe:
            n_cont += 1
            probe >>= 1
        if not 1 <= n_cont <= 6:
            raise ValueError("bad UTF-8 coded number")
        v = b0 & ((1 << (6 - n_cont)) - 1) if n_cont < 6 else 0
        for _ in range(n_cont):
            v = (v << 6) | (self.read(8) & 0x3F)
        return v


def _read_residual(br: _BitReader, bs: int, order: int) -> np.ndarray:
    method = br.read(2)
    if method not in (0, 1):
        raise ValueError("unsupported residual coding method")
    pbits = 4 if method == 0 else 5
    escape = (1 << pbits) - 1
    part_order = br.read(4)
    n_parts = 1 << part_order
    out = np.empty(bs - order, dtype=np.int64)
    w = 0
    for p in range(n_parts):
        cnt = (bs >> part_order) - (order if p == 0 else 0)
        k = br.read(pbits)
        if k == escape:
            raw = br.read(5)
            for i in range(cnt):
                out[w + i] = br.read_signed(raw) if raw else 0
        else:
            for i in range(cnt):
                q = br.read_unary()
                u = (q << k) | br.read(k)
                out[w + i] = (u >> 1) ^ -(u & 1)  # un-zigzag
        w += cnt
    return out


def _read_subframe(br: _BitReader, bs: int, bps: int) -> np.ndarray:
    if br.read(1) != 0:
        raise ValueError("bad subframe padding bit")
    stype = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = 1 + br.read_unary()
        bps -= wasted
    if stype == 0b000000:  # constant
        x = np.full(bs, br.read_signed(bps), dtype=np.int64)
    elif stype == 0b000001:  # verbatim
        x = np.array([br.read_signed(bps) for _ in range(bs)], dtype=np.int64)
    elif 0b001000 <= stype <= 0b001100:  # fixed
        order = stype & 0b111
        warm = [br.read_signed(bps) for _ in range(order)]
        res = _read_residual(br, bs, order)
        x = np.empty(bs, dtype=np.int64)
        x[:order] = warm
        coeffs = _FIXED_COEFFS[order]
        for i in range(order, bs):
            x[i] = res[i - order] + int(coeffs @ x[i - order:i][::-1])
    elif stype >= 0b100000:  # LPC
        order = (stype & 0b11111) + 1
        warm = [br.read_signed(bps) for _ in range(order)]
        prec = br.read(4) + 1
        shift = br.read_signed(5)
        qlp = np.array([br.read_signed(prec) for _ in range(order)],
                       dtype=np.int64)
        res = _read_residual(br, bs, order)
        x = np.empty(bs, dtype=np.int64)
        x[:order] = warm
        for i in range(order, bs):
            pred = int(qlp @ x[i - order:i][::-1]) >> shift
            x[i] = res[i - order] + pred
    else:
        raise ValueError(f"reserved subframe type {stype:06b}")
    return x << wasted


_BLOCKSIZE_TABLE = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
                    8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
                    13: 8192, 14: 16384, 15: 32768}
_SR_TABLE = {1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000, 6: 22050,
             7: 24000, 8: 32000, 9: 44100, 10: 48000, 11: 96000}
_BPS_TABLE = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}


def decode_flac(data: bytes) -> Tuple[np.ndarray, int]:
    """Decode a FLAC stream -> (int32 samples (N, C), sample_rate)."""
    if data[:4] != b"fLaC":
        raise ValueError("not a FLAC stream")
    pos = 4
    sr = n_ch = bps = n_total = None
    while True:  # metadata blocks
        hdr = data[pos]
        btype, last = hdr & 0x7F, bool(hdr & 0x80)
        length = int.from_bytes(data[pos + 1:pos + 4], "big")
        if btype == 0:
            body = data[pos + 4:pos + 4 + length]
            packed = int.from_bytes(body[10:18], "big")
            sr = packed >> 44
            n_ch = ((packed >> 41) & 0x7) + 1
            bps = ((packed >> 36) & 0x1F) + 1
            n_total = packed & ((1 << 36) - 1)
        pos += 4 + length
        if last:
            break
    if sr is None:
        raise ValueError("missing STREAMINFO")

    chans: List[List[np.ndarray]] = [[] for _ in range(n_ch)]
    got = 0
    while pos < len(data) and (n_total == 0 or got < n_total):
        br = _BitReader(data, pos)
        sync = br.read(14)
        if sync != 0b11111111111110:
            raise ValueError(f"lost frame sync at byte {pos}")
        br.read(1)  # reserved
        br.read(1)  # blocking strategy
        bs_code = br.read(4)
        sr_code = br.read(4)
        ch_code = br.read(4)
        bps_code = br.read(3)
        br.read(1)
        br.read_utf8()
        if bs_code == 6:
            bs = br.read(8) + 1
        elif bs_code == 7:
            bs = br.read(16) + 1
        else:
            bs = _BLOCKSIZE_TABLE[bs_code]
        if sr_code == 12:
            br.read(8)
        elif sr_code in (13, 14):
            br.read(16)
        f_sr = _SR_TABLE.get(sr_code, sr)
        f_bps = _BPS_TABLE.get(bps_code, bps)
        br.read(8)  # header CRC-8 (not verified here)

        if ch_code < 8:  # independent
            subs = [_read_subframe(br, bs, f_bps) for _ in range(ch_code + 1)]
        elif ch_code == 8:  # left/side
            left = _read_subframe(br, bs, f_bps)
            side = _read_subframe(br, bs, f_bps + 1)
            subs = [left, left - side]
        elif ch_code == 9:  # right/side
            side = _read_subframe(br, bs, f_bps + 1)
            right = _read_subframe(br, bs, f_bps)
            subs = [right + side, right]
        elif ch_code == 10:  # mid/side
            mid = _read_subframe(br, bs, f_bps)
            side = _read_subframe(br, bs, f_bps + 1)
            l = mid * 2 + (side & 1)
            subs = [(l + side) >> 1, (l - side) >> 1]
        else:
            raise ValueError(f"reserved channel assignment {ch_code}")
        br.align()
        br.read(16)  # frame CRC-16
        pos = br.byte
        for c, x in enumerate(subs):
            chans[c].append(x)
        got += bs
        assert f_sr  # per-frame rate override unused (we trust STREAMINFO)

    if not chans[0]:
        return np.zeros((0, n_ch), dtype=np.int32), sr
    out = np.stack([np.concatenate(c) for c in chans], axis=1)
    if n_total:
        out = out[:n_total]
    return out.astype(np.int32), sr


def decode_flac_float(data: bytes) -> Tuple[np.ndarray, int]:
    """decode_flac scaled to float32 [-1,1) by the stream's actual bit
    depth (FLAC in the wild is 16- or 24-bit). Returns ((N, C), sr)."""
    packed = int.from_bytes(data[4 + 4 + 10:4 + 4 + 18], "big")
    bps = ((packed >> 36) & 0x1F) + 1
    samples, sr = decode_flac(data)
    return samples.astype(np.float32) / float(1 << (bps - 1)), sr


# ---------------------------------------------------------------------------
# Format dispatch (the `soundfile.write(format=...)` equivalent)
# ---------------------------------------------------------------------------


def _ffmpeg_encode(audio: np.ndarray, sr: int, fmt: str) -> bytes:
    ff = shutil.which("ffmpeg")
    if not ff:
        raise TranscodeUnavailable("ffmpeg not found")
    n_ch = 1 if audio.ndim == 1 else audio.shape[1]
    pcm = (np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes()
    codec = {"mp3": ["-f", "mp3"], "opus": ["-f", "opus", "-c:a", "libopus"]}
    proc = subprocess.run(
        [ff, "-f", "s16le", "-ar", str(sr), "-ac", str(n_ch), "-i", "-",
         *codec[fmt], "-"],
        input=pcm, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
    )
    if proc.returncode != 0 or not proc.stdout:
        raise TranscodeUnavailable(f"ffmpeg failed to encode {fmt}")
    return proc.stdout


def _lame_encode(audio: np.ndarray, sr: int) -> bytes:
    try:
        import lameenc
    except ImportError as e:
        raise TranscodeUnavailable("lameenc not installed") from e
    enc = lameenc.Encoder()
    enc.set_in_sample_rate(sr)
    enc.set_channels(1 if audio.ndim == 1 else audio.shape[1])
    enc.set_bit_rate(128)
    pcm = (np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes()
    return bytes(enc.encode(pcm)) + bytes(enc.flush())


def _native_codec_ok(name: str) -> bool:
    """True when the system library backing `name` (mp3/opus) loads."""
    from fish_speech_tpu_torch.audio import libcodec

    try:
        if name == "mp3":
            libcodec._load_lame()
        elif name == "opus":
            libcodec._load_opus()
        else:
            return False
        return True
    except TranscodeUnavailable:
        return False


def available_formats() -> List[str]:
    fmts = ["wav", "pcm", "flac"]
    if _native_codec_ok("mp3"):
        fmts.append("mp3")
    else:
        try:
            import lameenc  # noqa: F401
            fmts.append("mp3")
        except ImportError:
            if shutil.which("ffmpeg"):
                fmts.append("mp3")
    if _native_codec_ok("opus") or shutil.which("ffmpeg"):
        fmts.append("opus")
    return fmts


def encode_audio(audio: np.ndarray, sample_rate: int, fmt: str) -> bytes:
    """float32 [-1,1] (N,) or (N,C) -> encoded bytes in `fmt`.

    wav/pcm are handled by the server directly; this covers flac/mp3/opus.
    Raises TranscodeUnavailable when no backend exists for `fmt`.
    """
    if fmt == "flac":
        return encode_flac(audio, sample_rate)
    if fmt == "mp3":
        from fish_speech_tpu_torch.audio import libcodec

        try:
            return libcodec.encode_mp3(audio, sample_rate)
        except TranscodeUnavailable:
            pass
        try:
            return _lame_encode(audio, sample_rate)
        except TranscodeUnavailable:
            return _ffmpeg_encode(audio, sample_rate, "mp3")
    if fmt == "opus":
        from fish_speech_tpu_torch.audio import libcodec

        try:
            return libcodec.encode_opus(audio, sample_rate)
        except TranscodeUnavailable:
            return _ffmpeg_encode(audio, sample_rate, "opus")
    raise TranscodeUnavailable(
        f"format {fmt!r} has no encoder; available: {available_formats()}"
    )
