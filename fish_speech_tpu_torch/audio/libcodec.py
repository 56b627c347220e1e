"""Native mp3 / Ogg-Opus backends via the system codec libraries.
(The port's copy of `fish_speech_tpu/audio/libcodec.py`.)

The reference serves `format: mp3|opus` by delegating to whatever
libsndfile was compiled with (`tools/server/views.py:184-188`,
`fish_speech/utils/schema.py:85`). This image has no soundfile/ffmpeg,
but it does ship `libmp3lame.so.0` and `libopus.so.0` — so these two
formats are implemented directly against the C libraries via ctypes:

  - mp3:  LAME encoder (`lame_encode_buffer`), HIP decoder for tests
  - opus: libopus encoder at 48 kHz (Opus only supports 8/12/16/24/48 k;
          the 44.1 kHz codec output is polyphase-resampled 160/147),
          wrapped in an Ogg container written from scratch per RFC 3533
          with the Opus mapping per RFC 7845 (OpusHead/OpusTags, pre-skip
          from OPUS_GET_LOOKAHEAD, end-trimming granule position)

Both load lazily; a missing library raises TranscodeUnavailable so
`transcode.available_formats()` stays truthful on stripped systems.
"""

from __future__ import annotations

import ctypes
import struct
from typing import List, Optional, Tuple

import numpy as np

from fish_speech_tpu_torch.audio.transcode import TranscodeUnavailable

# ---------------------------------------------------------------------------
# Library loading
# ---------------------------------------------------------------------------

_LAME: Optional[ctypes.CDLL] = None
_OPUS: Optional[ctypes.CDLL] = None


def _load_lame() -> ctypes.CDLL:
    global _LAME
    if _LAME is None:
        try:
            lib = ctypes.CDLL("libmp3lame.so.0")
        except OSError as e:
            raise TranscodeUnavailable("libmp3lame not found") from e
        lib.lame_init.restype = ctypes.c_void_p
        lib.lame_init.argtypes = []
        for f in ("lame_set_in_samplerate", "lame_set_num_channels",
                  "lame_set_brate", "lame_set_quality"):
            getattr(lib, f).argtypes = [ctypes.c_void_p, ctypes.c_int]
            getattr(lib, f).restype = ctypes.c_int
        lib.lame_init_params.argtypes = [ctypes.c_void_p]
        lib.lame_init_params.restype = ctypes.c_int
        short_p = ctypes.POINTER(ctypes.c_short)
        u8_p = ctypes.POINTER(ctypes.c_ubyte)
        lib.lame_encode_buffer.argtypes = [
            ctypes.c_void_p, short_p, short_p, ctypes.c_int, u8_p, ctypes.c_int]
        lib.lame_encode_buffer.restype = ctypes.c_int
        lib.lame_encode_buffer_interleaved.argtypes = [
            ctypes.c_void_p, short_p, ctypes.c_int, u8_p, ctypes.c_int]
        lib.lame_encode_buffer_interleaved.restype = ctypes.c_int
        lib.lame_encode_flush.argtypes = [ctypes.c_void_p, u8_p, ctypes.c_int]
        lib.lame_encode_flush.restype = ctypes.c_int
        lib.lame_close.argtypes = [ctypes.c_void_p]
        lib.hip_decode_init.restype = ctypes.c_void_p
        lib.hip_decode_init.argtypes = []
        lib.hip_decode1_headers.argtypes = [
            ctypes.c_void_p, u8_p, ctypes.c_size_t, short_p, short_p,
            ctypes.POINTER(_Mp3Data)]
        lib.hip_decode1_headers.restype = ctypes.c_int
        lib.hip_decode_exit.argtypes = [ctypes.c_void_p]
        _LAME = lib
    return _LAME


def _load_opus() -> ctypes.CDLL:
    global _OPUS
    if _OPUS is None:
        try:
            lib = ctypes.CDLL("libopus.so.0")
        except OSError as e:
            raise TranscodeUnavailable("libopus not found") from e
        int_p = ctypes.POINTER(ctypes.c_int)
        short_p = ctypes.POINTER(ctypes.c_short)
        u8_p = ctypes.POINTER(ctypes.c_ubyte)
        lib.opus_encoder_create.restype = ctypes.c_void_p
        lib.opus_encoder_create.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, int_p]
        lib.opus_encode.argtypes = [
            ctypes.c_void_p, short_p, ctypes.c_int, u8_p, ctypes.c_int]
        lib.opus_encode.restype = ctypes.c_int
        lib.opus_encoder_destroy.argtypes = [ctypes.c_void_p]
        lib.opus_decoder_create.restype = ctypes.c_void_p
        lib.opus_decoder_create.argtypes = [ctypes.c_int, ctypes.c_int, int_p]
        lib.opus_decode.argtypes = [
            ctypes.c_void_p, u8_p, ctypes.c_int, short_p, ctypes.c_int,
            ctypes.c_int]
        lib.opus_decode.restype = ctypes.c_int
        lib.opus_decoder_destroy.argtypes = [ctypes.c_void_p]
        # opus_encoder_ctl is varargs; bind the two call shapes we use as
        # independent prototypes (setting argtypes on the cached attribute
        # would alias both shapes onto one function object).
        lib.ctl_set_int = ctypes.CFUNCTYPE(
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int)(
                ("opus_encoder_ctl", lib))
        lib.ctl_get_int = ctypes.CFUNCTYPE(
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int, int_p)(
                ("opus_encoder_ctl", lib))
        _OPUS = lib
    return _OPUS


def _as_int16(audio: np.ndarray) -> np.ndarray:
    """float [-1,1] or int16, (N,) or (N,C) -> contiguous int16 (N, C)."""
    audio = np.asarray(audio)
    if audio.dtype.kind == "f":
        audio = (np.clip(audio, -1.0, 1.0) * 32767.0).round().astype(np.int16)
    audio = audio.astype(np.int16, copy=False)
    if audio.ndim == 1:
        audio = audio[:, None]
    if audio.shape[1] not in (1, 2):
        raise ValueError(f"mp3/opus support 1-2 channels, got {audio.shape[1]}")
    return np.ascontiguousarray(audio)


# ---------------------------------------------------------------------------
# MP3 (LAME)
# ---------------------------------------------------------------------------


class _Mp3Data(ctypes.Structure):
    """lame.h mp3data_struct."""
    _fields_ = [
        ("header_parsed", ctypes.c_int), ("stereo", ctypes.c_int),
        ("samplerate", ctypes.c_int), ("bitrate", ctypes.c_int),
        ("mode", ctypes.c_int), ("mode_ext", ctypes.c_int),
        ("framesize", ctypes.c_int), ("nsamp", ctypes.c_ulong),
        ("totalframes", ctypes.c_int), ("framenum", ctypes.c_int),
    ]


def encode_mp3(audio: np.ndarray, sample_rate: int,
               bitrate_kbps: int = 128) -> bytes:
    """Encode float/int16 samples to MP3 via libmp3lame."""
    lame = _load_lame()
    x = _as_int16(audio)
    n, ch = x.shape
    gfp = lame.lame_init()
    if not gfp:
        raise TranscodeUnavailable("lame_init failed")
    try:
        lame.lame_set_in_samplerate(gfp, sample_rate)
        lame.lame_set_num_channels(gfp, ch)
        lame.lame_set_brate(gfp, bitrate_kbps)
        lame.lame_set_quality(gfp, 2)
        if lame.lame_init_params(gfp) < 0:
            raise TranscodeUnavailable(
                f"lame rejected params (sr={sample_rate}, ch={ch})")
        buf = np.zeros(int(1.25 * n) + 7200, dtype=np.uint8)
        u8 = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))
        if ch == 2:
            wrote = lame.lame_encode_buffer_interleaved(
                gfp, x.ctypes.data_as(ctypes.POINTER(ctypes.c_short)),
                n, u8, len(buf))
        else:
            mono = x.ctypes.data_as(ctypes.POINTER(ctypes.c_short))
            wrote = lame.lame_encode_buffer(gfp, mono, mono, n, u8, len(buf))
        if wrote < 0:
            raise TranscodeUnavailable(f"lame_encode_buffer error {wrote}")
        tail = lame.lame_encode_flush(
            gfp, buf[wrote:].ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            len(buf) - wrote)
        if tail < 0:
            raise TranscodeUnavailable(f"lame_encode_flush error {tail}")
        return bytes(buf[:wrote + tail])
    finally:
        lame.lame_close(gfp)


def decode_mp3(data: bytes) -> Tuple[np.ndarray, int]:
    """Decode MP3 -> (int16 (N, C), sample_rate). Used by tests to prove
    the encoder emits a stream LAME's own decoder accepts."""
    lame = _load_lame()
    hip = lame.hip_decode_init()
    if not hip:
        raise TranscodeUnavailable("hip_decode_init failed")
    try:
        md = _Mp3Data()
        pl = (ctypes.c_short * 4608)()
        pr = (ctypes.c_short * 4608)()
        src = (ctypes.c_ubyte * len(data)).from_buffer_copy(data)
        empty = (ctypes.c_ubyte * 1)()
        chunks_l: List[np.ndarray] = []
        chunks_r: List[np.ndarray] = []

        def take(r: int) -> None:
            chunks_l.append(np.ctypeslib.as_array(pl)[:r].copy())
            if md.stereo == 2:
                chunks_r.append(np.ctypeslib.as_array(pr)[:r].copy())

        # Feed the whole stream once (hip buffers internally; r == 0 here
        # means "buffering", not end-of-stream), then drain with len=0
        # calls until the decoder runs dry.
        r = lame.hip_decode1_headers(
            hip, src, len(data), pl, pr, ctypes.byref(md))
        if r < 0:
            raise ValueError(f"mp3 decode error {r}")
        if r > 0:
            take(r)
        while True:
            r = lame.hip_decode1_headers(
                hip, empty, 0, pl, pr, ctypes.byref(md))
            if r < 0:
                raise ValueError(f"mp3 decode error {r}")
            if r == 0:
                break
            take(r)
        if not md.header_parsed and not chunks_l:
            raise ValueError("not an mp3 stream")
        left = np.concatenate(chunks_l) if chunks_l else np.zeros(0, np.int16)
        if chunks_r:
            out = np.stack([left, np.concatenate(chunks_r)], axis=1)
        else:
            out = left[:, None]
        return out.astype(np.int16), int(md.samplerate)
    finally:
        lame.hip_decode_exit(hip)


# ---------------------------------------------------------------------------
# Ogg container (RFC 3533) — written from scratch, no libogg
# ---------------------------------------------------------------------------

_OGG_CRC_TABLE = np.zeros(256, dtype=np.uint32)
for _i in range(256):
    _c = _i << 24
    for _ in range(8):
        _c = ((_c << 1) ^ 0x04C11DB7) if (_c & 0x80000000) else (_c << 1)
    _OGG_CRC_TABLE[_i] = _c & 0xFFFFFFFF


def _ogg_crc(data: bytes) -> int:
    c = 0
    for b in data:
        c = (int(_OGG_CRC_TABLE[((c >> 24) ^ b) & 0xFF]) ^ (c << 8)) & 0xFFFFFFFF
    return c


def _lacing(packet_lens: List[int]) -> bytes:
    out = bytearray()
    for ln in packet_lens:
        while ln >= 255:
            out.append(255)
            ln -= 255
        out.append(ln)  # 0 lacing terminates a 255-multiple packet
    return bytes(out)


def _ogg_page(packets: List[bytes], granule: int, serial: int, seq: int,
              header_type: int) -> bytes:
    lac = _lacing([len(p) for p in packets])
    if len(lac) > 255:
        raise ValueError("too many segments for one page")
    hdr = struct.pack("<4sBBqIII", b"OggS", 0, header_type,
                      granule, serial, seq, 0) + bytes([len(lac)]) + lac
    body = b"".join(packets)
    crc = _ogg_crc(hdr + body)
    return hdr[:22] + struct.pack("<I", crc) + hdr[26:] + body


def _ogg_pages(data: bytes):
    """Yield (header_type, granule, packets, continued_first) per page."""
    pos = 0
    while pos < len(data):
        if data[pos:pos + 4] != b"OggS":
            raise ValueError(f"lost Ogg sync at byte {pos}")
        (version, htype, granule, _serial, _seq, _crc) = struct.unpack(
            "<BBqIII", data[pos + 4:pos + 26])
        if version != 0:
            raise ValueError("unsupported Ogg version")
        nseg = data[pos + 26]
        lac = data[pos + 27:pos + 27 + nseg]
        body = pos + 27 + nseg
        packets: List[bytes] = []
        cur = bytearray()
        open_packet = False
        for ln in lac:
            cur += data[body:body + ln]
            body += ln
            open_packet = ln == 255
            if not open_packet:
                packets.append(bytes(cur))
                cur = bytearray()
        yield htype, granule, packets, bytes(cur) if open_packet else None
        pos = body


# ---------------------------------------------------------------------------
# Ogg-Opus (RFC 7845)
# ---------------------------------------------------------------------------

_OPUS_SR = 48000
_OPUS_FRAME = 960  # 20 ms at 48 kHz
_OPUS_APPLICATION_AUDIO = 2049
_OPUS_SET_BITRATE = 4002
_OPUS_GET_LOOKAHEAD = 4027
_PACKETS_PER_PAGE = 50  # 1 s of audio per page


def _resample_to_48k(x: np.ndarray, sr: int) -> np.ndarray:
    if sr == _OPUS_SR:
        return x
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(_OPUS_SR, sr)
    return resample_poly(x, _OPUS_SR // g, sr // g, axis=0)


def encode_opus(audio: np.ndarray, sample_rate: int,
                bitrate_bps: int = 64000) -> bytes:
    """Encode float/int16 samples to an Ogg-Opus stream via libopus."""
    opus = _load_opus()
    x = np.asarray(audio)
    if x.dtype.kind != "f":
        x = x.astype(np.float32) / 32768.0
    x48 = _resample_to_48k(x, sample_rate)
    xi = _as_int16(x48)
    n, ch = xi.shape

    err = ctypes.c_int()
    enc = opus.opus_encoder_create(
        _OPUS_SR, ch, _OPUS_APPLICATION_AUDIO, ctypes.byref(err))
    if err.value != 0 or not enc:
        raise TranscodeUnavailable(f"opus_encoder_create error {err.value}")
    try:
        opus.ctl_set_int(enc, _OPUS_SET_BITRATE, bitrate_bps)
        look = ctypes.c_int()
        opus.ctl_get_int(enc, _OPUS_GET_LOOKAHEAD, ctypes.byref(look))
        preskip = int(look.value)

        # Pad so total decoded >= preskip + n (end trim, RFC 7845 §4.4)
        # and is a whole number of 20 ms frames.
        total = -(-(n + preskip) // _OPUS_FRAME) * _OPUS_FRAME
        xi = np.vstack([xi, np.zeros((total - n, ch), np.int16)])

        out = (ctypes.c_ubyte * 4000)()
        packets: List[bytes] = []
        for i in range(0, total, _OPUS_FRAME):
            frame = np.ascontiguousarray(xi[i:i + _OPUS_FRAME])
            wrote = opus.opus_encode(
                enc, frame.ctypes.data_as(ctypes.POINTER(ctypes.c_short)),
                _OPUS_FRAME, out, len(out))
            if wrote <= 0:
                raise TranscodeUnavailable(f"opus_encode error {wrote}")
            packets.append(bytes(out[:wrote]))
    finally:
        opus.opus_encoder_destroy(enc)

    serial = 0x46535450  # 'FSTP'
    head = (b"OpusHead" + bytes([1, ch]) + struct.pack("<H", preskip)
            + struct.pack("<I", sample_rate) + struct.pack("<h", 0)
            + bytes([0]))
    tags = (b"OpusTags" + struct.pack("<I", 15) + b"fish-speech-tpu"
            + struct.pack("<I", 0))
    pages = [_ogg_page([head], 0, serial, 0, 0x02),
             _ogg_page([tags], 0, serial, 1, 0x00)]
    final_granule = preskip + n
    seq = 2
    for i in range(0, len(packets), _PACKETS_PER_PAGE):
        group = packets[i:i + _PACKETS_PER_PAGE]
        last = i + len(group) == len(packets)
        granule = final_granule if last else (i + len(group)) * _OPUS_FRAME
        pages.append(_ogg_page(group, granule, serial, seq,
                               0x04 if last else 0x00))
        seq += 1
    return b"".join(pages)


def decode_opus(data: bytes) -> Tuple[np.ndarray, int]:
    """Decode an Ogg-Opus stream -> (float32 (N, C) in [-1,1], 48000).

    Applies pre-skip and the final-page granule trim, so a round trip
    returns exactly the encoder's (48 kHz-resampled) sample count."""
    opus = _load_opus()
    packets: List[bytes] = []
    carry = b""
    preskip = ch = None
    final_granule = 0
    for htype, granule, pkts, open_tail in _ogg_pages(data):
        if carry and pkts:
            pkts[0] = carry + pkts[0]
            carry = b""
        elif carry and open_tail is not None:
            open_tail = carry + open_tail
            carry = b""
        for p in pkts:
            if preskip is None:
                if p[:8] != b"OpusHead":
                    raise ValueError("first Ogg packet is not OpusHead")
                ch = p[9]
                preskip = struct.unpack("<H", p[10:12])[0]
            elif p[:8] == b"OpusTags" and len(packets) == 0:
                continue
            else:
                packets.append(p)
        if open_tail is not None:
            carry = open_tail
        if granule > 0:
            final_granule = granule
    if preskip is None or ch is None:
        raise ValueError("no OpusHead found")

    err = ctypes.c_int()
    dec = opus.opus_decoder_create(_OPUS_SR, ch, ctypes.byref(err))
    if err.value != 0 or not dec:
        raise TranscodeUnavailable(f"opus_decoder_create error {err.value}")
    try:
        buf = (ctypes.c_short * (5760 * ch))()
        chunks: List[np.ndarray] = []
        for p in packets:
            pb = (ctypes.c_ubyte * len(p)).from_buffer_copy(p)
            got = opus.opus_decode(dec, pb, len(p), buf, 5760, 0)
            if got < 0:
                raise ValueError(f"opus_decode error {got}")
            chunks.append(
                np.ctypeslib.as_array(buf)[:got * ch].reshape(got, ch).copy())
    finally:
        opus.opus_decoder_destroy(dec)
    pcm = (np.concatenate(chunks, axis=0) if chunks
           else np.zeros((0, ch), np.int16))
    end = final_granule if final_granule else len(pcm)
    pcm = pcm[preskip:end]
    return pcm.astype(np.float32) / 32768.0, _OPUS_SR
