"""The fast-stack probe: what the fast stack's weight stream costs once the
launches are gone.

Port of the Pallas TPU probe `fish_speech_tpu/ops/pallas_faststack.py`
(`make_probe`, `make_weights`, `_bench`). One frame runs STEPS codebook
steps through NL fast layers of int8 weight-only matvecs at B=1 (qkv, a
mock attention mix, wo, rms, w13, silu * gate, w2, rms); attention,
sampling and embeddings are left out, as in the TPU probe. Dims default to
the flagship fast stack (1536 / 2560 / 6144, 12 layers, 10 steps) and are
parameters, so the tests run small.

The kernel is hand-written CUDA for Hopper (`csrc/faststack.cu`): one
persistent cooperative kernel per frame, one block per SM, a producer warp
streaming each block's weights ahead of its consumers, the first
`r_resident` layers read through an L2 persisting window. Each block owns a
strip of columns of every matrix (`piece_plan`); the kernel reads the
weights packed strip by strip (`pack_weights`, done once per weight set and
kept beside it). `probe_reference` is the plain version (the same chain as
a torch loop); `faststack_probe` runs it for CPU tensors only and, for CUDA
tensors, launches the kernel or raises. Both compute the INTENDED chain,
each layer with its own weights: the TPU kernel's prefetch into the slot it
is reading (`consume`, `pallas_faststack.py:180-189`) is a race, harmless
only where one layer is streamed.

    python -m fish_speech_tpu_torch.ops.faststack [R...] [bf16|w8a8]

times R in {0, 1} (default) for both variants on `cuda:0`, and a frame's
grid barriers alone and its weight stream alone.
"""

from __future__ import annotations

import dataclasses
import sys
import weakref

import numpy as np
import torch

from fish_speech_tpu_torch.ops._kernels import (check_launch, load_kernels,
                                                 scratch, sm_count, stream_ptr)
from fish_speech_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

RMS_EPS = 1e-5
CONSUMER_THREADS = 256  # a block's consumer threads (csrc: NC)
UNIT = 4  # columns of a unit, rows of a quad (csrc: the 4 x 4 tiles)
PARTS = {"frame": 0, "barriers": 1, "loads": 2}  # csrc: Part


@dataclasses.dataclass(frozen=True)
class ProbeDims:
    df: int = 1536     # fast dim
    dqkv: int = 2560   # 12*128 q + 2*4*128 kv
    inter: int = 6144
    n_layer: int = 12
    steps: int = 10

    def shapes(self):
        """(I, O) of each weight kind, in the packed order."""
        return {"qkv": (self.df, self.dqkv), "wo": (self.df, self.df),
                "w13": (self.df, 2 * self.inter), "w2": (self.inter, self.df)}

    @property
    def layer_bytes(self) -> int:
        return sum(i * o for i, o in self.shapes().values())

    def frame_bytes(self, r_resident: int) -> int:
        """Weight bytes one frame reads from device memory, as `_bench`
        reckons them: resident layers once, streamed ones every step."""
        s = self.n_layer - r_resident
        return (r_resident + self.steps * s) * self.layer_bytes


def make_weights(dims: ProbeDims = ProbeDims(), device=DEFAULT_DEVICE):
    """Random int8 weights and fp32 column scales, drawn from numpy's
    default_rng(0) in the order of the JAX package's `make_weights` (so the
    numbers are the same), laid out for the kernel: "w" (NL, layer_bytes)
    int8 with Wqkv | Wo | W13 | W2 of each layer in (I, O) row-major
    order, "sc" (NL, DQKV + DF + 2 INTER + DF) fp32 in the same order. Any
    R reads this one layout: residency changes where bytes come from. On
    `device`; raises without CUDA unless it is the CPU."""
    device = resolve_device(device, "make_weights")
    rng = np.random.default_rng(0)
    w = np.empty((dims.n_layer, dims.layer_bytes), np.int8)
    scales = []
    off = 0
    for kind, (i, o) in dims.shapes().items():
        block = rng.integers(-127, 128, size=(dims.n_layer, i, o),
                             dtype=np.int32).astype(np.int8)
        w[:, off : off + i * o] = block.reshape(dims.n_layer, -1)
        off += i * o
        scales.append(rng.random((dims.n_layer, o), dtype=np.float32)
                      * np.float32(0.04 / 127.0))
    return {"w": torch.from_numpy(w).to(device),
            "sc": torch.from_numpy(np.concatenate(scales, axis=1)).to(device)}


def layer_weights(weights, layer: int, dims: ProbeDims):
    """{kind: ((I, O) int8 view, (O,) fp32 scales)} of one layer."""
    out, off, soff = {}, 0, 0
    for kind, (i, o) in dims.shapes().items():
        out[kind] = (weights["w"][layer, off : off + i * o].view(i, o),
                     weights["sc"][layer, soff : soff + o])
        off += i * o
        soff += o
    return out


def piece_plan(dims: ProbeDims, n_blocks: int):
    """Each block's pieces of one layer, in stage order: [{kind: (first
    column unit, units, byte offset in the packed layer)}] per block. Block
    b owns units [b U / NB, (b + 1) U / NB) of the U = O / 4 column units of
    every matrix, over all rows; a packed layer holds block 0's four strips,
    then block 1's, and so on (`csrc/faststack.cu:strip`)."""
    plan, off = [], 0
    for b in range(n_blocks):
        pieces = {}
        for kind, (i, o) in dims.shapes().items():
            units = o // UNIT
            u0, u1 = b * units // n_blocks, (b + 1) * units // n_blocks
            pieces[kind] = (u0, u1 - u0, off)
            off += i * UNIT * (u1 - u0)
        plan.append(pieces)
    assert off == dims.layer_bytes
    return plan


def w13_units(w13, inter: int):
    """W13's columns in the kernel's unit order: unit u holds gate columns
    2u, 2u + 1 and up columns 2u, 2u + 1, so the block that sums them
    forms silu(gate) * up itself. Works on any (..., 2 INTER) tensor."""
    pairs = (*w13.shape[:-1], inter // 2, 2)
    gate, up = w13[..., :inter].reshape(pairs), w13[..., inter:].reshape(pairs)
    return torch.stack([gate, up], dim=-2).reshape(w13.shape)


def pack_weights(weights, dims: ProbeDims, n_blocks: int):
    """The kernel's layout of `weights["w"]` (NL, layer_bytes): per layer,
    each block's strips in `piece_plan` order; a strip holds its quads of 4
    rows, each quad its units, each unit a 4 x 4 tile column by column
    (byte 4 c + r is row 4 q + r of column 4 u + c, W13's columns in
    `w13_units` order). Layer l stays at [l * layer_bytes, (l + 1) *
    layer_bytes), so the first R layers are one range."""
    plan = piece_plan(dims, n_blocks)
    layers = []
    for layer in range(dims.n_layer):
        lw = {kind: w for kind, (w, _) in layer_weights(weights, layer,
                                                         dims).items()}
        lw["w13"] = w13_units(lw["w13"], dims.inter)
        tiles = {kind: lw[kind].reshape(i // UNIT, UNIT, o // UNIT, UNIT)
                 .permute(0, 2, 3, 1)  # (quad, unit, column, row)
                 for kind, (i, o) in dims.shapes().items()}
        layers.append(torch.cat([tiles[kind][:, u0:u0 + nu].reshape(-1)
                                 for pieces in plan
                                 for kind, (u0, nu, _) in pieces.items()]))
    return torch.stack(layers)


# id(weights["w"]) -> (a weak reference to it, dims, blocks, its packing)
_PACKED: dict = {}


def _packed(weights, dims: ProbeDims, n_blocks: int):
    """`pack_weights` of a weight set, made at its first use and kept while
    its "w" tensor lives (the weights are not written after that)."""
    w = weights["w"]
    kept = _PACKED.get(id(w))
    if kept is None or kept[0]() is not w or kept[1:3] != (dims, n_blocks):
        kept = (weakref.ref(w, lambda _, key=id(w): _PACKED.pop(key, None)),
                dims, n_blocks, pack_weights(weights, dims, n_blocks))
        _PACKED[id(w)] = kept
    return kept[3]


def _rms(x):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + RMS_EPS)


def _mv(x, wq, scale, variant: str):
    """x (1, I) fp32 @ int8 (I, O) with column scales, as the TPU probe's
    `_dot_bf16` / `_dot_w8a8` compute it."""
    if variant == "w8a8":
        xs = x.abs().max() / 127.0
        xq = torch.clamp(torch.round(x / torch.clamp(xs, min=1e-12)), -127, 127)
        # the int32 sum of int8 products, exact in float64
        y = (xq.double() @ wq.double()).float()
        return y * (xs * scale)
    xb = x.to(torch.bfloat16).float()
    return (xb @ wq.float()) * scale


def probe_reference(x, weights, variant: str = "bf16",
                    dims: ProbeDims = ProbeDims()):
    """The plain version: STEPS x NL layers as a torch loop, x (1, DF) fp32."""
    x = x.float()
    layers = [layer_weights(weights, l, dims) for l in range(dims.n_layer)]
    for _ in range(dims.steps):
        for lw in layers:
            u = _mv(x, *lw["qkv"], variant)
            kvs = u[:, dims.df :].sum() * 1e-3
            y = u[:, : dims.df] * (1.0 + kvs)
            x = x + _mv(y, *lw["wo"], variant)
            f = _mv(_rms(x), *lw["w13"], variant)
            g = torch.nn.functional.silu(f[:, : dims.inter]) * f[:, dims.inter :]
            x = _rms(x + _mv(g, *lw["w2"], variant))
    return x


def _check(x, weights, r_resident, variant, dims):
    if variant not in ("bf16", "w8a8"):
        raise ValueError(f"faststack_probe: variant {variant!r}")
    if not 0 <= r_resident < dims.n_layer:
        raise ValueError(f"faststack_probe: R={r_resident} not in "
                         f"[0, {dims.n_layer})")
    if x.device.type == "cpu":
        return
    w, sc = weights["w"], weights["sc"]
    if not (x.is_cuda and w.device == x.device and sc.device == x.device):
        raise ValueError("faststack_probe: x and the weights must lie on one "
                         "CUDA device")
    if (x.dtype != torch.float32 or w.dtype != torch.int8
            or sc.dtype != torch.float32):
        raise TypeError("faststack_probe: x fp32, weights int8, scales fp32")
    if (tuple(x.shape) != (1, dims.df)
            or tuple(w.shape) != (dims.n_layer, dims.layer_bytes)
            or tuple(sc.shape) != (dims.n_layer,
                                   dims.dqkv + 2 * dims.df + 2 * dims.inter)):
        raise ValueError("faststack_probe: shapes do not match the dims")
    if not (x.is_contiguous() and w.is_contiguous() and sc.is_contiguous()):
        raise ValueError("faststack_probe: tensors must be contiguous")


def _launch(x, weights, r_resident, variant, dims, part):
    n_blocks = sm_count(x.device)
    packed = _packed(weights, dims, n_blocks)
    out = torch.empty_like(x)
    ws, bar = scratch("faststack", x.device,
                      3 * dims.df + dims.dqkv + dims.inter, 1)
    rc = load_kernels().fs_faststack_probe(
        packed.data_ptr(), weights["sc"].data_ptr(), x.data_ptr(),
        out.data_ptr(), ws.data_ptr(), bar.data_ptr(), dims.df, dims.dqkv,
        dims.inter, dims.n_layer, dims.steps, r_resident,
        int(variant == "w8a8"), n_blocks, PARTS[part], stream_ptr(x))
    check_launch(rc, "faststack_probe")
    return out


def faststack_probe(x, weights, r_resident: int = 0, variant: str = "bf16",
                    dims: ProbeDims = ProbeDims()):
    """One frame of the probe: x (1, DF) fp32 -> (1, DF) fp32. On CUDA
    tensors runs the cooperative kernel with the first `r_resident` layers
    in an L2 persisting window (the first call on a weight set packs it)."""
    _check(x, weights, r_resident, variant, dims)
    if x.device.type == "cpu":
        return probe_reference(x, weights, variant, dims)
    out = _launch(x, weights, r_resident, variant, dims, "frame")
    faststack_probe.launches += 1
    return out


faststack_probe.launches = 0


def reset_l2_persistence():
    """Return the L2 lines the probe made persisting to normal."""
    check_launch(load_kernels().fs_l2_persistence_reset(), "l2_persistence_reset")


def make_probe(r_resident: int, variant: str = "bf16",
               dims: ProbeDims = ProbeDims()):
    """The probe as a function of (x (1, DF) fp32, weights), as the JAX
    package's `make_probe` returns it."""
    def run(x, weights):
        return faststack_probe(x, weights, r_resident, variant, dims)

    return run


def _frames_ms(run, x, frames):
    """ms per frame of `frames` chained calls of run (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    y = x
    start.record()
    for _ in range(frames):
        y = run(y)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / frames


def _bench(r_resident: int, variant: str, repeats: int = 3, frames: int = 30,
           dims: ProbeDims = ProbeDims(), weights=None, device="cuda:0"):
    """Best-of-`repeats` ms per frame over `frames` chained frames (CUDA
    events), printed with the effective weight-stream rate."""
    if not torch.cuda.is_available():
        raise SystemExit("faststack: the probe measures the card; CUDA is "
                         "not available")
    run = make_probe(r_resident, variant, dims)
    if weights is None:
        weights = make_weights(dims, device)
    x = torch.full((1, dims.df), 0.01, dtype=torch.float32, device=device)
    out = run(x, weights)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError("non-finite probe output")
    best = min(_frames_ms(lambda y: run(y, weights), x, frames)
               for _ in range(repeats))
    traffic = dims.frame_bytes(r_resident)
    print(f"R={r_resident} variant={variant}: {best:.4f} ms/frame (effective "
          f"{traffic / best / 1e6:.0f} GB/s over {traffic / 1e9:.2f} GB)",
          flush=True)
    return best


def part_ms(part: str, r_resident: int, variant: str, repeats: int = 3,
            frames: int = 30, dims: ProbeDims = ProbeDims(), weights=None,
            device="cuda:0"):
    """`_bench`'s best-of-`repeats` ms per frame of one part of a frame run
    alone: "barriers" (its 4 x NL x STEPS grid barriers) or "loads" (its
    weight stream, each slot released unread). Counts no launch."""
    if weights is None:
        weights = make_weights(dims, device)
    x = torch.full((1, dims.df), 0.01, dtype=torch.float32, device=device)
    _check(x, weights, r_resident, variant, dims)

    def run(y):
        _launch(y, weights, r_resident, variant, dims, part)
        return y

    run(x)
    torch.cuda.synchronize()
    return min(_frames_ms(run, x, frames) for _ in range(repeats))


if __name__ == "__main__":
    rs = [int(a) for a in sys.argv[1:] if a.isdigit()] or [0, 1]
    variants = [a for a in sys.argv[1:] if a in ("bf16", "w8a8")] or [
        "bf16", "w8a8"]
    w = make_weights(ProbeDims(), "cuda:0")
    for v in variants:
        for r in rs:
            _bench(r, v, weights=w)
            print(f"R={r} variant={v}: barriers alone "
                  f"{part_ms('barriers', r, v, weights=w):.4f} ms/frame, "
                  f"weight stream alone {part_ms('loads', r, v, weights=w):.4f} "
                  f"ms/frame", flush=True)
    if any(rs):
        reset_l2_persistence()
