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
persistent cooperative kernel per frame, the first `r_resident` layers read
through an L2 persisting window. `probe_reference` is the plain version
(the same chain as a torch loop); `faststack_probe` runs it for CPU tensors
only and, for CUDA tensors, launches the kernel or raises. Both compute the
INTENDED chain, each layer with its own weights: the TPU kernel's prefetch
into the slot it is reading (`consume`, `pallas_faststack.py:180-189`) is a
race, harmless only where one layer is streamed.

    python -m fish_speech_tpu_torch.ops.faststack [R...] [bf16|w8a8]

times R in {0, 1} (default) for both variants on `cuda:0`.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from fish_speech_tpu_torch.ops._kernels import check_launch, load_kernels
from fish_speech_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

RMS_EPS = 1e-5


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


def faststack_probe(x, weights, r_resident: int = 0, variant: str = "bf16",
                    dims: ProbeDims = ProbeDims()):
    """One frame of the probe: x (1, DF) fp32 -> (1, DF) fp32. On CUDA
    tensors runs the cooperative kernel with the first `r_resident` layers
    in an L2 persisting window."""
    if variant not in ("bf16", "w8a8"):
        raise ValueError(f"faststack_probe: variant {variant!r}")
    if not 0 <= r_resident < dims.n_layer:
        raise ValueError(f"faststack_probe: R={r_resident} not in "
                         f"[0, {dims.n_layer})")
    if x.device.type == "cpu":
        return probe_reference(x, weights, variant, dims)
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
    lib = load_kernels()
    out = torch.empty_like(x)
    ws = torch.empty(3 * dims.df + dims.dqkv + dims.df + 2 * dims.inter,
                     dtype=torch.float32, device=x.device)
    rc = lib.fs_faststack_probe(
        w.data_ptr(), sc.data_ptr(), x.data_ptr(), out.data_ptr(),
        ws.data_ptr(), dims.df, dims.dqkv, dims.inter, dims.n_layer,
        dims.steps, r_resident, int(variant == "w8a8"),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    check_launch(rc, "faststack_probe")
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
    best = float("inf")
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        y = x
        start.record()
        for _ in range(frames):
            y = run(y, weights)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / frames)
    traffic = dims.frame_bytes(r_resident)
    print(f"R={r_resident} variant={variant}: {best:.4f} ms/frame (effective "
          f"{traffic / best / 1e6:.0f} GB/s over {traffic / 1e9:.2f} GB)",
          flush=True)
    return best


if __name__ == "__main__":
    rs = [int(a) for a in sys.argv[1:] if a.isdigit()] or [0, 1]
    variants = [a for a in sys.argv[1:] if a in ("bf16", "w8a8")] or [
        "bf16", "w8a8"]
    w = make_weights(ProbeDims(), "cuda:0")
    for v in variants:
        for r in rs:
            _bench(r, v, weights=w)
    if any(rs):
        reset_l2_persistence()
