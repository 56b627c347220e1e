"""Weight-only quantization and the model's matmul helper.

Port of `fish_speech_tpu/ops/quant.py`. A quantized weight is a dict:

  * int8, per output channel: {"q": int8 (..., I, O), "s": fp32 (..., O)};
  * int4, group-wise, two values per byte in the HALF-SPLIT layout:
    {"p": uint8 (..., I/2, O), "gs": fp32 (..., I/g, O)}, where byte
    [i, o] holds w[i, o] in the low nibble and w[i + I/2, o] in the high
    nibble, each biased by 8; the group size is g = 2 * p.rows / gs.rows.

`mm` dispatches on the dict. The int8 product of up to 32 rows (every
decode product and head, and the prefill's LM head at a row per prompt)
runs the hand-written kernel `ops/int8.py` (`csrc/int8_mm.cu`, the port of
the Pallas int8 matvec: one rounding of the fp32 sum times the fp32 scale)
on CUDA tensors and its plain version on the CPU; more rows (the prefill's
layer products) stay `x @ q.to(dtype) * s.to(dtype)` in torch, as the JAX
package leaves them to XLA. `mm.launches_int8_matmul` and
`mm.launches_int8_cast` count the int8 products by route. The int4 product
runs the hand-written kernel `ops/int4.py` (`csrc/int4_mm.cuh`) on CUDA
tensors and the unpacked reference weight on the CPU. The quantizers give
results bitwise equal to the JAX package's (the tests hold them to it).
"""

from __future__ import annotations

import torch

from fish_speech_tpu_torch.ops.int4 import int4_matmul, unpack_int4
from fish_speech_tpu_torch.ops.int8 import MAX_ROWS as INT8_KERNEL_ROWS
from fish_speech_tpu_torch.ops.int8 import int8_matmul

# the layer weights quantized, and the default int4 group size (halved
# where a weight needs it, `_quantize_weight`)
TARGETS = ("wqkv", "wo", "w1", "w2", "w3")
GROUP_SIZE = 128


def quantize_int8(w, dim: int = -2):
    """Symmetric per-output-channel int8 quantization of (..., I, O)."""
    wf = w.float()
    scale = wf.abs().amax(dim=dim, keepdim=True) / 127.0
    q = torch.clamp(torch.round(wf / torch.clamp(scale, min=1e-12)), -128, 127)
    # fp32 scales, as in the JAX package: a bf16 scale would add a ~0.4%
    # multiplicative rounding to every channel
    return {"q": q.to(torch.int8), "s": scale.squeeze(dim)}


def dequantize_int8(qw, dtype=torch.bfloat16):
    return (qw["q"].float() * qw["s"][..., None, :].float()).to(dtype)


def quantize_int4(w, group_size: int = 128):
    """Group-wise symmetric int4 quantization of (..., I, O), packed in the
    half-split layout (module docstring)."""
    wf = w.float()
    *lead, i, o = wf.shape
    if i % 2 or i % group_size:
        raise ValueError(f"int4: I={i} must be even and a multiple of the "
                         f"group size {group_size}")
    grouped = wf.reshape(*lead, i // group_size, group_size, o)
    scale = grouped.abs().amax(dim=-2, keepdim=True) / 7.0
    q = torch.clamp(torch.round(grouped / torch.clamp(scale, min=1e-12)), -8, 7)
    q = q.to(torch.int8).reshape(*lead, i, o)
    half = i // 2
    lo = (q[..., :half, :] + 8).to(torch.uint8)
    hi = (q[..., half:, :] + 8).to(torch.uint8)
    return {"p": lo | (hi << 4), "gs": scale.squeeze(-2)}


def _int4_effective_weight(qw, dtype):
    """Unpack an int4 weight to (..., I, O) in `dtype`: `mm`'s CPU operand
    (W = q * s in fp32, rounded to `dtype`, as the JAX package's reference
    path does)."""
    q = unpack_int4(qw["p"])  # (..., I, O)
    g = q.shape[-2] // qw["gs"].shape[-2]
    scale = torch.repeat_interleave(qw["gs"].float(), g, dim=-2)
    return (q.float() * scale).to(dtype)


def mm(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for a plain, int8- or int4-quantized (..., I, O) weight."""
    if isinstance(w, dict) and "p" in w:
        if x.device.type == "cpu":
            return x @ _int4_effective_weight(w, x.dtype)
        lead = x.shape[:-1]
        y = int4_matmul(x.reshape(-1, x.shape[-1]).contiguous(), w["p"], w["gs"])
        return y.reshape(*lead, y.shape[-1])
    if isinstance(w, dict) and "q" in w:
        rows = x.numel() // x.shape[-1]
        if 0 < rows <= INT8_KERNEL_ROWS:
            mm.launches_int8_matmul += 1
            lead = x.shape[:-1]
            s = w["s"].float()  # a no-op on the fp32 scales of `fp32_scales`
            y = int8_matmul(x.reshape(rows, x.shape[-1]).contiguous(), w["q"], s)
            return y.reshape(*lead, y.shape[-1])
        mm.launches_int8_cast += 1
        y = x @ w["q"].to(x.dtype)
        return y * w["s"].to(x.dtype)
    return x @ w


def reset_launches():
    """Set `mm`'s counts of int8 products by route to 0."""
    mm.launches_int8_matmul = 0
    mm.launches_int8_cast = 0


reset_launches()


def fp32_scales(params):
    """The tree with every quantized weight's scales in fp32 (a checkpoint
    read in bf16 has bf16 scales; the kernels take fp32), cast once here
    rather than by `mm` on every call. Other leaves are shared."""
    if isinstance(params, dict):
        quant = {"q", "s"} <= params.keys() or {"p", "gs"} <= params.keys()
        return {k: v.float() if quant and k in ("s", "gs") else fp32_scales(v)
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(fp32_scales(v) for v in params)
    return params


def _quantize_weight(w, mode: str, group_size: int = GROUP_SIZE):
    if mode == "int8":
        return quantize_int8(w)
    if mode == "int4":
        i = w.shape[-2]
        g = group_size
        # g must divide I and must not straddle the half split (the kernel's
        # contract): (I/2) % g == 0
        while g > 1 and (i % g or (i // 2) % g):
            g //= 2
        return quantize_int4(w, group_size=g)
    raise ValueError(mode)


def _quantize_stacked(w, mode, group_size=GROUP_SIZE):
    """Quantize a leaf one layer at a time, so the fp32 temporaries stay
    one layer in size; the outputs are allocated once and filled."""
    if w.dim() != 3:
        return _quantize_weight(w, mode, group_size)
    first = _quantize_weight(w[0], mode, group_size)
    out = {k: torch.empty((w.shape[0], *v.shape), dtype=v.dtype, device=v.device)
           for k, v in first.items()}
    for i in range(w.shape[0]):
        qi = first if i == 0 else _quantize_weight(w[i], mode, group_size)
        for k, v in qi.items():
            out[k][i] = v
    return out


def quantize_dual_ar_lowmem(params, mode="int8", fast_mode=None,
                            group_size: int = GROUP_SIZE):
    """Quantize the Dual-AR parameter tree of a device-resident model, one
    leaf at a time and one layer at a time, each source leaf dropped from
    the returned tree as soon as it is quantized (the caller drops its own
    reference to `params` to free it).

    mode: "int8" (per channel) or "int4" (group-wise, packed) for the
    TARGETS of both layer stacks; `fast_mode` quantizes the fast stack
    differently ("mixed": mode="int8", fast_mode="int4"). The int4 group
    size starts at `group_size` and is halved, weight by weight, until it
    divides I and I/2 (`_quantize_weight`, the JAX package's rule).
    Embedding tables stay as they are (gathers, not matmuls); the untied LM
    head and the fast head are always int8. The tree equals the JAX
    package's `quantize_dual_ar` with the same modes and group size."""
    out = dict(params)
    layers = dict(params["layers"])
    for name in TARGETS:
        if name in layers and not isinstance(layers[name], dict):
            layers[name] = _quantize_stacked(layers.pop(name), mode, group_size)
    out["layers"] = layers
    fast = dict(params["fast"])
    flayers = dict(fast["layers"])
    for name in TARGETS:
        if name in flayers and not isinstance(flayers[name], dict):
            flayers[name] = _quantize_stacked(flayers.pop(name),
                                              fast_mode or mode, group_size)
    fast["layers"] = flayers
    if "output" in fast and not isinstance(fast["output"], dict):
        fast["output"] = _quantize_stacked(fast.pop("output"), "int8")
    out["fast"] = fast
    if "output" in out and not isinstance(out["output"], dict):
        out["output"] = _quantize_stacked(out.pop("output"), "int8")
    return out
