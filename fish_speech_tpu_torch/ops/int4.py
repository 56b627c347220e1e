"""int4 group-wise weight-only matmul: y = x @ W, W packed two per byte.

Port of the Pallas TPU kernel `fish_speech_tpu/ops/pallas_int4.py`
(`_int4_mm_kernel` / `int4_matmul`). Layout (per 2D weight, see
`ops/quant.py`):

  p:  (I/2, O) uint8 -- low nibble = row i, high nibble = row i + I/2, +8
  gs: (I/g, O) fp32  -- group scales over the original row index

and a group never straddles the half split: (I/2) % g == 0.

The kernels are hand-written CUDA for Hopper (`csrc/int4_mm.cu`). The
wrapper picks one of three routes by x's rows B and dtype (`_route`), an
explicit dispatch, not a fallback:

  * "gemv", B <= 8: a split-K matrix-vector kernel, one launch a product:
    `gemv_split` cuts the packed rows into runs of whole groups, and the
    kernel adds the runs' partials in split order itself; bf16 x uses the
    Pallas kernel's bf16 W (on the tensor cores where the groups are
    multiples of 128 rows and O of 16), fp32 x the fp32 W (CUDA cores);
  * "wgmma", bf16 x with B > 8 (every prefill): a tensor-core kernel that
    dequantizes W as the Pallas kernel does, rn_bf16(q * rn_bf16(s)), and
    sums in fp32; its plain version is `int4_matmul_bf16w_reference`;
  * "fp32_tiled", fp32 x with B > 8: a tiled product on the CUDA cores, W
    in fp32.

`int4_matmul_reference` is the plain version of the fp32-W routes (the JAX
package's `int4_matmul_reference`). The wrapper runs it for CPU tensors
only; for a CUDA tensor it launches the route's kernel or raises.
"""

from __future__ import annotations

import functools

import torch

from fish_speech_tpu_torch.ops._kernels import (DTYPE_CODES, check_launch,
                                                 load_kernels, scratch,
                                                 sm_count, stream_ptr)

GEMV_MAX_ROWS = 8  # rows of x up to which the split-K matvec kernel runs
ROUTES = ("gemv", "wgmma", "fp32_tiled")  # route codes of fs_int4_matmul
GEMV_COLS = 256  # output columns per block of the matvec kernel
GEMV_BLOCKS_PER_SM = 2  # blocks the split aims for
GEMV_MAX_SPLIT = 64  # most runs the packed rows are cut into
GEMV_MAX_RUN = 1024  # most packed rows of a run, where groups allow
_ROUTE_CODES = {r: n for n, r in enumerate(ROUTES)}


@functools.lru_cache(maxsize=None)
def gemv_split(i: int, o: int, g: int, n_sm: int) -> int:
    """How many equal runs of whole groups the matvec kernel cuts the I/2
    packed rows into: the fewest that still give GEMV_BLOCKS_PER_SM blocks
    per SM with ceil(O / GEMV_COLS) column tiles, else as many as
    GEMV_MAX_SPLIT allows (up to one group a run); a run of more than one
    group keeps within GEMV_MAX_RUN packed rows (the kernel stages a run's
    x in shared memory)."""
    n_groups = i // 2 // g
    tiles = -(-o // GEMV_COLS)
    sizes = [d for d in range(1, n_groups + 1)  # groups per run
             if n_groups % d == 0 and n_groups // d <= GEMV_MAX_SPLIT
             and (d == 1 or d * g <= GEMV_MAX_RUN)]
    sizes = sizes or [n_groups]
    fits = [d for d in sizes if tiles * (n_groups // d) >= GEMV_BLOCKS_PER_SM * n_sm]
    return n_groups // (max(fits) if fits else min(sizes))


def gemv_partials_reference(x, p, gs, n_split: int):
    """The matvec kernel's per-run partial sums in fp32, (n_split, B, O):
    run k covers packed rows [k * I/(2 n_split), (k + 1) * I/(2 n_split))
    and both their nibbles, on the W of x's dtype (bf16: the Pallas
    kernel's; fp32: q * s). Summed in run order they give y."""
    half = p.shape[-2]
    rows = half // n_split
    w = (int4_dequant_bf16(p, gs) if x.dtype == torch.bfloat16 else
         unpack_int4(p).float() * torch.repeat_interleave(
             gs.float(), 2 * half // gs.shape[-2], dim=-2)).float()
    xf = x.float()
    return torch.stack([
        xf[:, k * rows:(k + 1) * rows] @ w[k * rows:(k + 1) * rows]
        + xf[:, half + k * rows:half + (k + 1) * rows]
        @ w[half + k * rows:half + (k + 1) * rows]
        for k in range(n_split)])


def _group(i: int, n_groups: int) -> int:
    g = i // n_groups
    if g * n_groups != i or (i // 2) % g:
        raise ValueError(f"int4_matmul: {n_groups} groups over I={i} straddle "
                         f"the half split ((I/2) % g must be 0)")
    return g


def unpack_int4(p):
    """(..., I/2, O) packed bytes -> (..., I, O) int8 values in [-8, 7]."""
    lo = (p & 0xF).to(torch.int8) - 8
    hi = (p >> 4).to(torch.int8) - 8
    return torch.cat([lo, hi], dim=-2)


def int4_matmul_reference(x, p, gs):
    """x (B, I) @ the unpacked weight (I, O), in fp32, cast to x's dtype."""
    half = p.shape[-2]
    g = _group(2 * half, gs.shape[-2])
    w = unpack_int4(p).float() * torch.repeat_interleave(gs.float(), g, dim=-2)
    return (x.float() @ w).to(x.dtype)


def int4_dequant_bf16(p, gs):
    """The Pallas kernel's weight: rn_bf16(q * rn_bf16(s)), (I, O) bf16.
    Both factors are bf16, so the product rounds once, from an exact fp32
    product (a 4-bit and an 8-bit significand)."""
    half = p.shape[-2]
    g = _group(2 * half, gs.shape[-2])
    s = torch.repeat_interleave(gs.to(torch.bfloat16).float(), g, dim=-2)
    return (unpack_int4(p).float() * s).to(torch.bfloat16)


def int4_matmul_bf16w_reference(x, p, gs):
    """Plain version of the "wgmma" route: x @ `int4_dequant_bf16(p, gs)`,
    summed in fp32, cast to x's dtype."""
    return (x.float() @ int4_dequant_bf16(p, gs).float()).to(x.dtype)


def _route(b: int, dtype: torch.dtype) -> str:
    """Which kernel `int4_matmul` launches for B rows of x in `dtype`."""
    if b <= GEMV_MAX_ROWS:
        return "gemv"
    return "wgmma" if dtype == torch.bfloat16 else "fp32_tiled"


def _check(x, p, gs):
    if not (x.is_cuda and p.device == x.device and gs.device == x.device):
        raise ValueError("int4_matmul: x, p and gs must lie on one CUDA device")
    if x.dtype not in DTYPE_CODES or p.dtype != torch.uint8 or gs.dtype != torch.float32:
        raise TypeError(f"int4_matmul: x bf16/fp32, p uint8, gs fp32; got "
                        f"{x.dtype}/{p.dtype}/{gs.dtype}")
    if x.dim() != 2 or p.dim() != 2 or gs.dim() != 2:
        raise ValueError("int4_matmul: x (B, I), p (I/2, O), gs (I/g, O)")
    b, i = x.shape
    half, o = p.shape
    if 2 * half != i or gs.shape[1] != o:
        raise ValueError(f"int4_matmul: shapes x {tuple(x.shape)}, p "
                         f"{tuple(p.shape)}, gs {tuple(gs.shape)} disagree")
    for name, t in (("x", x), ("p", p), ("gs", gs)):
        if not t.is_contiguous():
            raise ValueError(f"int4_matmul: {name} must be contiguous")
    return b, i, o, _group(i, gs.shape[0])


_PLANS: dict = {}


def _plan(x, p, gs):
    """What a call of these shapes, dtypes and devices passes the kernel
    beyond its pointers: (route, counter name, I, O, g, split count,
    workspace, counters, dtype code, route code). The first call of a key
    runs every check of `_check` and keeps the plan; a later one repeats
    only contiguity, which the key does not fix."""
    key = (x.shape, p.shape, gs.shape, x.dtype, p.dtype, gs.dtype,
           x.get_device(), p.get_device(), gs.get_device())
    plan = _PLANS.get(key)
    if plan is None:
        b, i, o, g = _check(x, p, gs)
        route = _route(b, x.dtype)
        n_split = gemv_split(i, o, g, sm_count(x.device)) if route == "gemv" else 1
        work = counters = 0  # NULL: one run, or another route
        if n_split > 1:
            w, c = scratch("int4_gemv", x.device, n_split * b * o, -(-o // GEMV_COLS))
            work, counters = w.data_ptr(), c.data_ptr()
        plan = _PLANS[key] = (route, f"launches_{route}", i, o, g, n_split, work,
                              counters, DTYPE_CODES[x.dtype], _ROUTE_CODES[route])
    elif not (x.is_contiguous() and p.is_contiguous() and gs.is_contiguous()):
        raise ValueError("int4_matmul: x, p and gs must be contiguous")
    return plan


def int4_matmul(x, p, gs):
    """x (B, I) bf16/fp32 @ packed int4 W -> (B, O) in x's dtype. On CUDA
    tensors runs the hand-written kernel of `_route(B, x.dtype)`."""
    if not x.is_cuda and x.device.type == "cpu":
        return int4_matmul_reference(x, p, gs)
    route, count, i, o, g, n_split, work, counters, code, route_code = _plan(x, p, gs)
    b = x.shape[0]
    out = x.new_empty((b, o))
    rc = load_kernels().fs_int4_matmul(
        x.data_ptr(), p.data_ptr(), gs.data_ptr(), out.data_ptr(), work,
        counters, b, i, o, g, code, route_code, n_split, stream_ptr(x))
    check_launch(rc, f"int4_matmul ({route})")
    int4_matmul.launches += 1
    setattr(int4_matmul, count, getattr(int4_matmul, count) + 1)
    return out


def reset_launches():
    """Set `int4_matmul`'s launch counts (all routes and each route) to 0."""
    int4_matmul.launches = 0
    for route in ROUTES:
        setattr(int4_matmul, f"launches_{route}", 0)


reset_launches()
