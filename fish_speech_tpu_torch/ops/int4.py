"""int4 group-wise weight-only matmul: y = x @ W, W packed two per byte.

Port of the Pallas TPU kernel `fish_speech_tpu/ops/pallas_int4.py`
(`_int4_mm_kernel` / `int4_matmul`). Layout (per 2D weight, see
`ops/quant.py`):

  p:  (I/2, O) uint8 -- low nibble = row i, high nibble = row i + I/2, +8
  gs: (I/g, O) fp32  -- group scales over the original row index (bf16 or
                        fp16 as a checkpoint read in that dtype holds them:
                        the wrapper widens them to fp32, exactly)

and a group never straddles the half split: (I/2) % g == 0.

The kernels are hand-written CUDA for Hopper (`csrc/int4_mm.cuh`,
compiled per dtype by `int4_mm{,_bf16,_f16}.cu`). The wrapper picks one
of three routes by x's rows B and dtype (`_route`), an
explicit dispatch, not a fallback:

  * "gemv", B <= 8: a split-K matrix-vector kernel, one launch a product:
    `gemv_split` cuts the packed rows into runs of whole groups, and the
    kernel adds the runs' partials in split order itself; bf16 x uses the
    Pallas kernel's bf16 W (on the tensor cores where the groups are
    multiples of 128 rows and O of 16), fp32 x the fp32 W (CUDA cores);
  * "wgmma", bf16 x with B > 8 (every prefill): a tensor-core kernel that
    dequantizes W as the Pallas kernel does, rn_bf16(q * rn_bf16(s)), and
    sums in fp32; its plain version is `int4_matmul_bf16w_reference`;
  * "fp32_tc", fp32 x with B > 8: the products on the tensor cores, x as
    two TF32 terms times the exact q, each group's sum scaled once in fp32
    (`csrc/int4_mm.cuh:int4_tf32_kernel` on mma.sync and
    `int4_tf32_wgmma_kernel` on wgmma, its own C entry point; the tile
    shape and a split of the groups into runs, summed in the launch, from
    `fp32_tc_plan`);
  * "gemv_f16" and "wgmma_f16", fp16 x (`--half` serving), B <= 8 and
    B > 8: the first two routes' kernels on fp16 operands, W =
    rn_f16(q * rn_f16(s)) (`int4_dequant_f16`; plain version
    `int4_matmul_f16w_reference`). Where s is an fp16 value (a checkpoint
    read under `--half`) that is bitwise the JAX package's `mm` off the
    TPU, rn_f16(q * s); the Pallas kernel keeps a bf16 W under fp16 x
    (ROADMAP §3).

`int4_matmul_reference` is the plain version of the fp32-W routes (the JAX
package's `int4_matmul_reference`). The wrapper runs it for CPU tensors
only; for a CUDA tensor it launches the route's kernel or raises.
"""

from __future__ import annotations

import functools

import torch

from fish_speech_tpu_torch.ops._kernels import (DTYPE_CODES, check_launch,
                                                load_kernels, scratch, sm_count,
                                                stream_ptr)

GEMV_MAX_ROWS = 8  # rows of x up to which the split-K matvec kernel runs
# routes; the code of each in fs_int4_matmul, which takes fp16 x on the
# codes of "gemv" and "wgmma" ("fp32_tc" has its own entry point,
# fs_int4_matmul_fp32)
ROUTES = ("gemv", "wgmma", "fp32_tc", "gemv_f16", "wgmma_f16")
GEMV_COLS = 256  # output columns per block of the matvec kernel
GEMV_BLOCKS_PER_SM = 2  # blocks the split aims for
GEMV_MAX_SPLIT = 64  # most runs the packed rows are cut into
GEMV_MAX_RUN = 1024  # most packed rows of a run, where groups allow
_ROUTE_CODES = {"gemv": 0, "wgmma": 1, "gemv_f16": 0, "wgmma_f16": 1}
# "fp32_tc"'s tile shapes (rows of x, output columns), as `csrc/int4_mm.cuh:
# tf::Tile0..2` (mma.sync) and `tf::WTile` (wgmma) lay them out, and the rate
# of each (a block's rows x columns a unit of time; only their ratios count;
# set by `scripts/fp32_kernels_bench.py --sweep`)
FP32_TC_TILES = ((64, 64), (32, 64), (16, 64), (64, 128))
FP32_TC_RATE = (0.95, 0.75, 0.75, 1.5)
FP32_TC_MAX_SPLIT = 16  # most runs the groups are cut into
SCALE_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


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


def split_count(route: str, i: int, o: int, g: int, n_sm: int) -> int:
    """The runs the kernel of `route` cuts the packed rows into:
    `gemv_split`'s on the matvec routes (either dtype), else one."""
    return gemv_split(i, o, g, n_sm) if route in ("gemv", "gemv_f16") else 1


def gemv_partials_reference(x, p, gs, n_split: int):
    """The matvec kernel's per-run partial sums in fp32, (n_split, B, O):
    run k covers packed rows [k * I/(2 n_split), (k + 1) * I/(2 n_split))
    and both their nibbles, on the W of x's dtype (bf16: the Pallas
    kernel's; fp16: `int4_dequant_f16`; fp32: q * s). Summed in run order
    they give y."""
    half = p.shape[-2]
    rows = half // n_split
    if x.dtype in (torch.bfloat16, torch.float16):
        w = _dequant16(p, gs, x.dtype).float()
    else:
        w = unpack_int4(p).float() * torch.repeat_interleave(
            gs.float(), 2 * half // gs.shape[-2], dim=-2)
    xf = x.float()
    return torch.stack([
        xf[:, k * rows:(k + 1) * rows] @ w[k * rows:(k + 1) * rows]
        + xf[:, half + k * rows:half + (k + 1) * rows]
        @ w[half + k * rows:half + (k + 1) * rows]
        for k in range(n_split)])


def fp32_tc_plan(b: int, i: int, o: int, g: int, n_sm: int, resident) -> tuple:
    """(tile, n_split) of the "fp32_tc" kernel for B rows of x, I -> O with
    groups of g, on `n_sm` SMs, `resident[k]` blocks of tile shape k (an
    index of FP32_TC_TILES) fitting on one SM. For each shape the runs the
    I/2g groups of a half are cut into (the grid's z; whole groups, sizes
    differing by at most one) are the most, up to FP32_TC_MAX_SPLIT, that
    still leave no more blocks than fit on the card at once; the pick is
    the least waves x
    (blocks an SM runs at once) x rows x columns / runs / FP32_TC_RATE.
    So the products with few output columns or rows (s2-pro's wo and w2,
    O = 2560) fill the card. It reads the shape only."""
    n_groups = i // 2 // g

    def plan(k):
        bm, bn = FP32_TC_TILES[k]
        blocks = -(-b // bm) * -(-o // bn)
        fit = n_sm * resident[k]
        n = max(1, min(FP32_TC_MAX_SPLIT, n_groups, fit // blocks))
        total = blocks * n
        waves = -(-total // fit)
        per_sm = min(resident[k], -(-total // n_sm))
        return waves * per_sm * bm * bn / n / FP32_TC_RATE[k], n

    k = min(range(len(FP32_TC_TILES)), key=lambda k: plan(k)[0])
    return k, plan(k)[1]


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


def _dequant16(p, gs, dtype):
    """rn(q * rn(s)) in the 16-bit `dtype`, (I, O): both factors are
    values of `dtype`, so the product rounds once, from an exact fp32
    product (a 4-bit and an 8- or 11-bit significand)."""
    half = p.shape[-2]
    g = _group(2 * half, gs.shape[-2])
    s = torch.repeat_interleave(gs.to(dtype).float(), g, dim=-2)
    return (unpack_int4(p).float() * s).to(dtype)


def int4_dequant_bf16(p, gs):
    """The Pallas kernel's weight: rn_bf16(q * rn_bf16(s)), (I, O) bf16."""
    return _dequant16(p, gs, torch.bfloat16)


def int4_dequant_f16(p, gs):
    """The fp16 routes' weight: rn_f16(q * rn_f16(s)), (I, O) fp16. For
    fp16 scales (a checkpoint read under `--half`) it is rn_f16(q * s),
    bitwise the JAX package's `mm` off the TPU."""
    return _dequant16(p, gs, torch.float16)


def int4_matmul_bf16w_reference(x, p, gs):
    """Plain version of the "wgmma" route: x @ `int4_dequant_bf16(p, gs)`,
    summed in fp32, cast to x's dtype."""
    return (x.float() @ int4_dequant_bf16(p, gs).float()).to(x.dtype)


def int4_matmul_f16w_reference(x, p, gs):
    """Plain version of the "gemv_f16" and "wgmma_f16" routes: x @
    `int4_dequant_f16(p, gs)`, summed in fp32, cast to x's dtype."""
    return (x.float() @ int4_dequant_f16(p, gs).float()).to(x.dtype)


def _route(b: int, dtype: torch.dtype) -> str:
    """Which kernel `int4_matmul` launches for B rows of x in `dtype`."""
    if dtype == torch.float16:
        return "gemv_f16" if b <= GEMV_MAX_ROWS else "wgmma_f16"
    if b <= GEMV_MAX_ROWS:
        return "gemv"
    return "wgmma" if dtype == torch.bfloat16 else "fp32_tc"


def _check(x, p, gs):
    if not (x.is_cuda and p.device == x.device and gs.device == x.device):
        raise ValueError("int4_matmul: x, p and gs must lie on one CUDA device")
    if (x.dtype not in DTYPE_CODES or p.dtype != torch.uint8
            or gs.dtype not in SCALE_DTYPES):
        raise TypeError(f"int4_matmul: x bf16/fp16/fp32, p uint8, gs fp32/bf16/"
                        f"fp16; got {x.dtype}/{p.dtype}/{gs.dtype}")
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


@functools.lru_cache(maxsize=None)
def fp32_tc_resident(device: torch.device) -> tuple:
    """Blocks of each "fp32_tc" tile shape that fit on one SM of `device`
    (the CUDA occupancy calculator)."""
    import ctypes

    lib = load_kernels()
    out = []
    for k in range(len(FP32_TC_TILES)):
        n = ctypes.c_int()
        with torch.cuda.device(device):
            check_launch(lib.fs_int4_fp32_occupancy(k, ctypes.byref(n)),
                         "fs_int4_fp32_occupancy")
        out.append(max(1, n.value))
    return tuple(out)


def _plan(x, p, gs):
    """What a call of these shapes, dtypes and devices passes the kernel
    beyond its pointers: (route, counter name, I, O, g, split count,
    workspace, counters, dtype code, route code; "fp32_tc": its tile shape
    in place of the route code, its runs as the split count). The first call of a key
    runs every check of `_check` and keeps the plan; a later one repeats
    only contiguity, which the key does not fix."""
    key = (x.shape, p.shape, gs.shape, x.dtype, p.dtype, gs.dtype,
           x.get_device(), p.get_device(), gs.get_device())
    plan = _PLANS.get(key)
    if plan is None:
        b, i, o, g = _check(x, p, gs)
        route = _route(b, x.dtype)
        if route == "fp32_tc":
            code, n_split = fp32_tc_plan(b, i, o, g, sm_count(x.device),
                                         fp32_tc_resident(x.device))
            bm, bn = FP32_TC_TILES[code]
            name, tiles = "int4_fp32", -(-b // bm) * -(-o // bn)
        else:
            code, n_split = _ROUTE_CODES[route], split_count(route, i, o, g,
                                                             sm_count(x.device))
            name, tiles = "int4_gemv", -(-o // GEMV_COLS)
        work = counters = 0  # NULL: one run
        if n_split > 1:
            w, c = scratch(name, x.device, n_split * b * o, tiles)
            work, counters = w.data_ptr(), c.data_ptr()
        plan = _PLANS[key] = (route, f"launches_{route}", i, o, g, n_split, work,
                              counters, DTYPE_CODES[x.dtype], code)
    elif not (x.is_contiguous() and p.is_contiguous() and gs.is_contiguous()):
        raise ValueError("int4_matmul: x, p and gs must be contiguous")
    return plan


def int4_matmul(x, p, gs):
    """x (B, I) bf16/fp16/fp32 @ packed int4 W -> (B, O) in x's dtype. On
    CUDA tensors runs the hand-written kernel of `_route(B, x.dtype)`."""
    if not x.is_cuda and x.device.type == "cpu":
        return int4_matmul_reference(x, p, gs)
    route, count, i, o, g, n_split, work, counters, code, route_code = _plan(x, p, gs)
    if gs.dtype != torch.float32:  # a checkpoint's bf16 or fp16 scales, exactly
        gs = gs.float()
    b = x.shape[0]
    out = x.new_empty((b, o))
    if route == "fp32_tc":
        rc = load_kernels().fs_int4_matmul_fp32(
            x.data_ptr(), p.data_ptr(), gs.data_ptr(), out.data_ptr(), work, counters,
            b, i, o, g, route_code, n_split, stream_ptr(x))
    else:
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
