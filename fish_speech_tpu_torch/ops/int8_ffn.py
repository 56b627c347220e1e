"""Fused int8 SwiGLU FFN for up to 32 rows: y = rn(rn(silu(x W1) * (x W3)) W2).

Port of the Pallas TPU kernel `scripts/microbench/ffn_fused_packed.py`
(`_ffn_kernel` / `ffn_fused`), which computes the model's int8 FFN
(`models/dual_ar.py:_ffn`) in one kernel over per-channel int8 weights
(`ops/quant.py:quantize_int8`):

  x: (B, D) bf16, fp16 or fp32, 1 <= B <= 32
  w13: {"q": int8 (D, 2I), "s": fp32 (2I,)} (`fuse_ffn_weights`), or the
       pair (w1, w3), each {"q": int8 (D, I), "s": fp32 (I,)}
  w2: {"q": int8 (I, D), "s": fp32 (D,)}
  u1 = (x @ float(q1)) * s1,  u3 = (x @ float(q3)) * s3   fp32 sums, not rounded
  g  = rn_dtype(u1 * sigmoid(u1) * u3)                     the one rounding of g
  y  = rn_dtype((g @ float(q2)) * s2)                      fp32 sum, one rounding

JAX's `_ffn` (and the port's route for other FFNs) rounds u1 and u3 to
x's dtype in each `mm`, takes the gate in that dtype and rounds again; this
is the Pallas kernel's function, with fewer roundings.

The kernel is hand-written CUDA for Hopper (`csrc/int8_ffn.cu`): one launch
runs phase A (u1, u3 and the gate into g), a grid barrier, and phase B (g
@ q2), each cut into items of a column tile and a run of rows
(`int8_ffn_plan`). The wrapper picks the kernel by x's dtype (`_route`),
an explicit dispatch, not a fallback: "mma" for bf16 x (the tensor cores,
the weights streamed by TMA), "mma_f16" for fp16 x (`--half` serving: the
same kernel on fp16 operands, g and y rounded to fp16), "cuda_cores" for
fp32 x (the small fp32 models: `int8_ffn_fp32_kernel<NB, kTma>`, the
mma route's items on the CUDA cores, the weights by TMA where their layout
takes 128-byte boxes, runs from `ops/int8.py:fp32_split`; with one run of
D a block gates its own u1 and u3). It reads the weights as the session holds them: w13's halves are
views, w13 and w2 row-major; nothing is repacked or copied.

`int8_ffn_reference` is the plain version; the wrapper runs it for CPU
tensors only. For a CUDA tensor it launches the route's kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from fish_speech_tpu_torch.ops._kernels import (DTYPE_CODES, check_aligned,
                                                 check_launch, load_kernels,
                                                 scratch, stream_ptr)
from fish_speech_tpu_torch.ops.int8 import fp32_split

MAX_ROWS = 32  # rows of x the kernels take (`models/dual_ar.py:_ffn` keeps more in torch)
ROUTES = ("mma", "cuda_cores", "mma_f16")  # route codes of fs_int8_ffn
# columns of I (phase A) and of D (phase B) an item covers, by route: the
# mma route's phase A item is a 128-column box of q1 and one of q3, its
# phase B item two boxes of q2; the CUDA-core kernel's items are the same
# boxes (each 128 columns, 32 lanes of four, taken by four warps)
ITEM_COLS = {"mma": (128, 256), "cuda_cores": (128, 256), "mma_f16": (128, 256)}
STAGE_ROWS = 64  # weight rows per stage of the mma route (`csrc/int8_ffn.cu`)
STAGE_BYTES = 2 * STAGE_ROWS * 128  # two TMA boxes
ITEM_SUMS = 256  # fp32 sums of an mma item per row of x: u1 | u3 of 128 columns, or 256 of y
BARRIER_BYTES = 32768  # a grid barrier, in the bytes a block streams meanwhile
MAX_SPLIT = 64  # most runs a phase's rows are cut into
_ROUTE_CODES = {r: n for n, r in enumerate(ROUTES)}


@dataclasses.dataclass(frozen=True)
class FfnPlan:
    """One launch's work: phase A's `tiles_a` column tiles of I over D cut
    into `n_a` runs of `run_a` rows ([k run_a, min(D, (k + 1) run_a))),
    phase B's `tiles_b` column tiles of D over I cut into `n_b` runs of
    `run_b`; item k of a phase is tile k % tiles, run k // tiles, walked
    grid-stride by `grid` blocks."""
    tiles_a: int
    n_a: int
    run_a: int
    tiles_b: int
    n_b: int
    run_b: int
    grid: int


def _phase_split(tiles: int, rows: int, b: int, sums: int, n_blocks: int):
    """(n, run): the mma route's cut of a phase's `rows` into runs of whole
    stages with the least modelled cost: the bytes of the busiest block,
    which takes ceil(items / blocks) items, each streaming its run's stages
    of weight and x plus a stage's worth to fill its pipeline and writing
    its fp32 partial (B x 256 sums); then every block's share of the runs'
    partials of the phase's `sums` columns read back, after a grid barrier
    (BARRIER_BYTES). The fewer runs on a tie, at most MAX_SPLIT."""
    stages = -(-rows // STAGE_ROWS)
    best = None
    for per in range(stages, 0, -1):  # stages a run holds
        n = -(-stages // per)
        if n > MAX_SPLIT:
            break
        item = (per + 1) * STAGE_BYTES + 2 * b * per * STAGE_ROWS + 4 * b * ITEM_SUMS
        cost = (-(-n * tiles // n_blocks) * item + -(-4 * n * b * sums // n_blocks)
                + BARRIER_BYTES)
        if best is None or cost < best[0]:
            best = (cost, n, per)
    return best[1], best[2] * STAGE_ROWS


@functools.lru_cache(maxsize=None)
def int8_ffn_plan(route: str, b: int, d: int, i: int, n_blocks: int) -> FfnPlan:
    """The plan of a launch over B rows, D, I on a card that holds
    `n_blocks` blocks at once. "cuda_cores" cuts each phase by
    `ops/int8.py:fp32_split`, aiming at half the blocks the card holds (so
    that every item's block has a neighbour streaming on its SM)."""
    cols_a, cols_b = ITEM_COLS[route]
    tiles_a, tiles_b = -(-i // cols_a), -(-d // cols_b)
    if route == "cuda_cores":
        want = max(1, n_blocks // 2)
        n_a, run_a = fp32_split(tiles_a, d, b, want)
        n_b, run_b = fp32_split(tiles_b, i, b, want)
    else:
        n_a, run_a = _phase_split(tiles_a, d, b, 2 * i, n_blocks)
        n_b, run_b = _phase_split(tiles_b, i, b, d, n_blocks)
    grid = min(n_blocks, max(tiles_a * n_a, tiles_b * n_b))
    return FfnPlan(tiles_a, n_a, run_a, tiles_b, n_b, run_b, grid)


def workspace_floats(plan: FfnPlan, b: int, d: int, i: int, dtype: torch.dtype) -> int:
    """fp32 words of the kernel's workspace: g (B x I in x's dtype, whole
    16-byte words), then phase A's partials (n_a x B x 2I) and phase B's
    (n_b x B x D); a phase of one run leaves its partials unused."""
    esize = torch.tensor([], dtype=dtype).element_size()
    return -(-b * i * esize // 16) * 4 + plan.n_a * b * 2 * i + plan.n_b * b * d


def _halves(w13):
    """(q1, s1, q3, s3) of a fused {"q": (D, 2I), "s": (2I,)} (views of its
    halves) or of a pair (w1, w3)."""
    if isinstance(w13, dict):
        q, s = w13["q"], w13["s"]
        i = q.shape[-1] // 2
        return q[..., :i], s[..., :i], q[..., i:], s[..., i:]
    w1, w3 = w13
    return w1["q"], w1["s"], w3["q"], w3["s"]


def _gate_sums(x, q1, s1, q3, s3):
    """u1, u3 in fp32: x @ float(q) summed in fp32, times the fp32 scales."""
    xf = x.float()
    return (xf @ q1.float()) * s1.float(), (xf @ q3.float()) * s3.float()


def _gate(u1, u3, dtype):
    """g = rn_dtype(u1 * sigmoid(u1) * u3) from fp32 u1, u3."""
    return (u1 * torch.sigmoid(u1) * u3).to(dtype)


def int8_ffn_reference(x, w13, w2):
    """The plain version: u1 and u3 in fp32, the gate rounded once to x's
    dtype, the down product summed in fp32, scaled and rounded once."""
    q1, s1, q3, s3 = _halves(w13)
    g = _gate(*_gate_sums(x, q1, s1, q3, s3), x.dtype)
    return ((g.float() @ w2["q"].float()) * w2["s"].float()).to(x.dtype)


def int8_ffn_partials_reference(x, w13, w2, plan: FfnPlan):
    """Both routes' per-run fp32 partial sums, unscaled: phase A's
    (n_a, B, 2I), u1 | u3 over D's run k, and phase B's (n_b, B, D) over
    I's run k, from the g that phase A's partials give added in run order.
    Returns (part_a, g, part_b); part_b added in run order, times s2 and
    rounded, is y."""
    q1, s1, q3, s3 = _halves(w13)
    xf, q13 = x.float(), torch.cat([q1, q3], dim=-1).float()
    ra, rb = plan.run_a, plan.run_b
    part_a = torch.stack([xf[:, k * ra:(k + 1) * ra] @ q13[k * ra:(k + 1) * ra]
                          for k in range(plan.n_a)])
    u = part_a[0]
    for k in range(1, plan.n_a):  # in run order, as the kernel's blocks add them
        u = u + part_a[k]
    i = q1.shape[-1]
    g = _gate(u[:, :i] * s1.float(), u[:, i:] * s3.float(), x.dtype)
    gf, q2 = g.float(), w2["q"].float()
    part_b = torch.stack([gf[:, k * rb:(k + 1) * rb] @ q2[k * rb:(k + 1) * rb]
                          for k in range(plan.n_b)])
    return part_a, g, part_b


def _route(b: int, dtype: torch.dtype) -> str:
    """Which kernel `int8_ffn` launches for B rows of x in `dtype`."""
    if not 1 <= b <= MAX_ROWS:
        raise ValueError(f"int8_ffn: {b} rows of x; the kernels take 1 to "
                         f"{MAX_ROWS} (`models/dual_ar.py:_ffn` keeps more in torch)")
    routes = {torch.bfloat16: "mma", torch.float16: "mma_f16",
              torch.float32: "cuda_cores"}
    if dtype not in routes:
        raise TypeError(f"int8_ffn: x must be bf16, fp16 or fp32, got {dtype}")
    return routes[dtype]


def _check(x, q1, s1, q3, s3, q2, s2):
    """(B, D, I, row stride of q1 and q3, of q2). Types, shapes and layout
    first, the device last (so the CPU tests reach every check before it)."""
    if (x.dtype not in DTYPE_CODES
            or any(q.dtype != torch.int8 for q in (q1, q3, q2))
            or any(s.dtype != torch.float32 for s in (s1, s3, s2))):
        raise TypeError(f"int8_ffn: x bf16/fp16/fp32, q int8, s fp32; got {x.dtype}/"
                        f"{q1.dtype}, {q3.dtype}, {q2.dtype}/{s1.dtype}, "
                        f"{s3.dtype}, {s2.dtype}")
    if x.dim() != 2 or any(q.dim() != 2 for q in (q1, q3, q2)) or any(
            s.dim() != 1 for s in (s1, s3, s2)):
        raise ValueError("int8_ffn: x (B, D), q1 and q3 (D, I), q2 (I, D), scales 1-D")
    b, d = x.shape
    i = q1.shape[1]
    if (q1.shape != (d, i) or q3.shape != (d, i) or q2.shape != (i, d)
            or s1.shape != (i,) or s3.shape != (i,) or s2.shape != (d,)):
        raise ValueError(f"int8_ffn: shapes x {tuple(x.shape)}, q1 {tuple(q1.shape)}, "
                         f"q3 {tuple(q3.shape)}, q2 {tuple(q2.shape)}, s1 "
                         f"{tuple(s1.shape)}, s3 {tuple(s3.shape)}, s2 "
                         f"{tuple(s2.shape)} disagree")
    route = _route(b, x.dtype)
    if not all(t.is_contiguous() for t in (x, s1, s3, s2)):
        raise ValueError("int8_ffn: x and the scales must be contiguous")
    ld13, ld2 = q1.stride(0), q2.stride(0)
    if (q1.stride(1) != 1 or q3.stride() != q1.stride() or ld13 < i
            or q2.stride(1) != 1 or ld2 < d):
        raise ValueError(f"int8_ffn: q1, q3 and q2 need unit column stride and rows "
                         f"at least a row apart, q1 and q3 alike; strides "
                         f"{q1.stride()}, {q3.stride()}, {q2.stride()}")
    if route != "cuda_cores" and (d % 16 or i % 16 or d < 128 or i < 128
                           or ld13 % 16 or ld2 % 16):
        raise ValueError(f"int8_ffn: the tensor-core route reads whole 128-byte "
                         f"boxes by TMA: D={d} and I={i} must be multiples of 16, "
                         f"at least 128, and the rows 16 bytes apart (strides "
                         f"{ld13}, {ld2})")
    tensors = (q1, s1, q3, s3, q2, s2)
    if not (x.is_cuda and all(t.device == x.device for t in tensors)):
        raise ValueError("int8_ffn: x and the weights must lie on one CUDA device")
    return b, d, i, ld13, ld2


@functools.cache
def resident_blocks(route: str, b: int, device: torch.device) -> int:
    """Blocks of `route`'s kernel the card holds at once at B rows: the
    largest grid the kernel takes (its grid barrier needs all resident)."""
    with torch.cuda.device(device):
        n = ctypes.c_int()
        check_launch(load_kernels().fs_int8_ffn_blocks(_ROUTE_CODES[route], b,
                                                       ctypes.byref(n)),
                     f"int8_ffn ({route}) occupancy")
    if n.value < 1:
        raise RuntimeError(f"int8_ffn ({route}): no block fits on an SM at B={b}")
    return n.value


_PLANS: dict = {}


def _plan(x, q1, s1, q3, s3, q2, s2):
    """What a call of these shapes, strides, dtypes and devices passes the
    kernel beyond its pointers: (route, counter name, D, I, ld13, ld2,
    plan, workspace, the grid barrier's word, dtype code, route code). The
    first call of a key runs every check of `_check` and keeps the plan; a
    later one repeats only contiguity and alignment, which the key does not
    fix."""
    key = (x.shape, q1.shape, q1.stride(), q2.shape, q2.stride(), x.dtype,
           q1.dtype, q3.dtype, q2.dtype, s1.dtype, s3.dtype, s2.dtype,
           *(t.get_device() for t in (x, q1, s1, q3, s3, q2, s2)))
    plan = _PLANS.get(key)
    if plan is None:
        b, d, i, ld13, ld2 = _check(x, q1, s1, q3, s3, q2, s2)
        route = _route(b, x.dtype)
        p = int8_ffn_plan(route, b, d, i, resident_blocks(route, b, x.device))
        work, bar = scratch("int8_ffn", x.device,
                            workspace_floats(p, b, d, i, x.dtype), 1)
        plan = _PLANS[key] = (route, f"launches_{route}", d, i, ld13, ld2, p,
                              work.data_ptr(), bar.data_ptr(),
                              DTYPE_CODES[x.dtype], _ROUTE_CODES[route])
    elif not all(t.is_contiguous() for t in (x, s1, s3, s2)):
        raise ValueError("int8_ffn: x and the scales must be contiguous")
    if plan[0] != "cuda_cores":
        check_aligned("int8_ffn", x=x, q1=q1, q3=q3, q2=q2)
    return plan


def int8_ffn(x, w13, w2):
    """x (B, D) bf16/fp16/fp32, B <= 32, through the int8 SwiGLU FFN of w13 (a
    fused dict or a pair (w1, w3)) and w2 -> (B, D) in x's dtype. On CUDA
    tensors runs the hand-written kernel of `_route(B, x.dtype)`."""
    if not x.is_cuda and x.device.type == "cpu":
        return int8_ffn_reference(x, w13, w2)
    q1, s1, q3, s3 = _halves(w13)
    q2, s2 = w2["q"], w2["s"]
    (route, count, d, i, ld13, ld2, p, work, bar, code,
     route_code) = _plan(x, q1, s1, q3, s3, q2, s2)
    b = x.shape[0]
    out = x.new_empty((b, d))
    rc = load_kernels().fs_int8_ffn(
        x.data_ptr(), q1.data_ptr(), q3.data_ptr(), ld13, s1.data_ptr(),
        s3.data_ptr(), q2.data_ptr(), ld2, s2.data_ptr(), out.data_ptr(), work,
        bar, b, d, i, code, route_code, p.n_a, p.run_a, p.n_b, p.run_b,
        p.grid, stream_ptr(x))
    check_launch(rc, f"int8_ffn ({route})")
    int8_ffn.launches += 1
    setattr(int8_ffn, count, getattr(int8_ffn, count) + 1)
    return out


def reset_launches():
    """Set `int8_ffn`'s launch counts (all routes and each route) to 0."""
    int8_ffn.launches = 0
    for route in ROUTES:
        setattr(int8_ffn, f"launches_{route}", 0)


reset_launches()
