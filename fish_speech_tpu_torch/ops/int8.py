"""int8 weight-only matmul for up to 32 rows: y = rn(x @ q * s).

Port of the Pallas TPU kernels `scripts/microbench/matvec_pallas.py`
(`_kernel` / `pallas_matvec`) and `scripts/microbench/ffn_per_op_pallas.py`
(`_kernel` / `pl_mv`), which compute the same function over a per-channel
int8 weight (`ops/quant.py:quantize_int8`):

  x: (B, I) bf16, fp16 or fp32, B <= 32;  q: (I, O) int8;  s: (O,) fp32
  y[r, o] = rn_dtype(sum_i x[r, i] * float(q[i, o]) * s[o])

summed in fp32, the scale applied in fp32 to the sum, one rounding to x's
dtype (int8 -> bf16 or fp16 is exact). JAX's `mm` rounds twice in x's
dtype (`x @ q` to it, then the product with the scale rounded to it); this
is the Pallas kernels' one rounding, in fp16 too (ROADMAP §3: under
`--half` the two differ by up to an fp16 ulp, and JAX's fp16 `x @ q`
overflows where this fp32 sum does not).

The kernels are hand-written CUDA for Hopper (`csrc/int8_mm.cu`). The
wrapper picks one by x's dtype and rows (`_route`), an explicit dispatch,
not a fallback: "gemv_cluster" for bf16 x of 17-32 rows (the 32-row pool:
a 128-column tile's runs of I are the blocks of one thread block cluster,
`int8_gemv_plan`, their sums added in run order in the cluster's shared
memory), "gemv_mma" for bf16 x of 1-16 rows (the weight streamed by TMA,
mma.sync; runs of I from `int8_gemv_split`, their partials added in run
order in the same launch), "gemv" for fp32 x (the CUDA cores; the small
fp32 models: `int8_gemv_fp32_kernel<NB, kTma>`, NB rows of x in {1, 8,
16, 32}, four columns a lane, W by TMA where its rows lie 16 bytes apart,
runs of I from `fp32_split`, their partials added in run order in the
same launch). fp16 x (`--half` serving) takes the two tensor-core kernels
on fp16 operands, counted as "gemv_cluster_f16" and "gemv_mma_f16". q may
be a view whose rows lie further apart than O bytes (its column stride
must be 1).

`int8_matmul_reference` is the plain version; the wrapper runs it for CPU
tensors only. For a CUDA tensor it launches the route's kernel or raises.
"""

from __future__ import annotations

import functools

import torch

from fish_speech_tpu_torch.ops._kernels import (DTYPE_CODES, check_launch,
                                                 load_kernels, scratch,
                                                 sm_count, stream_ptr)

MAX_ROWS = 32  # rows of x the kernels take (ops/quant.py sends more to torch)
# route codes of fs_int8_matmul: the first two (fp16 x takes "gemv_mma"'s
# code, the kernel picks its form by the dtype); the cluster routes have
# their own entry points, fs_int8_matmul_cluster and _cluster_f16
ROUTES = ("gemv_mma", "gemv", "gemv_cluster", "gemv_mma_f16", "gemv_cluster_f16")
CLUSTER_ROWS = 17  # bf16 rows of x from which the cluster kernel runs
ROUTE_COLS = {"gemv_mma": 128, "gemv": 128, "gemv_mma_f16": 128}  # columns a block
STAGE_ROWS = 128  # rows of q per stage: a run is whole stages
BLOCKS_PER_SM = 2  # blocks the split aims for
MAX_SPLIT = 64  # most runs I is cut into
_ROUTE_CODES = {"gemv_mma": 0, "gemv": 1, "gemv_mma_f16": 0}
TILE_COLS = 128  # "gemv_cluster": output columns of a cluster, one TMA box of q
CLUSTER_STAGE_ROWS = 64  # "gemv_cluster": rows of q per stage, a run is whole stages
CLUSTERS = (1, 2, 4, 8)  # blocks of a cluster (runs of a tile) the kernel takes
# the fp32 kernels of the matvec ("gemv") and of the fused FFN
# ("cuda_cores", ops/int8_ffn.py), csrc/int8_fp32.cuh: runs of whole
# FP32_RUN_ALIGN rows, at most FP32_MAX_RUN[NB] (x of a run stays in shared
# memory once), none shorter than FP32_MIN_RUN unless I is; the matvec aims
# its items at FP32_BLOCKS_PER_SM a streaming multiprocessor
FP32_ROWS = (1, 8, 16, 32)  # the kernels' instantiations: NB rows of x
FP32_RUN_ALIGN = 64
FP32_MIN_RUN = 128
FP32_MAX_RUN = {1: 4096, 8: 1024, 16: 512, 32: 256}
FP32_BLOCKS_PER_SM = 2


@functools.lru_cache(maxsize=None)
def int8_gemv_split(route: str, b: int, i: int, o: int, n_sm: int):
    """(n_split, run): the kernel of `route` cuts I into n_split runs of
    `run` rows, [k * run, min(I, (k + 1) * run)), run a multiple of
    STAGE_ROWS (the last run shorter). The split with the least modelled
    cost, in bytes moved: the weight as the busiest SM streams it (every SM
    taking that many blocks, ceil(blocks / SMs), with ceil(O / cols) blocks
    a run), one stage's worth per block and its x of the run, and the fp32
    partials written and read back where there is more than one run; the
    fewer runs on a tie, at most MAX_SPLIT runs."""
    cols = ROUTE_COLS[route]
    stages = -(-i // STAGE_ROWS)
    tiles = -(-o // cols)
    best = None
    for per in range(stages, 0, -1):  # stages a run holds
        n = -(-stages // per)
        if n > MAX_SPLIT:
            break
        blocks = n * tiles
        cost = (-(-blocks // n_sm) * n_sm * per * STAGE_ROWS * cols
                + blocks * (STAGE_ROWS * cols + b * per * STAGE_ROWS)
                + (8 * n * b * o if n > 1 else 0))
        if best is None or cost < best[0]:
            best = (cost, n, per)
    return best[1], best[2] * STAGE_ROWS


def fp32_rows(b: int) -> int:
    """NB, the rows of x of the fp32 kernels' instantiation that takes B
    rows: B itself at 1, else the next of 8, 16, 32 (the padding rows 0)."""
    return next(n for n in FP32_ROWS if n >= b)


@functools.lru_cache(maxsize=None)
def fp32_split(tiles: int, rows: int, b: int, want: int):
    """(n, run): the fp32 kernels cut `rows` into n runs of `run` rows,
    [k run, min(rows, (k + 1) run)), run a multiple of FP32_RUN_ALIGN and at
    most FP32_MAX_RUN at B rows. With `tiles` column tiles, the runs make
    about `want` items where the tiles alone are fewer: n = ceil(want /
    tiles), but no run shorter than FP32_MIN_RUN (a short run's merge costs
    more than its rows: the tiny model's products are one run), none
    longer than FP32_MAX_RUN, and at most MAX_SPLIT runs."""
    most = FP32_MAX_RUN[fp32_rows(b)]
    n_min = -(-rows // most)
    if n_min > MAX_SPLIT:
        raise ValueError(f"fp32 int8 kernels: {rows} rows at B={b} need {n_min} "
                         f"runs of at most {most}; they take {MAX_SPLIT}")
    n = max(n_min, min(max(1, rows // FP32_MIN_RUN), -(-want // tiles), MAX_SPLIT))
    run = -(-(-(-rows // n)) // FP32_RUN_ALIGN) * FP32_RUN_ALIGN
    return -(-rows // run), run


@functools.lru_cache(maxsize=None)
def int8_gemv_plan(b: int, i: int, o: int, n_sm: int):
    """(cluster, run) of "gemv_cluster": each 128-column tile of O is a
    cluster of `cluster` blocks, block k taking the run of I's rows [k *
    run, min(I, (k + 1) * run)) (run whole stages of CLUSTER_STAGE_ROWS; a
    block whose run starts past I takes none). The largest cluster whose
    blocks stay within three quarters of the SMs (the tiles times the
    cluster size), one block a tile where the tiles alone pass that: on
    the H100 a card that holds more of the kernel's blocks streams the
    weight more slowly, as blocks come to share SMs (PERF.md). `b`
    keys the plan by rows; the rule does not read it."""
    stages = -(-i // CLUSTER_STAGE_ROWS)
    tiles = -(-o // TILE_COLS)
    cluster = max([c for c in CLUSTERS if tiles * c <= 3 * n_sm // 4 and c <= stages],
                  default=1)
    return cluster, -(-stages // cluster) * CLUSTER_STAGE_ROWS


def int8_gemv_cluster_reference(x, q, s, cluster: int, run: int):
    """A plain replay of the "gemv_cluster" kernel's order: in each
    128-column tile, block r of the cluster adds slice r of the tile's
    columns (128 / cluster of them) over the cluster's per-block sums
    (`int8_gemv_partials_reference`) in run order, scales them by s and
    rounds once to x's dtype."""
    parts = int8_gemv_partials_reference(x, q, cluster, run)
    o = q.shape[1]
    y = torch.empty((x.shape[0], o), dtype=torch.float32)
    width = TILE_COLS // cluster
    for tile0 in range(0, o, TILE_COLS):
        for r in range(cluster):
            cols = slice(tile0 + r * width, min(o, tile0 + (r + 1) * width))
            acc = parts[0][:, cols]
            for k in range(1, cluster):
                acc = acc + parts[k][:, cols]
            y[:, cols] = acc * s[cols].float()
    return y.to(x.dtype)


def int8_matmul_reference(x, q, s):
    """The plain version: x @ float(q) in fp32, times the fp32 scale, cast
    once to x's dtype."""
    return ((x.float() @ q.float()) * s.float()).to(x.dtype)


def int8_gemv_partials_reference(x, q, n_split: int, run: int):
    """The kernels' per-run partial sums in fp32, (n_split, B, O), unscaled:
    run k covers rows [k * run, min(I, (k + 1) * run)). Added in run order,
    times s and cast to x's dtype, they give y."""
    xf, qf = x.float(), q.float()
    return torch.stack([xf[:, k * run:(k + 1) * run] @ qf[k * run:(k + 1) * run]
                        for k in range(n_split)])


def _route(b: int, dtype: torch.dtype) -> str:
    """Which kernel `int8_matmul` launches for B rows of x in `dtype`."""
    if not 1 <= b <= MAX_ROWS:
        raise ValueError(f"int8_matmul: {b} rows of x; the kernels take 1 to "
                         f"{MAX_ROWS} (ops/quant.py:mm keeps more in torch)")
    if dtype in (torch.bfloat16, torch.float16):
        route = "gemv_cluster" if b >= CLUSTER_ROWS else "gemv_mma"
        return route + ("_f16" if dtype == torch.float16 else "")
    if dtype == torch.float32:
        return "gemv"
    raise TypeError(f"int8_matmul: x must be bf16, fp16 or fp32, got {dtype}")


def _check(x, q, s):
    """(B, I, O, row stride of q). Types, shapes and layout first, the
    device last (so the CPU tests reach every check before it)."""
    if x.dtype not in DTYPE_CODES or q.dtype != torch.int8 or s.dtype != torch.float32:
        raise TypeError(f"int8_matmul: x bf16/fp16/fp32, q int8, s fp32; got "
                        f"{x.dtype}/{q.dtype}/{s.dtype}")
    if x.dim() != 2 or q.dim() != 2 or s.dim() != 1:
        raise ValueError("int8_matmul: x (B, I), q (I, O), s (O,)")
    b, i = x.shape
    o = q.shape[1]
    if q.shape[0] != i or s.shape[0] != o:
        raise ValueError(f"int8_matmul: shapes x {tuple(x.shape)}, q "
                         f"{tuple(q.shape)}, s {tuple(s.shape)} disagree")
    _route(b, x.dtype)
    if not (x.is_contiguous() and s.is_contiguous()):
        raise ValueError("int8_matmul: x and s must be contiguous")
    if q.stride(1) != 1 or q.stride(0) < o:
        raise ValueError(f"int8_matmul: q needs unit column stride and rows at "
                         f"least O apart; strides {q.stride()}")
    if not (x.is_cuda and q.device == x.device and s.device == x.device):
        raise ValueError("int8_matmul: x, q and s must lie on one CUDA device")
    return b, i, o, q.stride(0)


_PLANS: dict = {}


def _plan(x, q, s):
    """What a call of these shapes, strides, dtypes and devices passes the
    kernel beyond its pointers: (route, counter name, I, O, ldq, n_split
    (the cluster size of "gemv_cluster"), run, workspace, counters, dtype
    code, route code). The first call of a
    key runs every check of `_check` and keeps the plan; a later one
    repeats only contiguity, which the key does not fix."""
    key = (x.shape, q.shape, q.stride(), s.shape, x.dtype, q.dtype, s.dtype,
           x.get_device(), q.get_device(), s.get_device())
    plan = _PLANS.get(key)
    if plan is None:
        b, i, o, ldq = _check(x, q, s)
        route = _route(b, x.dtype)
        cluster = route.startswith("gemv_cluster")
        if cluster:
            n_split, run = int8_gemv_plan(b, i, o, sm_count(x.device))
        elif route == "gemv":
            n_split, run = fp32_split(-(-o // ROUTE_COLS[route]), i, b,
                                      FP32_BLOCKS_PER_SM * sm_count(x.device))
        else:
            n_split, run = int8_gemv_split(route, b, i, o, sm_count(x.device))
        work = counters = 0  # NULL: one run, or the cluster kernel
        if n_split > 1 and not cluster:
            w, c = scratch("int8_gemv", x.device, n_split * b * o,
                           -(-o // ROUTE_COLS[route]))
            work, counters = w.data_ptr(), c.data_ptr()
        plan = _PLANS[key] = (route, f"launches_{route}", i, o, ldq, n_split, run,
                              work, counters, DTYPE_CODES[x.dtype],
                              _ROUTE_CODES.get(route))
    elif not (x.is_contiguous() and s.is_contiguous()):
        raise ValueError("int8_matmul: x and s must be contiguous")
    return plan


def int8_matmul(x, q, s):
    """x (B, I) bf16/fp16/fp32, B <= 32, @ int8 q (I, O) times s (O,) -> (B, O)
    in x's dtype. On CUDA tensors runs the hand-written kernel of
    `_route(B, x.dtype)`."""
    if not x.is_cuda and x.device.type == "cpu":
        return int8_matmul_reference(x, q, s)
    (route, count, i, o, ldq, n_split, run, work, counters, code,
     route_code) = _plan(x, q, s)
    b = x.shape[0]
    out = x.new_empty((b, o))
    if route_code is None:  # the cluster kernel, bf16 or fp16
        lib = load_kernels()
        entry = (lib.fs_int8_matmul_cluster_f16 if route == "gemv_cluster_f16"
                 else lib.fs_int8_matmul_cluster)
        rc = entry(x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), b, i,
                   o, ldq, n_split, run, stream_ptr(x))
    else:
        rc = load_kernels().fs_int8_matmul(
            x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), work, counters,
            b, i, o, ldq, code, route_code, n_split, run, stream_ptr(x))
    check_launch(rc, f"int8_matmul ({route})")
    int8_matmul.launches += 1
    setattr(int8_matmul, count, getattr(int8_matmul, count) + 1)
    return out


def reset_launches():
    """Set `int8_matmul`'s launch counts (all routes and each route) to 0."""
    int8_matmul.launches = 0
    for route in ROUTES:
        setattr(int8_matmul, f"launches_{route}", 0)


reset_launches()
