"""The int8 weight-only matmul (`ops/int8.py`) against the TPU kernels it
ports and the JAX package, on the CPU.

  * `int8_matmul_reference`, the CUDA kernels' plain version, against the
    two Pallas int8 matvec bodies of `scripts/microbench/`
    (`matvec_pallas.py:_kernel`, `ffn_per_op_pallas.py:_kernel`) run in
    interpret mode with the scripts' BlockSpecs (o_tile 512): bf16 outputs
    within one bf16 ulp of the kernel's (both round the fp32 sum times the
    fp32 scale once), fp32 outputs within 1e-5 of (|x| @ |q|) * s (the
    order of the fp32 sums). The scripts run a TPU benchmark when imported,
    so only their kernel and wrapper functions are read (with `ast`) and
    executed.
  * `quant.mm` on int8 weights against JAX's `mm`: up to 32 rows through
    `int8_matmul`, more through torch's cast; fp32 within 1e-5 of
    (|x| @ |q|) * s; bf16 within two bf16 ulps of |y| + 1e-5 (|x| @ |q|) * s:
    JAX's `mm` rounds x @ q, the scale and their product to bf16, and on the
    CPU its bf16 `x @ q` itself sits up to ~1.9 * 2^-9 of the sum off the
    exact sum (XLA's bf16 dot), so it lands up to 2.2 ulps off the exact
    value here, where the kernel route's one rounding stays within half an
    ulp (held too: 2^-8 |y| of the exact value).
  * `int8_gemv_split`'s runs ("gemv_mma") and `fp32_split`'s ("gemv",
    the fp32 kernel's own plan) cover I once within the kernels' limits,
    and the per-run partials added in run order equal the plain version.
  * The cluster kernel's plan (`int8_gemv_plan`, bf16 rows 17-32) covers I
    once within a cluster of 1, 2, 4 or 8 blocks, and a plain replay of the
    cluster's order (block r adds slice r of the tile's columns over the
    cluster's runs, in run order) equals the run-order sum bit for bit in
    fp32 and the plain version within one bf16 ulp.
  * `_route`, `_check` (the device checked last) and the counters; the
    semantic head's int8 rows lie 16 bytes apart (the kernel's TMA needs
    it) with JAX's values; `fp32_scales`.
  * The int8 pool (int8 weights in both stacks, int8 KV cache): the pool
    step over sub-chunks gives JAX's greedy columns, every int8 product of
    the step through `int8_matmul`'s route.
"""

import ast
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from fish_speech_tpu import generate as jgen
from fish_speech_tpu.config import SamplingConfig
from fish_speech_tpu.models import dual_ar as jdual
from fish_speech_tpu.ops import quant as jquant
from fish_speech_tpu_torch import generate as tgen
from fish_speech_tpu_torch.config import SamplingConfig as TSamplingConfig
from fish_speech_tpu_torch.models import dual_ar as tdual
from fish_speech_tpu_torch.ops import int8 as tint8
from fish_speech_tpu_torch.ops import quant as tquant
from fish_speech_tpu_torch.ops.int8 import (_check, _route, int8_gemv_cluster_reference,
                                            int8_gemv_partials_reference, int8_gemv_plan,
                                            int8_gemv_split, int8_matmul,
                                            int8_matmul_reference)

from tests.test_torch_batch_step import P, _cache_close, _pool
from tests.test_torch_graph_step import CHUNKS
from tests.test_torch_kv8 import _cfgs, _quantized

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
SCRIPTS = {"matvec_pallas": ("scripts/microbench/matvec_pallas.py", "pallas_matvec"),
           "ffn_per_op_pallas": ("scripts/microbench/ffn_per_op_pallas.py", "pl_mv")}
# s2-pro's int8 products (I, O), w13 fused, and the three heads
MODEL_SHAPES = [(2560, 6144), (4096, 2560), (2560, 19456), (9728, 2560),
                (1536, 2560), (1536, 1536), (1536, 12288), (6144, 1536),
                (2560, 155136), (2560, 4097), (1536, 4096)]


@functools.lru_cache(maxsize=None)
def _script(name):
    """The script's `_kernel` and its wrapper, read from the source and
    executed alone, `interpret=True` added to the wrapper's `pallas_call`."""
    path, wrapper = SCRIPTS[name]
    tree = ast.parse((ROOT / path).read_text())

    class Interpret(ast.NodeTransformer):
        def visit_Call(self, node):
            self.generic_visit(node)
            if isinstance(node.func, ast.Attribute) and node.func.attr == "pallas_call":
                node.keywords.append(ast.keyword(arg="interpret",
                                                 value=ast.Constant(True)))
            return node

    body = [Interpret().visit(n) for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name in ("_kernel", wrapper)]
    assert len(body) == 2, name
    ns = dict(jax=jax, jnp=jnp, pl=pl, pltpu=pltpu, functools=functools)
    exec(compile(ast.fix_missing_locations(ast.Module(body=body, type_ignores=[])),
                 path, "exec"), ns)
    return ns["_kernel"], ns[wrapper]


def _pallas_fp32(kernel, x, q, s, o_tile=512):
    """The scripts' grid and BlockSpecs around `kernel`, with an fp32
    output (the scripts' wrappers fix bf16)."""
    d, o = q.shape
    m = x.shape[0]
    return pl.pallas_call(
        kernel, grid=(o // o_tile,),
        in_specs=[
            pl.BlockSpec((m, d), lambda j: (0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((d, o_tile), lambda j: (0, j), memory_space=pltpu.VMEM),
            pl.BlockSpec((1, o_tile), lambda j: (0, j), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((m, o_tile), lambda j: (0, j),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((m, o), jnp.float32), interpret=True,
    )(x, q, s)


def _inputs(m, i, o, seed):
    """x (m, i) N(0,1) fp32, q (i, o) int8, s (o,) fp32 as the quantizer
    makes them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, i)).astype(np.float32)
    qw = tquant.quantize_int8(torch.from_numpy(
        (rng.standard_normal((i, o)) * 0.02).astype(np.float32)))
    return x, qw["q"].numpy(), qw["s"].numpy()


def _scale(x, q, s):
    """(|x| @ |q|) * s in fp64: the size of the sum each output comes from."""
    return (np.abs(np.asarray(x, np.float64)) @ np.abs(q.astype(np.float64))) * s


def _bf16_ulp(y):
    """One bf16 ulp at |y| (2^(e - 7) for |y| in [2^e, 2^(e+1)))."""
    e = np.floor(np.log2(np.maximum(np.abs(y), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m,i,o", [(1, 256, 1024), (3, 256, 1024),
                                   (8, 384, 512), (32, 640, 1536)])
@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_plain_matches_the_pallas_matvec_kernels(script, m, i, o, dtype):
    kernel, wrapper = _script(script)
    x, q, s = _inputs(m, i, o, seed=m + i + o)
    if dtype == "bfloat16":
        xt = _bf16(x)
        got = int8_matmul_reference(xt, torch.from_numpy(q), torch.from_numpy(s))
        assert got.dtype == torch.bfloat16
        got = got.float().numpy()
        want = np.asarray(wrapper(jnp.asarray(xt.float().numpy(), jnp.bfloat16),
                                  jnp.asarray(q), jnp.asarray(s[None]),
                                  o_tile=512).astype(jnp.float32))
        assert (np.abs(got - want) <= _bf16_ulp(want)).all()
    else:
        got = int8_matmul_reference(torch.from_numpy(x), torch.from_numpy(q),
                                    torch.from_numpy(s)).numpy()
        want = np.asarray(_pallas_fp32(kernel, jnp.asarray(x), jnp.asarray(q),
                                       jnp.asarray(s[None])))
        assert (np.abs(got - want) <= 1e-5 * _scale(x, q, s) + 1e-7).all()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("lead", [(1,), (3,), (2, 1, 16), (33,), (2, 40)])
def test_mm_int8_routes_match_jax_mm(lead, dtype):
    rows = int(np.prod(lead))
    x, _, _ = _inputs(rows, 256, 200, seed=rows)
    x = x.reshape(*lead, 256)
    w = (np.random.default_rng(9).standard_normal((256, 200)) * 0.02).astype(np.float32)
    tw = tquant.quantize_int8(torch.from_numpy(w))
    jw = jquant.quantize_int8(jnp.asarray(w))
    np.testing.assert_array_equal(tw["q"].numpy(), np.asarray(jw["q"]))
    xt = torch.from_numpy(x) if dtype == "float32" else _bf16(x)
    before = (tquant.mm.launches_int8_matmul, tquant.mm.launches_int8_cast)
    got = tquant.mm(xt, tw)
    kernel_route = rows <= tint8.MAX_ROWS
    assert (tquant.mm.launches_int8_matmul - before[0],
            tquant.mm.launches_int8_cast - before[1]) == (int(kernel_route),
                                                          int(not kernel_route))
    assert got.shape == (*lead, 200) and got.dtype == xt.dtype
    want = np.asarray(jquant.mm(jnp.asarray(xt.float().numpy(), getattr(jnp, dtype)),
                                jw).astype(jnp.float32))
    got = got.float().numpy()
    scale = _scale(xt.float().numpy().reshape(rows, 256), tw["q"].numpy(),
                   tw["s"].numpy()).reshape(*lead, 200)
    if dtype == "float32":
        assert (np.abs(got - want) <= 1e-5 * scale + 1e-7).all()
    else:
        assert (np.abs(got - want) <= 2 * _bf16_ulp(want) + 1e-5 * scale).all()
    if kernel_route:  # the kernel's plain version, to the bit: one rounding
        np.testing.assert_array_equal(got, int8_matmul_reference(
            xt.reshape(rows, 256), tw["q"], tw["s"]).float().numpy().reshape(got.shape))
        exact = int8_matmul_reference(xt.float().reshape(rows, 256), tw["q"],
                                      tw["s"]).numpy().reshape(got.shape)
        assert (np.abs(got - exact) <= 2.0 ** -8 * np.abs(exact) + 1e-5 * scale).all()


def _split_cost(route, b, i, o, n_sm, n, run):
    """`int8_gemv_split`'s model of a split's bytes, written out again."""
    cols = tint8.ROUTE_COLS[route]
    blocks = n * -(-o // cols)
    return (-(-blocks // n_sm) * n_sm * run * cols
            + blocks * (tint8.STAGE_ROWS * cols + b * run)
            + (8 * n * b * o if n > 1 else 0))


def _fp32_plan(b, i, o, n_sm):
    """The fp32 route's ("gemv") split, as `ops/int8.py:_plan` asks it."""
    return tint8.fp32_split(-(-o // tint8.ROUTE_COLS["gemv"]), i, b,
                            tint8.FP32_BLOCKS_PER_SM * n_sm)


@pytest.mark.parametrize("route", ["gemv_mma", "gemv"])
@pytest.mark.parametrize("i,o", MODEL_SHAPES + [(1000, 72), (100, 40), (130, 4097)])
def test_gemv_split_runs_cover_I_once(route, i, o):
    stages = -(-i // tint8.STAGE_ROWS)
    for b in (1, 4, 16, 32):
        for n_sm in (132, 8):
            if route == "gemv":  # the fp32 kernel's own plan
                n_split, run = _fp32_plan(b, i, o, n_sm)
                assert run % tint8.FP32_RUN_ALIGN == 0 and 1 <= n_split <= tint8.MAX_SPLIT
                assert run <= tint8.FP32_MAX_RUN[tint8.fp32_rows(b)]
                assert (n_split - 1) * run < i <= n_split * run
                # more runs than x's room asks only where O's tiles leave the
                # SMs short, and none shorter than FP32_MIN_RUN
                tiles = -(-o // tint8.ROUTE_COLS["gemv"])
                n_min = -(-i // tint8.FP32_MAX_RUN[tint8.fp32_rows(b)])
                want = -(-tint8.FP32_BLOCKS_PER_SM * n_sm // tiles)
                assert n_split <= max(n_min, min(want, max(1, i // tint8.FP32_MIN_RUN)))
                continue
            n_split, run = int8_gemv_split(route, b, i, o, n_sm)
            assert run % tint8.STAGE_ROWS == 0 and 1 <= n_split <= tint8.MAX_SPLIT
            # runs [k * run, min(I, (k + 1) * run)): every row once, none empty
            assert (n_split - 1) * run < i <= n_split * run
            # no other run length of whole stages that fits costs less
            cost = _split_cost(route, b, i, o, n_sm, n_split, run)
            for per in range(1, stages + 1):
                other = per * tint8.STAGE_ROWS
                n = -(-stages // per)
                if n <= tint8.MAX_SPLIT:
                    assert cost <= _split_cost(route, b, i, o, n_sm, n, other)


def test_gemv_split_shapes_of_the_serving_path():
    """The splits the card runs at s2-pro's shapes on 132 SMs."""
    split = functools.partial(int8_gemv_split, n_sm=132)
    assert split("gemv_mma", 1, 2560, 155136) == (1, 2560)  # the LM head: no split
    assert split("gemv_mma", 1, 1536, 1536) == (6, 256)     # fast wo: 72 blocks
    assert split("gemv_mma", 1, 2560, 6144) == (5, 512)     # slow wqkv: 240 blocks
    assert split("gemv_mma", 32, 2560, 155136) == (1, 2560)  # 32 rows: no split either
    # the fp32 kernel at the tiny model's shapes: one run, no merge
    assert _fp32_plan(1, 64, 320, 132) == (1, 64)
    assert _fp32_plan(4, 128, 64, 132) == (1, 128)
    assert _fp32_plan(1, 2560, 19456, 132) == (2, 1280)  # 152 tiles: 2 runs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,i,o", [(1, 2560, 200), (5, 1000, 72), (32, 4096, 130),
                                   (2, 300, 4097)])
def test_partials_added_in_run_order_equal_the_plain_version(b, i, o, dtype):
    x, q, s = _inputs(b, i, o, seed=b * i)
    xt = torch.from_numpy(x).to(dtype)
    qt, st = torch.from_numpy(q), torch.from_numpy(s)
    if dtype == torch.bfloat16:  # the split routes
        n_split, run = int8_gemv_split("gemv_mma", b, i, o, 132)
    else:
        n_split, run = _fp32_plan(b, i, o, 132)
    assert n_split > 1  # few column tiles: the split covers the card
    parts = int8_gemv_partials_reference(xt, qt, n_split, run)
    assert parts.shape == (n_split, b, o) and parts.dtype == torch.float32
    acc = parts[0]
    for k in range(1, n_split):  # in run order, as the kernels' last block
        acc = acc + parts[k]
    got = (acc * st).to(dtype).float().numpy()
    exact = int8_matmul_reference(xt.float(), qt, st).numpy()  # fp32, not rounded
    scale = _scale(xt.float().numpy(), q, s)
    if dtype == torch.float32:
        assert (np.abs(got - exact) <= 1e-5 * scale + 1e-7).all()
    else:  # one rounding of y, and the order of the fp32 sums
        assert (np.abs(got - exact) <= 2.0 ** -8 * np.abs(exact) + 1e-5 * scale).all()


@pytest.mark.parametrize("i,o", MODEL_SHAPES + [(1000, 72), (100, 40), (130, 4097)])
def test_cluster_plan_covers_I_once(i, o):
    stages = -(-i // tint8.CLUSTER_STAGE_ROWS)
    tiles = -(-o // tint8.TILE_COLS)
    for b in (17, 24, 32):
        for n_sm in (132, 8):
            cluster, run = int8_gemv_plan(b, i, o, n_sm)
            assert cluster in tint8.CLUSTERS and run % tint8.CLUSTER_STAGE_ROWS == 0
            # runs [k run, min(I, (k + 1) run)), k < cluster: every row once,
            # the rows' runs at most the cluster's blocks
            n_runs = -(-i // run)
            assert (n_runs - 1) * run < i <= n_runs * run and n_runs <= cluster
            assert run == -(-stages // cluster) * tint8.CLUSTER_STAGE_ROWS
            # the largest cluster within three quarters of the SMs, else 1
            fits = [c for c in tint8.CLUSTERS if tiles * c <= 3 * n_sm // 4 and c <= stages]
            assert cluster == max(fits, default=1)


def test_cluster_plan_of_the_serving_shapes():
    """The plans the card runs at s2-pro's shapes at 32 rows on 132 SMs:
    the tile count times the cluster size kept within 99 blocks (a block
    an SM over three quarters of the card), the full LM head's 1212 tiles
    one block each."""
    plan = functools.partial(int8_gemv_plan, 32, n_sm=132)
    assert plan(2560, 155136) == (1, 2560)  # the LM head
    assert plan(2560, 6144) == (2, 1280)    # slow wqkv: 48 tiles, 96 blocks
    assert plan(4096, 2560) == (4, 1024)    # slow wo: 20 tiles, 80 blocks
    assert plan(1536, 2560) == (4, 384)     # fast wqkv: 20 tiles
    assert plan(1536, 1536) == (8, 192)     # fast wo: 12 tiles, 96 blocks
    assert plan(2560, 4097) == (2, 1280)    # the semantic head: 33 tiles
    assert plan(1536, 4096) == (2, 768)     # the fast head: 32 tiles


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 5, 27, 32])
def test_cluster_order_replay_equals_the_plain_version(b, dtype):
    """Block r of a tile's cluster adds slice r of the tile's columns over
    the cluster's runs in run order: in fp32 that is the run-order sum of
    the per-block sums bit for bit (the slices change no order), within
    1e-5 of (|x| @ |q|) * s of the exact product; in bf16 within one ulp of
    the plain version (each rounds an fp32 sum of its own order once). A
    ragged O (the last tile's slices part past O), a run past I, and every
    cluster size the kernel takes."""
    i, o = 1000, 300
    x, q, s = _inputs(b, i, o, seed=b + 7)
    xt = torch.from_numpy(x).to(dtype)
    qt, st = torch.from_numpy(q), torch.from_numpy(s)
    stages = -(-i // tint8.CLUSTER_STAGE_ROWS)
    for cluster in tint8.CLUSTERS:
        run = -(-stages // cluster) * tint8.CLUSTER_STAGE_ROWS
        got = int8_gemv_cluster_reference(xt, qt, st, cluster, run)
        assert got.shape == (b, o) and got.dtype == dtype
        if dtype == torch.float32:
            parts = int8_gemv_partials_reference(xt, qt, cluster, run)
            acc = parts[0]
            for k in range(1, cluster):
                acc = acc + parts[k]
            assert torch.equal(got, acc * st)
            exact = int8_matmul_reference(xt.double(), qt, st).numpy()
            assert (np.abs(got.numpy() - exact) <= 1e-5 * _scale(x, q, s) + 1e-7).all()
        else:
            want = int8_matmul_reference(xt, qt, st).float().numpy()
            diff = np.abs(got.float().numpy() - want)
            assert (diff <= _bf16_ulp(want)).all(), (cluster, diff.max())


def test_route_by_rows_and_dtype():
    for b in (1, 8, 9, 16, 17, 32):
        # bf16: the cluster kernel from 17 rows; fp32: the CUDA cores
        assert _route(b, torch.bfloat16) == ("gemv_cluster" if b >= 17 else "gemv_mma")
        assert _route(b, torch.float32) == "gemv"
    for b in (0, 33, 1024):
        with pytest.raises(ValueError, match="rows"):
            _route(b, torch.bfloat16)
    with pytest.raises(TypeError):  # fp16 takes the kernels' fp16 forms
        _route(1, torch.float64)


def test_check_refuses_what_the_kernels_do_not_take_device_last():
    """On CPU tensors every check but the device's is reached first."""
    x = torch.zeros(2, 64)
    q = torch.zeros(64, 48, dtype=torch.int8)
    s = torch.ones(48)
    for args, err in [
            ((x.double(), q, s), TypeError),
            ((x, q.to(torch.uint8), s), TypeError),
            ((x, q, s.to(torch.bfloat16)), TypeError),
            ((x[None], q, s), ValueError),
            ((x, q, s[None]), ValueError),
            ((torch.zeros(2, 65), q, s), ValueError),
            ((x, q, torch.ones(47)), ValueError),
            ((torch.zeros(33, 64), q, s), ValueError),
            ((torch.zeros(64, 2).T, q, s), ValueError),
            ((x, torch.zeros(48, 64, dtype=torch.int8).T, s), ValueError),
            ((x, q, torch.ones(96)[::2]), ValueError)]:
        with pytest.raises(err):
            _check(*args)
    with pytest.raises(ValueError, match="CUDA"):
        _check(x, q, s)
    # a view whose rows lie further apart than O bytes is taken
    with pytest.raises(ValueError, match="CUDA"):
        _check(x, torch.zeros(64, 64, dtype=torch.int8)[:, :48], s)


def test_cpu_calls_take_the_plain_version_and_count_no_launch():
    x, q, s = _inputs(3, 256, 200, seed=1)
    args = (_bf16(x), torch.from_numpy(q), torch.from_numpy(s))
    n0 = (int8_matmul.launches, int8_matmul.launches_gemv_mma,
          int8_matmul.launches_gemv)
    assert torch.equal(int8_matmul(*args), int8_matmul_reference(*args))
    assert (int8_matmul.launches, int8_matmul.launches_gemv_mma,
            int8_matmul.launches_gemv) == n0
    int8_matmul.launches = int8_matmul.launches_gemv = 5
    tint8.reset_launches()
    assert int8_matmul.launches == int8_matmul.launches_gemv_mma == \
        int8_matmul.launches_gemv == 0
    tquant.mm.launches_int8_cast = 3
    tquant.reset_launches()
    assert tquant.mm.launches_int8_matmul == tquant.mm.launches_int8_cast == 0


def test_semantic_head_rows_lie_16_bytes_apart(tokenizer):
    jcfg, cfg = _cfgs(tokenizer)
    jq, tq = _quantized(jcfg, "int8", None, seed=4)
    jh = jdual.precompute_semantic_head(jq, jcfg)["_semantic_head"]
    th = tdual.precompute_semantic_head(tq, cfg)["_semantic_head"]
    q = th["q"]
    n = cfg.semantic_end_id - cfg.semantic_begin_id + 2
    assert q.shape == (cfg.dim, n) and n % 16  # S + 1 columns
    assert q.stride() == (n + (-n % 16), 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jh["q"]))
    np.testing.assert_array_equal(th["s"].numpy(), np.asarray(jh["s"]))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((3, cfg.dim))
                         .astype(np.float32))
    got = tdual.semantic_head_logits(dict(tq, _semantic_head=th), cfg, x)
    want = tdual.semantic_head_logits(
        dict(tq, _semantic_head={"q": q.contiguous(), "s": th["s"]}), cfg, x)
    assert torch.equal(got, want)


def test_fp32_scales_casts_only_the_scales():
    q = torch.ones(4, 8, dtype=torch.int8)
    p = torch.ones(2, 8, dtype=torch.uint8)
    emb = torch.ones(3, 4, dtype=torch.bfloat16)
    tree = {"embeddings": emb,
            "layers": {"wqkv": {"q": q, "s": torch.ones(8, dtype=torch.bfloat16)},
                       "w2": {"p": p, "gs": torch.ones(1, 8, dtype=torch.bfloat16)}},
            "norm": [torch.ones(4, dtype=torch.bfloat16)]}
    out = tquant.fp32_scales(tree)
    assert out["layers"]["wqkv"]["s"].dtype == torch.float32
    assert out["layers"]["w2"]["gs"].dtype == torch.float32
    assert out["layers"]["wqkv"]["q"] is q and out["layers"]["w2"]["p"] is p
    assert out["embeddings"] is emb and out["norm"][0].dtype == torch.bfloat16
    fp32 = torch.ones(8)
    assert tquant.fp32_scales({"q": q, "s": fp32})["s"] is fp32


def test_int8_pool_step_greedy_columns_match_jax(tokenizer):
    """The int8 pool: int8 weights in both stacks and heads, the int8 KV
    cache, P rows at ragged positions (one inactive), driven over
    sub-chunks; every int8 product goes through `int8_matmul`'s route."""
    jcfg, cfg = _cfgs(tokenizer)
    jp, tp = _quantized(jcfg, "int8", None, seed=6)
    jp = jdual.fuse_ffn_weights(jdual.precompute_semantic_head(jp, jcfg))
    tp = tquant.fp32_scales(tdual.fuse_ffn_weights(tdual.precompute_semantic_head(tp, cfg)))
    assert "q" in tp["fast"]["layers"]["w13"] and "q" in tp["layers"]["w13"]
    sampling = (0.7, 0.9, 1)
    st, jc, _ = _pool(cfg, True, seed=3, sampling=sampling)
    scfg = TSamplingConfig()
    tquant.reset_launches()
    got, want = [], []
    for n in CHUNKS:
        st.step.zero_()
        for _ in range(n):
            tgen.pool_decode_step(tp, cfg, scfg, st)
        got.append(st.cols[:n].clone().numpy())
        cols, jc["token"], jc["cache"], jc["pos"], jc["window"], jc["keys"], \
            jc["active"] = jgen.decode_chunk_multi(
                jp, jcfg, SamplingConfig(), n, jc["token"], jc["cache"],
                jc["pos"], jc["window"], jc["keys"], jc["active"],
                jnp.full((P,), sampling[0], jnp.float32),
                jnp.full((P,), sampling[1], jnp.float32),
                jnp.full((P,), sampling[2], jnp.int32))
        want.append(np.asarray(cols))
    np.testing.assert_array_equal(np.concatenate(got), np.concatenate(want))
    np.testing.assert_array_equal(st.pos.numpy(), np.asarray(jc["pos"]))
    _cache_close(st.cache, jc["cache"], True)
    assert tquant.mm.launches_int8_matmul > 0 and tquant.mm.launches_int8_cast == 0


def test_prefill_sends_its_head_to_the_kernel_route_and_its_layers_to_torch(tokenizer):
    """A prefill over 64 positions: the layer products (64 rows) keep
    torch's cast, the LM head (one row per prompt) takes `int8_matmul`."""
    jcfg, cfg = _cfgs(tokenizer)
    _, tq = _quantized(jcfg, "int8", None, seed=2)
    inp = torch.zeros((2, cfg.num_codebooks + 1, 64), dtype=torch.int32)
    cache = tdual.init_kv_cache(cfg, 2, 80, torch.float32, "cpu", quant=True)
    tquant.reset_launches()
    tdual.prefill(tq, cfg, inp, cache, torch.zeros(2, dtype=torch.int32), 60)
    # per slow layer: wqkv, wo, w1, w3, w2 over 128 rows; the head over 2
    assert tquant.mm.launches_int8_cast == 5 * cfg.n_layer
    assert tquant.mm.launches_int8_matmul == 1
