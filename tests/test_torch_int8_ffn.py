"""The fused int8 SwiGLU FFN (`ops/int8_ffn.py`) against the TPU kernel it
ports and the JAX package, on the CPU.

  * `int8_ffn_reference`, the CUDA kernels' plain version, against the
    Pallas kernel `scripts/microbench/ffn_fused_packed.py:_ffn_kernel` run
    in interpret mode through its own `ffn_fused` over weights packed by its
    own `pack` (chunk C 128 and 256), at B in {1, 4, 32}, D 256, I 512. The
    script runs a TPU benchmark when imported, so only those three
    functions are read (with `ast`) and executed, with `interpret=True`
    added to the `pallas_call` and the kernel's `jnp.bfloat16` read as x's
    dtype: for bf16 x that is the script's kernel, for fp32 x the same
    kernel without rounding g to bf16 (the plain version's fp32 function).
    bf16 within 2 bf16 ulps of max |y| (measured 0: the same bits at max
    |y|; the gate's sigmoid in another library may move a rounding of g);
    fp32 within 1e-5 of max |y| (measured 9.1e-7).
  * The plain version against JAX's `_ffn` on a `fuse_ffn_weights` int8
    tree: fp32 within 1e-5 of max |y| (measured 7.1e-7); bf16 within 4
    bf16 ulps of max |y| (JAX's `mm` rounds x @ q, the scale and their
    product to bf16 and its bf16 dot on the CPU is inexact, then the gate
    rounds in bf16 twice; the plain version rounds g and y once each:
    measured 1 ulp).
  * The w13 form equals the (w1, w3) form.
  * The mma route's plan (`int8_ffn_plan`): column tiles cover I and D
    once, runs of whole stages cover D and I once, the grid fits the card;
    the per-run partials added in run order (phase A to g, phase B to y),
    as the kernel's blocks add them, equal the plain version.
  * `_route`, `_check` (the device checked last) and the counters.
  * The choice in `models/dual_ar.py:_ffn`: an int8 FFN of 1-32 rows
    without LoRA takes `int8_ffn` (its w13 and w2 leave `mm`); 33 rows,
    int4, bf16 and a LoRA layer do not; a layer with bf16 scales hands
    the kernel fp32 ones.
  * A `mixed` + int8-KV session and the int8 pool step give JAX's greedy
    columns with every slow (and, in the pool, fast) FFN through
    `int8_ffn`.
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
from fish_speech_tpu_torch import generate as tgen
from fish_speech_tpu_torch.config import SamplingConfig as TSamplingConfig
from fish_speech_tpu_torch.models import dual_ar as tdual
from fish_speech_tpu_torch.ops import int8 as tint8
from fish_speech_tpu_torch.ops import int8_ffn as tffn
from fish_speech_tpu_torch.ops import quant as tquant
from fish_speech_tpu_torch.ops.int8_ffn import (_check, _route, int8_ffn,
                                                int8_ffn_partials_reference,
                                                int8_ffn_plan, int8_ffn_reference,
                                                workspace_floats)

from tests.test_torch_batch_step import P, _pool
from tests.test_torch_graph_step import CHUNKS
from tests.test_torch_int8 import _bf16_ulp
from tests.test_torch_kv8 import _cfgs, _prompt, _quantized

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
SCRIPT = "scripts/microbench/ffn_fused_packed.py"
# s2-pro's FFNs (D, I): the slow and the fast stack; the card tests' small
# model; a ragged one
FFN_SHAPES = [(2560, 9728), (1536, 6144), (256, 512), (128, 400), (1000, 136)]


@functools.lru_cache(maxsize=None)
def _script():
    """The script's `_ffn_kernel`, `ffn_fused` and `pack`, read from the
    source and executed alone: `interpret=True` added to `pallas_call`,
    and the kernel's `jnp.bfloat16` read as the dtype of its x."""
    tree = ast.parse((ROOT / SCRIPT).read_text())

    class Interpret(ast.NodeTransformer):
        def visit_Call(self, node):
            self.generic_visit(node)
            if isinstance(node.func, ast.Attribute) and node.func.attr == "pallas_call":
                node.keywords.append(ast.keyword(arg="interpret",
                                                 value=ast.Constant(True)))
            return node

    class XDtype(ast.NodeTransformer):
        def visit_Attribute(self, node):
            if (isinstance(node.value, ast.Name) and node.value.id == "jnp"
                    and node.attr == "bfloat16"):
                return ast.Attribute(value=ast.Name(id="x", ctx=ast.Load()),
                                     attr="dtype", ctx=ast.Load())
            return self.generic_visit(node)

    body = []
    for n in tree.body:
        if isinstance(n, ast.FunctionDef) and n.name in ("_ffn_kernel", "ffn_fused", "pack"):
            body.append(XDtype().visit(n) if n.name == "_ffn_kernel" else Interpret().visit(n))
    assert [n.name for n in body] == ["_ffn_kernel", "ffn_fused", "pack"]
    ns = dict(jax=jax, jnp=jnp, pl=pl, pltpu=pltpu, functools=functools)
    exec(compile(ast.fix_missing_locations(ast.Module(body=body, type_ignores=[])),
                 SCRIPT, "exec"), ns)
    return ns["ffn_fused"], ns["pack"]


def _weights(d, i, seed):
    """w1, w3 (D, I) and w2 (I, D) quantized by the port's `quantize_int8`
    from N(0, 0.02) weights: {"q": int8, "s": fp32}."""
    rng = np.random.default_rng(seed)
    return [tquant.quantize_int8(torch.from_numpy(
        (rng.standard_normal(shape) * 0.02).astype(np.float32)))
        for shape in ((d, i), (d, i), (i, d))]


def _fused(w1, w3):
    return {k: torch.cat([w1[k], w3[k]], dim=-1) for k in ("q", "s")}


def _x(b, d, seed, dtype):
    x = np.random.default_rng(seed).standard_normal((b, d)).astype(np.float32)
    return torch.from_numpy(x).to(dtype)


def _f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def _max_ulps(got, want):
    """|got - want| in bf16 ulps of max |want|."""
    got, want = _f32(got), _f32(want)
    return float(np.abs(got - want).max() / _bf16_ulp(np.abs(want).max()))


def _rel(got, want):
    got, want = _f32(got), _f32(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c", [128, 256])
@pytest.mark.parametrize("b", [1, 4, 32])
def test_plain_matches_the_pallas_ffn_kernel(b, c, dtype):
    ffn_fused, pack = _script()
    d, i = 256, 512
    w1, w3, w2 = _weights(d, i, seed=b + c)
    x = _x(b, d, seed=b * c, dtype=dtype)
    got = int8_ffn_reference(x, _fused(w1, w3), w2)
    assert got.shape == (b, d) and got.dtype == dtype
    stack = {name: {"q": jnp.asarray(w["q"].numpy()[None]),
                    "s": jnp.asarray(w["s"].numpy()[None, None])}
             for name, w in (("w1", w1), ("w3", w3), ("w2", w2))}
    p = jax.tree.map(lambda a: a[0], pack(stack, c))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = ffn_fused(jnp.asarray(x.float().numpy(), jdt), p["w1p"], p["s1"],
                     p["w3p"], p["s3"], p["w2p"], p["s2"])
    assert want.dtype == jdt
    want = np.asarray(want.astype(jnp.float32))
    if dtype == torch.bfloat16:
        assert _max_ulps(got, want) <= 2
    else:
        assert _rel(got, want) <= 1e-5


def _jax_ffn_layer(w1, w3, w2):
    """The same integers and scales as JAX's layer after `fuse_ffn_weights`."""
    layers = {name: {"q": jnp.asarray(w["q"].numpy()[None]),
                     "s": jnp.asarray(w["s"].numpy()[None])}
              for name, w in (("w1", w1), ("w3", w3), ("w2", w2))}
    fused = jdual.fuse_ffn_weights({"layers": layers, "fast": {"layers": {}}})
    return jax.tree.map(lambda a: a[0], fused["layers"])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b", [1, 5, 32])
def test_plain_and_the_model_route_match_jax_ffn(b, dtype):
    d, i = 128, 384
    w1, w3, w2 = _weights(d, i, seed=b)
    jl = _jax_ffn_layer(w1, w3, w2)
    assert set(jl) == {"w13", "w2"}
    x = _x(b, d, seed=7 * b, dtype=dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    spec = (1, 1, 16, 1e-5, 1.0)
    want = np.asarray(jdual._ffn(jl, spec, jnp.asarray(x.float().numpy(), jdt)[:, None])
                      .astype(jnp.float32))[:, 0]
    lp = {"w13": _fused(w1, w3), "w2": w2}
    got = int8_ffn_reference(x, lp["w13"], w2)
    routed = tdual._ffn(lp, spec, x[:, None])  # B rows of one position
    assert routed.shape == (b, 1, d) and torch.equal(routed[:, 0], got)
    if dtype == torch.bfloat16:
        assert _max_ulps(got, want) <= 4
    else:
        assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_w13_form_equals_the_w1_w3_form(dtype):
    w1, w3, w2 = _weights(128, 256, seed=3)
    x = _x(6, 128, seed=4, dtype=dtype)
    fused = int8_ffn_reference(x, _fused(w1, w3), w2)
    assert torch.equal(fused, int8_ffn_reference(x, (w1, w3), w2))
    assert torch.equal(tdual._ffn({"w13": _fused(w1, w3), "w2": w2}, (0,) * 5, x),
                       tdual._ffn({"w1": w1, "w3": w3, "w2": w2}, (0,) * 5, x))


@pytest.mark.parametrize("route", tffn.ROUTES)
@pytest.mark.parametrize("d,i", FFN_SHAPES)
def test_plan_covers_every_column_and_row_once(route, d, i):
    cols_a, cols_b = tffn.ITEM_COLS[route]
    for b in (1, 4, 16, 32):
        for n_blocks in (132, 264, 8):
            p = int8_ffn_plan(route, b, d, i, n_blocks)
            # column tiles: [cols t, cols (t + 1)) covers I (phase A), D (B)
            assert (p.tiles_a - 1) * cols_a < i <= p.tiles_a * cols_a
            assert (p.tiles_b - 1) * cols_b < d <= p.tiles_b * cols_b
            # runs [k run, min(rows, (k + 1) run)): every row once, none empty
            assert (p.n_a - 1) * p.run_a < d <= p.n_a * p.run_a
            assert (p.n_b - 1) * p.run_b < i <= p.n_b * p.run_b
            if route != "cuda_cores":  # "mma" and "mma_f16"
                assert p.run_a % tffn.STAGE_ROWS == 0 and p.run_b % tffn.STAGE_ROWS == 0
                assert p.n_a <= tffn.MAX_SPLIT and p.n_b <= tffn.MAX_SPLIT
            else:  # the fp32 kernel's own plan: whole 64 rows, x of a run fits
                most = tint8.FP32_MAX_RUN[tint8.fp32_rows(b)]
                for n, run in ((p.n_a, p.run_a), (p.n_b, p.run_b)):
                    assert run % tint8.FP32_RUN_ALIGN == 0 and run <= most
                    assert n <= tffn.MAX_SPLIT
                want = max(1, n_blocks // 2)
                assert (p.n_a, p.run_a) == tint8.fp32_split(p.tiles_a, d, b, want)
                assert (p.n_b, p.run_b) == tint8.fp32_split(p.tiles_b, i, b, want)
            # grid-stride: every item of both phases is walked, the grid fits
            assert 1 <= p.grid <= n_blocks
            assert p.grid == min(n_blocks, max(p.tiles_a * p.n_a, p.tiles_b * p.n_b))
            # the workspace holds g and every partial
            need = -(-b * i * 2 // 16) * 4 + p.n_a * b * 2 * i + p.n_b * b * d
            assert workspace_floats(p, b, d, i, torch.bfloat16) == need


def test_plan_of_the_serving_shapes():
    """The plans the card runs at s2-pro's FFNs with two blocks per SM:
    phase A's 76 (slow) or 48 (fast) column tiles and phase B's 10 or 6
    need runs to fill 264 blocks; every block merges its share of the
    partials, so 32 rows cut no coarser than one."""
    plan = functools.partial(int8_ffn_plan, "mma", n_blocks=264)
    FfnPlan = tffn.FfnPlan
    for b in (1, 32):
        assert plan(b, 2560, 9728) == FfnPlan(76, 3, 896, 10, 26, 384, 260)
        assert plan(b, 1536, 6144) == FfnPlan(48, 5, 320, 6, 32, 192, 240)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,d,i", [(1, 2560, 1024), (7, 384, 640), (32, 1024, 1024),
                                   (3, 1000, 400)])
def test_partials_added_in_run_order_equal_the_plain_version(b, d, i, dtype):
    w1, w3, w2 = _weights(d, i, seed=b + d)
    x = _x(b, d, seed=i, dtype=dtype)
    p = int8_ffn_plan("mma", b, d, i, 264)
    assert p.n_a > 1 and p.n_b > 1  # few tiles: both phases split
    part_a, g, part_b = int8_ffn_partials_reference(x, _fused(w1, w3), w2, p)
    assert part_a.shape == (p.n_a, b, 2 * i) and part_b.shape == (p.n_b, b, d)
    assert g.dtype == dtype
    y = part_b[0]
    for k in range(1, p.n_b):  # in run order, as the kernel's blocks add them
        y = y + part_b[k]
    got = (y * w2["s"]).to(dtype)
    want = int8_ffn_reference(x, _fused(w1, w3), w2)
    if dtype == torch.float32:
        assert _rel(got, want) <= 1e-5
    else:  # g's rounding may land one step apart where its fp32 sum differs
        assert _max_ulps(got, want) <= 2


def test_route_by_rows_and_dtype():
    for b in (1, 8, 9, 32):
        assert _route(b, torch.bfloat16) == "mma"
        assert _route(b, torch.float32) == "cuda_cores"
    for b in (0, 33, 1024):
        with pytest.raises(ValueError, match="rows"):
            _route(b, torch.bfloat16)
    with pytest.raises(TypeError):  # fp16 takes the kernel's fp16 form
        _route(1, torch.float64)


def test_check_refuses_what_the_kernels_do_not_take_device_last():
    """On CPU tensors every check but the device's is reached first."""
    d, i = 128, 256
    x = torch.zeros(2, d)
    q13 = torch.zeros(d, 2 * i, dtype=torch.int8)
    q1, q3 = q13[:, :i], q13[:, i:]
    s1 = s3 = torch.ones(i)
    q2 = torch.zeros(i, d, dtype=torch.int8)
    s2 = torch.ones(d)
    ok = (x, q1, s1, q3, s3, q2, s2)

    def but(**kw):
        names = ("x", "q1", "s1", "q3", "s3", "q2", "s2")
        return tuple(kw.get(n, a) for n, a in zip(names, ok))

    for args, err in [
            (but(x=x.double()), TypeError),
            (but(q1=q1.to(torch.uint8)), TypeError),
            (but(q2=q2.to(torch.uint8)), TypeError),
            (but(s3=s3.to(torch.bfloat16)), TypeError),
            (but(x=x[None]), ValueError),
            (but(s2=s2[None]), ValueError),
            (but(x=torch.zeros(2, d + 16)), ValueError),
            (but(q2=torch.zeros(i, d + 16, dtype=torch.int8)), ValueError),
            (but(s1=torch.ones(i + 1)), ValueError),
            (but(x=torch.zeros(33, d)), ValueError),
            (but(x=torch.zeros(d, 2).T), ValueError),
            (but(s2=torch.ones(2 * d)[::2]), ValueError),
            (but(q3=torch.zeros(d, i, dtype=torch.int8)), ValueError),  # rows I apart, q1's 2I
            (but(q2=torch.zeros(d, i, dtype=torch.int8).T), ValueError),
            # the tensor-core route: 128-byte TMA boxes, rows 16 bytes apart
            (but(x=torch.zeros(2, d, dtype=torch.bfloat16), q1=q13[:64, :i],
                 q3=q13[:64, i:], q2=torch.zeros(i, 64, dtype=torch.int8),
                 s2=torch.ones(64)), ValueError)]:
        with pytest.raises(err):
            _check(*args)
    for args in (ok, but(x=x.to(torch.bfloat16))):
        with pytest.raises(ValueError, match="CUDA"):
            _check(*args)
    # the fp32 route takes any width; the split form's separate tensors too
    small = (torch.zeros(1, 64), torch.zeros(64, 40, dtype=torch.int8), torch.ones(40),
             torch.zeros(64, 40, dtype=torch.int8), torch.ones(40),
             torch.zeros(40, 64, dtype=torch.int8), torch.ones(64))
    with pytest.raises(ValueError, match="CUDA"):
        _check(*small)


def test_cpu_calls_take_the_plain_version_and_count_no_launch():
    w1, w3, w2 = _weights(128, 256, seed=1)
    x = _x(3, 128, seed=2, dtype=torch.bfloat16)
    n0 = (int8_ffn.launches, int8_ffn.launches_mma, int8_ffn.launches_cuda_cores)
    assert torch.equal(int8_ffn(x, _fused(w1, w3), w2),
                       int8_ffn_reference(x, _fused(w1, w3), w2))
    assert (int8_ffn.launches, int8_ffn.launches_mma,
            int8_ffn.launches_cuda_cores) == n0
    int8_ffn.launches = int8_ffn.launches_cuda_cores = 5
    tffn.reset_launches()
    assert int8_ffn.launches == int8_ffn.launches_mma == \
        int8_ffn.launches_cuda_cores == 0
    assert (int8_ffn, "launches_mma") in {(f, n) for f, n in tgen._launch_counts()}


def _layer(kind, d=64, i=128, seed=0, lora=False):
    """A layer's FFN leaves: "int8" (w13 fused), "int8 split" (w1, w3),
    "int4" or "bf16"; with `lora`, a rank-2 LoRA on w1."""
    w1, w3, w2 = _weights(d, i, seed)
    if kind == "int8":
        lp = {"w13": _fused(w1, w3), "w2": w2}
    elif kind == "int8 split":
        lp = {"w1": w1, "w3": w3, "w2": w2}
    else:
        ws = [tquant.dequantize_int8(w, torch.float32) for w in (w1, w3, w2)]
        if kind == "int4":
            ws = [tquant.quantize_int4(w, group_size=32) for w in ws]
        lp = dict(zip(("w1", "w3", "w2"), ws))
    if lora:
        rng = np.random.default_rng(seed)
        lp["lora"] = {"w1": {"a": torch.from_numpy(rng.standard_normal((d, 2)).astype(np.float32)),
                             "b": torch.from_numpy(rng.standard_normal((2, i)).astype(np.float32))}}
    return lp


@pytest.mark.parametrize("kind,rows,lora,fused", [
    ("int8", 1, False, True), ("int8", 32, False, True), ("int8 split", 7, False, True),
    ("int8", 33, False, False), ("int4", 1, False, False), ("bf16", 1, False, False),
    ("int8", 1, True, False), ("int8 split", 1, True, False)])
def test_ffn_takes_the_fused_kernel_for_int8_up_to_32_rows(monkeypatch, kind, rows,
                                                           lora, fused):
    lp = _layer(kind, lora=lora)
    h2 = _x(rows, 64, seed=rows, dtype=torch.float32)[None]  # (1, rows, D)
    calls = []

    def spy(x, w13, w2):
        calls.append(x.shape)
        return int8_ffn(x, w13, w2)

    monkeypatch.setattr(tdual, "int8_ffn", spy)
    tquant.reset_launches()
    got = tdual._ffn(lp, (0, 0, 0, 0, 1.0), h2)
    assert got.shape == h2.shape
    assert calls == ([(rows, 64)] if fused else [])
    int8_products = (tquant.mm.launches_int8_matmul, tquant.mm.launches_int8_cast)
    if fused:  # w13 and w2 left `mm`
        assert int8_products == (0, 0)
        w13 = lp["w13"] if "w13" in lp else (lp["w1"], lp["w3"])
        assert torch.equal(got[0], int8_ffn_reference(h2[0], w13, lp["w2"]))
    elif kind.startswith("int8"):  # through `mm`: 2 products fused, 3 split
        n = 2 if "w13" in lp else 3
        assert int8_products == ((n, 0) if rows <= 32 else (0, n))


@pytest.mark.parametrize("kind", ["int8", "int8 split"])
def test_ffn_hands_the_kernel_fp32_scales(monkeypatch, kind):
    """A layer whose scales are bf16 (a checkpoint read in bf16, no
    `fp32_scales`): `_ffn` casts them, as `mm` does, so every check of
    `_check` but the device's passes, and the output is the one of the
    fp32 scales."""
    lp = {k: {"q": w["q"], "s": w["s"].to(torch.bfloat16)} for k, w in _layer(kind).items()}
    h2 = _x(3, 64, seed=5, dtype=torch.float32)[None]
    checked = []

    def spy(x, w13, w2):
        with pytest.raises(ValueError, match="one CUDA device"):
            _check(x, *tffn._halves(w13), w2["q"], w2["s"])
        checked.append(True)
        return int8_ffn(x, w13, w2)

    monkeypatch.setattr(tdual, "int8_ffn", spy)
    got = tdual._ffn(lp, (0, 0, 0, 0, 1.0), h2)
    assert checked == [True]
    assert torch.equal(got, tdual._ffn(tquant.fp32_scales(lp), (0, 0, 0, 0, 1.0), h2))
    with pytest.raises(TypeError):  # the wrapper itself takes fp32 scales only
        _check(h2[0], *tffn._halves(lp["w13"] if "w13" in lp else (lp["w1"], lp["w3"])),
               lp["w2"]["q"], lp["w2"]["s"])


def test_mixed_session_takes_the_fused_ffn_and_matches_jax(tokenizer, monkeypatch):
    """The `mixed` session (slow int8, fast int4) with the int8 KV cache:
    greedy columns equal JAX's; each decode step sends its slow stack's
    FFNs through `int8_ffn` (the fast stack is int4)."""
    jcfg, cfg = _cfgs(tokenizer)
    jq, tq = _quantized(jcfg, "int8", "int4", seed=5)
    calls = []

    def spy(x, w13, w2):
        calls.append(x.shape[0])
        return int8_ffn(x, w13, w2)

    monkeypatch.setattr(tdual, "int8_ffn", spy)
    js = jgen.GenerationSession(jq, jcfg, SamplingConfig(), max_batch=1,
                                dtype=jnp.float32, decode_chunk_size=4,
                                first_chunk_size=2, kv_quant=True)
    ts = tgen.GenerationSession(tq, cfg, TSamplingConfig(), max_batch=1,
                                dtype=torch.float32, decode_chunk_size=4,
                                first_chunk_size=2, kv_quant=True)
    prompt = _prompt(cfg, 29, seed=6)[0]
    kw = dict(max_new_tokens=10, top_k=1)
    want = list(js.generate_stream(prompt, jax.random.PRNGKey(0), **kw))
    got = list(ts.generate_stream(prompt, ts.new_generator(1), **kw))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # the prefill's slow stack over its bucket, then one row per decode step
    # and slow layer (the step graph runs whole chunks)
    steps = got[-1].shape[1] - 1  # cumulative columns, the first the prefill's
    ones = [c for c in calls if c == 1]
    assert len(ones) % cfg.n_layer == 0 and len(ones) >= cfg.n_layer * steps > 0
    assert len(calls) - len(ones) in (0, cfg.n_layer)


def test_int8_pool_step_takes_the_fused_ffn_in_both_stacks(tokenizer, monkeypatch):
    """The int8 pool step (int8 weights in both stacks, int8 KV cache, P
    rows): JAX's greedy columns, and per step one `int8_ffn` of P rows per
    slow layer and per fast layer of every codebook column."""
    jcfg, cfg = _cfgs(tokenizer)
    jp, tp = _quantized(jcfg, "int8", None, seed=6)
    jp = jdual.fuse_ffn_weights(jdual.precompute_semantic_head(jp, jcfg))
    tp = tquant.fp32_scales(tdual.fuse_ffn_weights(tdual.precompute_semantic_head(tp, cfg)))
    sampling = (0.7, 0.9, 1)
    st, jc, _ = _pool(cfg, True, seed=3, sampling=sampling)
    calls = []

    def spy(x, w13, w2):
        calls.append(x.shape[0])
        return int8_ffn(x, w13, w2)

    monkeypatch.setattr(tdual, "int8_ffn", spy)
    scfg = TSamplingConfig()
    got, want = [], []
    n_steps = 0
    for n in CHUNKS:
        st.step.zero_()
        for _ in range(n):
            tgen.pool_decode_step(tp, cfg, scfg, st)
        n_steps += n
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
    per_step = cfg.n_layer + cfg.n_fast_layer * cfg.num_codebooks
    assert calls == [P] * (per_step * n_steps)
