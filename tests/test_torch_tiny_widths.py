"""JAX's own tiny model in the port (`--tiny`), on the CPU.

JAX's `--tiny` entry points build `dual_ar_tiny` at its own widths: slow
heads 32 wide (2 over 1 KV head), fast heads 16 wide (2 over 1). The port's
attention kernels take those widths in fp32 (the decode also 16, the
training attention in bf16 too), so its `--tiny` builds the same model:

  (a) `server.main.tiny_models`' config equals, field by field, the one the
      JAX server's `build_engine` builds for `--tiny` (its `dual_ar_tiny`
      call read from the source with `ast` and evaluated on JAX's test
      tokenizer and `dac_tiny`), and so does the codec's;
  (b) JAX's tiny weights (`init_dual_ar(PRNGKey(0))`, bridged by
      `convert/from_jax.py`) served by the port's `--tiny` engine
      (`server.main.build_engine`, fp32 and `--int8`) give the greedy codes
      of JAX's `--tiny` engine over a voice's requests: the first a miss,
      the others prefix-cache hits (the suffix attention at D=32), every
      frame through the fast stack's decode at D=16;
  (c) each attention wrapper's check takes the widths its routes list
      (`HEAD_DIMS`: bf16 and fp16 64 and 128; fp32 32, 64 and 128; the fp32
      decode also 16; bf16 training also 32) up to the device check, and
      refuses D=8 and D=48 with a ValueError before it; bf16 training at
      D=32 routes to "bf16_tf32";
  (d) the fp32 int8 kernels' split plans (`ops/int8.py:fp32_split`, the
      matvec's and the fused FFN's): per-run partials added in run order
      equal `int8_matmul_reference` and `int8_ffn_reference` within 1e-5
      of max |y|, and JAX's `mm` and `_ffn` on the same fp32 inputs at
      JAX's tiny shapes (the order of fp32 sums); JAX's tiny products are
      one run each, s2-pro's split.
"""

import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_speech_tpu.config import dac_tiny as jdac_tiny
from fish_speech_tpu.config import dual_ar_tiny as jdual_ar_tiny
from fish_speech_tpu.models import dual_ar as jdual
from fish_speech_tpu.ops import quant as jquant
from fish_speech_tpu.server import main as jmain
from fish_speech_tpu.tokenizer import build_test_tokenizer as jtokenizer
from fish_speech_tpu_torch.convert.from_jax import dual_ar_from_jax
from fish_speech_tpu_torch.models import dual_ar as tdual
from fish_speech_tpu_torch.ops import flash_decode, flash_prefill, flash_train
from fish_speech_tpu_torch.ops import int8 as tint8
from fish_speech_tpu_torch.ops import int8_ffn as tffn
from fish_speech_tpu_torch.server import main as tmain

from tests.test_torch_prefix_cache import _speaker

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent


def _jax_tiny_cfg():
    """The config the JAX server's `build_engine` builds for `--tiny`: its
    `dual_ar_tiny(...)` call, read from the source and evaluated on the
    names it uses there (the test tokenizer and `dac_tiny`)."""
    tree = ast.parse((ROOT / "fish_speech_tpu/server/main.py").read_text())
    build = next(n for n in tree.body
                 if isinstance(n, ast.FunctionDef) and n.name == "build_engine")
    calls = [n for n in ast.walk(build) if isinstance(n, ast.Call)
             and getattr(n.func, "id", None) == "dual_ar_tiny"]
    assert len(calls) == 1 and not calls[0].args
    names = {"tokenizer": jtokenizer(), "dac_cfg": jdac_tiny()}
    kw = {}
    for k in calls[0].keywords:
        used = {n.id for n in ast.walk(k.value) if isinstance(n, ast.Name)}
        assert used <= set(names), used
        kw[k.arg] = eval(compile(ast.Expression(k.value), "main.py", "eval"),
                         {}, names)
    return jdual_ar_tiny(**kw)


# -- (a) the config ------------------------------------------------------------


def test_tiny_models_build_the_jax_servers_tiny_config():
    tok, cfg, params, dac_cfg, _ = tmain.tiny_models("cpu")
    want = dataclasses.asdict(_jax_tiny_cfg())
    got = dataclasses.asdict(cfg)
    assert set(got) == set(want)
    for name, value in want.items():
        assert got[name] == value, name
    assert (cfg.head_dim, cfg.n_head, cfg.n_local_heads) == (32, 2, 1)
    assert (cfg.fast_head_dim, cfg.fast_n_head, cfg.fast_n_local_heads) == (16, 2, 1)
    assert dataclasses.asdict(dac_cfg) == dataclasses.asdict(jdac_tiny())
    assert tok.vocab_size == jtokenizer().vocab_size
    # the weights are the config's: the slow wqkv (H + 2 Hkv) x 32 wide
    assert params["layers"]["wqkv"].shape[-1] == (2 + 2 * 1) * 32


# -- (b) JAX's tiny weights served by the port's --tiny engine -------------------


@pytest.fixture(scope="module")
def jax_tiny_params():
    """JAX's `--tiny` LM weights, as its `build_engine` makes them."""
    return jdual.init_dual_ar(jax.random.PRNGKey(0), _jax_tiny_cfg(), dtype=jnp.float32)


@pytest.mark.parametrize("int8", [False, True])
def test_port_tiny_engine_gives_jax_tiny_engines_greedy_codes(jax_tiny_params, int8,
                                                              monkeypatch):
    flags = ["--tiny", "--cpu", "--prefix-cache", "2"] + (["--int8"] if int8 else [])
    jengine = jmain.build_engine(jmain.parse_args(flags))
    real = tmain.tiny_models

    def with_jax_weights(device):
        tok, cfg, _, dac_cfg, dac_params = real(device)
        bridged = dual_ar_from_jax(jax.tree_util.tree_map(np.asarray, jax_tiny_params),
                                   dtype=torch.float32, device=device)
        return tok, cfg, bridged, dac_cfg, dac_params

    monkeypatch.setattr(tmain, "tiny_models", with_jax_weights)
    tengine = tmain.build_engine(tmain.parse_args(flags))
    js, ts = jengine.session, tengine.session
    assert (ts.cfg.head_dim, ts.cfg.fast_head_dim) == (32, 16)
    # a voice's requests: the first stores the shared prefix, the next two
    # hit it and prefill only their suffix
    prompts = _speaker(ts.cfg, (12, 20, 9))
    kw = dict(max_new_tokens=8, temperature=0.7, top_p=0.9, top_k=1)
    for i, p in enumerate(prompts):
        want = js.generate(p, jax.random.PRNGKey(i), **kw)
        got = ts.generate(p, ts.new_generator(i), **kw)
        assert got.shape[1] > 1
        np.testing.assert_array_equal(got, want, err_msg=f"request {i}")
    assert (ts.prefix_hits, ts.prefix_misses) == (js.prefix_hits, js.prefix_misses)
    assert ts.prefix_hits == 2


# -- (c) the widths each wrapper takes ----------------------------------------------


def test_the_listed_widths():
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    assert flash_decode.HEAD_DIMS == {bf16: (64, 128), f16: (64, 128),
                                      f32: (16, 32, 64, 128)}
    assert flash_decode.KV8_HEAD_DIMS == {bf16: (64, 128), f16: (64, 128),
                                          f32: (32, 64, 128)}
    assert flash_prefill.HEAD_DIMS == {"fp32_tc": (32, 64, 128),
                                       "wgmma": (64, 128), "wgmma_f16": (64, 128)}
    assert flash_train.HEAD_DIMS == {"fp32_tc": (32, 64, 128), "wgmma": (64, 128),
                                     "bf16_tf32": (32,)}
    assert flash_train._route(bf16, 32) == "bf16_tf32"
    assert flash_train._route(bf16, 64) == flash_train._route(bf16, 128) == "wgmma"
    assert flash_train._route(f32, 32) == "fp32_tc"


def _decode_args(dtype, d, g=2, kv8=False):
    q = torch.zeros(1, 1, g, d, dtype=dtype)
    lengths = torch.ones(1, dtype=torch.int32)
    if kv8:
        k = torch.zeros(1, 1, 8, 1, d, dtype=torch.int8)
        s = torch.zeros(1, 1, 8, 1, dtype=torch.bfloat16)
        return q, k, s, k.clone(), s.clone(), 0, lengths, None
    k = torch.zeros(1, 1, 8, 1, d, dtype=dtype)
    return q, k, k.clone(), 0, lengths, None


DTYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kv8", [False, True])
def test_decode_checks_take_the_listed_widths(dtype, kv8):
    check = flash_decode._check_kv8 if kv8 else flash_decode._check
    dims = (flash_decode.KV8_HEAD_DIMS if kv8 else flash_decode.HEAD_DIMS)[dtype]
    for d in dims:
        with pytest.raises(ValueError, match="CUDA device"):
            check(*_decode_args(dtype, d, kv8=kv8))
    for d in (8, 48) + tuple(x for x in (16, 32) if x not in dims):
        with pytest.raises(ValueError, match=f"D={d} "):
            check(*_decode_args(dtype, d, kv8=kv8))


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_and_suffix_checks_take_the_listed_widths(dtype):
    dims = flash_prefill.HEAD_DIMS[flash_prefill._route(dtype)]
    assert dims == ((32, 64, 128) if dtype == torch.float32 else (64, 128))

    def prefill(d):
        q = torch.zeros(1, 8, 2, d, dtype=dtype)
        k = torch.zeros(1, 8, 1, d, dtype=dtype)
        return flash_prefill._check(q, k, k.clone(), torch.zeros(1, dtype=torch.int32))

    def suffix(d, kv8):
        q = torch.zeros(1, 4, 2, d, dtype=dtype)
        cache = {n: torch.zeros(2, 1, 16, 1, d, dtype=torch.int8 if kv8 else dtype)
                 for n in "kv"}
        if kv8:
            cache.update({n: torch.zeros(2, 1, 16, 1, dtype=torch.bfloat16)
                          for n in ("ks", "vs")})
        return flash_prefill._check_suffix(q, cache, 1, torch.zeros(1, dtype=torch.int32))

    calls = [prefill, lambda d: suffix(d, False), lambda d: suffix(d, True)]
    for call in calls:
        for d in dims:
            with pytest.raises(ValueError, match="CUDA device"):
                call(d)
        for d in (8, 16, 48) + (() if 32 in dims else (32,)):
            with pytest.raises(ValueError, match=f"head dim {d} "):
                call(d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("backward", [False, True])
def test_training_checks_take_the_listed_widths(dtype, backward):
    def check(d):
        q = torch.zeros(1, 8, 2, d, dtype=dtype)
        k = torch.zeros(1, 8, 1, d, dtype=dtype)
        kvalid = torch.ones(1, 8, dtype=torch.int32)
        if backward:
            return flash_train._check_backward(q, k, k.clone(), kvalid, q.clone(),
                                               torch.zeros(1, 2, 8), q.clone())
        return flash_train._check(q, k, k.clone(), kvalid)

    for d in (32, 64, 128):  # fp32: "fp32_tc"; bf16: "bf16_tf32", "wgmma"
        with pytest.raises(ValueError, match="CUDA device"):
            check(d)
    for d in (8, 16, 48, 96):
        with pytest.raises(ValueError, match=f"head dim {d} "):
            check(d)


# -- (d) the fp32 int8 kernels' split plans -----------------------------------------

# JAX's tiny model's int8 products (I, O) as `--tiny --int8` serves them:
# slow wqkv, wo, w13, w2; fast wqkv, wo, w13, w2; the semantic head; the
# fast head
TINY_MM = [(64, 128), (64, 64), (64, 256), (128, 64), (32, 64), (32, 32), (32, 128),
           (64, 32), (64, 4097), (32, 4096)]
# shapes the plan splits: few column tiles over a long I, s2-pro's
SPLIT_MM = [(2560, 200), (1000, 72), (4096, 130), (300, 4097), (2560, 19456)]
TINY_FFN = [(64, 128), (32, 64)]  # (D, I): the slow and the fast stack
SPLIT_FFN = [(2560, 9728), (1536, 6144), (384, 640)]


def _int8(i, o, seed):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.integers(-127, 128, (i, o)).astype(np.int8))
    s = torch.from_numpy(rng.uniform(0.001, 0.02, o).astype(np.float32))
    return q, s


def _x(b, n, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((b, n))
                            .astype(np.float32))


def _within(got, want, rel=1e-5):
    top = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= rel * top, (err, top)


def _matvec_plan(b, i, o, n_sm=132):
    return tint8.fp32_split(-(-o // tint8.ROUTE_COLS["gemv"]), i, b,
                            tint8.FP32_BLOCKS_PER_SM * n_sm)


@pytest.mark.parametrize("i,o", TINY_MM + SPLIT_MM)
def test_fp32_matvec_plan_partials_equal_the_plain_version(i, o):
    q, s = _int8(i, o, seed=i + o)
    for b in (1, 4, 16, 32):
        n, run = _matvec_plan(b, i, o)
        assert (n - 1) * run < i <= n * run and run % tint8.FP32_RUN_ALIGN == 0
        assert run <= tint8.FP32_MAX_RUN[tint8.fp32_rows(b)]
        assert n == 1 or (i, o) in SPLIT_MM  # the tiny products: one run each
        x = _x(b, i, seed=b)
        parts = tint8.int8_gemv_partials_reference(x, q, n, run)
        acc = parts[0]
        for k in range(1, n):  # in run order, as the tile's last block adds them
            acc = acc + parts[k]
        _within((acc * s).numpy(), tint8.int8_matmul_reference(x, q, s).numpy())
    assert _matvec_plan(1, 2560, 19456)[0] > 1  # s2-pro's w13: 152 tiles, 4 runs


@pytest.mark.parametrize("i,o", TINY_MM)
def test_fp32_matvec_matches_jax_mm_at_the_tiny_shapes(i, o):
    q, s = _int8(i, o, seed=3 * i + o)
    for b in (1, 4):
        x = _x(b, i, seed=7 + b)
        with jax.default_matmul_precision("highest"):
            want = np.asarray(jquant.mm(jnp.asarray(x.numpy()),
                                        {"q": jnp.asarray(q.numpy()),
                                         "s": jnp.asarray(s.numpy())}))
        got = tint8.int8_matmul(x, q, s)  # CPU tensors: the plain version
        _within(got.numpy(), want)
        n, run = _matvec_plan(b, i, o)
        parts = tint8.int8_gemv_partials_reference(x, q, n, run)
        _within((parts.sum(0) * s).numpy(), want)


def _ffn_weights(d, i, seed):
    rng = np.random.default_rng(seed)
    q13 = torch.from_numpy(rng.integers(-127, 128, (d, 2 * i)).astype(np.int8))
    q2 = torch.from_numpy(rng.integers(-127, 128, (i, d)).astype(np.int8))
    s13 = torch.from_numpy(rng.uniform(0.5, 1.5, 2 * i).astype(np.float32) / (73 * d ** 0.5))
    s2 = torch.from_numpy(rng.uniform(0.5, 1.5, d).astype(np.float32) / (73 * i ** 0.5))
    return {"q": q13, "s": s13}, {"q": q2, "s": s2}


@pytest.mark.parametrize("d,i", TINY_FFN + SPLIT_FFN)
def test_fp32_ffn_plan_partials_equal_the_plain_version(d, i):
    w13, w2 = _ffn_weights(d, i, seed=d + i)
    for b in (1, 4, 16, 32):
        for n_blocks in (1056, 264, 8):  # what the card holds at once
            p = tffn.int8_ffn_plan("cuda_cores", b, d, i, n_blocks)
            if (d, i) in TINY_FFN:  # one block, one run a phase: no partials
                assert (p.n_a, p.n_b, p.grid) == (1, 1, 1)
            x = _x(b, d, seed=b + d)
            _, g, part_b = tffn.int8_ffn_partials_reference(x, w13, w2, p)
            y = part_b[0]
            for k in range(1, p.n_b):  # in run order, as the blocks add them
                y = y + part_b[k]
            _within((y * w2["s"]).numpy(), tffn.int8_ffn_reference(x, w13, w2).numpy())
    assert tffn.int8_ffn_plan("cuda_cores", 1, 2560, 9728, 1056).n_a > 1


@pytest.mark.parametrize("d,i", TINY_FFN)
def test_fp32_ffn_matches_jax_ffn_at_the_tiny_shapes(d, i):
    w13, w2 = _ffn_weights(d, i, seed=2 * d + i)
    jl = {"w13": {n: jnp.asarray(t.numpy()) for n, t in w13.items()},
          "w2": {n: jnp.asarray(t.numpy()) for n, t in w2.items()}}
    spec = (2, 1, 32, 1e-6, 1.0)
    for b in (1, 4):
        x = _x(b, d, seed=11 * b)
        with jax.default_matmul_precision("highest"):
            want = np.asarray(jdual._ffn(jl, spec, jnp.asarray(x.numpy())[:, None]))[:, 0]
        got = tffn.int8_ffn(x, w13, w2)  # CPU tensors: the plain version
        _within(got.numpy(), want)
        routed = tdual._ffn({"w13": w13, "w2": w2}, spec + (None,), x[:, None])[:, 0]
        assert torch.equal(routed, got)
        p = tffn.int8_ffn_plan("cuda_cores", b, d, i, 1056)
        _, _, part_b = tffn.int8_ffn_partials_reference(x, w13, w2, p)
        _within((part_b.sum(0) * w2["s"]).numpy(), want)
