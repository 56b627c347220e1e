"""The port's ops against the JAX package's, on the CPU.

Inputs are float32 from numpy with a seed; both packages get the same
arrays. Elementwise ops and einsum attention agree to 1e-5 abs (only the
summation order differs); sampling with JAX's own uniforms passed in gives
identical indices. The kernels' plain versions are held to the Pallas
kernels run in interpret mode, and a CPU tensor through a kernel wrapper
runs the plain version and never counts a launch.
"""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_speech_tpu.ops import attention as jattn
from fish_speech_tpu.ops import norms as jnorms
from fish_speech_tpu.ops import rope as jrope
from fish_speech_tpu.ops import sampling as jsamp
from fish_speech_tpu.ops.pallas_attention import \
    flash_prefill_attention as j_flash_prefill
from fish_speech_tpu.ops.pallas_decode import \
    flash_decode_attention as j_flash_decode
from fish_speech_tpu_torch.ops import attention as tattn
from fish_speech_tpu_torch.ops import norms as tnorms
from fish_speech_tpu_torch.ops import rope as trope
from fish_speech_tpu_torch.ops import sampling as tsamp
from fish_speech_tpu_torch.ops.flash_decode import (flash_decode_attention,
                                                    flash_decode_reference)
from fish_speech_tpu_torch.ops.flash_prefill import (flash_prefill_attention,
                                                     flash_prefill_reference)
from fish_speech_tpu_torch.ops.int4 import int4_matmul
from fish_speech_tpu_torch.ops.quant import mm

torch.set_num_threads(1)
ATOL = 1e-5


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol, rtol=0)


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x, w = _rand(rng, 2, 5, 64), _rand(rng, 64)
    _close(tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
           jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_rope_table_matches_jax_bit_for_bit(dtype):
    j = jrope.precompute_rope(300, 128, 1e6, dtype=getattr(jnp, dtype))
    t = trope.precompute_rope(300, 128, 1e6, dtype=getattr(torch, dtype))
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(j.astype(jnp.float32)))


def test_apply_rope_matches_jax_with_bf16_table():
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 7, 3, 32)
    jt = jrope.precompute_rope(64, 32, 10000.0)[:7]
    tt = trope.precompute_rope(64, 32, 10000.0)[:7]
    _close(trope.apply_rope(torch.from_numpy(x), tt),
           jrope.apply_rope(jnp.asarray(x), jt))


@pytest.mark.parametrize("window", [None, 4])
def test_gqa_attention_matches_jax(window):
    rng = np.random.default_rng(2)
    q, k, v = _rand(rng, 2, 9, 4, 16), _rand(rng, 2, 9, 2, 16), _rand(rng, 2, 9, 2, 16)
    if window is None:
        jm, tm = jattn.causal_mask(9, bool), tattn.causal_mask(9)
    else:
        jm = jattn.windowed_causal_mask(9, window)
        tm = tattn.windowed_causal_mask(9, window)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    _close(tattn.gqa_attention(*map(torch.from_numpy, (q, k, v)), tm),
           jattn.gqa_attention(*map(jnp.asarray, (q, k, v)), jm))


@pytest.mark.parametrize("temperature,top_p,top_k", [
    (0.8, 0.8, 30), (1.0, 0.95, 64), (0.3, 1.0, 5), (1.0, 0.9, 1),
])
def test_sample_topk_with_jax_uniforms_is_identical(temperature, top_p, top_k):
    rng = np.random.default_rng(3)
    logits = _rand(rng, 16, 200) * 3
    jstate = jsamp.topk_state(jnp.asarray(logits))
    tstate = tsamp.topk_state(torch.from_numpy(logits))
    _close(tstate[0], jstate[0])
    np.testing.assert_array_equal(tstate[1].numpy(), np.asarray(jstate[1]))
    for seed in range(8):
        key = jax.random.PRNGKey(seed)
        want = jsamp.sample_topk(key, jstate, temperature, top_p, top_k)
        u = jax.random.uniform(key, (16, tsamp.TOP_K_CAP), jnp.float32,
                               minval=jnp.finfo(jnp.float32).tiny)
        got = tsamp.sample_topk(tstate, temperature, top_p, top_k,
                                u=torch.from_numpy(np.array(u)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.dtype == torch.int32


def test_ras_select_matches_jax():
    rng = np.random.default_rng(4)
    normal = rng.integers(90, 140, size=32).astype(np.int32)
    high = rng.integers(100, 132, size=32).astype(np.int32)
    window = rng.integers(95, 135, size=(32, 10)).astype(np.int32)
    want = jsamp.ras_select(jnp.asarray(normal), jnp.asarray(high),
                            jnp.asarray(window), 100, 131)
    got = tsamp.ras_select(*map(torch.from_numpy, (normal, high, window)), 100, 131)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_check_top_k_cap():
    tsamp.check_top_k(64)
    with pytest.raises(ValueError):
        tsamp.check_top_k(65)


@pytest.mark.parametrize("b,t,h,hkv,d,offsets", [
    (1, 64, 4, 2, 64, [0]),
    (2, 128, 4, 1, 32, [0, 37]),
    (2, 128, 2, 2, 16, [5, 100]),
])
def test_flash_prefill_plain_matches_pallas_interpret(b, t, h, hkv, d, offsets):
    rng = np.random.default_rng(t + h)
    q, k, v = _rand(rng, b, t, h, d), _rand(rng, b, t, hkv, d), _rand(rng, b, t, hkv, d)
    off = np.asarray(offsets, np.int32)
    want = j_flash_prefill(*map(jnp.asarray, (q, k, v, off)), interpret=True)
    args = tuple(map(torch.from_numpy, (q, k, v, off)))
    _close(flash_prefill_reference(*args), want)
    n0 = flash_prefill_attention.launches
    _close(flash_prefill_attention(*args), want)  # CPU: the plain version
    assert flash_prefill_attention.launches == n0


@pytest.mark.parametrize("g,lengths", [(4, [1, 300]), (3, [257, 10]), (8, [512, 33])])
def test_flash_decode_plain_matches_pallas_interpret(g, lengths):
    rng = np.random.default_rng(g)
    n_layer, b, s, hkv, d, gp = 2, 2, 512, 2, 64, 8
    q = np.zeros((b, hkv, gp, d), np.float32)  # JAX side: G padded to Gp
    q[:, :, :g] = _rand(rng, b, hkv, g, d)
    k, v = _rand(rng, n_layer, b, s, hkv, d), _rand(rng, n_layer, b, s, hkv, d)
    lens = np.asarray(lengths, np.int32)
    for layer in range(n_layer):
        want = j_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.int32(layer), jnp.asarray(lens),
                              interpret=True)[:, :, :g]
        args = (torch.from_numpy(q[:, :, :g].copy()), torch.from_numpy(k),
                torch.from_numpy(v), layer, torch.from_numpy(lens))
        _close(flash_decode_reference(*args), want)
        n0 = flash_decode_attention.launches
        _close(flash_decode_attention(*args), want)  # CPU: the plain version
        assert flash_decode_attention.launches == n0


def test_mm_rejects_quantized_weights():
    """`mm` takes int8 and int4 weight dicts (`tests/test_torch_quant.py`
    holds them to JAX); it rejects an int4 weight whose groups straddle the
    half split, as the kernel's contract does."""
    x = torch.ones(2, 4)
    assert mm(x, torch.ones(4, 3)).shape == (2, 3)
    y = mm(x, {"q": torch.ones(4, 3, dtype=torch.int8), "s": torch.full((3,), 0.5)})
    np.testing.assert_array_equal(y.numpy(), np.full((2, 3), 2.0, np.float32))
    with pytest.raises(ValueError, match="straddle"):
        int4_matmul(torch.ones(1, 12), torch.zeros(6, 3, dtype=torch.uint8),
                    torch.ones(3, 3))


PORT_MODULES = [
    "fish_speech_tpu_torch",
    "fish_speech_tpu_torch.ops.norms",
    "fish_speech_tpu_torch.ops.rope",
    "fish_speech_tpu_torch.ops.attention",
    "fish_speech_tpu_torch.ops.quant",
    "fish_speech_tpu_torch.ops.sampling",
    "fish_speech_tpu_torch.ops.flash_prefill",
    "fish_speech_tpu_torch.ops.flash_decode",
    "fish_speech_tpu_torch.ops.flash_train",
    "fish_speech_tpu_torch.ops._kernels",
    "fish_speech_tpu_torch.models.dual_ar",
    "fish_speech_tpu_torch.models.lora",
    "fish_speech_tpu_torch.train.loss",
    "fish_speech_tpu_torch.train.step",
    "fish_speech_tpu_torch.train.trainer",
    "fish_speech_tpu_torch.train.cli",
    "fish_speech_tpu_torch.utils.checkpoint",
    "fish_speech_tpu_torch.models.dac.conv",
    "fish_speech_tpu_torch.models.dac.transformer",
    "fish_speech_tpu_torch.models.dac.rvq",
    "fish_speech_tpu_torch.models.dac.model",
    "fish_speech_tpu_torch.convert.from_jax",
    "fish_speech_tpu_torch.generate",
    "fish_speech_tpu_torch.engine.tts",
    "fish_speech_tpu_torch.engine.batcher",
    "fish_speech_tpu_torch.engine.reference_loader",
    "fish_speech_tpu_torch.ops.int4",
    "fish_speech_tpu_torch.ops.int8",
    "fish_speech_tpu_torch.ops.faststack",
    "fish_speech_tpu_torch.config",
    "fish_speech_tpu_torch.tokenizer",
    "fish_speech_tpu_torch.sequence",
    "fish_speech_tpu_torch.audio.io",
    "fish_speech_tpu_torch.data.clean",
    "fish_speech_tpu_torch.data.stream",
    "fish_speech_tpu_torch.data.dataset",
    "fish_speech_tpu_torch.data.protos",
    "fish_speech_tpu_torch.utils.file",
    "fish_speech_tpu_torch.utils.textseg",
    "fish_speech_tpu_torch.audio.transcode",
    "fish_speech_tpu_torch.audio.libcodec",
    "fish_speech_tpu_torch.audio.stretch",
    "fish_speech_tpu_torch.i18n",
    "fish_speech_tpu_torch.native",
    "fish_speech_tpu_torch.server",
    "fish_speech_tpu_torch.server.schema",
    "fish_speech_tpu_torch.server.openapi",
    "fish_speech_tpu_torch.server.app",
    "fish_speech_tpu_torch.server.main",
    "fish_speech_tpu_torch.tools",
    "fish_speech_tpu_torch.tools.tts",
    "fish_speech_tpu_torch.tools.codec",
    "fish_speech_tpu_torch.tools.extract_vq",
    "fish_speech_tpu_torch.tools.batch_tts",
    "fish_speech_tpu_torch.convert.torch_state",
    "fish_speech_tpu_torch.convert.dual_ar",
    "fish_speech_tpu_torch.convert.dac",
    "fish_speech_tpu_torch.convert.cli",
    "fish_speech_tpu_torch.models.naive",
    "fish_speech_tpu_torch.tools.quantize",
    "fish_speech_tpu_torch.tools.merge_lora",
    "fish_speech_tpu_torch.tools.parity_check",
    "fish_speech_tpu_torch.tools.build_dataset",
    "fish_speech_tpu_torch.tools.create_train_split",
]

# Run on the CPU with the JAX package and jax unimportable: every port
# module (the tools included), the tiny training CLI, a streamed engine
# request (generate_long inside, from device partials) and a voice-clone
# one (a WAV reference by id: load_audio, the codec's encode), a
# mixed-quantized int8-KV session (its int8 products through
# `ops/int8.py`'s route), a lockstep `generate_batch` of two prompts, a
# streamed request through the continuous batcher's pool, the fast-stack
# probe, one /v1/tts answered by the port's HTTP app (its UI and spec
# too), and the checkpoint lifecycle's CLIs: `convert.cli` (export-dual-ar,
# dual-ar), `tools.quantize --cpu`, `tools.merge_lora --cpu` (over a LoRA
# trainer checkpoint), `tools.parity_check --cpu` (a golden saved, then
# passed), `tools.build_dataset` and `tools.create_train_split`.
# (`jax` is blocked by an import hook, not by `sys.modules['jax'] = None`:
# scipy's array-API helpers take a `jax` entry in `sys.modules` for the
# imported package.)
_RUN_WITHOUT_JAX = """
import importlib, os, sys, tempfile
class NoJax:
    def find_spec(self, name, path=None, target=None):
        if name == 'jax' or name.startswith('jax.'):
            raise ImportError(name + ' is made unimportable')
assert 'jax' not in sys.modules
sys.meta_path.insert(0, NoJax())
for m in MODULES:
    importlib.import_module(m)
import numpy as np, torch
from fish_speech_tpu_torch import config
from fish_speech_tpu_torch.audio.io import write_wav
from fish_speech_tpu_torch.data.protos import Semantics, Sentence, TextData
from fish_speech_tpu_torch.data.stream import write_pb_stream
from fish_speech_tpu_torch.engine.tts import TTSInferenceEngine, TTSRequest
from fish_speech_tpu_torch.generate import GenerationSession
from fish_speech_tpu_torch.models import dual_ar
from fish_speech_tpu_torch.models.dac.model import init_dac
from fish_speech_tpu_torch.ops import faststack, quant
from fish_speech_tpu_torch.tokenizer import build_test_tokenizer
from fish_speech_tpu_torch.train import cli

tmp = tempfile.mkdtemp()
rng = np.random.default_rng(0)
with open(os.path.join(tmp, 'd.protos'), 'wb') as f:
    for g in range(2):
        sents = [Sentence(texts=['a short line'], semantics=[
            Semantics(values=rng.integers(0, 32, size=6).tolist())
            for _ in range(3)]) for _ in range(3)]
        write_pb_stream(f, TextData(source='t', name=f's{g}', sentences=sents))
cli.main(['--tiny', '--cpu', '--data', os.path.join(tmp, 'd.protos'),
          '--output', os.path.join(tmp, 'ft'), '--max-steps', '1',
          '--batch-size', '1', '--max-length', '64', '--precision', 'float32'],
         standalone_mode=False)

tok = build_test_tokenizer()
dac_cfg = config.dac_tiny()
cfg = config.dual_ar_tiny(vocab_size=tok.vocab_size, max_seq_len=256,
                          num_codebooks=dac_cfg.rvq.total_codebooks,
                          tie_word_embeddings=False,
                          semantic_begin_id=tok.semantic_begin_id,
                          semantic_end_id=tok.semantic_end_id,
                          im_end_id=tok.im_end_id)
params = quant.quantize_dual_ar_lowmem(
    dual_ar.init_dual_ar(0, cfg, torch.float32, 'cpu'), mode='int8',
    fast_mode='int4')
quant.reset_launches()
session = GenerationSession(params, cfg, dtype=torch.float32,
                            decode_chunk_size=4, kv_quant=True)
os.makedirs(os.path.join(tmp, 'refs', 'spk'))
write_wav(os.path.join(tmp, 'refs', 'spk', 'sample.wav'),
          0.3 * rng.standard_normal(4000), 16000)
with open(os.path.join(tmp, 'refs', 'spk', 'sample.lab'), 'w') as f:
    f.write('a reference line')
engine = TTSInferenceEngine(session, tok, init_dac(1, dac_cfg, device='cpu'),
                            dac_cfg, references_dir=os.path.join(tmp, 'refs'))
for extra in ({}, {'reference_id': 'spk'}):
    results = list(engine.inference(TTSRequest(
        text='Hi.', streaming=True, max_new_tokens=6, seed=1, **extra)))
    codes = [r.code for r in results]
    assert codes[0] == 'header' and codes[-1] == 'final', (codes, results[-1].error)
assert engine.vq_cache_misses == 1
# the streamed requests decoded from device partials: the codec's decode
# ran on the partials' device columns
assert engine.device_partials and engine.codec_eager_runs
batch = GenerationSession(dual_ar.init_dual_ar(2, cfg, torch.float32, 'cpu'), cfg,
                          max_batch=2, dtype=torch.float32, decode_chunk_size=4)
prompts = [np.concatenate([rng.integers(0, 200, (1, t)),
                           rng.integers(0, cfg.codebook_size,
                                        (cfg.num_codebooks, t))]).astype(np.int32)
           for t in (9, 5)]
outs = batch.generate_batch(prompts, 3, max_new_tokens=6)
assert [o.shape[0] for o in outs] == [cfg.num_codebooks + 1] * 2
assert batch.eager_runs['decode_2'] > 0
# the mixed session's int8 products of up to 32 rows took ops/int8.py's route
assert 'fish_speech_tpu_torch.ops.int8' in sys.modules
assert quant.mm.launches_int8_matmul > 0, quant.mm.launches_int8_matmul

from fish_speech_tpu_torch.engine.batcher import BatcherSession, ContinuousBatcher
pool = ContinuousBatcher(dual_ar.init_dual_ar(1, cfg, torch.float32, 'cpu'), cfg,
                         pool_size=2, dtype=torch.float32, decode_chunk_size=4)
try:
    pooled = TTSInferenceEngine(BatcherSession(pool), tok, engine.codec_params,
                                dac_cfg)
    results = list(pooled.inference(TTSRequest(
        text='Hi.', streaming=True, max_new_tokens=6, seed=1)))
    codes = [r.code for r in results]
    assert codes[0] == 'header' and codes[-1] == 'final', (codes, results[-1].error)
finally:
    pool.shutdown()

dims = faststack.ProbeDims(64, 128, 64, 2, 2)
out = faststack.make_probe(1, 'w8a8', dims)(
    torch.ones(1, 64), faststack.make_weights(dims, 'cpu'))
assert bool(torch.isfinite(out).all())

import asyncio
from aiohttp.test_utils import TestClient, TestServer
from fish_speech_tpu_torch.server.app import create_app

async def serve():
    client = TestClient(TestServer(create_app(engine)))
    await client.start_server()
    try:
        r = await client.post('/v1/tts', json={'text': 'Hi.', 'max_new_tokens': 6,
                                              'format': 'flac'})
        body = await r.read()
        ui = await client.get('/ui')
        spec = await client.get('/v1/openapi.json')
        return r.status, body, ui.status, spec.status
    finally:
        await client.close()

status, body, ui, spec = asyncio.run(serve())
assert status == 200 and body[:4] == b'fLaC', (status, body[:200])
assert ui == 200 and spec == 200

from pathlib import Path
from fish_speech_tpu_torch.config import dac_tiny
from fish_speech_tpu_torch.convert import cli as convert_cli
from fish_speech_tpu_torch.models.lora import LoraConfig, add_lora, extract_lora
from fish_speech_tpu_torch.tools import (build_dataset, create_train_split,
                                         merge_lora, parity_check, quantize)
from fish_speech_tpu_torch.utils.checkpoint import save_codec, save_dual_ar

ck = Path(tmp) / 'ckpt'
base = dual_ar.init_dual_ar(3, cfg, torch.float32, 'cpu')
save_dual_ar(ck, base, cfg, tok)
save_codec(ck, init_dac(1, dac_cfg, device='cpu'), dac_cfg)
def run(main, args):
    main([str(a) for a in args], standalone_mode=False)
run(convert_cli.cli, ['export-dual-ar', '--input', ck, '--output', Path(tmp) / 'up'])
tok.save_pretrained(str(Path(tmp) / 'up'))
run(convert_cli.cli, ['dual-ar', '--input', Path(tmp) / 'up', '--output',
                      Path(tmp) / 'conv'])
assert (Path(tmp) / 'conv' / 'model.safetensors').exists()
run(quantize.main, ['--checkpoint-path', ck, '--mode', 'int4', '--cpu'])
assert (Path(tmp) / 'ckpt-int4' / 'model.safetensors').exists()
lcfg = LoraConfig(r=2, lora_alpha=4.0)
step = Path(tmp) / 'lora' / 'step_00000001'
step.mkdir(parents=True)
torch.save({'params': extract_lora(add_lora(base, cfg, lcfg, 1, torch.float32)),
            'opt_state': {}}, step / 'state.pt')
run(merge_lora.main, ['--base', ck, '--lora', step, '--lora-r', 2, '--lora-alpha', 4,
                      '--output', Path(tmp) / 'merged', '--cpu'])
assert (Path(tmp) / 'merged' / 'model.safetensors').exists()
golden = Path(tmp) / 'golden.json'
run(parity_check.main, ['--checkpoint-path', ck, '--max-new-tokens', 4,
                        '--save-golden', golden, '--cpu'])
run(parity_check.main, ['--checkpoint-path', ck, '--max-new-tokens', 4,
                        '--golden', golden, '--cpu'])
data = Path(tmp) / 'data' / 'spk'
data.mkdir(parents=True)
np.save(data / 'a.npy', rng.integers(0, 32, (4, 9)))
(data / 'a.lab').write_text('a line')
write_wav(data / 'a.wav', 0.1 * rng.standard_normal(4000), 16000)
run(build_dataset.main, ['--input', data.parent, '--output', Path(tmp) / 'protos'])
assert list((Path(tmp) / 'protos').glob('*.protos'))
run(create_train_split.main, [data.parent])
assert (data.parent / 'vq_train_filelist.txt').exists()

bad = sorted(m for m in sys.modules
             if m == 'fish_speech_tpu' or m.startswith('fish_speech_tpu.'))
assert not bad, bad
print('ok')
"""


def test_port_imports_no_jax():
    """Every port module imports with `jax` made unimportable, and so does
    the text-encoding path it loads lazily."""
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "from fish_speech_tpu_torch.generate import build_base_conversation\n"
        "build_base_conversation(None, None)\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_port_runs_without_the_jax_package():
    """The import rule as a test: the port's paths run on the CPU with `jax`
    unimportable, and no `fish_speech_tpu` module is loaded on the way;
    `chip_smoke.py` imports nothing of either."""
    code = _RUN_WITHOUT_JAX.replace("MODULES", repr(PORT_MODULES))
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA")}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, cwd=root)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().endswith("ok")
    src = open(os.path.join(root, "chip_smoke.py")).read()
    assert not re.search(r"^\s*(from|import)\s+(jax|fish_speech_tpu)\b(?!_torch)",
                         src, re.M)
