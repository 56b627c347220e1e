"""The port's checkpoint writers and checkpoint tools against the JAX
package's on the same inputs (CPU, tiny configs):

  * `save_params`, `save_dual_ar` and `save_dac` write the JAX writers'
    bytes for the same tree (bf16, fp32, int8 `q` and uint8 `p` leaves,
    lists); `save_codec` then `load_codec` is the identity, and
    `save_codec` of the bridged torch layout writes JAX's `save_dac` bytes;
  * `tools.quantize` (int8; int4 at `--group-size` 128 and at 512, which
    every weight must halve) writes JAX's tool's tree: the same keys,
    dtypes and shapes, equal integers, scales within 1 fp32 ulp;
  * `tools.merge_lora` over a port trainer checkpoint (LoRA leaves from
    JAX's `add_lora` with random B) gives JAX's `merge_lora` to 1e-6
    relative and prints the L1 line;
  * `tools.parity_check --cpu` passes a golden saved by the JAX tool
    (`PARITY OK`), fails a perturbed checkpoint with `MISMATCH` (exit 1),
    and reports JAX's keys.
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from fish_speech_tpu.config import dac_tiny, dual_ar_tiny
from fish_speech_tpu.models import lora as jlora
from fish_speech_tpu.models.dac import init_dac
from fish_speech_tpu.models.dual_ar import init_dual_ar
from fish_speech_tpu.utils import checkpoint as jckpt
from fish_speech_tpu_torch.config import DACConfig, DualARConfig
from fish_speech_tpu_torch.convert.from_jax import (config_from_jax, dac_from_jax,
                                                    dual_ar_from_jax)
from fish_speech_tpu_torch.models.dac.model import init_dac as tinit_dac
from fish_speech_tpu_torch.tokenizer import build_test_tokenizer
from fish_speech_tpu_torch.utils import checkpoint as tckpt

from tests.test_parity_check import make_ckpt

torch.set_num_threads(1)


def _to_torch(tree):
    """A JAX tree (numpy leaves) as torch CPU tensors, dtypes kept (bf16
    through fp32, exactly)."""
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_torch(v) for v in tree]
    a = np.asarray(tree)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    t = np.asarray(t)
    return t.astype(np.float32) if t.dtype == jnp.bfloat16 else t


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def _mixed_tree(seed=0):
    """Every leaf kind a checkpoint holds: bf16 and fp32 weights, an int8
    {"q", "s"} and an int4 {"p", "gs"} weight, a list, a scalar table."""
    rng = np.random.default_rng(seed)
    return {
        "embeddings": jnp.asarray(rng.normal(size=(12, 8)), jnp.bfloat16),
        "norm": jnp.asarray(rng.normal(size=(8,)), jnp.float32),
        "layers": {
            "wqkv": {"q": jnp.asarray(rng.integers(-128, 128, (2, 8, 24)), jnp.int8),
                     "s": jnp.asarray(rng.uniform(0.01, 1, (2, 24)), jnp.float32)},
            "w2": {"p": jnp.asarray(rng.integers(0, 256, (2, 8, 8)), jnp.uint8),
                   "gs": jnp.asarray(rng.uniform(0.01, 1, (2, 2, 8)), jnp.float32)},
        },
        "stack": [jnp.asarray(rng.normal(size=(3, 4)), jnp.float32),
                  jnp.asarray(rng.normal(size=(5,)), jnp.bfloat16)],
    }


# -- writers --


def test_save_params_writes_the_jax_bytes(tmp_path):
    tree = _mixed_tree()
    jckpt.save_params(tmp_path / "jax", tree)
    port = _to_torch(jax.tree_util.tree_map(np.asarray, tree))
    assert port["embeddings"].dtype == torch.bfloat16
    tckpt.save_params(tmp_path / "port", port)
    want = (tmp_path / "jax" / "model.safetensors").read_bytes()
    assert (tmp_path / "port" / "model.safetensors").read_bytes() == want
    # and it reads back as written: integer leaves integer, bf16 bf16
    back = tckpt.load_params(tmp_path / "port", device="cpu")
    got, ref = _leaves(back), _leaves(port)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        assert torch.equal(got[k], ref[k]), k
    # numpy leaves (the converter's), transposed views too, write the same
    # bytes as the tensors
    f32 = {"w": np.arange(12, dtype=np.float32).reshape(3, 4).T, "b": np.ones(2)}
    tckpt.save_params(tmp_path / "np", f32)
    tckpt.save_params(tmp_path / "t", {k: torch.from_numpy(np.ascontiguousarray(v))
                                       for k, v in f32.items()})
    assert ((tmp_path / "np" / "model.safetensors").read_bytes()
            == (tmp_path / "t" / "model.safetensors").read_bytes())
    back = tckpt.load_params(tmp_path / "np", device="cpu")
    np.testing.assert_array_equal(back["w"].numpy(), f32["w"])


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
def test_save_dual_ar_writes_the_jax_bytes(tmp_path, tokenizer, dtype):
    jcfg = dual_ar_tiny(attention_qk_norm=True, tie_word_embeddings=False)
    params = init_dual_ar(jax.random.PRNGKey(0), jcfg, dtype=dtype)
    jckpt.save_dual_ar(tmp_path / "jax", params, jcfg, tokenizer)
    port = _to_torch(jax.tree_util.tree_map(np.asarray, params))
    tckpt.save_dual_ar(tmp_path / "port", port, config_from_jax(jcfg, DualARConfig),
                       build_test_tokenizer())
    for name in ("config.json", "model.safetensors", "tokenizer.json"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name
    back, cfg = tckpt.load_dual_ar(tmp_path / "port", dtype=None, device="cpu")
    assert cfg == config_from_jax(jcfg, DualARConfig)
    for k, v in _leaves(port).items():
        assert torch.equal(_leaves(back)[k], v), k


def test_save_dac_and_save_codec_write_the_jax_bytes(tmp_path):
    jcfg = dac_tiny()
    cfg = config_from_jax(jcfg, DACConfig)
    params = init_dac(jax.random.PRNGKey(0), jcfg, jnp.float32)
    jckpt.save_dac(tmp_path / "jax", params, jcfg)
    stored = jax.tree_util.tree_map(np.asarray, params)
    tckpt.save_dac(tmp_path / "port", _to_torch(stored), cfg)
    # the torch layout (the bridge's) goes back to the stored one
    tckpt.save_codec(tmp_path / "codec", dac_from_jax(stored, device="cpu"), cfg)
    for name in ("codec_config.json", "codec.safetensors"):
        want = (tmp_path / "jax" / name).read_bytes()
        assert (tmp_path / "port" / name).read_bytes() == want, name
        assert (tmp_path / "codec" / name).read_bytes() == want, name


def test_save_codec_then_load_codec_is_the_identity(tmp_path):
    from fish_speech_tpu_torch.config import dac_tiny as tdac_tiny

    cfg = tdac_tiny()
    params = tinit_dac(1, cfg, device="cpu")
    tckpt.save_codec(tmp_path, params, cfg)
    back, cfg2 = tckpt.load_codec(tmp_path, device="cpu")
    assert cfg2 == cfg
    got, want = _leaves(back), _leaves(params)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape and torch.equal(got[k], want[k]), k


# -- tools.quantize --


def _quant_cfg(tokenizer):
    # widths at which a 128 group fits some weights and is halved for others
    return dual_ar_tiny(vocab_size=tokenizer.vocab_size, dim=256,
                        intermediate_size=512, fast_dim=128,
                        fast_intermediate_size=256, tie_word_embeddings=False,
                        semantic_begin_id=tokenizer.semantic_begin_id,
                        semantic_end_id=tokenizer.semantic_end_id,
                        im_end_id=tokenizer.im_end_id)


def _tree_close(got, want):
    """Same keys, dtypes and shapes; equal integers; floating leaves within
    1 fp32 ulp (rtol 2^-23): `tests/test_torch_quant.py`'s rule."""
    got, want = _leaves(got), _leaves(want)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        gd = str(g.dtype).split(".")[-1]
        assert gd == np.asarray(w).dtype.name, k
        g, w = _np(g), _np(w)
        assert g.shape == w.shape, k
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=2.0 ** -23, atol=0, err_msg=k)


@pytest.mark.parametrize("mode,group_size", [("int8", 128), ("int4", 128),
                                             ("int4", 512)])
def test_quantize_tool_writes_the_jax_tools_tree(tmp_path, tokenizer, mode,
                                                 group_size):
    from fish_speech_tpu.tools.quantize import main as jax_main
    from fish_speech_tpu_torch.tools.quantize import main

    jcfg = _quant_cfg(tokenizer)
    src = tmp_path / "ckpt"
    jckpt.save_dual_ar(src, init_dual_ar(jax.random.PRNGKey(0), jcfg, jnp.bfloat16),
                       jcfg, tokenizer)
    jckpt.save_dac(src, init_dac(jax.random.PRNGKey(1), dac_tiny(), jnp.float32),
                   dac_tiny())
    runner = CliRunner()
    args = ["--checkpoint-path", str(src), "--mode", mode,
            "--group-size", str(group_size)]
    r = runner.invoke(jax_main, args + ["--output", str(tmp_path / "jax")],
                      catch_exceptions=False)
    assert r.exit_code == 0, r.output
    r = runner.invoke(main, args + ["--output", str(tmp_path / "port"), "--cpu"],
                      catch_exceptions=False)
    assert r.exit_code == 0, r.output
    want = jckpt.load_params(tmp_path / "jax")
    got = tckpt.load_params(tmp_path / "port", device="cpu")
    _tree_close(got, want)
    if mode == "int4":  # the halving rule cut the group for some weights
        leaves = _leaves(got)
        groups = [2 * leaves[k[:-3] + "/p"].shape[-2] // v.shape[-2]
                  for k, v in leaves.items() if k.endswith("/gs")]
        assert max(groups) <= group_size and min(groups) < group_size
    for name in ("tokenizer.json", "codec.safetensors", "codec_config.json"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (src / name).read_bytes()), name
    assert (tmp_path / "port" / "config.json").read_bytes() == (
        tmp_path / "jax" / "config.json").read_bytes()


@pytest.mark.parametrize("tool", ["quantize", "merge_lora", "parity_check"])
def test_tools_refuse_cuda_without_a_card(tmp_path, tool):
    """Without `--cpu` each computing tool runs on cuda:0, and raises where
    there is no CUDA device."""
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    jcfg = dual_ar_tiny()
    ckpt = tmp_path / "ckpt"
    jckpt.save_dual_ar(ckpt, init_dual_ar(jax.random.PRNGKey(0), jcfg), jcfg)
    args = {"quantize": ["--checkpoint-path", ckpt],
            "merge_lora": ["--base", ckpt, "--lora", tmp_path, "--lora-r", "2",
                           "--lora-alpha", "4", "--output", tmp_path / "out"],
            "parity_check": ["--checkpoint-path", ckpt]}[tool]
    main = importlib.import_module(f"fish_speech_tpu_torch.tools.{tool}").main
    r = CliRunner().invoke(main, [str(a) for a in args])
    assert r.exit_code != 0 and "no CUDA device" in str(r.exception)


# -- tools.merge_lora --


def test_merge_lora_tool_matches_jax_merge(tmp_path, tokenizer):
    from fish_speech_tpu_torch.tools.merge_lora import main

    jcfg = dual_ar_tiny(vocab_size=tokenizer.vocab_size, tie_word_embeddings=False,
                        semantic_begin_id=tokenizer.semantic_begin_id,
                        semantic_end_id=tokenizer.semantic_end_id,
                        im_end_id=tokenizer.im_end_id)
    params = init_dual_ar(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    jckpt.save_dual_ar(tmp_path / "base", params, jcfg, tokenizer)
    lcfg = jlora.LoraConfig(r=4, lora_alpha=8.0)
    with_lora = jlora.add_lora(params, jcfg, lcfg, jax.random.PRNGKey(1),
                               dtype=jnp.float32)
    rng = np.random.default_rng(2)

    def random_b(path, x):
        last = getattr(path[-1], "key", None)
        if last == "b" and any("lora" in str(getattr(p, "key", "")) for p in path):
            return jnp.asarray(rng.normal(size=x.shape) * 0.1, x.dtype)
        return x

    with_lora = jax.tree_util.tree_map_with_path(random_b, with_lora)
    # the trainer's checkpoint: state.pt of the LoRA leaves, then meta.json
    step = tmp_path / "run" / "checkpoints" / "step_00000002"
    step.mkdir(parents=True)
    lora_leaves = jax.tree_util.tree_map(np.asarray, jlora.extract_lora(with_lora))
    torch.save({"params": dual_ar_from_jax(lora_leaves, torch.float32, "cpu"),
                "opt_state": {}}, step / "state.pt")
    (step / "meta.json").write_text(json.dumps({"step": 2}))

    r = CliRunner().invoke(main, [
        "--base", str(tmp_path / "base"), "--lora", str(step), "--lora-r", "4",
        "--lora-alpha", "8", "--output", str(tmp_path / "merged"), "--cpu"],
        catch_exceptions=False)
    assert r.exit_code == 0, r.output
    l1 = float(re.search(r"L1 delta on layers\.0\.wqkv after merge: ([0-9.]+)",
                         r.output).group(1))
    assert l1 > 0
    got, cfg = tckpt.load_dual_ar(tmp_path / "merged", dtype=None, device="cpu")
    assert cfg == config_from_jax(jcfg, DualARConfig)
    want = jlora.merge_lora(with_lora, jlora.apply_lora_config(jcfg, lcfg))
    got, want = _leaves(got), _leaves(want)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(w).max()), err_msg=k)
    assert (tmp_path / "merged" / "tokenizer.json").exists()


# -- tools.parity_check --


def _report_keys(report):
    if isinstance(report, dict):
        return {k: _report_keys(v) for k, v in report.items()}
    return type(report).__name__


def test_parity_check_passes_a_jax_golden_and_fails_a_perturbed_model(
        tmp_path, tokenizer):
    from fish_speech_tpu.tools.parity_check import main as jax_main
    from fish_speech_tpu_torch.tools.parity_check import main

    ckpt = make_ckpt(tmp_path / "ckpt", tokenizer, seed=0)
    golden = tmp_path / "golden.json"
    runner = CliRunner()
    r = runner.invoke(jax_main, ["--checkpoint-path", str(ckpt),
                                 "--max-new-tokens", "6", "--save-golden",
                                 str(golden), "--cpu"], catch_exceptions=False)
    assert r.exit_code == 0 and golden.exists()
    r = runner.invoke(main, ["--checkpoint-path", str(ckpt), "--max-new-tokens",
                             "6", "--golden", str(golden), "--cpu",
                             "--save-golden", str(tmp_path / "port.json")],
                      catch_exceptions=False)
    assert r.exit_code == 0, r.output
    assert "PARITY OK" in r.output
    want = json.loads(golden.read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert _report_keys(got) == _report_keys(want)
    assert got["greedy_decode"]["n_frames"] > 0

    other = make_ckpt(tmp_path / "other", tokenizer, seed=123)
    r = runner.invoke(main, ["--checkpoint-path", str(other), "--max-new-tokens",
                             "6", "--golden", str(golden), "--cpu"])
    assert r.exit_code == 1
    assert "MISMATCH" in r.output and "PARITY OK" not in r.output
