"""The port's converter (`fish_speech_tpu_torch/convert/`) against the JAX
package's (`fish_speech_tpu/convert/`) on the same inputs:

  * `fold_weight_norm` in both namings, for a conv and a transposed conv,
    equal to torch's weight norm (to rounding) and to JAX's (exactly);
  * `fuse_wqkv` and `remap_fish_qwen3_omni` equal to JAX's;
  * `load_torch_state_dict` over the three upstream layouts (sharded
    safetensors with an index, one `model.safetensors`, `model.pth` with
    `state_dict` and `model.` prefixes) equal to JAX's;
  * `convert_dual_ar` of JAX's `export_dual_ar` of a tiny model (qk-norm
    and an untied head; `fast_dim != dim` and biases): trees exactly JAX's,
    and export then import the identity;
  * `convert_dac` of a synthetic upstream codec (`tests/upstream_state.py`)
    exactly JAX's tree;
  * the CLI's `export-dual-ar`, `dual-ar` and `dac` write `config.json`,
    `model.safetensors`, `tokenizer.json`, `codec_config.json` and
    `codec.safetensors` byte for byte as the JAX CLI does, except where the
    JAX CLI writes transposed views in memory order (a JAX-side fault, kept
    on record here): there, as the JAX package's writer writes the same
    tree made contiguous.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from fish_speech_tpu.config import dac_tiny, dual_ar_tiny
from fish_speech_tpu.convert import cli as jcli
from fish_speech_tpu.convert import dac as jdac
from fish_speech_tpu.convert import dual_ar as jdual
from fish_speech_tpu.convert import torch_state as jts
from fish_speech_tpu.models.dac import init_dac
from fish_speech_tpu.models.dual_ar import init_dual_ar
from fish_speech_tpu.utils.checkpoint import save_dual_ar
from fish_speech_tpu_torch.config import DACConfig, DualARConfig
from fish_speech_tpu_torch.convert import cli as tcli
from fish_speech_tpu_torch.convert import dac as tdac
from fish_speech_tpu_torch.convert import dual_ar as tdual
from fish_speech_tpu_torch.convert import torch_state as tts
from fish_speech_tpu_torch.convert.from_jax import config_from_jax

from tests.upstream_state import upstream_codec_state

torch.set_num_threads(1)


def _assert_same_tree(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def _assert_same_dict(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k])


# -- torch_state --


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("naming", ["parametrizations", "old"])
def test_fold_weight_norm_matches_torch_and_jax(naming, transposed):
    torch.manual_seed(0)
    conv = (torch.nn.ConvTranspose1d(6, 3, 4) if transposed
            else torch.nn.Conv1d(4, 8, 5))
    if naming == "parametrizations":
        wn = torch.nn.utils.parametrizations.weight_norm(conv, dim=0)
        weight = wn.weight
    else:
        wn = torch.nn.utils.weight_norm(conv, dim=0)
        weight = conv.weight_g * conv.weight_v / torch.linalg.vector_norm(
            conv.weight_v, dim=(1, 2), keepdim=True)
    state = {f"c.{k}": v.detach().numpy() for k, v in wn.state_dict().items()}
    assert any(k.endswith(("original0", "weight_g")) for k in state)
    folded = tts.fold_weight_norm(state)
    assert sorted(folded) == ["c.bias", "c.weight"]
    np.testing.assert_allclose(folded["c.weight"], weight.detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    _assert_same_dict(folded, jts.fold_weight_norm(state))


def test_fuse_wqkv_and_remap_equal_jax():
    rng = np.random.default_rng(0)
    state = {
        "text_model.model.layers.0.attention.wq.weight": rng.normal(size=(8, 4)),
        "text_model.model.layers.0.attention.wk.weight": rng.normal(size=(2, 4)),
        "text_model.model.layers.0.attention.wv.weight": rng.normal(size=(2, 4)),
        "text_model.model.norm.weight": rng.normal(size=(4,)),
        "audio_decoder.layers.0.attention.wqkv.weight": rng.normal(size=(6, 4)),
        "audio_decoder.codebook_embeddings.weight": rng.normal(size=(5, 4)),
        "other.weight": rng.normal(size=(3,)),
    }
    remapped = tts.remap_fish_qwen3_omni(state)
    _assert_same_dict(remapped, jts.remap_fish_qwen3_omni(state))
    assert "fast_layers.0.attention.wqkv.weight" in remapped
    assert "codebook_embeddings.weight" in remapped
    fused = tts.fuse_wqkv(remapped)
    want = jts.fuse_wqkv(remapped)
    assert sorted(fused) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(fused[k], want[k])
    assert fused["layers.0.attention.wqkv.weight"].shape == (12, 4)
    # a state dict without the omni prefixes comes back as it was
    assert tts.remap_fish_qwen3_omni({"a": 1}) == {"a": 1}


def _upstream_weights(seed=0):
    rng = np.random.default_rng(seed)
    return {f"layers.{i}.w{j}": rng.normal(size=(3, 2 + j)).astype(np.float32)
            for i in range(3) for j in range(2)} | {
        "norm.weight": rng.normal(size=(5,)).astype(np.float32)}


@pytest.mark.parametrize("layout", ["sharded", "single", "pth_state_dict",
                                    "pth_model_prefix", "file"])
def test_load_torch_state_dict_layouts_equal_jax(tmp_path, layout):
    from safetensors.numpy import save_file

    weights = _upstream_weights()
    keys = sorted(weights)
    if layout == "sharded":
        shards = {"model-00001-of-00002.safetensors": keys[:3],
                  "model-00002-of-00002.safetensors": keys[3:]}
        for name, ks in shards.items():
            save_file({k: weights[k] for k in ks}, str(tmp_path / name))
        index = {"weight_map": {k: n for n, ks in shards.items() for k in ks}}
        (tmp_path / "model.safetensors.index.json").write_text(json.dumps(index))
        path = tmp_path
    elif layout in ("single", "file"):
        save_file(weights, str(tmp_path / "model.safetensors"))
        path = tmp_path if layout == "single" else tmp_path / "model.safetensors"
    else:
        tensors = {k: torch.from_numpy(v) for k, v in weights.items()}
        if layout == "pth_model_prefix":  # bf16 leaves, widened on load
            tensors = {"model." + k: v.to(torch.bfloat16) for k, v in tensors.items()}
            weights = {k: v.float().numpy() for k, v in zip(
                weights, (t for t in tensors.values()))}
        torch.save({"state_dict": tensors}, tmp_path / "model.pth")
        path = tmp_path
    got = tts.load_torch_state_dict(path)
    _assert_same_dict(dict(got), dict(jts.load_torch_state_dict(path)))
    assert sorted(got) == keys
    for k in keys:
        np.testing.assert_array_equal(got[k], weights[k])


def test_load_torch_state_dict_remaps_omni_and_refuses_an_empty_dir(tmp_path):
    from safetensors.numpy import save_file

    save_file({"text_model.model.norm.weight": np.ones(3, np.float32)},
              str(tmp_path / "model.safetensors"))
    assert list(tts.load_torch_state_dict(tmp_path)) == ["norm.weight"]
    with pytest.raises(FileNotFoundError):
        tts.load_torch_state_dict(tmp_path / "missing")
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        tts.load_torch_state_dict(tmp_path / "empty")


# -- dual_ar --


DUAL_AR_CASES = {
    "qk_norm_untied": dict(attention_qk_norm=True, tie_word_embeddings=False),
    "fast_dim_biases": dict(fast_dim=48, attention_qkv_bias=True,
                            attention_o_bias=True, fast_attention_qkv_bias=True,
                            fast_attention_o_bias=True),
}


def _jax_dual_ar(case, seed=0):
    cfg = dual_ar_tiny(semantic_begin_id=300, semantic_end_id=331, im_end_id=3,
                       **DUAL_AR_CASES[case])
    params = init_dual_ar(jax.random.PRNGKey(seed), cfg, dtype=jnp.float32)
    return jax.tree_util.tree_map(np.asarray, params), cfg


@pytest.mark.parametrize("case", sorted(DUAL_AR_CASES))
def test_convert_dual_ar_equals_jax(case):
    params, jcfg = _jax_dual_ar(case)
    cfg = config_from_jax(jcfg, DualARConfig)
    state = jdual.export_dual_ar(params, jcfg)
    got = tdual.convert_dual_ar(state, cfg)
    _assert_same_tree(got, jdual.convert_dual_ar(state, jcfg))
    _assert_same_tree(got, params)  # export then import: the identity
    if case == "fast_dim_biases":
        assert "project_in" in got["fast"] and "bqkv" in got["layers"]
    else:
        assert "output" in got and "q_norm" in got["layers"]
    # the port's export, from numpy leaves and from torch tensors (bf16
    # widened exactly), is JAX's
    _assert_same_dict(tdual.export_dual_ar(params, cfg), state)
    tensors = jax.tree_util.tree_map(torch.from_numpy, params)
    _assert_same_dict(tdual.export_dual_ar(tensors, cfg), state)
    bf16 = jax.tree_util.tree_map(lambda t: t.to(torch.bfloat16), tensors)
    want = jdual.export_dual_ar(jax.tree_util.tree_map(
        lambda t: t.float().numpy(), bf16), jcfg)
    _assert_same_dict(tdual.export_dual_ar(bf16, cfg), want)


# -- dac --


def test_convert_dac_equals_jax():
    jcfg = dac_tiny()
    params = jax.tree_util.tree_map(
        np.asarray, init_dac(jax.random.PRNGKey(0), jcfg, jnp.float32))
    state = upstream_codec_state(params, jcfg)
    assert any(k.endswith(".weight_g") for k in state)
    assert any(k.endswith(".original0") for k in state)
    got = tdac.convert_dac(state, config_from_jax(jcfg, DACConfig))
    _assert_same_tree(got, jdac.convert_dac(state, jcfg))
    # the fold recovers the weights to rounding
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


# -- the CLI --
#
# The JAX CLI's `dual-ar` and `dac` hand safetensors' `save_file` the
# converters' transposed numpy views (`convert/dual_ar.py:_stack`,
# `convert/dac.py:_conv`), and this safetensors writes each tensor from its
# data pointer, so those leaves land in memory order (ROADMAP §3, a JAX-side
# fault, recorded by `test_jax_cli_writes_transposed_views_in_memory_order`).
# The port's files are held to the JAX package's writer on the same tree
# made contiguous (`_jax_files`), the bytes the JAX CLI means to write.


def _files_equal(a, b, names):
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


def _contiguous(tree):
    return jax.tree_util.tree_map(np.ascontiguousarray, tree)


def _upstream_dual_ar(tmp_path, tokenizer, case):
    """A native JAX checkpoint of the case's tiny model, its upstream
    (torch-layout) export by both CLIs, and the export with the tokenizer."""
    params, jcfg = _jax_dual_ar(case, seed=1)
    native = tmp_path / "native"
    save_dual_ar(native, jax.tree_util.tree_map(jnp.asarray, params), jcfg,
                 tokenizer)
    runner = CliRunner()
    for name, group in (("jax", jcli.cli), ("port", tcli.cli)):
        r = runner.invoke(group, ["export-dual-ar", "--input", str(native),
                                  "--output", str(tmp_path / f"{name}_export")],
                          catch_exceptions=False)
        assert r.exit_code == 0, r.output
    upstream = tmp_path / "jax_export"
    tokenizer.save_pretrained(str(upstream))
    return native, upstream, jcfg


@pytest.mark.parametrize("case", sorted(DUAL_AR_CASES))
def test_cli_dual_ar_writes_the_jax_package_bytes(tmp_path, tokenizer, case):
    from fish_speech_tpu.utils.checkpoint import save_params

    native, upstream, jcfg = _upstream_dual_ar(tmp_path, tokenizer, case)
    _files_equal(upstream, tmp_path / "port_export",
                 ("config.json", "model.safetensors"))
    runner = CliRunner()
    for name, group in (("jax", jcli.cli), ("port", tcli.cli)):
        r = runner.invoke(group, ["dual-ar", "--input", str(upstream),
                                  "--output", str(tmp_path / f"{name}_native")],
                          catch_exceptions=False)
        assert r.exit_code == 0, r.output
    _files_equal(tmp_path / "jax_native", tmp_path / "port_native",
                 ("config.json", "tokenizer.json"))
    want = tmp_path / "jax_contiguous"
    save_params(want, _contiguous(jdual.convert_dual_ar(upstream, jcfg)))
    _files_equal(want, tmp_path / "port_native", ("model.safetensors",))
    # native -> export -> native gives back the first native file's bytes
    # (its leaves are fp32)
    _files_equal(native, tmp_path / "port_native", ("model.safetensors",))


def _codec_pth(tmp_path, seed):
    jcfg = dac_tiny()
    params = jax.tree_util.tree_map(
        np.asarray, init_dac(jax.random.PRNGKey(seed), jcfg, jnp.float32))
    state = upstream_codec_state(params, jcfg, seed=seed + 1)
    torch.save({k: torch.from_numpy(v) for k, v in state.items()},
               tmp_path / "codec.pth")
    return tmp_path / "codec.pth", jcfg


def test_cli_dac_writes_the_jax_package_bytes(tmp_path):
    from fish_speech_tpu.utils.checkpoint import save_dac

    pth, jcfg = _codec_pth(tmp_path, 2)
    runner = CliRunner()
    for name, group in (("jax", jcli.cli), ("port", tcli.cli)):
        r = runner.invoke(group, ["dac", "--input", str(pth),
                                  "--output", str(tmp_path / name),
                                  "--config", "tiny"], catch_exceptions=False)
        assert r.exit_code == 0, r.output
    _files_equal(tmp_path / "jax", tmp_path / "port", ("codec_config.json",))
    save_dac(tmp_path / "want", _contiguous(jdac.convert_dac(str(pth), jcfg)), jcfg)
    _files_equal(tmp_path / "want", tmp_path / "port",
                 ("codec_config.json", "codec.safetensors"))


def test_jax_cli_writes_transposed_views_in_memory_order(tmp_path, tokenizer):
    """The JAX-side fault, recorded: each leaf of the JAX CLI's files that
    the converter left as a non-contiguous view holds the view's memory
    order, not its values; every other leaf is right."""
    from safetensors.numpy import load_file

    from fish_speech_tpu.utils.checkpoint import flatten_pytree

    _, upstream, jcfg = _upstream_dual_ar(tmp_path, tokenizer, "fast_dim_biases")
    pth, dac_cfg = _codec_pth(tmp_path, 4)
    runner = CliRunner()
    for args in (["dual-ar", "--input", str(upstream)],
                 ["dac", "--input", str(pth), "--config", "tiny"]):
        r = runner.invoke(jcli.cli, args + ["--output", str(tmp_path / "jax")],
                          catch_exceptions=False)
        assert r.exit_code == 0, r.output
    for name, tree in (
            ("model.safetensors", jdual.convert_dual_ar(upstream, jcfg)),
            ("codec.safetensors", jdac.convert_dac(str(pth), dac_cfg))):
        written = load_file(str(tmp_path / "jax" / name))
        views = 0
        for key, leaf in flatten_pytree(tree).items():
            if leaf.flags.c_contiguous:
                np.testing.assert_array_equal(written[key], leaf)
            else:
                views += 1
                np.testing.assert_array_equal(written[key].ravel(),
                                              leaf.ravel(order="K"))
                assert not np.array_equal(written[key], leaf), key
        assert views > 0
