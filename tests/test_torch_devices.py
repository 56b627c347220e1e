"""Where the port's initialisers and loaders place what they make, on the CPU.

Every entry point runs on the card unless the caller asks for the CPU:
`init_dual_ar`, `init_dac`, `init_dac_decoder`, `dual_ar_from_jax`,
`dac_from_jax`, `dac_decoder_from_jax`, `load_params`, `load_dual_ar` and
`faststack.make_weights` default to `cuda:0`. Where CUDA is absent, that
default (or any CUDA device asked for) raises, and `device="cpu"` builds on
the CPU. The probe's `__main__` asks for the card whatever the machine has.
Whether there is a card is decided inside each test: with one, the default
must land on it.
"""

import inspect
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_speech_tpu.config import dac_tiny as j_dac_tiny
from fish_speech_tpu.config import dual_ar_tiny as j_dual_ar_tiny
from fish_speech_tpu.models.dac import init_dac
from fish_speech_tpu.utils.checkpoint import save_dual_ar
from fish_speech_tpu_torch.config import dac_tiny, dual_ar_tiny
from fish_speech_tpu_torch.convert.from_jax import (dac_decoder_from_jax,
                                                    dac_from_jax,
                                                    dual_ar_from_jax,
                                                    init_dac_decoder)
from fish_speech_tpu_torch.models.dac.model import init_dac as t_init_dac
from fish_speech_tpu_torch.models.dual_ar import init_dual_ar
from fish_speech_tpu_torch.ops import faststack
from fish_speech_tpu_torch.utils.checkpoint import load_dual_ar, load_params

ROOT = Path(__file__).resolve().parent.parent


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A native checkpoint of the tiny LM, written by the JAX package."""
    path = tmp_path_factory.mktemp("ckpt")
    cfg = j_dual_ar_tiny()
    params = init_dual_ar(0, dual_ar_tiny(), torch.float32, "cpu")
    save_dual_ar(path, jax.tree_util.tree_map(lambda t: t.numpy(), params), cfg)
    return path


def _makers(checkpoint):
    """name -> a call of the initialiser or loader with `device` given or not."""
    lm = init_dual_ar(0, dual_ar_tiny(), torch.float32, "cpu")
    lm_np = jax.tree_util.tree_map(lambda t: t.numpy(), lm)
    dac_np = jax.tree_util.tree_map(
        np.asarray, init_dac(jax.random.PRNGKey(1), j_dac_tiny(), dtype=jnp.float32))
    dims = faststack.ProbeDims(64, 128, 64, 2, 2)
    return {
        "init_dual_ar": lambda **kw: init_dual_ar(0, dual_ar_tiny(), torch.float32, **kw),
        "init_dac": lambda **kw: t_init_dac(1, dac_tiny(), **kw),
        "init_dac_decoder": lambda **kw: init_dac_decoder(1, dac_tiny(), **kw),
        "dac_from_jax": lambda **kw: dac_from_jax(dac_np, **kw),
        "dual_ar_from_jax": lambda **kw: dual_ar_from_jax(lm_np, torch.float32, **kw),
        "dac_decoder_from_jax": lambda **kw: dac_decoder_from_jax(dac_np, **kw),
        "load_params": lambda **kw: load_params(checkpoint, **kw),
        "load_dual_ar": lambda **kw: load_dual_ar(checkpoint, **kw)[0],
        "make_weights": lambda **kw: faststack.make_weights(dims, **kw),
    }


FUNCTIONS = {"init_dual_ar": init_dual_ar, "init_dac": t_init_dac,
             "init_dac_decoder": init_dac_decoder,
             "dual_ar_from_jax": dual_ar_from_jax, "dac_from_jax": dac_from_jax,
             "dac_decoder_from_jax": dac_decoder_from_jax,
             "load_params": load_params, "load_dual_ar": load_dual_ar,
             "make_weights": faststack.make_weights}
NAMES = list(FUNCTIONS)


@pytest.mark.parametrize("name", NAMES)
def test_default_device_is_the_card(name):
    assert inspect.signature(FUNCTIONS[name]).parameters["device"].default == "cuda:0"


@pytest.mark.parametrize("name", NAMES)
def test_maker_raises_without_cuda_and_runs_on_the_cpu(checkpoint, name):
    build = _makers(checkpoint)[name]
    if torch.cuda.is_available():
        assert all(x.is_cuda for x in _leaves(build()))
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build(device="cuda:0")
    leaves = _leaves(build(device="cpu"))
    assert leaves and all(x.device.type == "cpu" for x in leaves)


def test_probe_main_asks_for_the_card():
    """`python -m fish_speech_tpu_torch.ops.faststack` has no CPU branch:
    without CUDA it stops before measuring anything."""
    if torch.cuda.is_available():
        pytest.skip("runs the probe's measurement where there is a card")
    proc = subprocess.run(
        [sys.executable, "-m", "fish_speech_tpu_torch.ops.faststack", "0", "bf16"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "ms/frame" not in proc.stdout
