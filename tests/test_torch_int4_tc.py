"""The int4 matmul's tensor-core route and the trainer's device, on the CPU.

The port's "wgmma" route (bf16 x, more than 8 rows) dequantizes W as the
Pallas TPU kernel does. Its plain version is held to that kernel, run in
interpret mode on the same numpy inputs:

  * `int4_dequant_bf16` is bitwise the Pallas kernel's W, read out by
    feeding it x = the bf16 identity (each output row is one W row, summed
    with zeros in fp32 and cast to bf16, so exact);
  * `int4_matmul_bf16w_reference` agrees with the Pallas kernel on bf16 x
    to one bf16 step of y (2^-7 |y|: both round an fp32 sum to bf16, and
    sums in another order can land one step apart) plus 1e-5 of
    |x| @ |W| (the order of the fp32 sums);
  * `_route` sends up to 8 rows to the matvec kernel, more bf16 rows to the
    tensor cores and more fp32 rows to the CUDA-core tiled kernel.

The training CLI without `--cpu` and `Trainer` without a device never train
on the CPU: on a machine without CUDA both raise.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_speech_tpu.ops import quant as jquant
from fish_speech_tpu.ops.pallas_int4 import int4_matmul as j_int4_matmul
from fish_speech_tpu_torch.ops import int4 as tint4
from fish_speech_tpu_torch.ops.int4 import (_route, int4_dequant_bf16,
                                             int4_matmul_bf16w_reference)
from fish_speech_tpu_torch.train.trainer import TrainConfig, Trainer

from tests.test_data import make_proto_file

torch.set_num_threads(1)
no_cuda = pytest.mark.skipif(torch.cuda.is_available(),
                             reason="shows what happens without a CUDA device")


def _packed(i, o, g, seed):
    w = np.random.default_rng(seed).standard_normal((i, o)).astype(np.float32)
    qw = jquant.quantize_int4(jnp.asarray(w * 0.05), group_size=g)
    return np.array(qw["p"]), np.array(qw["gs"])


def _bf16_np(t):
    return np.asarray(t.astype(jnp.float32))


@pytest.mark.parametrize("i,o,g", [(256, 136, 64), (512, 200, 128), (128, 264, 32)])
def test_int4_dequant_bf16_is_the_pallas_kernels_weight(i, o, g):
    p, gs = _packed(i, o, g, seed=i + o)
    kern_w = j_int4_matmul(jnp.eye(i, dtype=jnp.bfloat16), jnp.asarray(p),
                           jnp.asarray(gs), interpret=True)
    got = int4_dequant_bf16(torch.from_numpy(p), torch.from_numpy(gs))
    assert got.dtype == torch.bfloat16 and got.shape == (i, o)
    np.testing.assert_array_equal(got.float().numpy(), _bf16_np(kern_w))


def test_the_pallas_weight_is_not_the_fp32_weight_rounded():
    """rn_bf16(q * rn_bf16(s)) and rn_bf16(q * s) differ in some elements:
    the route's W has to round the scale first, as the TPU kernel does."""
    p, gs = _packed(256, 136, 64, seed=1)
    tp, tgs = torch.from_numpy(p), torch.from_numpy(gs)
    w_fp32 = tint4.int4_matmul_reference(torch.eye(256), tp, tgs)
    differ = (int4_dequant_bf16(tp, tgs) != w_fp32.to(torch.bfloat16)).float()
    assert 0.0 < differ.mean().item() < 0.5


@pytest.mark.parametrize("b", [1, 8, 9, 130, 300])
def test_bf16w_reference_matches_the_pallas_kernel(b):
    i, o, g = 256, 136, 64
    p, gs = _packed(i, o, g, seed=b)
    x = np.random.default_rng(b + 1).standard_normal((b, i)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    # B = 1 runs as the first of two rows on the JAX side: on the CPU, XLA
    # rewrites a one-row dot into a multiply in bf16 and a sum, which rounds
    # every product (the TPU's matrix unit sums exact products in fp32)
    xj = np.concatenate([x, np.zeros_like(x)]) if b == 1 else x
    kern = _bf16_np(j_int4_matmul(jnp.asarray(xj, dtype=jnp.bfloat16),
                                  jnp.asarray(p), jnp.asarray(gs),
                                  interpret=True))[:b]
    got = int4_matmul_bf16w_reference(xb, torch.from_numpy(p),
                                      torch.from_numpy(gs))
    assert got.dtype == torch.bfloat16 and got.shape == (b, o)
    w = int4_dequant_bf16(torch.from_numpy(p), torch.from_numpy(gs)).float()
    scale = (xb.float().abs() @ w.abs()).numpy()
    err = np.abs(got.float().numpy() - kern)
    assert (err <= 2.0 ** -7 * np.abs(kern) + 1e-5 * scale).all(), err.max()


@pytest.mark.parametrize("b,dtype,route", [
    (1, torch.bfloat16, "gemv"), (8, torch.bfloat16, "gemv"),
    (9, torch.bfloat16, "wgmma"), (1024, torch.bfloat16, "wgmma"),
    (1, torch.float32, "gemv"), (8, torch.float32, "gemv"),
    (9, torch.float32, "fp32_tiled"), (1024, torch.float32, "fp32_tiled"),
])
def test_route_by_rows_and_dtype(b, dtype, route):
    assert _route(b, dtype) == route
    assert route in tint4.ROUTES


def test_reset_launches_zeroes_every_route():
    for name in ("launches", *(f"launches_{r}" for r in tint4.ROUTES)):
        setattr(tint4.int4_matmul, name, 5)
    tint4.reset_launches()
    assert tint4.int4_matmul.launches == 0
    assert all(getattr(tint4.int4_matmul, f"launches_{r}") == 0
               for r in tint4.ROUTES)


def test_trainer_defaults_to_the_card():
    assert inspect.signature(Trainer).parameters["device"].default == "cuda:0"


@no_cuda
def test_trainer_without_a_device_raises_without_cuda(tmp_path):
    from fish_speech_tpu_torch.config import dual_ar_tiny

    tcfg = TrainConfig(output_dir=str(tmp_path), project="t", max_steps=1,
                       precision="float32")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(dual_ar_tiny(), tcfg)


@no_cuda
def test_cli_without_cpu_raises_without_cuda(tmp_path):
    from click.testing import CliRunner

    from fish_speech_tpu_torch.train.cli import main

    proto = make_proto_file(tmp_path / "d.protos")
    out = tmp_path / "out"
    res = CliRunner().invoke(main, [
        "--data", str(proto), "--output", str(out), "--max-steps", "1",
        "--batch-size", "2", "--max-length", "128", "--tiny",
        "--precision", "float32"])
    assert res.exit_code != 0 and "--cpu" in res.output, res.output
    assert not out.exists()
