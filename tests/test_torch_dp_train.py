"""Data-, tensor- and ZeRO-1-parallel training of the port (gloo ranks on
the CPU) against the JAX package's trainer on the same (dp, tp) mesh of
virtual CPU devices, on the same weights and global batches: losses within
2e-5 and grad norms within 2e-4 (JAX's own tolerances,
`tests/test_multihost.py:160-164`), parameters after 3 steps within 1e-5.
ZeRO-1 keeps 1/dp of AdamW's m and v on each rank; its checkpoint holds
what the single-process trainer's holds, and a trainer resumed from it
lands where the uninterrupted run does. LoRA runs under tp=2 with its
replicated leaves' gradients whole on every rank."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_speech_tpu.config import dual_ar_tiny
from fish_speech_tpu.models import dual_ar as jdual
from fish_speech_tpu.models import lora as jlora
from fish_speech_tpu.parallel.mesh import (dual_ar_param_specs, make_mesh,
                                           to_named)
from fish_speech_tpu.train import step as jstep
from fish_speech_tpu.train.trainer import TrainConfig as JTrainConfig
from fish_speech_tpu.train.trainer import Trainer as JTrainer
from fish_speech_tpu_torch.config import DualARConfig
from fish_speech_tpu_torch.convert.from_jax import (config_from_jax,
                                                    dual_ar_from_jax)
from fish_speech_tpu_torch.train.trainer import TrainConfig, Trainer
from tests.test_torch_train import _flat, make_batch
from tests.torch_dist_worker import spawn_ranks

torch.set_num_threads(1)

STEPS = 3
LR = 1e-3


def _cfg():
    return dual_ar_tiny(
        semantic_begin_id=300, semantic_end_id=331, im_end_id=3,
        n_head=4, n_local_heads=2, head_dim=32, dim=128,
        intermediate_size=256, attention_qk_norm=True,
        tie_word_embeddings=False, fast_n_head=2, fast_n_local_heads=2,
        fast_head_dim=16, fast_dim=64, fast_intermediate_size=128,
        max_seq_len=64)


def _tcfg(cls, out, **kw):
    return cls(output_dir=str(out), project="p", max_steps=10, batch_size=4,
               max_length=64, lr=LR, warmup_steps=1, precision="float32",
               val_every_steps=1000, **kw)


def _batches(cfg):
    return [make_batch(cfg, seed=20 + i, b=4, t=24) for i in range(STEPS)]


def _jax_run(cfg, params, dp, tp, zero1, tmp):
    mesh = make_mesh(jax.devices()[:dp * tp], dp=dp, tp=tp)
    tr = JTrainer(cfg, _tcfg(JTrainConfig, tmp, dp=dp, tp=tp, zero1=zero1),
                  params=params, mesh=mesh)
    metrics = []
    for batch in _batches(cfg):
        tr.params, tr.opt_state, m = tr.train_step(
            tr.params, tr.opt_state, tr._place_batch(batch, tr.bspecs))
        metrics.append({k: float(v) for k, v in m.items()})
    adam = next(x for x in jax.tree_util.tree_leaves(
        tr.opt_state, is_leaf=lambda x: hasattr(x, "nu")) if hasattr(x, "nu"))
    # AdamW's bias-corrected second moment: |gradient| of each element
    rms = jax.tree_util.tree_map(
        lambda v: np.sqrt(np.asarray(v) / (1 - tr.train_cfg.betas[1] ** STEPS)),
        adam.nu)
    return metrics, jax.tree_util.tree_map(np.asarray, tr.params), rms


def ill_conditioned(rms):
    """Elements whose AdamW step is set by rounding: a gradient RMS above
    zero and below 100 eps."""
    return (rms > 0) & (rms < 100 * 1e-8)


MESHES = {"dp2": (2, 1, False), "tp2": (1, 2, False),
          "dp2_tp2_zero1": (2, 2, True)}


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg()
    params = jax.tree_util.tree_map(
        np.asarray, jdual.init_dual_ar(jax.random.PRNGKey(0), cfg, jnp.float32))
    return cfg, params


@pytest.fixture(scope="module")
def runs(setup, tmp_path_factory):
    """{mesh: (JAX's metrics, params and gradient RMS, the port ranks'
    results, their directory)}."""
    cfg, params = setup
    tcfg = config_from_jax(cfg, DualARConfig)
    out = {}
    for name, (dp, tp, zero1) in MESHES.items():
        work = tmp_path_factory.mktemp(name)
        want = _jax_run(cfg, jax.tree_util.tree_map(jnp.asarray, params), dp,
                        tp, zero1, work / "jax")
        torch.save({"cfg": tcfg, "dp": dp, "tp": tp,
                    "params": dual_ar_from_jax(params, dtype=torch.float32,
                                               device="cpu"),
                    "train_cfg": _tcfg(TrainConfig, work / "port", dp=dp, tp=tp,
                                       zero1=zero1),
                    "batches": _batches(cfg),
                    "save_at": 2 if zero1 else None}, work / "inputs.pt")
        out[name] = want, spawn_ranks("train", dp * tp, work), work
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
def test_losses_and_grad_norms_match_jax_on_the_same_mesh(runs, mesh):
    (want, _, _), got, _ = runs[mesh]
    for rank in got:
        for i, (w, g) in enumerate(zip(want, rank["metrics"])):
            np.testing.assert_allclose(g["loss"], w["loss"], atol=2e-5, rtol=0,
                                       err_msg=f"loss step {i}")
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                       atol=2e-4, rtol=0,
                                       err_msg=f"grad_norm step {i}")
    assert want[-1]["loss"] < want[0]["loss"]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_parameters_after_three_steps_match_jax(runs, mesh):
    """Within 1e-5 of JAX's trainer on the mesh, except where AdamW's
    update is ill-conditioned: m / (sqrt(v) + eps) turns a gradient within
    a few eps of zero into a step of about lr of either sign, so the
    rounding of a sum moves it (JAX's own one-device and dp=2 runs differ
    by 9e-5 at one embedding element of 589,824). Elements whose gradient
    RMS in JAX's AdamW state is below 100 eps are held to AdamW's reach, lr
    per step each way; they are a small share of the tree (elements with
    no gradient at all, such as unused vocabulary rows, stay strict)."""
    (_, want, rms), got, _ = runs[mesh]
    flat_w, flat_rms = _flat(want), _flat(rms)
    for rank in got:
        flat_g = _flat(rank["params"])
        assert flat_g.keys() == flat_w.keys()
        for k, w in flat_w.items():
            g = flat_g[k].detach().numpy()
            tiny = ill_conditioned(flat_rms[k])
            assert tiny.sum() <= max(1e-3 * tiny.size, 1), (k, tiny.sum())
            np.testing.assert_allclose(g[~tiny], w[~tiny], atol=1e-5, rtol=0,
                                       err_msg=k)
            assert np.all(np.abs(g - w)[tiny] <= 2 * LR * STEPS), k


def test_zero1_keeps_half_of_adamw_state_per_rank(runs):
    """dp=2: each rank's m/v bytes are half of the replicated state's."""
    _, got, _ = runs["dp2_tp2_zero1"]
    _, rep, _ = runs["tp2"]  # the same tp shards, m/v replicated over dp
    for rank in got:
        assert rank["opt_bytes"] * 2 == pytest.approx(rep[0]["opt_bytes"],
                                                      rel=1e-3)


def test_zero1_checkpoint_holds_the_single_process_trainers_state(runs, setup,
                                                                  tmp_path):
    """Rank 0 writes the gathered state: the keys, shapes, step, update
    count and hyperparameters of a single-process trainer's file after the
    same 2 steps, its values within 1e-5."""
    cfg, params = setup
    _, _, work = runs["dp2_tp2_zero1"]
    got = torch.load(work / "port" / "p" / "checkpoints" / "step_00000002" /
                     "state.pt", weights_only=True)
    tr = Trainer(config_from_jax(cfg, DualARConfig),
                 _tcfg(TrainConfig, tmp_path), device="cpu",
                 params=dual_ar_from_jax(params, dtype=torch.float32, device="cpu"))
    for batch in _batches(cfg)[:2]:
        tr.train_step(tr.params, tr._place_batch(batch))
        tr.step += 1
    tr.save_checkpoint()
    want = torch.load(tmp_path / "p" / "checkpoints" / "step_00000002" /
                      "state.pt", weights_only=True)
    assert got["opt_state"]["count"] == want["opt_state"]["count"] == 2
    assert (got["opt_state"]["adamw"]["param_groups"]
            == want["opt_state"]["adamw"]["param_groups"])
    gs, ws = got["opt_state"]["adamw"]["state"], want["opt_state"]["adamw"]["state"]
    flat_g, flat_w = _flat(got["params"]), _flat(want["params"])
    assert flat_g.keys() == flat_w.keys() == set(map("/".join, tr.optimizer.paths))
    for i, path in enumerate(tr.optimizer.paths):
        k = "/".join(path)
        g, w = flat_g[k].detach().numpy(), flat_w[k].detach().numpy()
        assert g.shape == w.shape
        # as in test_parameters_after_three_steps_match_jax, from this
        # trainer's own AdamW state after its 2 updates
        tiny = ill_conditioned(np.sqrt(ws[i]["exp_avg_sq"].numpy() / (1 - 0.95 ** 2)))
        np.testing.assert_allclose(g[~tiny], w[~tiny], atol=1e-5, rtol=0,
                                   err_msg=k)
        assert np.all(np.abs(g - w)[tiny] <= 2 * LR * 2), k
    assert gs.keys() == ws.keys()
    for i in ws:
        assert gs[i].keys() == ws[i].keys()
        assert torch.equal(gs[i]["step"], ws[i]["step"])
        for k in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(gs[i][k], ws[i][k], atol=1e-6, rtol=0)


def test_zero1_trainer_resumes_where_the_uninterrupted_run_lands(runs):
    _, got, _ = runs["dp2_tp2_zero1"]
    for rank in got:
        full, resumed = _flat(rank["params"]), _flat(rank["resumed"])
        for k in full:
            np.testing.assert_allclose(resumed[k].detach().numpy(),
                                       full[k].detach().numpy(), atol=1e-6,
                                       rtol=0, err_msg=k)


@pytest.fixture(scope="module")
def lora_runs(setup, tmp_path_factory):
    """LoRA on a (dp=2, tp=2) mesh, ZeRO-1: the port's optimizer and step vs
    JAX's jitted step on the same mesh (one warmup step, a clip that
    engages, non-zero B)."""
    cfg, params = setup
    lcfg = jlora.LoraConfig(r=4, lora_alpha=8.0)
    jp = jlora.add_lora(jax.tree_util.tree_map(jnp.asarray, params), cfg, lcfg,
                        jax.random.PRNGKey(1), dtype=jnp.float32)
    cfg = jlora.apply_lora_config(cfg, lcfg)
    rng = np.random.default_rng(2)

    def leaf(path, x):
        keys = [str(getattr(p, "key", p)) for p in path]
        if any("lora" in k for k in keys) and keys[-1] == "b":
            return (rng.standard_normal(x.shape) * 0.05).astype(np.float32)
        return np.asarray(x)

    jp = jax.tree_util.tree_map_with_path(leaf, jp)
    mask = jlora.lora_filter(jp)
    schedule = (1e-3, 1, 10)
    jopt = jstep.make_optimizer(
        lr=jstep.cosine_schedule_with_warmup(*schedule, final_lr_ratio=0.1),
        grad_clip=0.05, params=jp, trainable_mask=mask)
    mesh = make_mesh(jax.devices()[:4], dp=2, tp=2)
    pspecs = to_named(mesh, dual_ar_param_specs(cfg))
    from fish_speech_tpu.train.trainer import _match_tree

    state = jax.tree_util.tree_map(jax.device_put, jp, _match_tree(pspecs, jp))
    opt_state = jopt.init(state)
    step = jax.jit(jstep.make_train_step(cfg, jopt, trainable_filter=mask))
    want = []
    for batch in _batches(cfg):
        state, opt_state, m = step(state, opt_state,
                                   {k: jnp.asarray(v) for k, v in batch.items()})
        want.append({k: float(v) for k, v in m.items()})
    work = tmp_path_factory.mktemp("lora")
    torch.save({"cfg": config_from_jax(cfg, DualARConfig), "dp": 2, "tp": 2,
                "params": dual_ar_from_jax(jp, dtype=torch.float32, device="cpu"),
                "schedule": schedule, "grad_clip": 0.05, "zero1": True,
                "batches": _batches(cfg)}, work / "inputs.pt")
    return (want, jax.tree_util.tree_map(np.asarray, state),
            spawn_ranks("train", 4, work))


def test_lora_under_tp2_matches_jax(lora_runs):
    want, want_params, got = lora_runs
    assert want[-1]["grad_norm"] > 0.05  # the clip engaged
    flat_w = _flat(want_params)
    for rank in got:
        for w, g in zip(want, rank["metrics"]):
            np.testing.assert_allclose(g["loss"], w["loss"], atol=2e-5, rtol=0)
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                       atol=2e-4, rtol=0)
        flat_g = _flat(rank["params"])
        for k, w in flat_w.items():
            np.testing.assert_allclose(flat_g[k].detach().numpy(), w,
                                       atol=1e-5, rtol=0, err_msg=k)


def test_trainer_without_ranks_refuses_a_mesh(tmp_path):
    cfg = config_from_jax(_cfg(), DualARConfig)
    for kw in ({"dp": 2}, {"tp": 2}):
        with pytest.raises(ValueError, match="ranks"):
            Trainer(cfg, dataclasses.replace(_tcfg(TrainConfig, tmp_path), **kw),
                    device="cpu")


def test_cli_trains_on_two_ranks(tmp_path):
    """`train.cli --coordinator --num-hosts 2 --host-id I --dp 2 --zero1
    --cpu` as two processes: each reads its dp shard of the proto file,
    rank 0 writes the checkpoints, both exit cleanly."""
    import os
    import subprocess
    import sys
    import time

    from tests.test_data import make_proto_file

    proto = make_proto_file(tmp_path / "d.protos")
    out = tmp_path / "out"
    root = str(__import__("pathlib").Path(__file__).resolve().parents[1])
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=root)
    logs = [open(tmp_path / f"rank_{r}.log", "w") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "fish_speech_tpu_torch.train.cli", "--data",
         str(proto), "--output", str(out), "--max-steps", "2", "--batch-size",
         "1", "--max-length", "128", "--tiny", "--cpu", "--lora-r", "2",
         "--ckpt-every", "1", "--warmup-steps", "1", "--precision", "float32",
         "--dp", "2", "--zero1", "--coordinator", f"file://{tmp_path}/rdzv",
         "--num-hosts", "2", "--host-id", str(r)],
        stdout=logs[r], stderr=subprocess.STDOUT, env=env, cwd=root)
        for r in range(2)]
    deadline = time.monotonic() + 180
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    text = "\n".join((tmp_path / f"rank_{r}.log").read_text()[-3000:]
                     for r in range(2))
    assert [p.returncode for p in procs] == [0, 0], text
    ckpts = sorted(p.name for p in (out / "run" / "checkpoints").iterdir())
    assert ckpts == ["step_00000001", "step_00000002"], text
