"""The port's training path against the JAX package, on the CPU.

Tiny "plain" and "qwen3ish" configs (`tests/test_torch_slice.py`), the same
float32 weights (JAX `init_dual_ar` + `add_lora`, with the LoRA B matrices
made nonzero from numpy so the LoRA terms are exercised), bridged with
`dual_ar_from_jax`, and the same batches go through both packages:

  * `forward_train` logits to atol 1e-4, with the JAX package's training
    attention off (masked einsum) and forced through its Pallas kernels in
    interpret mode;
  * `dual_ar_loss` and its metrics, and LoRA gradients with remat on, to
    rtol 5e-4 / atol 1e-5;
  * three `make_train_step` updates (clip, AdamW, cosine warmup) and two
    `grad_accum=2` updates: LoRA leaves to 1e-5, frozen leaves bit-equal;
  * greedy decoding of a LoRA tree gives the JAX package's token columns,
    and the port's own after `merge_lora`;
  * the trainer resumes bit-exactly, prunes checkpoints, and the `--tiny`
    CLI trains on a proto file.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_speech_tpu import generate as jgen
from fish_speech_tpu.config import SamplingConfig, dual_ar_tiny
from fish_speech_tpu.models import dual_ar as jdual
from fish_speech_tpu.models import lora as jlora
from fish_speech_tpu.train import loss as jloss
from fish_speech_tpu.train import step as jstep
from fish_speech_tpu_torch import generate as tgen
from fish_speech_tpu_torch.convert.from_jax import dual_ar_from_jax
from fish_speech_tpu_torch.models import dual_ar as tdual
from fish_speech_tpu_torch.models import lora as tlora
from fish_speech_tpu_torch.train import loss as tloss
from fish_speech_tpu_torch.train import step as tstep
from fish_speech_tpu_torch.train.trainer import TrainConfig, Trainer

from tests.test_data import NUM_CODEBOOKS, make_proto_file
from tests.test_torch_slice import _prompt, make_cfg

torch.set_num_threads(1)


def make_lora_params(cfg, seed=0, lora=True):
    """(cfg with lora_scale, JAX tree, port tree) on the same weights."""
    jp = jdual.init_dual_ar(jax.random.PRNGKey(seed), cfg, dtype=jnp.float32)
    if lora:
        lcfg = jlora.LoraConfig(r=4, lora_alpha=8.0)
        jp = jlora.add_lora(jp, cfg, lcfg, jax.random.PRNGKey(seed + 1),
                            dtype=jnp.float32)
        cfg = jlora.apply_lora_config(cfg, lcfg)
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        keys = [str(getattr(p, "key", p)) for p in path]
        if any("lora" in k for k in keys) and keys[-1] == "b":
            return (rng.standard_normal(x.shape) * 0.05).astype(np.float32)
        return np.asarray(x)

    jp = jax.tree_util.tree_map_with_path(leaf, jp)
    tp = dual_ar_from_jax(jp, dtype=torch.float32, device="cpu")
    return cfg, jax.tree_util.tree_map(jnp.asarray, jp), tp


def make_batch(cfg, seed=0, b=2, t=32, n_pad=5):
    rng = np.random.default_rng(seed)
    inputs = np.zeros((b, cfg.num_codebooks + 1, t), dtype=np.int32)
    inputs[:, 0] = rng.integers(4, 200, size=(b, t))
    sem = rng.random((b, t)) < 0.6
    span = cfg.semantic_end_id - cfg.semantic_begin_id + 1
    for i in range(b):
        codes = rng.integers(0, cfg.codebook_size, size=(cfg.num_codebooks, t))
        inputs[i, 0, sem[i]] = cfg.semantic_begin_id + codes[0, sem[i]] % span
        inputs[i, 1:, sem[i]] = codes[:, sem[i]].T
    labels = inputs.copy()
    pad = np.zeros((b, t), bool)
    if n_pad:
        pad[:, -n_pad:] = True
        labels[:, :, -n_pad:] = -100
    return {"inputs": inputs, "labels": labels, "pad_mask": pad}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict (JAX or torch leaves)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("flash", ["off", "interpret"])
@pytest.mark.parametrize("lora", [False, True])
@pytest.mark.parametrize("name", ["plain", "qwen3ish"])
def test_forward_train_logits_match_jax(tokenizer, name, lora, flash,
                                        monkeypatch):
    monkeypatch.setattr(jdual, "FLASH_TRAIN", flash)
    cfg, jp, tp = make_lora_params(make_cfg(tokenizer, name), lora=lora)
    batch = make_batch(cfg)
    jt, jc = jdual.forward_train(jp, cfg, jnp.asarray(batch["inputs"]),
                                 labels=jnp.asarray(batch["labels"]),
                                 pad_mask=jnp.asarray(batch["pad_mask"]),
                                 remat=False)
    b = _t(batch)
    tt, tc = tdual.forward_train(tp, cfg, b["inputs"], labels=b["labels"],
                                 pad_mask=b["pad_mask"], remat=False)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", ["plain", "qwen3ish"])
def test_dual_ar_loss_and_lora_grads_with_remat_match_jax(tokenizer, name,
                                                          monkeypatch):
    monkeypatch.setattr(jdual, "FLASH_TRAIN", "interpret")
    cfg, jp, tp = make_lora_params(make_cfg(tokenizer, name), seed=3)
    batch = make_batch(cfg, seed=3)
    mask = jlora.lora_filter(jp)

    def jloss_fn(train):
        full = jax.tree_util.tree_map(lambda m, t, p: t if m else p, mask,
                                      train, jp)
        return jloss.dual_ar_loss(full, cfg, _j(batch), remat=True)

    (jl, jm), jg = jax.value_and_grad(jloss_fn, has_aux=True)(jp)
    lora_paths = [k for k, v in _flat(tlora.lora_filter(tp)).items() if v]
    flat_t = _flat(tp)
    leaves = [flat_t[k].requires_grad_(True) for k in lora_paths]
    tl, tm = tloss.dual_ar_loss(tp, cfg, _t(batch), remat=True)
    tg = torch.autograd.grad(tl, leaves)

    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for key in ("loss", "base_loss", "semantic_loss", "top_5_accuracy"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5,
                                   err_msg=key)
    flat_jg = _flat(jg)
    assert len(lora_paths) >= 7
    for path, g in zip(lora_paths, tg):
        np.testing.assert_allclose(g.numpy(), np.asarray(flat_jg[path]),
                                   rtol=5e-4, atol=1e-5, err_msg=path)


def test_weight_decay_mask_matches_jax(tokenizer):
    cfg, jp, tp = make_lora_params(make_cfg(tokenizer, "qwen3ish"))
    want = _flat(jstep.weight_decay_mask(jp))
    got = _flat(tstep.weight_decay_mask(tp))
    assert got == {k: bool(v) for k, v in want.items()}
    assert not got["lora_embeddings/a"] and got["layers/lora/wqkv/a"]
    assert _flat(tlora.lora_filter(tp)) == {
        k: bool(v) for k, v in _flat(jlora.lora_filter(jp)).items()}


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_steps_match_jax(tokenizer, grad_accum, monkeypatch):
    """Three updates (one-step-warmup cosine schedule, AdamW, a global-norm
    clip that engages) or two `grad_accum=2` updates (the first at the
    warmup's learning rate 0): LoRA leaves track the JAX package's to 1e-5;
    frozen leaves stay bit-equal."""
    monkeypatch.setattr(jdual, "FLASH_TRAIN", "interpret")
    cfg, jp, tp = make_lora_params(make_cfg(tokenizer, "qwen3ish"), seed=5)
    before = {k: v.clone() for k, v in _flat(tp).items()}
    schedule_args = (1e-3, 1, 10)
    jsched = jstep.cosine_schedule_with_warmup(*schedule_args, final_lr_ratio=0.1)
    tsched = tstep.cosine_schedule_with_warmup(*schedule_args, final_lr_ratio=0.1)
    mask = jlora.lora_filter(jp)
    jopt = jstep.make_optimizer(lr=jsched, grad_clip=0.05, params=jp,
                                trainable_mask=mask)
    jstep_fn = jax.jit(jstep.make_train_step(cfg, jopt, trainable_filter=mask,
                                             grad_accum=grad_accum))
    topt = tstep.make_optimizer(tp, lr=tsched, grad_clip=0.05,
                                trainable_mask=tlora.lora_filter(tp))
    tstep_fn = tstep.make_train_step(cfg, topt, grad_accum=grad_accum)

    jstate = jopt.init(jp)
    n_steps = 3 if grad_accum == 1 else 2
    for i in range(n_steps):
        batch = make_batch(cfg, seed=10 + i, b=2 * grad_accum)
        if grad_accum > 1:
            batch = {k: v.reshape(grad_accum, 2, *v.shape[1:])
                     for k, v in batch.items()}
        jp, jstate, jm = jstep_fn(jp, jstate, _j(batch))
        tm = tstep_fn(tp, _t(batch))
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-5, err_msg=f"{key} step {i}")
    assert float(jm["grad_norm"]) > 0.05  # the clip engaged
    flat_j = _flat(jp)
    lora_bits = _flat(tlora.lora_filter(tp))
    for path, got in _flat(tp).items():
        if lora_bits[path]:
            assert not torch.equal(got, before[path]), path
            np.testing.assert_allclose(got.detach().numpy(),
                                       np.asarray(flat_j[path]), rtol=0,
                                       atol=1e-5, err_msg=path)
        else:
            assert torch.equal(got, before[path]), path
            np.testing.assert_array_equal(np.asarray(flat_j[path]),
                                          before[path].numpy())


@pytest.mark.parametrize("name", ["plain", "qwen3ish"])
def test_lora_tree_decodes_as_jax_and_as_merged(tokenizer, name):
    """Greedy `generate_stream` of a LoRA tree (fused FFN, LoRA w1/w3 split,
    LoRA semantic head): identical token columns to the JAX package's, and
    to the port's own run on the `merge_lora` tree."""
    cfg = dataclasses.replace(make_cfg(tokenizer, name), max_seq_len=128)
    cfg, jp, tp = make_lora_params(cfg, seed=7)
    scfg = SamplingConfig()
    prompt = _prompt(cfg, 37, seed=3)[0]
    kw = dict(max_new_tokens=12, temperature=0.7, top_p=0.9, top_k=1)
    js = jgen.GenerationSession(jp, cfg, scfg, max_batch=1, dtype=jnp.float32,
                                decode_chunk_size=4, first_chunk_size=2)
    want = list(js.generate_stream(prompt, jax.random.PRNGKey(0), **kw))
    runs = []
    for params in (tp, tlora.merge_lora(tp, cfg)):
        ts = tgen.GenerationSession(params, cfg, scfg, dtype=torch.float32,
                                    decode_chunk_size=4, first_chunk_size=2)
        runs.append(list(ts.generate_stream(prompt, ts.new_generator(1), **kw)))
    assert not any("lora" in k for k in _flat(tlora.merge_lora(tp, cfg)))
    assert want[-1].shape[1] > 1
    for got in runs:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def _tiny_cfg(tokenizer):
    return dual_ar_tiny(vocab_size=tokenizer.vocab_size,
                        semantic_begin_id=tokenizer.semantic_begin_id,
                        semantic_end_id=tokenizer.semantic_end_id,
                        im_end_id=tokenizer.im_end_id,
                        num_codebooks=NUM_CODEBOOKS, max_seq_len=128)


@pytest.mark.parametrize("lora", [False, True])
def test_trainer_resume_is_bit_equivalent(tokenizer, tmp_path, lora):
    """4 steps straight vs 2 steps -> checkpoint -> fresh Trainer -> resume
    -> 2 more steps on the same batches: bit-identical parameters and
    optimizer state (the checkpoint keeps m/v, the update count driving the
    warmup schedule and the step)."""
    cfg = _tiny_cfg(tokenizer)
    batches = [make_batch(cfg, seed=100 + i) for i in range(4)]

    def tc(outdir, max_steps):
        return TrainConfig(
            output_dir=str(tmp_path / outdir), project="t",
            max_steps=max_steps, batch_size=2, max_length=32, lr=1e-3,
            warmup_steps=2, ckpt_every_steps=2, log_every_steps=100,
            precision="float32", val_every_steps=1000,
            lora=tlora.LoraConfig(r=2, lora_alpha=4.0) if lora else None)

    t_a = Trainer(cfg, tc("a", 4), device="cpu")
    t_a.fit(list(batches), resume=False)
    t_b = Trainer(cfg, tc("b", 2), device="cpu")
    t_b.fit(batches[:2], resume=False)
    t_b2 = Trainer(cfg, tc("b", 4), device="cpu")
    t_b2.fit(batches[2:], resume=True)
    assert t_a.step == t_b2.step == 4

    flat_a, flat_b = _flat(t_a.params), _flat(t_b2.params)
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        assert torch.equal(flat_a[k], flat_b[k]), k
    sa, sb = t_a.optimizer.state_dict(), t_b2.optimizer.state_dict()
    assert sa["count"] == sb["count"] == 4
    for pa, pb in zip(sa["adamw"]["state"].values(), sb["adamw"]["state"].values()):
        for key in pa:
            assert torch.equal(pa[key], pb[key]), key
    saved = torch.load(t_b2.latest_checkpoint() / "state.pt", weights_only=True)
    assert all("lora" in k for k in _flat(saved["params"])) == lora


def test_trainer_prunes_checkpoints_and_logs(tokenizer, tmp_path):
    cfg = _tiny_cfg(tokenizer)
    tcfg = TrainConfig(output_dir=str(tmp_path), project="p", max_steps=4,
                       batch_size=2, lr=1e-2, warmup_steps=0,
                       ckpt_every_steps=1, keep_ckpts=2, log_every_steps=2,
                       precision="float32",
                       lora=tlora.LoraConfig(r=2, lora_alpha=4.0))
    trainer = Trainer(cfg, tcfg, device="cpu")
    batch = make_batch(cfg)
    trainer.fit([batch] * 4, resume=False)
    ckpts = sorted(p.name for p in (tmp_path / "p" / "checkpoints").iterdir())
    assert ckpts == ["step_00000003", "step_00000004"]
    recs = [json.loads(x) for x in
            (tmp_path / "p" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [2, 4]
    assert recs[-1]["loss"] < recs[0]["loss"]
    with pytest.raises(ValueError, match="ranks"):  # no process group
        Trainer(cfg, dataclasses.replace(tcfg, dp=2))


def test_cli_tiny_trains_on_a_proto_file(tmp_path):
    from click.testing import CliRunner

    from fish_speech_tpu_torch.train.cli import main

    proto = make_proto_file(tmp_path / "d.protos")
    out = tmp_path / "out"
    args = ["--data", str(proto), "--output", str(out), "--max-steps", "2",
            "--batch-size", "2", "--max-length", "128", "--tiny", "--cpu",
            "--lora-r", "2", "--ckpt-every", "1", "--warmup-steps", "1",
            "--precision", "float32"]
    res = CliRunner().invoke(main, args, catch_exceptions=False)
    assert res.exit_code == 0, res.output
    ckpts = sorted(p.name for p in (out / "run" / "checkpoints").iterdir())
    assert ckpts == ["step_00000001", "step_00000002"]
    res = CliRunner().invoke(main, args + ["--tp", "2"])  # one process
    assert isinstance(res.exception, ValueError)


def test_load_dual_ar_reads_the_native_format(tokenizer, tmp_path):
    from fish_speech_tpu.utils.checkpoint import save_dual_ar
    from fish_speech_tpu_torch.utils.checkpoint import load_dual_ar

    cfg = make_cfg(tokenizer, "qwen3ish")
    jp = jdual.init_dual_ar(jax.random.PRNGKey(0), cfg, dtype=jnp.bfloat16)
    save_dual_ar(tmp_path / "ckpt", jp, cfg)
    params, got_cfg = load_dual_ar(tmp_path / "ckpt", dtype=None, device="cpu")
    assert got_cfg.n_layer == cfg.n_layer and got_cfg.dim == cfg.dim
    flat_j, flat_t = _flat(jp), _flat(params)
    assert flat_j.keys() == flat_t.keys()
    for k, v in flat_j.items():
        assert flat_t[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(flat_t[k].float().numpy(),
                                      np.asarray(v.astype(jnp.float32)), k)
    params32, _ = load_dual_ar(tmp_path / "ckpt", dtype=torch.float32,
                                device="cpu")
    assert params32["layers"]["wqkv"].dtype == torch.float32
