"""The port's mesh layer (`fish_speech_tpu_torch/parallel/`) in one process:
the specs and memory plan against the JAX package's, every leaf's shards
put back together, the fused wqkv split by heads and w13 by halves, and a
simulated tp run: the ranks as threads whose collectives sum the partials
by hand, in rank order, against the unsharded model (prefill, decode,
training forward, and the gradients, LoRA included). Then the multi-rank
dry run, `dryrun_multichip(4)`, on four gloo processes."""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_speech_tpu.config import dual_ar_s2_pro as jdual_ar_s2_pro
from fish_speech_tpu.parallel import mesh as jmesh
from fish_speech_tpu_torch.config import DualARConfig, dual_ar_s2_pro, dual_ar_tiny
from fish_speech_tpu_torch.convert.from_jax import config_from_jax
from fish_speech_tpu_torch.models import dual_ar as td
from fish_speech_tpu_torch.models.lora import LoraConfig, add_lora, apply_lora_config
from fish_speech_tpu_torch.parallel import mesh as tmesh
from fish_speech_tpu_torch.parallel.mesh import (Axis, Mesh, leaf_split,
                                                 shard_params, split_index,
                                                 tp_layout, use_mesh)
from fish_speech_tpu_torch.train.loss import dual_ar_loss

torch.set_num_threads(1)


def _cfg(**kw):
    base = dict(semantic_begin_id=300, semantic_end_id=331, im_end_id=3,
                n_head=8, n_local_heads=4, head_dim=16, dim=128,
                intermediate_size=256, attention_qk_norm=True,
                attention_qkv_bias=True, tie_word_embeddings=False,
                fast_n_head=8, fast_n_local_heads=4, fast_head_dim=8,
                fast_dim=64, fast_intermediate_size=128, vocab_size=4096,
                max_seq_len=64)
    base.update(kw)
    return dual_ar_tiny(**base)


def _params(cfg, seed=0):
    p = td.init_dual_ar(seed, cfg, torch.float32, "cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():  # non-zero biases and norms: every path counts
        for stack in (p["layers"], p["fast"]["layers"]):
            for k in ("bqkv", "q_norm", "k_norm", "attn_norm"):
                if k in stack:
                    stack[k].add_(0.1 * torch.randn(stack[k].shape, generator=gen))
    return p


def _inputs(cfg, b=2, t=16, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, cfg.codebook_size, size=(b, cfg.num_codebooks + 1, t))
    a[:, 0] = rng.integers(4, 340, size=(b, t))
    return torch.from_numpy(a.astype(np.int32))


class _HandSum:
    """The partials of `n` threads, summed by hand in rank order."""

    def __init__(self, n):
        self.n, self.slots = n, [None] * n
        self.barrier = threading.Barrier(n)

    def __call__(self, rank, x):
        self.barrier.wait()
        self.slots[rank] = x.clone()
        self.barrier.wait()
        total = self.slots[0].clone()
        for part in self.slots[1:]:
            total = total + part
        self.barrier.wait()
        return total


class ThreadAxis(Axis):
    """A mesh axis whose ranks are threads of this process."""

    def __init__(self, name, hand_sum, rank):
        super().__init__(name, range(hand_sum.n), rank, None, "gloo")
        self.hand_sum = hand_sum

    def all_reduce(self, x):
        return x.copy_(self.hand_sum(self.rank, x))


def fake_mesh(tp, rank=0, hand_sum=None):
    hand_sum = hand_sum or _HandSum(tp)
    return Mesh(dp=ThreadAxis("dp", _HandSum(1), 0),
                tp=ThreadAxis("tp", hand_sum, rank),
                device=torch.device("cpu"), backend="gloo")


def run_tp(tp, fn):
    """fn(mesh) on `tp` thread ranks under `use_mesh`; their results."""
    hand_sum, out, errors = _HandSum(tp), [None] * tp, []

    def rank_main(r):
        try:
            mesh = fake_mesh(tp, r, hand_sum)
            with use_mesh(mesh):
                out[r] = fn(mesh)
        except BaseException as e:  # noqa: BLE001 -- re-raised below
            errors.append(e)
            hand_sum.barrier.abort()

    threads = [threading.Thread(target=rank_main, args=(r,)) for r in range(tp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads), "a thread rank hung"
    if errors:
        raise errors[0]
    return out


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


# -- specs and plan ----------------------------------------------------------


def test_param_specs_are_the_jax_packages():
    cfg = _cfg()
    want = jax.tree_util.tree_map(
        lambda s: tuple(s), jmesh.dual_ar_param_specs(cfg),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert tmesh.dual_ar_param_specs(config_from_jax(cfg, DualARConfig)) == want
    for quant in (False, True):
        assert tmesh.kv_cache_specs(quant) == {
            k: tuple(v) for k, v in jmesh.kv_cache_specs(quant).items()}
    for accum in (False, True):
        assert tmesh.batch_spec(accum) == {
            k: tuple(v) for k, v in jmesh.batch_spec(accum).items()}


@pytest.mark.parametrize("dp,tp,zero1", [(1, 1, False), (2, 1, True),
                                         (4, 2, True)])
def test_train_state_memory_plan_equals_jax(dp, tp, zero1):
    ids = dict(semantic_begin_id=151000, semantic_end_id=155095,
               im_end_id=150994)
    want = jmesh.train_state_memory_plan(jdual_ar_s2_pro(**ids), dp=dp, tp=tp,
                                         zero1=zero1)
    got = tmesh.train_state_memory_plan(dual_ar_s2_pro(**ids), dp=dp, tp=tp,
                                        zero1=zero1)
    assert got == want


# -- shards ------------------------------------------------------------------


@pytest.mark.parametrize("tp", [2, 4])
def test_shards_put_back_together_equal_the_full_tree(tp):
    cfg = _cfg()
    full = add_lora(_params(cfg), cfg, LoraConfig(r=2, lora_alpha=4.0), 3,
                    dtype=torch.float32)
    layout = tp_layout(cfg, tp)
    assert layout.vocab and layout.slow and layout.fast
    shards = [shard_params(full, cfg, fake_mesh(tp, r)) for r in range(tp)]
    n_split = 0
    for path, leaf in _flat(full).items():
        split = leaf_split(path, cfg, layout)
        parts = [_flat(s)[path] for s in shards]
        if split is None:
            assert all(p is leaf for p in parts), path
            continue
        n_split += 1
        axis, kind, heads = split
        n = leaf.shape[axis]
        rebuilt = torch.empty_like(leaf)
        for r, part in enumerate(parts):
            assert part.shape[axis] * tp == n, path
            rebuilt.index_copy_(axis % leaf.dim(),
                                torch.tensor(split_index(kind, n, tp, r, heads)),
                                part)
        assert torch.equal(rebuilt, leaf), path
    # wqkv, bqkv, wo, w1, w3, w2 of both stacks, output, embeddings,
    # fast output, project_in w and b
    assert n_split == 2 * 6 + 5


def test_wqkv_splits_by_heads_and_w13_by_halves():
    """s2-pro's slow stack at tp=2 (H=32, Hkv=8, D=128): rank 1 takes q
    heads 16-31, k heads 4-7 and v heads 4-7, not the second half of the
    6,144 fused columns (which would be all of k and v)."""
    h, hkv, d = 32, 8, 128
    idx = np.array(split_index("qkv", (h + 2 * hkv) * d, 2, 1, (h, hkv, d)))
    assert len(idx) == (16 + 4 + 4) * d
    heads = idx[::d] // d
    assert list(heads) == (list(range(16, 32)) + list(range(36, 40))
                           + list(range(44, 48)))
    assert list(idx[:d]) == list(range(16 * d, 17 * d))
    # w13: [w1 part | w3 part] of each rank
    i = 9728
    for r in range(4):
        got = split_index("halves", 2 * i, 4, r)
        assert got == (list(range(r * i // 4, (r + 1) * i // 4))
                       + list(range(i + r * i // 4, i + (r + 1) * i // 4)))
    # a fused tree's w13 shard is the fused unfused shards
    cfg = _cfg()
    full = _params(cfg)
    fused = td.fuse_ffn_weights(full)
    for r in range(2):
        m = fake_mesh(2, r)
        a, b = shard_params(full, cfg, m), shard_params(fused, cfg, m)
        assert torch.equal(td.fuse_ffn_weights(a)["layers"]["w13"],
                           b["layers"]["w13"])


def test_a_stack_whose_heads_do_not_divide_stays_whole():
    """The server's --tiny fast stack (3 heads, 1 kv head) at tp=2."""
    cfg = _cfg(fast_n_head=3, fast_n_local_heads=1, fast_head_dim=16)
    layout = tp_layout(cfg, 2)
    assert layout.slow and not layout.fast
    shard = shard_params(_params(cfg), cfg, fake_mesh(2, 0))
    assert shard["fast"]["layers"]["wqkv"].shape[-1] == (3 + 2) * 16
    assert shard["layers"]["wqkv"].shape[-1] == (4 + 2 + 2) * 16


def test_quantized_weights_are_refused_under_tp():
    from fish_speech_tpu_torch.ops.quant import quantize_dual_ar_lowmem

    cfg = _cfg()
    q = quantize_dual_ar_lowmem(_params(cfg), mode="int8")
    with pytest.raises(NotImplementedError, match="quantized"):
        shard_params(q, cfg, fake_mesh(2, 0))
    from fish_speech_tpu_torch.config import SamplingConfig
    from fish_speech_tpu_torch.generate import GenerationSession

    with pytest.raises(NotImplementedError, match="item 10"):
        GenerationSession(q, cfg, SamplingConfig(), dtype=torch.float32,
                          mesh=fake_mesh(2, 0))
    with pytest.raises(NotImplementedError, match="item 10"):
        GenerationSession(_params(cfg), cfg, SamplingConfig(), max_batch=2,
                          dtype=torch.float32, mesh=fake_mesh(2, 0))


# -- the simulated tp run ----------------------------------------------------


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("tp", [2, 4])
def test_simulated_tp_prefill_and_decode_equal_unsharded(tp, tie):
    cfg = _cfg(tie_word_embeddings=tie)
    full = _params(cfg)
    inp = _inputs(cfg, b=1)
    offsets = torch.zeros(1, dtype=torch.int32)

    def run(params):
        cache = td.init_kv_cache(cfg, 1, 32, torch.float32, "cpu")
        logits, hidden, _ = td.prefill(params, cfg, inp, cache, offsets, 12)
        h2, slow, _ = td.decode_slow_step(params, cfg, inp[:, :, 12], cache, 12)
        fc = td.init_fast_kv_cache(cfg, 1, torch.float32, "cpu")
        x = td.fast_project_in(params, cfg, h2)
        fl, _ = td.fast_decode_step(params, cfg, x, fc, 0)
        head = td.precompute_semantic_head(params, cfg)["_semantic_head"]["w"]
        return logits, hidden, slow, fl, head, cache["k"].shape[3]

    want = run(full)
    for got in run_tp(tp, lambda m: run(shard_params(full, cfg, m))):
        assert got[-1] == cfg.n_local_heads // tp
        for g, w in zip(got[:-1], want[:-1]):
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-6, rtol=0)
        assert torch.equal(got[4], want[4])  # the semantic head: the same values


@pytest.mark.parametrize("lora", [False, True], ids=["full", "lora"])
@pytest.mark.parametrize("tp", [2, 4])
def test_simulated_tp_loss_and_gradients_equal_unsharded(tp, lora):
    """Split leaves get this rank's part of the unsharded gradient, the
    replicated ones (norms, biases, every LoRA leaf) the whole of it."""
    cfg = _cfg(tie_word_embeddings=lora)  # the tied head's LoRA path too
    full = _params(cfg)
    if lora:
        lcfg = LoraConfig(r=4, lora_alpha=8.0)
        full = add_lora(full, cfg, lcfg, 1, dtype=torch.float32)
        cfg = apply_lora_config(cfg, lcfg)
        gen = torch.Generator().manual_seed(5)
        with torch.no_grad():
            for path, v in _flat(full).items():
                if path[-1] == "b" and any("lora" in k for k in path):
                    v.copy_(0.05 * torch.randn(v.shape, generator=gen))
    inp = _inputs(cfg, b=2, t=16, seed=2)
    batch = {"inputs": inp, "labels": inp.clone(),
             "pad_mask": torch.zeros(2, 16, dtype=torch.bool)}

    def grads(params):
        leaves = {p: v.requires_grad_(True) for p, v in _flat(params).items()
                  if not lora or any("lora" in k for k in p)}
        loss, _ = dual_ar_loss(params, cfg, batch, remat=True)
        return loss.detach(), dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))

    want_loss, want = grads(full)
    layout = tp_layout(cfg, tp)
    results = run_tp(tp, lambda m: (m.tp.rank, grads(shard_params(full, cfg, m))))
    for rank, (loss, got) in results:
        np.testing.assert_allclose(float(loss), float(want_loss), atol=1e-6)
        assert got.keys() == want.keys()
        for path, g in got.items():
            w = want[path]
            split = leaf_split(path, cfg, layout)
            if split is not None:
                axis, kind, heads = split
                idx = torch.tensor(split_index(kind, w.shape[axis], tp, rank, heads))
                w = w.index_select(axis % w.dim(), idx)
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-6, rtol=0,
                                       err_msg="/".join(path))


# -- the dry run -------------------------------------------------------------


def test_entry_config_is_the_graft_entry_config():
    import __graft_entry__

    from fish_speech_tpu_torch.parallel.dryrun import entry_config, make_batch

    want = __graft_entry__._entry_config()
    assert dataclasses.asdict(entry_config()) == dataclasses.asdict(
        config_from_jax(want, DualARConfig))
    for k, v in __graft_entry__._make_batch(want, batch=2, t=64).items():
        np.testing.assert_array_equal(make_batch(entry_config(), 2, 64)[k], v)


def test_dryrun_multichip_4_on_gloo():
    from fish_speech_tpu_torch.parallel.dryrun import dryrun_multichip

    report = dryrun_multichip(4, device="cpu", timeout=300)
    assert report["mesh"] == {"dp": 2, "tp": 2}
    assert np.isfinite(report["loss"]) and np.isfinite(report["zero1_loss"])
    assert report["grad_norm"] > 0


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="shows what happens without a CUDA device")
def test_a_rank_without_a_card_runs_on_the_cpu_only_when_asked(tmp_path):
    """Under a process group, the mesh and the trainer take this rank's
    card; without one they raise unless the caller passes device="cpu"."""
    import torch.distributed as dist

    from fish_speech_tpu_torch.train.trainer import TrainConfig, Trainer

    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.default_device(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.init_distributed(f"file://{tmp_path}/never", 1, 0)
    assert not dist.is_initialized()
    assert tmesh.init_distributed(f"file://{tmp_path}/rdzv", 1, 0, device="cpu")
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_mesh(dp=1, tp=1)
        tcfg = TrainConfig(output_dir=str(tmp_path), project="t", max_steps=1,
                           precision="float32")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(_cfg(), tcfg)
        for kw in ({"dp": 2}, {"tp": 2}):  # a mesh comes only from mesh=
            with pytest.raises(ValueError, match="mesh=make_mesh"):
                Trainer(_cfg(), dataclasses.replace(tcfg, **kw), device="cpu")
        assert tmesh.make_mesh(dp=1, tp=1, device="cpu").device.type == "cpu"
    finally:
        dist.destroy_process_group()
