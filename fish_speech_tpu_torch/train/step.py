"""Optimizer and train step, in PyTorch.

Port of `fish_speech_tpu/train/step.py` on one device. The JAX package's
`optax.chain(clip_by_global_norm, adamw)` becomes `Optimizer`: global-norm
clipping as optax computes it, then `torch.optim.AdamW` with a decay group
and a no-decay group over the trainable tensors only (state exists only for
them), the learning rate read from the schedule at the update count before
each update (optax evaluates the schedule at count 0 for the first update).
The step updates the parameters in place.

On a (dp, tp) mesh (`parallel/mesh.py`) the tree is this rank's shard and
the batch its dp rows (`Trainer`). The dp ranks' gradients are summed
(each rank's loss is its share of the global batch's, `train/loss.py`), in
fp32, in one all-reduce; the global norm adds the tp ranks' squares of the
split leaves to the replicated leaves' once, so clipping sees the global
gradient. With ZeRO-1 (`zero1`) each dp rank keeps AdamW's m and v only
for its 1/dp of every trainable tensor (`zero1_shard_opt_state`): a step
reduce-scatters the gradients, updates its part with the same AdamW and
all-gathers the updated parts. `state_dict` under a mesh is the whole
state, as the single-device optimizer's: a collective that every rank
calls.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from fish_speech_tpu_torch.config import DualARConfig
from fish_speech_tpu_torch.parallel.mesh import (gather_leaf, leaf_split,
                                                 shard_leaf, tp_layout,
                                                 use_mesh,
                                                 zero1_shard_opt_state)
from fish_speech_tpu_torch.train.loss import dual_ar_loss

_NO_DECAY_NAMES = ("alpha", "alpha1", "alpha2", "gamma", "norm_w", "norm_b")


def weight_decay_mask(params, _path=()):
    """Bool tree, the reference's exclusion (`lit_module.py:44-57`): no decay
    for biases, norm scales and embedding tables (LoRA embedding leaves
    included, since their path holds "embeddings")."""
    out = {}
    for k, v in params.items():
        path = _path + (k,)
        if isinstance(v, dict):
            out[k] = weight_decay_mask(v, path)
            continue
        last = str(k)
        out[k] = not ("embeddings" in "/".join(path)
                      or (last.startswith("b") and v.dim() == 1)
                      or "norm" in last or "scale" in last
                      or last in _NO_DECAY_NAMES or v.dim() == 1)
    return out


def _leaves(tree, mask=None, path=()):
    """(path, leaf, mask bit) of a nested dict in insertion order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, None if mask is None else mask[k], path + (k,))
        else:
            yield path + (k,), v, True if mask is None else mask[k]


def _flat_fp32(tensors):
    return torch.cat([t.float().reshape(-1) for t in tensors])


class Optimizer:
    """Global-norm clip then AdamW over the trainable tensors of a tree.

    `mesh` and `cfg`: the tree is this rank's shard of a (dp, tp) mesh;
    `zero1` keeps m and v for this dp rank's part of each tensor only."""

    def __init__(self, params, schedule: Callable[[int], float],
                 weight_decay: float = 0.01, betas=(0.9, 0.95),
                 grad_clip: Optional[float] = 1.0, trainable_mask=None,
                 mesh=None, cfg: Optional[DualARConfig] = None,
                 zero1: bool = False):
        decay, no_decay = [], []
        for (path, p, trainable), (_, _, decays) in zip(
                _leaves(params, trainable_mask),
                _leaves(params, weight_decay_mask(params))):
            p.requires_grad_(bool(trainable))
            if trainable:
                (decay if decays else no_decay).append((path, p))
        self.paths = [path for path, _ in decay + no_decay]
        self.params = [p for _, p in decay + no_decay]
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.count = 0  # updates applied so far
        self.mesh, self.cfg = mesh, cfg
        self.dp = mesh.dp if mesh is not None and mesh.dp.size > 1 else None
        self.tp = mesh.tp if mesh is not None and mesh.tp.size > 1 else None
        # which tensors are split over tp (their squares sum over tp)
        layout = tp_layout(cfg, self.tp.size) if self.tp is not None else None
        self.split = [layout is not None and leaf_split(p, cfg, layout) is not None
                      for p in self.paths]
        self.zero1 = bool(zero1) and self.dp is not None
        # ZeRO-1: AdamW runs on this rank's part of each tensor
        if self.zero1:
            self.shards, self.shard_sizes = zero1_shard_opt_state(self.params,
                                                                  self.dp)
        else:
            self.shards = self.params
        n_decay = len(decay)
        groups = [{"params": self.shards[:n_decay], "weight_decay": weight_decay},
                  {"params": self.shards[n_decay:], "weight_decay": 0.0}]
        self.adamw = torch.optim.AdamW(
            [g for g in groups if g["params"]], lr=schedule(0), betas=betas,
            eps=1e-8, weight_decay=weight_decay)

    def _global_norm(self, grads) -> torch.Tensor:
        if self.tp is None and not self.zero1:
            return torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
        sq = torch.zeros(2, dtype=torch.float32, device=grads[0].device)
        for g, split in zip(grads, self.split):
            sq[int(split)] += (g.float() ** 2).sum()
        if self.zero1:  # each dp rank holds a part of every gradient
            self.dp.all_reduce(sq)
        if self.tp is not None:  # split tensors: each tp rank holds a part
            sq[1:] = self.tp.all_reduce(sq[1:].clone())
        return torch.sqrt(sq.sum())

    def apply(self, grads) -> torch.Tensor:
        """One update from `grads` (aligned with `self.params`: this rank's
        gradients of its own rows); returns the global norm of the
        gradients before clipping (fp32 tensor)."""
        grads = list(grads)
        if self.zero1:
            grads = self._reduce_scatter(grads)
        elif self.dp is not None:
            flat = self.dp.all_reduce(_flat_fp32(grads))
            grads = [x.view_as(g).to(g.dtype) for x, g in
                     zip(flat.split([g.numel() for g in grads]), grads)]
        norm = self._global_norm(grads)
        if self.grad_clip is not None:
            # optax.clip_by_global_norm: g unchanged below the limit, else
            # g / norm * limit
            factor = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                                 self.grad_clip / norm)
            grads = [(g.float() * factor).to(g.dtype) for g in grads]
        for p, g in zip(self.shards, grads):
            p.grad = g
        lr = float(self.schedule(self.count))
        for group in self.adamw.param_groups:
            group["lr"] = lr
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=True)
        if self.zero1:
            self._all_gather_updates()
        self.count += 1
        return norm

    def _reduce_scatter(self, grads):
        """This dp rank's part of each summed gradient (rank-major layout:
        one reduce-scatter for every tensor)."""
        dp, sizes = self.dp.size, self.shard_sizes
        rows = []
        for g, s in zip(grads, sizes):
            flat = torch.zeros(dp * s, dtype=torch.float32, device=g.device)
            flat[: g.numel()] = g.float().reshape(-1)
            rows.append(flat.view(dp, s))
        mine = self.dp.reduce_scatter(torch.cat(rows, dim=1))
        return [x.to(g.dtype) for x, g in zip(mine.split(sizes), grads)]

    def _gather_parts(self, parts, like):
        """Each tensor of `like` rebuilt from every dp rank's part."""
        sizes = self.shard_sizes
        full = self.dp.all_gather(torch.cat([p.reshape(-1) for p in parts])
                                  [None], dim=0)  # (dp, sum sizes)
        return [x.reshape(-1)[: t.numel()].view_as(t).to(t.dtype)
                for x, t in zip(full.split(sizes, dim=1), like)]

    @torch.no_grad()
    def _all_gather_updates(self):
        for p, x in zip(self.params, self._gather_parts(self.shards, self.params)):
            p.copy_(x)

    def state_dict(self):
        """The single-device optimizer's state: under a mesh the whole of
        each tensor's m and v (gathered over dp under ZeRO-1 and over tp
        for split tensors); a collective that every rank calls."""
        state = self.adamw.state_dict()
        if self.mesh is not None:
            state = self._whole_state(state)
        return {"adamw": state, "count": self.count}

    def _whole_state(self, state):
        out = {"param_groups": state["param_groups"], "state": {}}
        keys = ("exp_avg", "exp_avg_sq")
        moments = {k: [state["state"][i][k] for i in range(len(self.params))]
                   for k in keys} if state["state"] else None
        if moments is None:
            return out
        for k in keys:
            if self.zero1:
                moments[k] = self._gather_parts(moments[k], self.params)
            moments[k] = [gather_leaf(x, path, self.cfg, self.mesh)
                          for x, path in zip(moments[k], self.paths)]
        for i in range(len(self.params)):
            out["state"][i] = dict(state["state"][i],
                                   **{k: moments[k][i] for k in keys})
        return out

    def load_state_dict(self, state):
        """Load `state_dict`'s state (the single-device optimizer's, or a
        mesh's whole state), keeping this rank's part of each tensor."""
        adamw = state["adamw"]
        if self.mesh is not None and adamw["state"]:
            adamw = {"param_groups": adamw["param_groups"], "state": {}}
            for i, (path, p) in enumerate(zip(self.paths, self.params)):
                entry = dict(state["adamw"]["state"][i])
                for k in ("exp_avg", "exp_avg_sq"):
                    x = shard_leaf(entry[k].to(p.device), path, self.cfg,
                                   self.mesh)
                    if self.zero1:
                        x = zero1_shard_opt_state([x], self.dp)[0][0]
                    entry[k] = x
                adamw["state"][i] = entry
        self.adamw.load_state_dict(adamw)
        self.count = int(state["count"])
        if self.zero1:  # the parts of the parameters the caller restored
            with torch.no_grad():
                for shard, x in zip(self.shards, zero1_shard_opt_state(
                        self.params, self.dp)[0]):
                    shard.copy_(x)


def make_optimizer(params, lr=3e-4, weight_decay: float = 0.01,
                   betas=(0.9, 0.95), grad_clip: Optional[float] = 1.0,
                   trainable_mask=None, mesh=None, cfg=None,
                   zero1: bool = False) -> Optimizer:
    """AdamW + global-norm clip. `lr` is a float or a schedule (update count
    -> learning rate). With `trainable_mask` (bool tree, e.g. `lora_filter`)
    only those tensors train; the others are marked requires_grad False and
    get no optimizer state. `mesh`, `cfg`, `zero1`: see `Optimizer`."""
    schedule = lr if callable(lr) else (lambda step, lr=lr: lr)
    return Optimizer(params, schedule, weight_decay, betas, grad_clip,
                     trainable_mask, mesh=mesh, cfg=cfg, zero1=zero1)


def make_train_step(cfg: DualARConfig, optimizer: Optimizer,
                    grad_accum: int = 1):
    """`train_step(params, batch) -> metrics`, updating params in place.

    Gradients are taken only for the optimizer's tensors. With grad_accum >
    1 every batch leaf carries a leading microbatch axis of that size; the
    step sums the microbatch gradients in fp32 and applies ONE update with
    their mean (metrics are the microbatch means). Under the optimizer's
    mesh the forward runs on this rank's shard and the batch is its dp
    rows; the metrics are the global batch's."""
    mesh = optimizer.mesh
    dp = optimizer.dp

    def train_step(params, batch):
        with use_mesh(mesh):
            return _train_step(params, batch)

    def _train_step(params, batch):
        if grad_accum == 1:
            loss, metrics = dual_ar_loss(params, cfg, batch, dp=dp)
            grads = torch.autograd.grad(loss, optimizer.params)
        else:
            gsum, ms = None, []
            for i in range(grad_accum):
                loss, m = dual_ar_loss(params, cfg,
                                       {k: v[i] for k, v in batch.items()},
                                       dp=dp)
                g = torch.autograd.grad(loss, optimizer.params)
                gsum = ([x.float() for x in g] if gsum is None
                        else [a + x.float() for a, x in zip(gsum, g)])
                ms.append(m)
            grads = [(s / grad_accum).to(p.dtype)
                     for s, p in zip(gsum, optimizer.params)]
            metrics = {k: torch.stack([m[k].float() for m in ms]).mean()
                       for k in ms[0]}
        metrics = dict(metrics)
        metrics["grad_norm"] = optimizer.apply(grads)
        return metrics

    return train_step


# -- LR schedules (reference `fish_speech/scheduler.py`) --


def cosine_schedule_with_warmup(base_lr: float, num_warmup_steps,
                                num_training_steps: int,
                                num_cycles: float = 0.5,
                                final_lr_ratio: float = 0.0):
    if 0 < num_warmup_steps < 1:
        num_warmup_steps = int(num_warmup_steps * num_training_steps)

    def schedule(step):
        step = float(step)
        if step < num_warmup_steps:
            return base_lr * step / max(num_warmup_steps, 1)
        progress = (step - num_warmup_steps) / max(
            num_training_steps - num_warmup_steps, 1)
        cos = 0.5 * (1.0 + math.cos(math.pi * num_cycles * 2.0 * progress))
        return base_lr * max(final_lr_ratio, cos)

    return schedule


def constant_schedule_with_warmup(base_lr: float, num_warmup_steps,
                                  num_training_steps: Optional[int] = None):
    if 0 < num_warmup_steps < 1:
        if num_training_steps is None:
            raise ValueError("a fractional warmup needs num_training_steps")
        num_warmup_steps = int(num_warmup_steps * num_training_steps)

    def schedule(step):
        return base_lr * min(float(step) / max(num_warmup_steps, 1), 1.0)

    return schedule
