"""Optimizer and train step, in PyTorch.

Port of `fish_speech_tpu/train/step.py` on one device. The JAX package's
`optax.chain(clip_by_global_norm, adamw)` becomes `Optimizer`: global-norm
clipping as optax computes it, then `torch.optim.AdamW` with a decay group
and a no-decay group over the trainable tensors only (state exists only for
them), the learning rate read from the schedule at the update count before
each update (optax evaluates the schedule at count 0 for the first update).
The step updates the parameters in place.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from fish_speech_tpu.config import DualARConfig
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


def _leaves(tree, mask=None):
    """Leaves of a nested dict in insertion order, with their mask bits."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, None if mask is None else mask[k])
        else:
            yield v, True if mask is None else mask[k]


class Optimizer:
    """Global-norm clip then AdamW over the trainable tensors of a tree."""

    def __init__(self, params, schedule: Callable[[int], float],
                 weight_decay: float = 0.01, betas=(0.9, 0.95),
                 grad_clip: Optional[float] = 1.0, trainable_mask=None):
        decay, no_decay = [], []
        for (p, trainable), (_, decays) in zip(
                _leaves(params, trainable_mask),
                _leaves(params, weight_decay_mask(params))):
            p.requires_grad_(bool(trainable))
            if trainable:
                (decay if decays else no_decay).append(p)
        self.params = decay + no_decay
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.count = 0  # updates applied so far
        groups = [{"params": decay, "weight_decay": weight_decay},
                  {"params": no_decay, "weight_decay": 0.0}]
        self.adamw = torch.optim.AdamW(
            [g for g in groups if g["params"]], lr=schedule(0), betas=betas,
            eps=1e-8, weight_decay=weight_decay)

    def apply(self, grads) -> torch.Tensor:
        """One update from `grads` (aligned with `self.params`); returns the
        global norm of the gradients before clipping (fp32 tensor)."""
        norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
        if self.grad_clip is not None:
            # optax.clip_by_global_norm: g unchanged below the limit, else
            # g / norm * limit
            factor = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                                 self.grad_clip / norm)
            grads = [(g.float() * factor).to(g.dtype) for g in grads]
        for p, g in zip(self.params, grads):
            p.grad = g
        lr = float(self.schedule(self.count))
        for group in self.adamw.param_groups:
            group["lr"] = lr
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=True)
        self.count += 1
        return norm

    def state_dict(self):
        return {"adamw": self.adamw.state_dict(), "count": self.count}

    def load_state_dict(self, state):
        self.adamw.load_state_dict(state["adamw"])
        self.count = int(state["count"])


def make_optimizer(params, lr=3e-4, weight_decay: float = 0.01,
                   betas=(0.9, 0.95), grad_clip: Optional[float] = 1.0,
                   trainable_mask=None) -> Optimizer:
    """AdamW + global-norm clip. `lr` is a float or a schedule (update count
    -> learning rate). With `trainable_mask` (bool tree, e.g. `lora_filter`)
    only those tensors train; the others are marked requires_grad False and
    get no optimizer state."""
    schedule = lr if callable(lr) else (lambda step, lr=lr: lr)
    return Optimizer(params, schedule, weight_decay, betas, grad_clip,
                     trainable_mask)


def make_train_step(cfg: DualARConfig, optimizer: Optimizer,
                    grad_accum: int = 1):
    """`train_step(params, batch) -> metrics`, updating params in place.

    Gradients are taken only for the optimizer's tensors. With grad_accum >
    1 every batch leaf carries a leading microbatch axis of that size; the
    step sums the microbatch gradients in fp32 and applies ONE update with
    their mean (metrics are the microbatch means)."""

    def train_step(params, batch):
        if grad_accum == 1:
            loss, metrics = dual_ar_loss(params, cfg, batch)
            grads = torch.autograd.grad(loss, optimizer.params)
        else:
            gsum, ms = None, []
            for i in range(grad_accum):
                loss, m = dual_ar_loss(params, cfg,
                                       {k: v[i] for k, v in batch.items()})
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
