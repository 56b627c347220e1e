"""Training loop: config -> data -> train loop -> checkpoints.

Port of `fish_speech_tpu/train/trainer.py`. On one device, or on a (dp, tp)
mesh of one process per card (`parallel/mesh.py`; `dp`, `tp` and `zero1`
as JAX's): each rank holds its shard of the tree (`shard_params`; LoRA
leaves replicated, as JAX's `_match_tree` keeps them) and takes its dp
rows of each batch (`_place_batch`), and the step sums the gradients over
dp (`train/step.py`; ZeRO-1 keeps each dp rank's part of AdamW's m and v).
Under tp the training attention kernels run on each rank's heads, where
JAX keeps XLA's attention under a mesh. Checkpoints are directories
`checkpoints/step_XXXXXXXX/` holding `state.pt` (`torch.save` of the
parameters — LoRA leaves only in LoRA mode — and the optimizer state) and
`meta.json`, written last; `fit` resumes from the newest complete one. Under
a mesh rank 0 writes the whole state, gathered first (the file is the one a
single device would write), and every rank restores its part of it.
"""

from __future__ import annotations

import json
import logging
import shutil
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from fish_speech_tpu_torch.config import DualARConfig
from fish_speech_tpu_torch.models import dual_ar
from fish_speech_tpu_torch.models.lora import (LoraConfig, add_lora,
                                               apply_lora_config, extract_lora,
                                               lora_filter)
from fish_speech_tpu_torch.parallel.mesh import (shard_params, unshard_params,
                                                 use_mesh)
from fish_speech_tpu_torch.train.loss import dual_ar_loss
from fish_speech_tpu_torch.train.step import (constant_schedule_with_warmup,
                                              cosine_schedule_with_warmup,
                                              make_optimizer, make_train_step)
from fish_speech_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


@dataclass
class TrainConfig:
    """Mirrors the reference finetune defaults
    (`configs/text2semantic_finetune.yaml`, `configs/base.yaml`)."""

    project: str = "text2semantic_finetune"
    output_dir: str = "results"
    max_steps: int = 10000
    batch_size: int = 4
    grad_accum_steps: int = 1  # microbatches per optimizer step
    max_length: int = 4096
    lr: float = 1e-4
    weight_decay: float = 0.01
    betas: tuple = (0.9, 0.95)
    grad_clip: float = 1.0
    warmup_steps: int = 100
    schedule: str = "cosine"  # "cosine" | "constant"
    final_lr_ratio: float = 0.1
    val_every_steps: int = 100
    val_batches: int = 4
    ckpt_every_steps: int = 1000
    keep_ckpts: int = 5
    log_every_steps: int = 10
    seed: int = 42
    precision: str = "bfloat16"
    # the mesh's shape (None: 1); dp x tp > 1 needs Trainer(mesh=)
    dp: Optional[int] = None
    tp: int = 1
    lora: Optional[LoraConfig] = None
    # ZeRO-1: each dp rank keeps AdamW's m and v for its 1/dp of every
    # trainable tensor (`train/step.py`); the same updates as replicated
    zero1: bool = False


def _copy_into(dst, src):
    """Copy a (sub)tree of tensors into the same-named tensors of dst."""
    for k, v in src.items():
        if isinstance(v, dict):
            _copy_into(dst[k], v)
        else:
            dst[k].copy_(v)


class Trainer:
    """`mesh`: this rank's (dp, tp) mesh (`parallel.mesh.make_mesh`), the
    only way to a sharded trainer: dp x tp > 1 without one raises.
    `device`: on one device the trainer's; under a mesh the mesh's.
    `params`: the full tree, the same on every rank. `local_batches`:
    the loader gives this rank's own rows (each process reads its shard of
    the data, as the CLI does); else it gives the global batch, the same on
    every rank, and each rank takes its dp rows."""

    def __init__(self, cfg: DualARConfig, train_cfg: TrainConfig, params=None,
                 device="cuda:0", mesh=None, local_batches: bool = False):
        self.train_cfg = train_cfg
        if mesh is None and (train_cfg.dp or 1) * train_cfg.tp > 1:
            raise ValueError(
                f"dp={train_cfg.dp} x tp={train_cfg.tp} needs a mesh over that "
                f"many ranks: start one process per rank, call "
                f"parallel.mesh.init_distributed, and pass mesh=make_mesh(...)")
        self.mesh = mesh
        self.local_batches = local_batches
        self.device = mesh.device if mesh is not None else resolve_device(
            device, "Trainer")
        self.out_dir = Path(train_cfg.output_dir) / train_cfg.project
        self.out_dir.mkdir(parents=True, exist_ok=True)

        dtype = torch.bfloat16 if train_cfg.precision == "bfloat16" else torch.float32
        if params is None:
            params = dual_ar.init_dual_ar(train_cfg.seed, cfg, dtype, self.device)
        trainable = None
        if train_cfg.lora is not None:
            params = add_lora(params, cfg, train_cfg.lora, train_cfg.seed + 1,
                              dtype=dtype)
            cfg = apply_lora_config(cfg, train_cfg.lora)
            trainable = lora_filter(params)
        self.cfg = cfg.resolve()
        self.lora_mode = train_cfg.lora is not None
        if mesh is not None:
            with torch.no_grad():
                params = shard_params(params, self.cfg, mesh)
        self.params = params

        if train_cfg.schedule == "cosine":
            schedule = cosine_schedule_with_warmup(
                train_cfg.lr, train_cfg.warmup_steps, train_cfg.max_steps,
                final_lr_ratio=train_cfg.final_lr_ratio)
        else:
            schedule = constant_schedule_with_warmup(
                train_cfg.lr, train_cfg.warmup_steps, train_cfg.max_steps)
        self.optimizer = make_optimizer(
            params, lr=schedule, weight_decay=train_cfg.weight_decay,
            betas=train_cfg.betas, grad_clip=train_cfg.grad_clip,
            trainable_mask=trainable, mesh=mesh, cfg=self.cfg,
            zero1=train_cfg.zero1)
        self.accum = max(train_cfg.grad_accum_steps, 1)
        self.train_step = make_train_step(self.cfg, self.optimizer,
                                          grad_accum=self.accum)
        self.step = 0

    # -- checkpointing --

    def _payload_params(self):
        return extract_lora(self.params) if self.lora_mode else self.params

    @property
    def writer(self) -> bool:
        """Whether this process writes the checkpoints and the log."""
        return self.mesh is None or dist.get_rank() == 0

    def save_checkpoint(self):
        """Every rank calls it (under a mesh the state is gathered first);
        rank 0 writes."""
        params = self._payload_params()
        opt_state = self.optimizer.state_dict()
        if self.mesh is not None:
            params = unshard_params(params, self.cfg, self.mesh)
        path = self.out_dir / "checkpoints" / f"step_{self.step:08d}"
        if self.writer:
            path.mkdir(parents=True, exist_ok=True)
            torch.save({"params": params, "opt_state": opt_state},
                       path / "state.pt")
            with open(path / "meta.json", "w") as f:  # last: marks it complete
                json.dump({"step": self.step}, f)
            self._prune_checkpoints()
            logger.info("Saved checkpoint at step %d -> %s", self.step, path)
        if self.mesh is not None:  # no rank reads it before it is whole
            self.mesh.barrier()

    def _checkpoints(self):
        ckpt_dir = self.out_dir / "checkpoints"
        return sorted(p for p in ckpt_dir.glob("step_*")
                      if (p / "meta.json").exists())

    def _prune_checkpoints(self):
        for old in self._checkpoints()[: -self.train_cfg.keep_ckpts]:
            shutil.rmtree(old)

    def latest_checkpoint(self) -> Optional[Path]:
        ckpts = self._checkpoints()
        return ckpts[-1] if ckpts else None

    def restore_checkpoint(self, path=None) -> bool:
        path = Path(path) if path else self.latest_checkpoint()
        if path is None:
            return False
        state = torch.load(path / "state.pt", map_location=self.device,
                           weights_only=True)
        params = state["params"]
        with torch.no_grad():
            if self.mesh is not None:
                params = shard_params(params, self.cfg, self.mesh)
            _copy_into(self.params, params)
        self.optimizer.load_state_dict(state["opt_state"])
        with open(path / "meta.json") as f:
            self.step = json.load(f)["step"]
        logger.info("Resumed from %s (step %d)", path, self.step)
        return True

    # -- loop --

    def _place_batch(self, batch, accum: bool = False):
        """The batch on this rank's device: under dp its rows (axis 1 of
        a microbatch-stacked batch), unless the loader gave them."""
        out = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
        dp = self.mesh.dp if self.mesh is not None else None
        if dp is not None and dp.size > 1 and not self.local_batches:
            axis = 1 if accum else 0
            n = out["inputs"].shape[axis]
            if n % dp.size:
                raise ValueError(f"a batch of {n} rows does not split over "
                                 f"dp={dp.size}")
            out = {k: v.narrow(axis, dp.rank * (n // dp.size), n // dp.size)
                   for k, v in out.items()}
        return {k: v.to(self.device) for k, v in out.items()}

    def fit(self, train_loader, val_loader=None, resume: bool = True):
        if resume:
            self.restore_checkpoint()
        tcfg = self.train_cfg
        t0 = time.perf_counter()
        window_metrics = []

        train_iter = iter(train_loader)
        while self.step < tcfg.max_steps:
            if self.accum > 1:
                micro = [next(train_iter) for _ in range(self.accum)]
                batch = self._place_batch(
                    {k: np.stack([np.asarray(m[k]) for m in micro])
                     for k in micro[0]}, accum=True)
            else:
                batch = self._place_batch(next(train_iter))
            window_metrics.append(self.train_step(self.params, batch))
            self.step += 1

            if self.step % tcfg.log_every_steps == 0:
                m = {k: float(np.mean([float(w[k]) for w in window_metrics]))
                     for k in window_metrics[0]}
                dt = time.perf_counter() - t0
                t0 = time.perf_counter()
                sps = tcfg.log_every_steps / dt
                logger.info(
                    "step %d | loss %.4f (base %.4f semantic %.4f) | "
                    "top5 %.3f | grad %.3f | %.2f it/s",
                    self.step, m["loss"], m["base_loss"], m["semantic_loss"],
                    m["top_5_accuracy"], m["grad_norm"], sps)
                self._append_log({"step": self.step, **m, "it_per_s": sps})
                window_metrics = []

            if val_loader is not None and self.step % tcfg.val_every_steps == 0:
                self.validate(val_loader)

            if self.step % tcfg.ckpt_every_steps == 0:
                self.save_checkpoint()

        if self.step % tcfg.ckpt_every_steps != 0:
            self.save_checkpoint()

    def validate(self, val_loader):
        losses = []
        with torch.no_grad():
            for i, batch in enumerate(val_loader):
                if i >= self.train_cfg.val_batches:
                    break
                with use_mesh(self.mesh):
                    _, m = dual_ar_loss(self.params, self.cfg,
                                        self._place_batch(batch), remat=False,
                                        dp=self.optimizer.dp)
                losses.append({k: float(v) for k, v in m.items()})
        if losses:
            m = {k: float(np.mean([x[k] for x in losses])) for k in losses[0]}
            logger.info("val @ step %d | loss %.4f | top5 %.3f",
                        self.step, m["loss"], m["top_5_accuracy"])
            self._append_log({"step": self.step, "val": m})

    def _append_log(self, record: dict):
        if not self.writer:
            return
        with open(self.out_dir / "metrics.jsonl", "a") as f:
            f.write(json.dumps(record) + "\n")
