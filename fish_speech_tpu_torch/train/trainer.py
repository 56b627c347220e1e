"""Training loop on one device: config -> data -> train loop -> checkpoints.

Port of `fish_speech_tpu/train/trainer.py` without the mesh: `dp`, `tp`,
`zero1` and multi-host runs are the ROADMAP's multi-device trainer item and
raise NotImplementedError here. Checkpoints are directories
`checkpoints/step_XXXXXXXX/` holding `state.pt` (`torch.save` of the
parameters — LoRA leaves only in LoRA mode — and the optimizer state) and
`meta.json`, written last; `fit` resumes from the newest complete one.
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

from fish_speech_tpu_torch.config import DualARConfig
from fish_speech_tpu_torch.models import dual_ar
from fish_speech_tpu_torch.models.lora import (LoraConfig, add_lora,
                                               apply_lora_config, extract_lora,
                                               lora_filter)
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
    # multi-device (not ported: ROADMAP "multi-device trainer")
    dp: Optional[int] = None
    tp: int = 1
    lora: Optional[LoraConfig] = None
    zero1: bool = False


def _copy_into(dst, src):
    """Copy a (sub)tree of tensors into the same-named tensors of dst."""
    for k, v in src.items():
        if isinstance(v, dict):
            _copy_into(dst[k], v)
        else:
            dst[k].copy_(v)


class Trainer:
    def __init__(self, cfg: DualARConfig, train_cfg: TrainConfig, params=None,
                 device="cuda:0"):
        if train_cfg.dp not in (None, 1) or train_cfg.tp != 1 or train_cfg.zero1:
            raise NotImplementedError(
                "dp/tp/zero1 are not ported yet (ROADMAP: multi-device trainer)")
        self.train_cfg = train_cfg
        self.device = resolve_device(device, "Trainer")
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
            trainable_mask=trainable)
        self.accum = max(train_cfg.grad_accum_steps, 1)
        self.train_step = make_train_step(self.cfg, self.optimizer,
                                          grad_accum=self.accum)
        self.step = 0

    # -- checkpointing --

    def _payload_params(self):
        return extract_lora(self.params) if self.lora_mode else self.params

    def save_checkpoint(self):
        path = self.out_dir / "checkpoints" / f"step_{self.step:08d}"
        path.mkdir(parents=True, exist_ok=True)
        torch.save({"params": self._payload_params(),
                    "opt_state": self.optimizer.state_dict()},
                   path / "state.pt")
        with open(path / "meta.json", "w") as f:  # last: marks it complete
            json.dump({"step": self.step}, f)
        self._prune_checkpoints()
        logger.info("Saved checkpoint at step %d -> %s", self.step, path)

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
        with torch.no_grad():
            _copy_into(self.params, state["params"])
        self.optimizer.load_state_dict(state["opt_state"])
        with open(path / "meta.json") as f:
            self.step = json.load(f)["step"]
        logger.info("Resumed from %s (step %d)", path, self.step)
        return True

    # -- loop --

    def _place_batch(self, batch):
        return {k: torch.from_numpy(np.asarray(v)).to(self.device)
                for k, v in batch.items()}

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
                     for k in micro[0]})
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
                _, m = dual_ar_loss(self.params, self.cfg,
                                    self._place_batch(batch), remat=False)
                losses.append({k: float(v) for k, v in m.items()})
        if losses:
            m = {k: float(np.mean([x[k] for x in losses])) for k in losses[0]}
            logger.info("val @ step %d | loss %.4f | top5 %.3f",
                        self.step, m["loss"], m["top_5_accuracy"])
            self._append_log({"step": self.step, "val": m})

    def _append_log(self, record: dict):
        with open(self.out_dir / "metrics.jsonl", "a") as f:
            f.write(json.dumps(record) + "\n")
