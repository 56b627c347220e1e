#!/usr/bin/env python3
"""Where the device time of one LoRA fine-tune step goes, on one GPU.

    PYTHONPATH=. python3 scripts/train_step_profile.py [--steps 3]

Builds `chip_smoke.py`'s training slice (full-width `dual_ar_s2_pro`, bf16,
random weights, LoRA r=8 on attention/mlp/embeddings/output, remat, one
B=2 x T=1024 batch of the shared data pipeline), runs two warm-up steps of
`Trainer.train_step`, times `--steps` steps (host time until `train_step`
returns, i.e. until its kernels are enqueued, and until the host sync of
its loss), then profiles `--steps` steps with `torch.profiler` and prints
the device kernel time per step by kernel class, the device's idle share
under the profiler, and the ten kernels that take the most time.
"""

from __future__ import annotations

import argparse
import collections
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

CLASSES = [  # (class, substrings of the kernel name), first match wins
    ("attention forward", ("train_fwd",)),
    ("attention backward", ("train_bwd",)),
    ("cuBLAS products", ("gemm", "sm90_", "cutlass", "nvjet", "xmma")),
    ("copies and casts", ("copy", "cast", "cat_", "catarray")),
    ("elementwise and reductions", ("elementwise", "reduce", "softmax",
                                    "norm", "vectorized", "unrolled")),
]


def _class(name: str) -> str:
    low = name.lower()
    for label, keys in CLASSES:
        if any(k in low for k in keys):
            return label
    return "other"


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=3)
    args = parser.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import _s2_pro_cfg, _write_protos
    from fish_speech_tpu_torch.data.dataset import (SemanticIterableDataset,
                                                    TextDataCollator)
    from fish_speech_tpu_torch.models.lora import LoraConfig
    from fish_speech_tpu_torch.tokenizer import build_test_tokenizer
    from fish_speech_tpu_torch.train.trainer import TrainConfig, Trainer

    if not torch.cuda.is_available():
        raise SystemExit("train_step_profile: CUDA is not available")
    dev = torch.device("cuda:0")
    tokenizer = build_test_tokenizer()
    cfg = _s2_pro_cfg(tokenizer, 1024)
    out = Path(tempfile.mkdtemp(prefix="train_profile_"))
    proto = _write_protos(out / "data.protos", cfg.num_codebooks,
                          cfg.codebook_size, np.random.default_rng(0))
    ds = SemanticIterableDataset([str(proto)], tokenizer, seed=0,
                                 max_length=1024, num_codebooks=cfg.num_codebooks)
    stream = iter(ds)
    batch = TextDataCollator(tokenizer, 1024)([next(stream) for _ in range(2)])
    lora = LoraConfig(r=8, lora_alpha=16.0,
                      target_modules=["attention", "mlp", "embeddings", "output"])
    tcfg = TrainConfig(output_dir=str(out), project="lora", max_steps=10,
                       batch_size=2, max_length=1024, lr=1e-3, warmup_steps=1,
                       schedule="constant", seed=0, precision="bfloat16",
                       lora=lora)
    trainer = Trainer(cfg, tcfg, device=dev)
    placed = trainer._place_batch(batch)

    def step():
        return float(trainer.train_step(trainer.params, placed)["loss"])

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    enqueued, synced = [], []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        loss = trainer.train_step(trainer.params, placed)["loss"]
        enqueued.append(time.perf_counter() - t0)
        float(loss)
        synced.append(time.perf_counter() - t0)
    print(f"unprofiled steps: host enqueue {np.mean(enqueued):.4f} s/step, "
          f"synced {np.mean(synced):.4f} s/step "
          f"({', '.join(f'{x:.3f}' for x in synced)})")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.steps

    by_class, by_name = collections.Counter(), collections.Counter()
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.self_device_time_total / args.steps
        by_class[_class(e.key)] += us
        by_name[e.key] += us
    busy = sum(by_class.values()) / 1e6
    print(f"card: {torch.cuda.get_device_name(0)}")
    print(f"step (host, synced): {wall:.4f} s; device kernels {busy:.4f} s "
          f"per step; device idle {100 * (1 - busy / wall):.1f}%")
    for label, us in by_class.most_common():
        print(f"  {label}: {us / 1e3:.2f} ms per step, "
              f"{100 * us / 1e6 / busy:.1f}% of device time")
    print("top kernels (ms per step):")
    for name, us in by_name.most_common(10):
        print(f"  {us / 1e3:9.2f}  {name[:110]}")


if __name__ == "__main__":
    main()
