"""The multi-rank dry run: one full training step on a (dp, tp) mesh.

Counterpart of `__graft_entry__.py:dryrun_multichip` on torch.distributed:
`dryrun_multichip(n)` starts n processes (one rank each: over nccl on
`cuda:{rank}`, or with `device="cpu"` over gloo on the CPU), builds the
mesh as JAX's does (dp=2, tp=n/2 from four ranks on, else dp=1, tp=n),
splits the model of `entry_config()` Megatron-style and runs one training
step (loss, gradients, AdamW) on a global batch split over dp, then, with
dp > 1, one ZeRO-1 step. It waits for the ranks with a timeout, kills them
all if one fails, and raises with their output.

    python -m fish_speech_tpu_torch.parallel.dryrun 4 [--cpu]
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np


def entry_config():
    """The model of `__graft_entry__._entry_config` (the flagship's
    structure at a reduced width; a copy, the port imports nothing of the
    JAX package)."""
    from fish_speech_tpu_torch.config import DualARConfig

    return DualARConfig(
        vocab_size=8192, n_layer=4, n_head=8, n_local_heads=2, dim=512,
        head_dim=64, intermediate_size=1536, max_seq_len=1024,
        attention_qk_norm=True, tie_word_embeddings=False, codebook_size=4096,
        num_codebooks=10, n_fast_layer=2, fast_dim=256, fast_n_head=4,
        fast_n_local_heads=2, fast_head_dim=64, fast_intermediate_size=768,
        semantic_begin_id=100, semantic_end_id=4195, im_end_id=5,
        scale_codebook_embeddings=True, norm_fastlayer_input=True,
    ).resolve()


def make_batch(cfg, batch: int = 2, t: int = 128, seed: int = 0):
    """`__graft_entry__._make_batch`: text ids with 70% semantic positions."""
    rng = np.random.default_rng(seed)
    inputs = np.zeros((batch, cfg.num_codebooks + 1, t), dtype=np.int32)
    inputs[:, 0] = rng.integers(6, 99, size=(batch, t))
    sem = rng.random((batch, t)) < 0.7
    codes = rng.integers(0, cfg.codebook_size, size=(batch, cfg.num_codebooks, t))
    for b in range(batch):
        inputs[b, 0, sem[b]] = cfg.semantic_begin_id + codes[b, 0, sem[b]] % (
            cfg.semantic_end_id - cfg.semantic_begin_id + 1)
        inputs[b, 1:, sem[b]] = codes[b][:, sem[b]].T
    return {"inputs": inputs, "labels": inputs.copy(),
            "pad_mask": np.zeros((batch, t), dtype=bool)}


def mesh_shape(n: int):
    """(dp, tp) of n ranks, as JAX's dry run lays them out."""
    return (2, n // 2) if n >= 4 else (1, n)


def dryrun_multichip(n: int, device: str = "cuda", timeout: float = 900.0) -> dict:
    """Run the dry run on n ranks; returns rank 0's report (mesh, loss,
    grad_norm, zero1_loss)."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    root = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        tmp = Path(tmp)
        logs = [open(tmp / f"rank_{r}.log", "w") for r in range(n)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "fish_speech_tpu_torch.parallel.dryrun",
             "--rank", str(r), str(n), device, str(tmp)],
            stdout=logs[r], stderr=subprocess.STDOUT, env=env, cwd=root)
            for r in range(n)]
        deadline = time.monotonic() + timeout
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
        if any(p.returncode != 0 for p in procs):
            raise RuntimeError("dryrun_multichip(%d) failed:\n%s" % (n, "\n".join(
                f"--- rank {r} (exit {p.returncode}) ---\n"
                + (tmp / f"rank_{r}.log").read_text()[-3000:]
                for r, p in enumerate(procs))))
        return json.loads((tmp / "report.json").read_text())


def _rank_main(rank: int, n: int, device: str, tmp: Path):
    import torch

    from fish_speech_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from fish_speech_tpu_torch.train.trainer import TrainConfig, Trainer

    torch.set_num_threads(1)
    dev = "cpu" if device == "cpu" else f"cuda:{rank}"
    init_distributed(f"file://{tmp}/rendezvous", n, rank, device=dev)
    dp, tp = mesh_shape(n)
    mesh = make_mesh(dp=dp, tp=tp, device=dev)
    cfg = entry_config()
    report = {"mesh": {"dp": dp, "tp": tp}}
    for zero1 in ((False, True) if dp > 1 else (False,)):
        tcfg = TrainConfig(output_dir=str(tmp / "out"), max_steps=1,
                           batch_size=2, max_length=cfg.max_seq_len, lr=1e-4,
                           warmup_steps=0, precision="float32", dp=dp, tp=tp,
                           zero1=zero1)
        trainer = Trainer(cfg, tcfg, mesh=mesh)
        batch = trainer._place_batch(make_batch(cfg, batch=2, t=64,
                                                seed=int(zero1)))
        m = trainer.train_step(trainer.params, batch)
        loss = float(m["loss"])
        if not np.isfinite(loss):
            raise RuntimeError(f"non-finite loss in the dry run: {loss}")
        key = "zero1_loss" if zero1 else "loss"
        report[key] = loss
        report["grad_norm" if not zero1 else "zero1_grad_norm"] = float(
            m["grad_norm"])
    if rank == 0:
        (tmp / "report.json").write_text(json.dumps(report))
    mesh.barrier()
    torch.distributed.destroy_process_group()


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--rank"]:
        _rank_main(int(argv[1]), int(argv[2]), argv[3], Path(argv[4]))
        return
    n = int(argv[0])
    report = dryrun_multichip(n, device="cpu" if "--cpu" in argv else "cuda")
    print(f"dryrun_multichip OK: mesh={report['mesh']} loss={report['loss']:.4f}"
          + (f" zero1_loss={report['zero1_loss']:.4f}" if "zero1_loss" in report
             else ""))


if __name__ == "__main__":
    main()
