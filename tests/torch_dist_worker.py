"""One rank of the port's multi-process CPU tests (`tests/test_torch_mesh.py`,
`test_torch_tp_serving.py`, `test_torch_multihost.py`,
`test_torch_dp_train.py`).

`spawn_ranks(scenario, world, workdir)` starts `world` processes of

    python tests/torch_dist_worker.py SCENARIO RENDEZVOUS RANK WORLD WORKDIR

over gloo (a `file://` rendezvous inside WORKDIR, so concurrent test
workers never share one), waits for them with a timeout, kills every rank
if one fails or the time runs out, and raises with their output. Inputs
come from WORKDIR/inputs.pt (written by the test, `torch.save`), each rank
writes WORKDIR/result_{rank}.pt. The ranks import torch and the port only.
"""

from __future__ import annotations

import datetime
import os
import subprocess
import sys
import time
from pathlib import Path

TIMEOUT = datetime.timedelta(seconds=120)


def spawn_ranks(scenario: str, world: int, workdir, timeout: float = 240.0):
    """Run `scenario` on `world` gloo ranks; returns their results (a list
    indexed by rank)."""
    import torch

    workdir = Path(workdir)
    url = f"file://{workdir}/rendezvous"
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("CUDA_VISIBLE_DEVICES", None)
    root = str(Path(__file__).resolve().parents[1])
    env["PYTHONPATH"] = os.pathsep.join([root] + [
        p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    logs = [open(workdir / f"rank_{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, scenario, url, str(r), str(world),
         str(workdir)], stdout=logs[r], stderr=subprocess.STDOUT, env=env,
        cwd=root) for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:  # a rank left waiting on a failed one, or a hang
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    outs = [(workdir / f"rank_{r}.log").read_text() for r in range(world)]
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:  # a killed rank's code is negative
        raise AssertionError("ranks %s of %s failed:\n%s" % (
            failed, scenario, "\n".join(f"--- rank {r} ---\n{o[-3000:]}"
                                        for r, o in enumerate(outs))))
    return [torch.load(workdir / f"result_{r}.pt", weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------------------
# Scenarios (run inside a rank)
# ---------------------------------------------------------------------------


def _serve(inputs, mesh):
    """Greedy sessions (plain and int8 KV) and the teacher-forced forward
    on this rank's tp shard."""
    import torch

    from fish_speech_tpu_torch.config import SamplingConfig
    from fish_speech_tpu_torch.generate import GenerationSession
    from fish_speech_tpu_torch.models import dual_ar
    from fish_speech_tpu_torch.parallel.mesh import shard_params, use_mesh

    cfg, params = inputs["cfg"], inputs["params"]
    shard = shard_params(params, cfg, mesh)
    out = {"codes": {}, "eager_runs": {}}
    for kv_quant in (False, True):
        s = GenerationSession(shard, cfg, SamplingConfig(), dtype=torch.float32,
                              decode_chunk_size=8, kv_quant=kv_quant, mesh=mesh)
        out["codes"][kv_quant] = s.generate(inputs["prompt"], 5, top_k=1,
                                            max_new_tokens=12)
        out["codes"][kv_quant, "sampled"] = s.generate(
            inputs["prompt"], 5, temperature=0.8, top_k=30, max_new_tokens=12)
        out["eager_runs"][kv_quant] = dict(s.eager_runs)
        out["cache_heads"] = s.cache["k"].shape[3]
    with use_mesh(mesh), torch.no_grad():
        out["logits"] = dual_ar.forward_train(shard, cfg, inputs["forward_inp"],
                                              remat=False)
    return out


def _train(inputs, mesh):
    """Steps on this rank's shard and dp rows: through `Trainer` (inputs
    "train_cfg"), or, for a tree that already holds its LoRA leaves, through
    the optimizer and step themselves. Returns the metrics, the whole
    parameters after the steps, this rank's AdamW m/v bytes and, with
    "save_at", the whole parameters of a trainer resumed from the
    checkpoint of that step."""
    import torch

    from fish_speech_tpu_torch.models.lora import lora_filter
    from fish_speech_tpu_torch.parallel.mesh import shard_params, unshard_params
    from fish_speech_tpu_torch.train.step import (cosine_schedule_with_warmup,
                                                  make_optimizer,
                                                  make_train_step)
    from fish_speech_tpu_torch.train.trainer import Trainer

    cfg = inputs["cfg"]
    trainer = None
    if "train_cfg" in inputs:
        trainer = Trainer(cfg, inputs["train_cfg"], params=inputs["params"],
                          device="cpu", mesh=mesh)
        params, opt, step = trainer.params, trainer.optimizer, trainer.train_step
        place = trainer._place_batch
    else:
        params = shard_params(inputs["params"], cfg, mesh)
        opt = make_optimizer(
            params, lr=cosine_schedule_with_warmup(*inputs["schedule"],
                                                   final_lr_ratio=0.1),
            grad_clip=inputs["grad_clip"], trainable_mask=lora_filter(params),
            mesh=mesh, cfg=cfg, zero1=inputs["zero1"])
        step = make_train_step(cfg, opt)

        def place(batch):
            n = len(batch["inputs"]) // mesh.dp.size
            return {k: torch.from_numpy(v[mesh.dp.rank * n:(mesh.dp.rank + 1) * n])
                    for k, v in batch.items()}
    metrics = []
    for i, batch in enumerate(inputs["batches"]):
        metrics.append({k: float(v) for k, v in step(params, place(batch)).items()})
        if trainer is not None:
            trainer.step += 1
            if inputs.get("save_at") == i + 1:
                trainer.save_checkpoint()
    out = {"metrics": metrics, "params": unshard_params(params, cfg, mesh),
           "opt_bytes": sum(t.numel() * t.element_size()
                            for st in opt.adamw.state.values()
                            for k, t in st.items() if k != "step")}
    if inputs.get("save_at"):
        resumed = Trainer(cfg, inputs["train_cfg"], params=inputs["params"],
                          device="cpu", mesh=mesh)
        assert resumed.restore_checkpoint()
        assert resumed.step == inputs["save_at"]
        for batch in inputs["batches"][resumed.step:]:
            resumed.train_step(resumed.params, resumed._place_batch(batch))
        out["resumed"] = unshard_params(resumed.params, resumed.cfg, mesh)
    return out


def _server(inputs, mesh_unused):
    """The server's own multi-card path: `build_engine(multihost=True)`,
    rank 0 leading (`wrap_leader` + `engine.inference`), the others
    following, as `tests/multihost_serving_worker.py` drives the JAX one."""
    import torch.distributed as dist

    from fish_speech_tpu_torch.server import multihost as mh
    from fish_speech_tpu_torch.server.main import build_engine, parse_args

    engine = build_engine(parse_args(inputs["args"]), multihost=True)
    session = engine.session
    out = {"heads": session.cache["k"].shape[3]}
    if dist.get_rank() == 0:
        mh.wrap_leader(session, session.cfg)
        for seed in (7, 8):
            out[seed] = run_request(engine, seed)
        out["stream", 9] = run_streaming_request(engine, 9)
        # abandoned after its first segment: the leader drains the stream,
        # so the next request still runs in lockstep
        run_streaming_request(engine, 10, abandon_after=1)
        out[11] = run_request(engine, 11)
        mh.broadcast_stop(session, session.cfg)
    else:
        out["served"] = mh.follower_loop(session, session.cfg)
    return out


def run_request(engine, seed: int) -> str:
    """One request; a digest of its final audio."""
    import hashlib

    from fish_speech_tpu_torch.engine.tts import TTSRequest

    final = None
    for result in engine.inference(TTSRequest(text="Hello world.",
                                              max_new_tokens=16, seed=seed)):
        if result.code == "error":
            raise result.error
        if result.code == "final":
            final = result.audio[1]
    assert final is not None, "no final audio"
    return hashlib.sha256(final.tobytes()).hexdigest()[:16]


def run_streaming_request(engine, seed: int, abandon_after: int = 0) -> str:
    """One streamed request; a digest of its segments. `abandon_after` > 0
    closes the stream after that many segments (a client that leaves)."""
    import hashlib

    import numpy as np

    from fish_speech_tpu_torch.engine.tts import TTSRequest

    gen = engine.inference(TTSRequest(text="Hello world.", max_new_tokens=16,
                                      seed=seed, streaming=True))
    chunks = []
    try:
        for result in gen:
            if result.code == "error":
                raise result.error
            if result.code == "segment":
                chunks.append(result.audio[1])
                if abandon_after and len(chunks) >= abandon_after:
                    break
    finally:
        gen.close()
    assert chunks, "no streamed audio segments"
    return hashlib.sha256(b"".join(np.ascontiguousarray(c).tobytes()
                                   for c in chunks)).hexdigest()[:16]


SCENARIOS = {"serve": _serve, "train": _train, "server": _server}


def main():
    scenario, url, rank, world, workdir = sys.argv[1:6]
    rank, world, workdir = int(rank), int(world), Path(workdir)
    import torch

    torch.set_num_threads(1)
    from fish_speech_tpu_torch.parallel.mesh import init_distributed, make_mesh

    inputs = torch.load(workdir / "inputs.pt", weights_only=False)
    assert init_distributed(url, world, rank, device="cpu", timeout=TIMEOUT)
    mesh = None
    if scenario != "server":  # the server builds its own
        mesh = make_mesh(dp=inputs.get("dp", 1), tp=inputs.get("tp", world),
                         device="cpu", timeout=TIMEOUT)
    out = SCENARIOS[scenario](inputs, mesh)
    torch.save(out, workdir / f"result_{rank}.pt")
    import torch.distributed as dist

    if mesh is not None:
        mesh.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
