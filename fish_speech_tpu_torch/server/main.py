"""API server entry point of the port, with the JAX server's flags.

    python -m fish_speech_tpu_torch.server.main \
        --checkpoint-path checkpoints/s2-pro --listen 127.0.0.1:8080

It serves on the card (`cuda:0`) and fails where there is none; `--cpu`
is the only way to the CPU. `--tiny` starts with random tiny models (no
checkpoint needed; the LM's heads 64 wide, which the kernels take), for
smoke tests and demos:

    python -m fish_speech_tpu_torch.server.main --tiny --cpu

`--int8` quantizes the weights at load (`quantize_dual_ar_lowmem(mode=
"int8")`), `--kv-int8` keeps the KV cache in int8, `--pool-size` > 1 serves
through the continuous batcher (`engine/batcher.py`), and `--prefix-cache`
sizes the voice-clone prefix cache of either session. The LM and the codec
load in bf16, or in fp16 with `--half` (the JAX server's dtypes; the
kernels have fp16 forms), with any of the flags above and under a mesh,
over a checkpoint of int8 or int4 leaves (`tools/quantize.py`) too.
`--tiny` serves fp32 models whatever `--half` says, as JAX's.

Multi-card serving: one process per card, each started with the same flags
and `--coordinator HOST:PORT --num-hosts N --host-id I` (JAX's flags; in the
port the rendezvous, the world size and this process's rank). Rank I runs
on `cuda:{I % cards}` over nccl (with `--cpu` on the CPU over gloo), the LM
is split over a (dp=1, tp=N) mesh, rank 0 serves HTTP and broadcasts each
request (`server/multihost.py`), and the other ranks follow it in lockstep.
As JAX's server, it serves one stream of bf16 (or, with `--half`, fp16)
weights: `--pool-size` > 1 and `--int8` raise under it.
The JAX server's persistent compile cache has no counterpart: `warm_up`
captures the CUDA graphs instead.
"""

from __future__ import annotations

import argparse
import logging
import sys
import threading
import time

logger = logging.getLogger("fish_speech_tpu_torch.server")


def check_args(args, multihost: bool = False):
    """Raise on the JAX server's flags that the port does not serve (under
    multi-card serving, as JAX's refuses them: the pool and int8)."""
    if multihost and args.pool_size > 1:
        raise NotImplementedError(
            "multi-card serving drives the single-stream session; continuous "
            "batching across ranks is not ported (--pool-size 1; ROADMAP §1 "
            "item 10)")
    if multihost and args.int8:
        raise NotImplementedError(
            "int8 weights have no tensor-parallel layout yet; serve "
            "multi-card in bf16 or fp16 (ROADMAP §1 item 10)")


def tiny_models(device):
    """(tokenizer, LM config, LM params, codec config, codec params) of the
    random tiny models, fp32 on `device`: the test tokenizer, `dual_ar_tiny`
    with heads 64 wide (the narrowest the attention kernels take on the
    card) and `dac_tiny`, from seeds 0 and 1."""
    import torch

    from fish_speech_tpu_torch.config import dac_tiny, dual_ar_tiny
    from fish_speech_tpu_torch.models.dac.model import init_dac
    from fish_speech_tpu_torch.models.dual_ar import init_dual_ar
    from fish_speech_tpu_torch.tokenizer import build_test_tokenizer

    tokenizer = build_test_tokenizer()
    dac_cfg = dac_tiny()
    cfg = dual_ar_tiny(
        vocab_size=tokenizer.vocab_size,
        semantic_begin_id=tokenizer.semantic_begin_id,
        semantic_end_id=tokenizer.semantic_end_id,
        im_end_id=tokenizer.im_end_id,
        codebook_size=4096,
        num_codebooks=dac_cfg.rvq.total_codebooks,
        head_dim=64, n_head=4, n_local_heads=2, fast_head_dim=64,
        fast_n_head=3, fast_n_local_heads=1,
    )
    return (tokenizer, cfg, init_dual_ar(0, cfg, dtype=torch.float32, device=device),
            dac_cfg, init_dac(1, dac_cfg, dtype=torch.float32, device=device))


def build_engine(args, multihost: bool = False):
    """The engine `args` ask for: the LM (a checkpoint's, or random tiny
    models with --tiny) in bf16 or, with --half, fp16 (the codec in the
    same dtype, as JAX's), quantized with --int8, behind a single-stream
    `GenerationSession` or, with --pool-size > 1, a `ContinuousBatcher`,
    and the codec. On `cuda:0` unless --cpu. `multihost` (the process group
    is up, `parallel/mesh.py:init_distributed`): on this rank's device, the
    LM split over the (dp=1, tp=world) mesh before the session is built."""
    import dataclasses

    import torch

    from fish_speech_tpu_torch.config import SamplingConfig
    from fish_speech_tpu_torch.engine.tts import TTSInferenceEngine
    from fish_speech_tpu_torch.generate import GenerationSession
    from fish_speech_tpu_torch.tokenizer import FishTokenizer
    from fish_speech_tpu_torch.utils.checkpoint import load_codec, load_dual_ar

    check_args(args, multihost)
    mesh = None
    device = "cpu" if args.cpu else "cuda:0"
    if multihost:
        import torch.distributed as dist

        from fish_speech_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(dp=1, tp=dist.get_world_size(),
                         device="cpu" if args.cpu else None)
        device = mesh.device
    if args.tiny:
        tokenizer, cfg, params, dac_cfg, dac_params = tiny_models(device)
        dtype = torch.float32
    else:
        dtype = torch.float16 if args.half else torch.bfloat16
        params, cfg = load_dual_ar(args.checkpoint_path, dtype=dtype,
                                   device=device)
        tokenizer = FishTokenizer.from_pretrained(args.checkpoint_path)
        cfg = dataclasses.replace(
            cfg, semantic_begin_id=tokenizer.semantic_begin_id,
            semantic_end_id=tokenizer.semantic_end_id,
            im_end_id=tokenizer.im_end_id).resolve()
        dac_params, dac_cfg = load_codec(
            args.decoder_checkpoint_path or args.checkpoint_path,
            dtype=dtype, device=device)

    if args.int8:
        from fish_speech_tpu_torch.ops.quant import quantize_dual_ar_lowmem

        params = quantize_dual_ar_lowmem(params, mode="int8")
    if mesh is not None:
        from fish_speech_tpu_torch.parallel.mesh import shard_params

        params = shard_params(params, cfg, mesh)

    if args.pool_size > 1:
        from fish_speech_tpu_torch.engine.batcher import (BatcherSession,
                                                          ContinuousBatcher)

        batcher = ContinuousBatcher(
            params, cfg, SamplingConfig(), pool_size=args.pool_size,
            dtype=dtype, decode_chunk_size=args.decode_chunk_size,
            first_chunk_size=8, kv_quant=args.kv_int8,
            prefix_cache_size=args.prefix_cache, admit_every=args.admit_every)
        session = BatcherSession(batcher)
    else:
        session = GenerationSession(
            params, cfg, SamplingConfig(), max_batch=1, dtype=dtype,
            decode_chunk_size=args.decode_chunk_size,
            # a small first chunk: the first audio reaches the codec after
            # 8 frames instead of a whole chunk
            first_chunk_size=8, kv_quant=args.kv_int8,
            prefix_cache_size=args.prefix_cache, mesh=mesh)
    # the sessions hold a fused-w13 copy of the weights: drop our reference
    del params
    return TTSInferenceEngine(session, tokenizer, dac_params, dac_cfg,
                              references_dir=args.references_dir)


def warm_up(engine, code_buckets=(32, 64, 128), reference_buckets=()):
    """Start-up warm-up: capture the session's (with the prefix cache on,
    every suffix bucket a hit can take) or the pool's (every signature at
    every prompt bucket and, with the prefix cache on, every suffix bucket
    a hit can take) CUDA graphs and the engine's codec
    graphs of `code_buckets` and `reference_buckets` (the encode of a
    reference clip of that many frames), then the JAX server's warm
    requests: one synthesis and, with a pool, a concurrent burst that
    reaches every admission signature. On the CPU the captures are no-ops
    and the requests run eagerly."""
    from fish_speech_tpu_torch.engine.tts import TTSRequest

    t0 = time.time()
    session = engine.session
    if getattr(session, "concurrent", False):
        times = session.batcher.precompile()
    else:
        times = session.precompile(1, 0, suffix_buckets=session.hit_buckets)
    times.update(engine.precompile(code_buckets, reference_buckets))
    logger.info("Graphs captured in %.1fs: %d", time.time() - t0, len(times))
    for result in engine.inference(TTSRequest(text="Hello world.",
                                              max_new_tokens=32)):
        if result.code == "error":
            raise RuntimeError(f"Warmup failed: {result.error}")

    if getattr(session, "concurrent", False):
        pool = session.batcher.pool_size
        n_burst = min(pool, 16) + (4 if pool > 4 else 0) + 1
        errors = []

        def one(i):
            try:
                for r in engine.inference(TTSRequest(
                        text="Warm up the admission pool.", max_new_tokens=16,
                        seed=i)):
                    if r.code == "error":
                        errors.append(r.error)
            except Exception as e:  # noqa: BLE001 -- reported below
                errors.append(e)

        threads = [threading.Thread(target=one, args=(i,)) for i in range(n_burst)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errors:
            raise RuntimeError(f"Pool warmup failed: {errors[0]}")
    logger.info("Warmup finished in %.1fs", time.time() - t0)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint-path", type=str, default="checkpoints/s2-pro-tpu")
    parser.add_argument("--decoder-checkpoint-path", type=str, default=None)
    parser.add_argument("--listen", type=str, default="127.0.0.1:8080")
    parser.add_argument("--api-key", type=str, default=None)
    parser.add_argument("--half", action="store_true",
                        help="fp16 LM and codec")
    parser.add_argument("--max-text-length", type=int, default=0)
    parser.add_argument("--max-inflight", type=int, default=0,
                        help="cap concurrent /v1/tts requests; excess gets "
                             "503 + Retry-After instead of queueing "
                             "unboundedly (0 = unlimited)")
    parser.add_argument("--references-dir", type=str, default="references")
    parser.add_argument("--decode-chunk-size", type=int, default=64)
    parser.add_argument("--pool-size", type=int, default=1,
                        help=">1 enables continuous batching: a shared "
                             "decode pool serving this many streams")
    parser.add_argument("--admit-every", type=int, default=4,
                        help="pooled decode sub-chunk length: the worker "
                             "checks for new arrivals every this many "
                             "steps; 0 = monolithic --decode-chunk-size "
                             "dispatches")
    parser.add_argument("--prefix-cache", type=int, default=4,
                        help="voice-clone prefix cache entries (0 disables)"
                             ": repeat-speaker requests restore the "
                             "reference prompt's KV and prefill only the "
                             "user text; with --pool-size, same-speaker "
                             "admission groups reuse it too")
    parser.add_argument("--kv-int8", action="store_true",
                        help="int8 KV cache (halves decode KV reads)")
    parser.add_argument("--int8", action="store_true",
                        help="int8 weight-only quantization at load")
    parser.add_argument("--tiny", action="store_true",
                        help="random tiny models (smoke test)")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (else on cuda:0, or fail)")
    parser.add_argument("--no-warmup", action="store_true")
    parser.add_argument("--coordinator", default=None,
                        help="multi-card serving: the rendezvous HOST:PORT "
                             "(one process per card)")
    parser.add_argument("--num-hosts", type=int, default=None)
    parser.add_argument("--host-id", type=int, default=None)
    return parser.parse_args(argv)


def main(argv=None):
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    args = parse_args(argv)

    from aiohttp import web

    from fish_speech_tpu_torch.parallel.mesh import init_distributed
    from fish_speech_tpu_torch.server.app import create_app

    multihost = init_distributed(args.coordinator, args.num_hosts, args.host_id,
                                 device="cpu" if args.cpu else None)
    engine = build_engine(args, multihost=multihost)
    if multihost:
        from fish_speech_tpu_torch.server import multihost as mh

        session = engine.session
        if not args.no_warmup:  # every rank captures the same graphs
            session.precompile(1, 0, suffix_buckets=session.hit_buckets)
        if args.host_id != 0:
            # followers never face HTTP: they replay the leader's requests
            # in lockstep until its stop descriptor
            mh.follower_loop(session, session.cfg)
            return
        mh.wrap_leader(session, session.cfg)
    if not args.no_warmup:
        warm_up(engine)
    app = create_app(engine, api_key=args.api_key,
                     max_text_length=args.max_text_length,
                     max_inflight=args.max_inflight)

    async def _drain_pool(app_):
        # stop the batcher's worker between chunks on SIGTERM/SIGINT;
        # registered here, not in create_app, so test clients can tear apps
        # down without stopping a shared engine
        batcher = getattr(engine.session, "batcher", None)
        if batcher is not None:
            batcher.shutdown()
        if multihost:  # release the followers
            from fish_speech_tpu_torch.server import multihost as mh

            mh.broadcast_stop(engine.session, engine.session.cfg)

    app.on_cleanup.append(_drain_pool)
    host, port = args.listen.rsplit(":", 1)
    logger.info("Serving on http://%s:%s", host, port)
    # handler_cancellation: a dropped client cancels its handler, whose
    # cancel event the engine polls per decode chunk
    web.run_app(app, host=host, port=int(port), print=None,
                handler_cancellation=True)


if __name__ == "__main__":
    main()
