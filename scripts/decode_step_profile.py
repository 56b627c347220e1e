#!/usr/bin/env python3
"""Where the device time of one replayed decode step goes, on one GPU.

    PYTHONPATH=. python3 scripts/decode_step_profile.py [--pool N] \
        [bf16|mixed|int4|int8 ...]

For each mode (default: bf16 and mixed) builds `chip_smoke.py`'s serving
LM (full-width `dual_ar_s2_pro`, random weights from seed 0, max_seq_len
2048; `mixed`: slow int8, fast int4, heads int8, int8 KV cache; `int4`:
every layer int4; `int8`: every layer int8, int8 KV cache), captures the
session's graphs with `precompile`, serves one 72-token request untimed,
then times a chunk of 64 replays of the step graph with CUDA events and
profiles another with `torch.profiler`. With `--pool N` the step is the
continuous batcher's at N rows instead (`chip_smoke.py`'s phase-8 pool:
its step graph captured, every row at position 256), replayed in
sub-chunks of its step buffer. Prints
the step's device time, the kernels' busy time and the gaps between them,
the kernel time per step by kernel class, and the kernels that take the
most time, beside the card's name and power limit.
"""

from __future__ import annotations

import collections
import gc
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

CLASSES = [  # (class, substrings of the kernel name), first match wins
    ("decode attention (hand-written)", ("decode_",)),
    ("int4 matvec (hand-written)", ("int4_",)),
    ("int8 matvec (hand-written)", ("int8_gemv",)),
    ("int8 FFN (hand-written)", ("int8_ffn",)),
    ("cuBLAS products", ("gemm", "gemv", "sm90_", "cutlass", "nvjet", "xmma")),
    ("top-k and sort", ("topk", "sort", "radix", "bitonic")),
    ("copies and casts", ("copy", "cast", "cat_", "catarray", "index")),
    ("elementwise and reductions", ("elementwise", "reduce", "softmax",
                                    "norm", "vectorized", "unrolled", "scan")),
]
STEPS = 64


def _class(name: str) -> str:
    low = name.lower()
    for label, keys in CLASSES:
        if any(k in low for k in keys):
            return label
    return "other"


def _session_steps(params, cfg, mode, tokenizer):
    """The single-stream session's step: (run STEPS steps, launches per
    step, the owner to free)."""
    import torch

    from chip_smoke import _prompt_len, _requests
    from fish_speech_tpu_torch.config import SamplingConfig
    from fish_speech_tpu_torch.generate import GenerationSession

    session = GenerationSession(params, cfg, SamplingConfig(),
                                dtype=torch.bfloat16, decode_chunk_size=STEPS,
                                first_chunk_size=8, kv_quant=mode != "bf16")
    req = dict(_requests())["short"]
    t = _prompt_len(tokenizer, cfg, req.text)
    session.precompile(t, 72, 8)
    prompt = torch.randint(0, cfg.codebook_size, (cfg.num_codebooks + 1, t),
                           generator=torch.Generator().manual_seed(0),
                           dtype=torch.int32).numpy()
    session.generate(prompt, session.new_generator(0), max_new_tokens=72,
                     top_k=30)
    gen = session.new_generator(1)
    return (lambda: session.decode_chunk(STEPS, gen),
            session.launches_per_replay("decode"), session)


def _pool_steps(params, cfg, mode, rows):
    """The continuous batcher's step at `rows` rows, every row at
    position 256 and inactive (inactive rows compute as active ones)."""
    from chip_smoke import POOL_TIMED_POS, _pool_for
    from fish_speech_tpu_torch.generate import replay_graph

    batcher = _pool_for(params, cfg, rows, mode != "bf16")  # serves nothing
    batcher._graph("decode")
    st, graph = batcher.state, batcher._graphs["decode"]
    st.active.zero_()
    st.pos.fill_(POOL_TIMED_POS)
    n = st.cols.shape[0]

    def run():
        for _ in range(STEPS // n):
            st.step.zero_()
            for _ in range(n):
                replay_graph(*graph)

    return run, batcher.launches_per_replay("decode"), batcher


def profile_mode(mode, dev, tokenizer, pool=0):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import _s2_pro_cfg
    from fish_speech_tpu_torch.models import dual_ar
    from fish_speech_tpu_torch.ops.quant import quantize_dual_ar_lowmem

    cfg = _s2_pro_cfg(tokenizer, 2048)
    params = dual_ar.init_dual_ar(0, cfg, torch.bfloat16, dev)
    if mode != "bf16":
        params = quantize_dual_ar_lowmem(
            params, mode="int4" if mode == "int4" else "int8",
            fast_mode="int4" if mode == "mixed" else None)
    run, per_step, owner = (_pool_steps(params, cfg, mode, pool) if pool
                            else _session_steps(params, cfg, mode, tokenizer))
    del params
    label = f"{mode} P={pool}" if pool else mode
    run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / STEPS
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    by_class, by_name = collections.Counter(), collections.Counter()
    calls = 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.self_device_time_total / STEPS
        by_class[_class(e.key)] += us
        by_name[e.key] += us
        calls += e.count
    busy_ms = sum(by_class.values()) / 1e3
    launches = sum(per_step.values())
    mode = label
    print(f"{mode}: replayed step {step_ms:.3f} ms (CUDA events over {STEPS} "
          f"replays); kernels traced {calls / STEPS:.0f} per step, busy "
          f"{busy_ms:.3f} ms per step, gaps {step_ms - busy_ms:.3f} ms "
          f"({100 * (1 - busy_ms / step_ms):.1f}% of the step); hand-written "
          f"kernel launches per step {launches}")
    if not busy_ms:
        print(f"{mode}: the profiler saw no device time")
        return
    for label, us in by_class.most_common():
        print(f"  {label}: {us / 1e3:.3f} ms per step, "
              f"{100 * us / 1e3 / busy_ms:.1f}% of kernel time")
    print(f"{mode}: top kernels (ms per step):")
    for name, us in by_name.most_common(12):
        print(f"  {us / 1e3:8.3f}  {name[:110]}")
    if pool:
        owner.shutdown()
    del owner
    gc.collect()
    torch.cuda.empty_cache()


def main():
    import torch

    from fish_speech_tpu_torch.tokenizer import build_test_tokenizer

    if not torch.cuda.is_available():
        raise SystemExit("decode_step_profile: CUDA is not available")
    args = sys.argv[1:]
    pool = 0
    if "--pool" in args:
        i = args.index("--pool")
        pool = int(args[i + 1])
        del args[i : i + 2]
    modes = args or ["bf16", "mixed"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    tokenizer = build_test_tokenizer()
    for mode in modes:
        profile_mode(mode, torch.device("cuda:0"), tokenizer, pool)


if __name__ == "__main__":
    main()
