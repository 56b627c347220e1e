#!/usr/bin/env python3
"""The main paths' replayed decode steps, two checkouts in turns.

    python3 scripts/step_turns.py OTHER_CHECKOUT [ROUNDS] [STEPS]

Times, in a fresh process for each turn (ROUNDS rounds, 2 by default,
of OTHER_CHECKOUT, this checkout, this checkout, OTHER_CHECKOUT; each with
its own kernels and wrappers),
three replayed decode steps of full-width s2-pro (random weights from seed
0, max_seq_len 2048), each from its graph, at cache position 256:

  * bf16: the single-stream session's step (`chip_smoke.py:replayed_step_ms`,
    64 replays between CUDA events, best of three);
  * mixed: the same, quantized `mixed` (slow int8, fast int4, heads int8)
    with the int8 KV cache;
  * int8 P=32: the continuous batcher's 32-row pool step, int8 weights and
    int8 KV cache (`chip_smoke.py:pool_step_ms`, every row at 256).

STEPS picks some of them (a comma list of `bf16`, `mixed`, `int8`; all by
default). One line per turn and a summary (each checkout's mean and median of its
turns and this checkout's over the other's), each with the card's name
and power limit. OTHER_CHECKOUT comes from `git archive REV | tar -x -C DIR` inside
this checkout (a directory `.gitignore` lists, e.g. `build/parent_tree`).
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

CHILD = """
import gc, json, sys, torch
sys.path.insert(0, '.')
from chip_smoke import _pool_for, _s2_pro_cfg, pool_step_ms, replayed_step_ms
from fish_speech_tpu_torch.config import SamplingConfig
from fish_speech_tpu_torch.generate import GenerationSession
from fish_speech_tpu_torch.models import dual_ar
from fish_speech_tpu_torch.ops.quant import quantize_dual_ar_lowmem
from fish_speech_tpu_torch.tokenizer import build_test_tokenizer

dev = torch.device('cuda:0')
cfg = _s2_pro_cfg(build_test_tokenizer(), 2048)
steps = sys.argv[1].split(',')
out = {}

def free():
    gc.collect()
    torch.cuda.empty_cache()

def session_step(params, kv_quant):
    s = GenerationSession(params, cfg, SamplingConfig(), dtype=torch.bfloat16,
                          decode_chunk_size=64, first_chunk_size=8,
                          kv_quant=kv_quant)
    s.precompile(100, 72)
    best = float('inf')
    for _ in range(3):
        s.state.pos.fill_(256)
        best = min(best, replayed_step_ms(s))
    return best

if 'bf16' in steps or 'mixed' in steps:
    params = dual_ar.init_dual_ar(0, cfg, torch.bfloat16, dev)
    if 'bf16' in steps:
        out['bf16'] = session_step(params, False)
        free()
    if 'mixed' in steps:
        out['mixed'] = session_step(quantize_dual_ar_lowmem(
            params, mode='int8', fast_mode='int4'), True)
    del params
    free()
if 'int8' in steps:
    pool = _pool_for(quantize_dual_ar_lowmem(
        dual_ar.init_dual_ar(0, cfg, torch.bfloat16, dev), mode='int8'), cfg, 32, True)
    try:
        pool.precompile((64,))
        out['int8 P=32'] = pool_step_ms(pool)
    finally:
        pool.shutdown()
print('STEPS', json.dumps(out))
"""


def main():
    other = Path(sys.argv[1]).resolve()
    rounds = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    steps = sys.argv[3] if len(sys.argv) > 3 else "bf16,mixed,int8"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    got = {"other": [], "this": []}
    for label, tree in [("other", other), ("this", ROOT), ("this", ROOT),
                        ("other", other)] * rounds:
        out = subprocess.run([sys.executable, "-c", CHILD, steps], cwd=tree,
                             capture_output=True, text=True, timeout=900)
        lines = [line for line in out.stdout.splitlines() if line.startswith("STEPS")]
        if out.returncode != 0 or not lines:
            raise SystemExit(f"{label} ({tree}) failed:\n{out.stderr[-3000:]}")
        times = json.loads(lines[0][len("STEPS"):])
        got[label].append(times)
        print(f"turn {label} ({tree.name}): replayed step ms "
              + ", ".join(f"{k} {v:.4f}" for k, v in times.items()) + f"; {smi}",
              flush=True)
    for name in got["this"][0]:
        mean = {k: sum(t[name] for t in v) / len(v) for k, v in got.items()}
        median = {k: sorted(t[name] for t in v)[len(v) // 2] for k, v in got.items()}
        print(f"{name}: mean this {mean['this']:.4f} ms, other {mean['other']:.4f} "
              f"ms, this / other {mean['this'] / mean['other']:.4f}; median this "
              f"{median['this']:.4f}, other {median['other']:.4f}, this / other "
              f"{median['this'] / median['other']:.4f}; {smi}")


if __name__ == "__main__":
    main()
