#!/usr/bin/env python3
"""The serving fast stack's time per frame, two checkouts in turns.

    python3 scripts/fast_stack_turns.py OTHER_CHECKOUT [FRAMES]

Builds full-width s2-pro (bf16, random weights from seed 0), quantizes it
`mixed` (slow int8, fast int4, heads int8) with the int8 KV cache, and
times `chip_smoke.py:fast_stack_frame_ms` (the fast stack of one frame:
12 layers x 10 codebook steps with their heads and samplers, CUDA events)
in a fresh process for each turn: OTHER_CHECKOUT, this checkout, this
checkout, OTHER_CHECKOUT, each with its own kernels and wrappers. The
fast stack is bound by host launches, so the host's load between calls
moves it; turns inside one call on one card are what may be compared.
One line per turn, with the card's name and power limit.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

CHILD = """
import sys, torch
sys.path.insert(0, '.')
from chip_smoke import _s2_pro_cfg, fast_stack_frame_ms
from fish_speech_tpu_torch.config import SamplingConfig
from fish_speech_tpu_torch.generate import GenerationSession
from fish_speech_tpu_torch.models import dual_ar
from fish_speech_tpu_torch.ops.quant import quantize_dual_ar_lowmem
from fish_speech_tpu_torch.tokenizer import build_test_tokenizer

dev = torch.device('cuda:0')
cfg = _s2_pro_cfg(build_test_tokenizer(), 2048)
params = quantize_dual_ar_lowmem(dual_ar.init_dual_ar(0, cfg, torch.bfloat16, dev),
                                 mode='int8', fast_mode='int4')
session = GenerationSession(params, cfg, SamplingConfig(), max_batch=1,
                            dtype=torch.bfloat16, decode_chunk_size=64,
                            first_chunk_size=8, kv_quant=True)
fast_stack_frame_ms(session, 5)  # kernels built, first calls made
print('FRAME_MS', fast_stack_frame_ms(session, int(sys.argv[1])))
"""


def main():
    other = Path(sys.argv[1]).resolve()
    frames = sys.argv[2] if len(sys.argv) > 2 else "40"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    for label, tree in (("other", other), ("this", ROOT), ("this", ROOT),
                        ("other", other)):
        out = subprocess.run([sys.executable, "-c", CHILD, frames], cwd=tree,
                             capture_output=True, text=True, timeout=600)
        lines = [line for line in out.stdout.splitlines() if line.startswith("FRAME_MS")]
        if out.returncode != 0 or not lines:
            raise SystemExit(f"{label} ({tree}) failed:\n{out.stderr[-3000:]}")
        print(f"fast stack {label} ({tree.name}): {float(lines[0].split()[1]):.3f} "
              f"ms/frame over {frames} frames; {smi}", flush=True)


if __name__ == "__main__":
    main()
