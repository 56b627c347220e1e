"""Process-rank-aware logging and seeding, the port of
`fish_speech_tpu/utils/logging.py`.

Reference: `fish_speech/utils/logger.py` (RankedLogger) and
`utils/utils.py:120-136` (set_seed).
"""

from __future__ import annotations

import logging
import os
import random
from typing import Optional

import numpy as np
import torch


def process_index() -> int:
    """This process's rank: `torch.distributed`'s when a process group is
    up, else the `RANK` environment variable (0 without it)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", 0))


class RankedLogger(logging.LoggerAdapter):
    """Prefixes records with the process rank; optionally logs on rank 0
    only."""

    def __init__(self, name: str = __name__, rank_zero_only: bool = False):
        super().__init__(logging.getLogger(name), {})
        self.rank_zero_only = rank_zero_only

    def log(self, level, msg, *args, rank: Optional[int] = None, **kwargs):
        if not self.isEnabledFor(level):
            return
        current = process_index()
        msg = f"[rank: {current}] {msg}"
        if self.rank_zero_only or rank is not None:
            target = 0 if self.rank_zero_only else rank
            if current != target:
                return
        self.logger.log(level, msg, *args, **kwargs)


def set_seed(seed: int) -> torch.Generator:
    """Seed python and numpy and return a CPU `torch.Generator` seeded with
    `seed` (the port's explicit random state, where JAX returns a PRNG
    key)."""
    random.seed(seed)
    np.random.seed(seed)
    return torch.Generator().manual_seed(seed)
