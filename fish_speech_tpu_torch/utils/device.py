"""Where the port's initialisers and loaders place what they make.

Every entry point runs on the card unless the caller asks for the CPU:
the default device is `cuda:0`, and asking for a CUDA device where there is
none raises instead of quietly running on the CPU.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda:0"


def resolve_device(device, who: str) -> torch.device:
    """`torch.device(device)`; raises RuntimeError when it names a CUDA
    device and CUDA is unavailable."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device for {device}; pass "
                           f"device='cpu' to run on the CPU")
    return device
