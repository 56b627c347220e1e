"""Reader of the native checkpoint format, into torch tensors.

Port of the reading half of `fish_speech_tpu/utils/checkpoint.py`: a
directory with `config.json` (DualARConfig) and `model.safetensors`, a flat
"/"-joined parameter tree whose bf16 leaves are stored as raw uint16 bits
under a "::bf16" key suffix. Lists are numeric path segments.

A quantized tree (`ops/quant.py`) reads back as it was written: integer
leaves (int8 `q`, uint8 `p`) stay integer, and floating leaves, the scales
included, are cast to `dtype` when one is given, as the JAX package's
`load_params` casts them.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
from safetensors.numpy import load_file

from fish_speech_tpu_torch.config import DualARConfig
from fish_speech_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

_BF16_SUFFIX = "::bf16"


def _to_tensor(key, value, dtype, device):
    if key.endswith(_BF16_SUFFIX):
        t = torch.from_numpy(np.ascontiguousarray(value).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(value))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _lists_from_numeric_dicts(node):
    if not isinstance(node, dict):
        return node
    node = {k: _lists_from_numeric_dicts(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        return [node[str(i)] for i in range(len(node))]
    return node


def load_params(path, name="model.safetensors", dtype=None,
                device=DEFAULT_DEVICE):
    """The parameter tree of `path/name`; floating leaves cast to `dtype`
    when given, every leaf placed on `device`. Raises without CUDA unless
    `device` is the CPU."""
    device = resolve_device(device, "load_params")
    root = {}
    for key, value in load_file(str(Path(path) / name)).items():
        parts = key[: -len(_BF16_SUFFIX)].split("/") if key.endswith(
            _BF16_SUFFIX) else key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _to_tensor(key, value, dtype, device)
    return _lists_from_numeric_dicts(root)


def load_dual_ar(path, dtype=torch.bfloat16, device=DEFAULT_DEVICE):
    """(params, cfg) of a native Dual-AR checkpoint directory, on `device`.
    Raises without CUDA unless `device` is the CPU."""
    device = resolve_device(device, "load_dual_ar")
    path = Path(path)
    cfg = DualARConfig.from_json(str(path / "config.json"))
    return load_params(path, dtype=dtype, device=device), cfg
