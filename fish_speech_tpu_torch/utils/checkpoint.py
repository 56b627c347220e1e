"""Reader of the native checkpoint format, into torch tensors.

Port of the reading half of `fish_speech_tpu/utils/checkpoint.py`: a
directory with `config.json` (DualARConfig) and `model.safetensors`, a flat
"/"-joined parameter tree whose bf16 leaves are stored as raw uint16 bits
under a "::bf16" key suffix. Lists are numeric path segments.

A bundled codec (`codec_config.json`, DACConfig, and `codec.safetensors`)
reads with `load_dac` (the stored layout) or `load_codec` (the torch
layout the port's codec runs). The writers (`save_dual_ar`, `save_dac`) wait for
the port's `tools/quantize.py` (ROADMAP).

A quantized tree (`ops/quant.py`) reads back as it was written: integer
leaves (int8 `q`, uint8 `p`) stay integer, and floating leaves, the scales
included, are cast to `dtype` when one is given, as the JAX package's
`load_params` casts them.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch
from safetensors.numpy import load_file

from fish_speech_tpu_torch.config import (CodecTransformerConfig, DACConfig,
                                          DualARConfig, RVQConfig)
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


def _dac_config_from_json(d: dict) -> DACConfig:
    """A DACConfig from `codec_config.json` (the JAX package's
    `dataclasses.asdict` layout)."""
    d = dict(d)
    rvq = dict(d.pop("rvq"))
    for k in ("pre_transformer", "post_transformer"):
        if rvq.get(k) is not None:
            rvq[k] = CodecTransformerConfig(**rvq[k])
    rvq["downsample_factor"] = tuple(rvq["downsample_factor"])
    for k in ("encoder_rates", "decoder_rates", "encoder_transformer_layers"):
        d[k] = tuple(d[k])
    return DACConfig(rvq=RVQConfig(**rvq), **d)


def load_dac(path, dtype=torch.float32, device=DEFAULT_DEVICE):
    """(params, cfg) of the codec bundled in a checkpoint directory
    (`codec_config.json`, `codec.safetensors`), on `device`. Raises without
    CUDA unless `device` is the CPU."""
    device = resolve_device(device, "load_dac")
    path = Path(path)
    with open(path / "codec_config.json") as f:
        cfg = _dac_config_from_json(json.load(f))
    return load_params(path, name="codec.safetensors", dtype=dtype,
                       device=device), cfg


def load_codec(path, dtype=torch.float32, device=DEFAULT_DEVICE):
    """(params, cfg) of the codec bundled in a checkpoint directory, in the
    torch layout the port's codec runs (`convert/from_jax.py:dac_from_jax`:
    the convolutions' weights transposed), on `device`. Raises without
    CUDA unless `device` is the CPU."""
    from fish_speech_tpu_torch.convert.from_jax import dac_from_jax

    device = resolve_device(device, "load_codec")
    params, cfg = load_dac(path, dtype=torch.float32, device="cpu")
    return dac_from_jax(params, dtype, device), cfg
