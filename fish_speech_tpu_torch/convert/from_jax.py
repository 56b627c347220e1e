"""Weight bridge from the JAX package's parameter pytrees to the port.

Input is the pytree with every leaf as a numpy array (`np.asarray` of each
JAX leaf, or what `fish_speech_tpu/convert/` emits from a checkpoint);
output is the same nested dict of torch tensors on a given device and
dtype, in the port's layouts:

  * the dual-AR LM keeps the JAX layout: stacked (L, in, out) weights;
  * codec conv weights (K, Cin, Cout) become torch's (Cout, Cin, K);
    conv-transpose weights (K, Cout, Cin) become torch's (Cin, Cout, K)
    (`fish_speech_tpu/models/dac/conv.py`: the JAX layout is the torch one
    rolled to spatial-major); depthwise convs follow the conv rule, with
    Cin = 1 and `groups` = channels.

The port's own random initialisers (`init_dual_ar` in `models/dual_ar.py`,
`init_dac` in `models/dac/model.py`, `init_dac_decoder` below) build a
full-size model directly on the card, without a second copy on the host.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from fish_speech_tpu_torch.config import DACConfig
from fish_speech_tpu_torch.models.dac.model import decode_half, init_dac
from fish_speech_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


def config_from_jax(obj, cls):
    """The port's config `cls` built from any dataclass with the same field
    names (a config of the JAX package, say), by its fields: nested configs
    are rebuilt as the port's classes. Never imports the JAX package."""
    return _config(cls, dataclasses.asdict(obj))


def _config(cls, data):
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if not f.init or f.name not in data:
            continue
        value = data[f.name]
        sub = _nested_dataclass(hints[f.name])
        if sub is not None and isinstance(value, dict):
            value = _config(sub, value)
        kwargs[f.name] = value
    return cls(**kwargs)


def _nested_dataclass(tp):
    """The dataclass in a field's type (`X` or `Optional[X]`), if any."""
    if dataclasses.is_dataclass(tp):
        return tp
    return next((a for a in typing.get_args(tp) if dataclasses.is_dataclass(a)),
                None)


def _tensor(a, dtype, device):
    """One leaf as a tensor: integer leaves (int8 `q`, uint8 `p`) stay
    integer, floating leaves are cast to `dtype` (None: the leaf's own)."""
    a = np.asarray(a)
    bf16 = a.dtype.name == "bfloat16"  # ml_dtypes bf16: torch cannot view it
    t = torch.from_numpy(np.array(a.astype(np.float32) if bf16 else a))
    if t.is_floating_point():
        t = t.to(dtype or (torch.bfloat16 if bf16 else t.dtype))
    return t.to(device)


def dual_ar_from_jax(params, dtype=torch.bfloat16, device=DEFAULT_DEVICE):
    """Dual-AR LM pytree (numpy leaves) -> torch tensors on `device`, layout
    unchanged, LoRA leaves included (`models/lora.py` layout). Quantized
    weights cross leaf for leaf: int8 {"q","s"} and int4 {"p","gs"} keep
    their integer `q`/`p` and their scales' dtype. The audio projector is
    not ported. Raises without CUDA unless `device` is the CPU."""
    device = resolve_device(device, "dual_ar_from_jax")

    def convert(node, path=""):
        if isinstance(node, dict):
            quant = {"q", "s"} <= node.keys() or {"p", "gs"} <= node.keys()
            out = {}
            for k, v in node.items():
                if k == "audio_projector":
                    raise NotImplementedError(f"{path}/{k} is not ported")
                if quant and k in ("s", "gs"):  # scales keep their dtype
                    out[k] = _tensor(v, None, device)
                else:
                    out[k] = convert(v, f"{path}/{k}")
            return out
        if isinstance(node, (list, tuple)):
            return [convert(v, path) for v in node]
        return _tensor(node, dtype, device)

    return convert(params)


def _conv(p, dtype, device):
    """JAX conv {"w": (K, Cin, Cout), "b"} -> torch {"w": (Cout, Cin, K)};
    also right for conv-transpose (K, Cout, Cin) -> (Cin, Cout, K)."""
    return {"w": _tensor(np.transpose(np.asarray(p["w"]), (2, 1, 0)), dtype, device),
            "b": _tensor(p["b"], dtype, device)}


# the codec tree's conv and conv-transpose leaves, by key; every other leaf
# (transformer stacks, projections, codebooks, alphas, norms) keeps its layout
CODEC_CONVS = {"conv_in", "conv", "conv1", "conv2", "conv_out", "dwconv"}


def dac_from_jax(params, dtype=torch.float32, device=DEFAULT_DEVICE):
    """Codec pytree (numpy leaves) -> the same tree in torch layout on
    `device`: the encoder, the quantizer (in-projections, downsample, `pre`,
    codebooks, out-projections, upsample, `post`) and the decoder, or any
    part of them. Raises without CUDA unless `device` is the CPU."""
    device = resolve_device(device, "dac_from_jax")

    def convert(node):
        if isinstance(node, dict):
            return {k: _conv(v, dtype, device) if k in CODEC_CONVS else convert(v)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [convert(v) for v in node]
        return _tensor(node, dtype, device)

    return convert(params)


def dac_decoder_from_jax(params, dtype=torch.float32, device=DEFAULT_DEVICE):
    """The decode half of `dac_from_jax` (`models/dac/model.py:decode_half`):
    what `dac_from_indices` reads, for callers that never encode. Raises
    without CUDA unless `device` is the CPU."""
    device = resolve_device(device, "dac_decoder_from_jax")
    return dac_from_jax(decode_half(params), dtype, device)


def init_dac_decoder(seed: int, cfg: DACConfig, dtype=torch.float32,
                     device=DEFAULT_DEVICE):
    """The decode half of `init_dac(seed, cfg)`'s tree, for callers that
    never encode. Raises without CUDA unless `device` is the CPU."""
    device = resolve_device(device, "init_dac_decoder")
    return decode_half(init_dac(seed, cfg, dtype, device))
