"""Upstream state-dict loading, the port's copy of
`fish_speech_tpu/convert/torch_state.py`.

Handles the reference's three checkpoint layouts (`llama.py:546-588`):
sharded safetensors (index json), single safetensors, model.pth; plus the
fish_qwen3_omni key remapping (`llama.py:229-246`) and the wq/wk/wv -> wqkv
fusion hook (`llama.py:877-882`). Weight-norm folding for the codec
(g * v / ||v||) happens here so native checkpoints store plain weights.

Everything here reshapes numpy arrays on the host and does no device work
(a `.pth` is read with `map_location="cpu"`), as the JAX package's
converter pins itself to the CPU.
"""

from __future__ import annotations

import json
from collections import OrderedDict
from pathlib import Path
from typing import Dict

import numpy as np
import torch


def _to_numpy(t):
    # torch tensor or numpy
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.float().numpy()
        return t.numpy()
    return np.asarray(t)


def load_torch_state_dict(path) -> Dict[str, np.ndarray]:
    """Load any reference checkpoint layout into {name: np.ndarray}."""
    path = Path(path)
    if path.is_dir():
        index_json = path / "model.safetensors.index.json"
        single_st = path / "model.safetensors"
        pth = path / "model.pth"
        if index_json.exists():
            from safetensors import safe_open

            with open(index_json) as f:
                index = json.load(f)
            shard_files = sorted(set(index["weight_map"].values()))
            weights = OrderedDict()
            for shard in shard_files:
                with safe_open(str(path / shard), framework="np") as f:
                    for k in f.keys():
                        weights[k] = f.get_tensor(k)
            return remap_fish_qwen3_omni(weights)
        if single_st.exists():
            path = single_st
        elif pth.exists():
            path = pth
        else:
            raise FileNotFoundError(f"No model weights found in {path}")

    if path.suffix == ".safetensors":
        from safetensors import safe_open

        weights = OrderedDict()
        with safe_open(str(path), framework="np") as f:
            for k in f.keys():
                weights[k] = f.get_tensor(k)
        return remap_fish_qwen3_omni(weights)

    # .pth / .ckpt via torch
    state = torch.load(str(path), map_location="cpu", weights_only=True)
    if "state_dict" in state:
        state = state["state_dict"]
    weights = OrderedDict((k, _to_numpy(v)) for k, v in state.items())
    if weights and next(iter(weights)).startswith("model."):
        weights = OrderedDict(
            (k[len("model."):], v) for k, v in weights.items()
        )
    return remap_fish_qwen3_omni(weights)


def remap_fish_qwen3_omni(weights):
    """text_model.model.* -> bare; audio_decoder.* -> fast_* (except
    codebook_embeddings)."""
    if not any(k.startswith(("text_model.", "audio_decoder.")) for k in weights):
        return weights
    out = OrderedDict()
    for k, v in weights.items():
        if k.startswith("text_model.model."):
            nk = k[len("text_model.model."):]
        elif k.startswith("audio_decoder."):
            suffix = k[len("audio_decoder."):]
            nk = suffix if suffix.startswith("codebook_embeddings.") else "fast_" + suffix
        else:
            nk = k
        out[nk] = v
    return out


def fuse_wqkv(weights: Dict[str, np.ndarray]):
    """Fuse separate wq/wk/wv weights into wqkv (the reference load hook)."""
    out = dict(weights)
    for k in list(weights):
        if k.endswith("attention.wq.weight"):
            prefix = k[: -len("wq.weight")]
            wq = out.pop(prefix + "wq.weight")
            wk = out.pop(prefix + "wk.weight")
            wv = out.pop(prefix + "wv.weight")
            out[prefix + "wqkv.weight"] = np.concatenate([wq, wk, wv], axis=0)
    return out


def fold_weight_norm(weights: Dict[str, np.ndarray]):
    """Fold torch weight-norm parametrizations into plain weights.

    Handles both naming schemes:
      new: <name>.parametrizations.weight.original0 (g), .original1 (v)
      old: <name>.weight_g, <name>.weight_v
    dim=0 semantics: g has shape (d0, 1, 1); w = g * v / ||v||_(all but d0).
    """
    out = {}
    handled = set()
    for k in weights:
        if k.endswith(".parametrizations.weight.original0"):
            base = k[: -len(".parametrizations.weight.original0")]
            g = weights[k]
            v = weights[base + ".parametrizations.weight.original1"]
            out[base + ".weight"] = _fold(g, v)
            handled.add(k)
            handled.add(base + ".parametrizations.weight.original1")
        elif k.endswith(".weight_g"):
            base = k[: -len(".weight_g")]
            g = weights[k]
            v = weights[base + ".weight_v"]
            out[base + ".weight"] = _fold(g, v)
            handled.add(k)
            handled.add(base + ".weight_v")
    for k, v in weights.items():
        if k not in handled and k not in out:
            out[k] = v
    return out


def _fold(g: np.ndarray, v: np.ndarray) -> np.ndarray:
    v = np.asarray(v, dtype=np.float32)
    g = np.asarray(g, dtype=np.float32)
    axes = tuple(range(1, v.ndim))
    norm = np.sqrt((v * v).sum(axis=axes, keepdims=True))
    return (g * v / np.maximum(norm, 1e-12)).astype(np.float32)
