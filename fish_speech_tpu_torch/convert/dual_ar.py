"""Convert a reference Dual-AR checkpoint to the native format, the port's
copy of `fish_speech_tpu/convert/dual_ar.py`.

Key mapping (reference names from `llama.py`, module attributes):
  embeddings.weight                        -> embeddings
  codebook_embeddings.weight               -> codebook_embeddings
  layers.{i}.attention.wqkv.weight (O,I)   -> layers/wqkv[i] (I,O)  [stacked]
  layers.{i}.attention.wo.weight           -> layers/wo[i]  (transposed)
  layers.{i}.attention.{q,k}_norm.weight   -> layers/{q,k}_norm[i]
  layers.{i}.attention_norm.weight         -> layers/attn_norm[i]
  layers.{i}.ffn_norm.weight               -> layers/ffn_norm[i]
  layers.{i}.feed_forward.w{1,2,3}.weight  -> layers/w{1,2,3}[i] (transposed)
  norm.weight                              -> norm
  output.weight (V,D)                      -> output (D,V)
  fast_project_in.{weight,bias}            -> fast/project_in/{w,b}
  fast_embeddings.weight                   -> fast/embeddings
  fast_layers.* / fast_norm / fast_output  -> fast/...
Linear weights transpose from torch (out,in) to (in,out).

The native tree is the JAX layout the port's LM keeps (stacked (L, in,
out) weights, `convert/from_jax.py`) with float32 numpy leaves.
`export_dual_ar` also takes a tree of torch tensors (a loaded checkpoint).
Both only reshape arrays on the host and do no device work.
"""

from __future__ import annotations

import numpy as np
import torch

from fish_speech_tpu_torch.config import DualARConfig
from fish_speech_tpu_torch.convert.torch_state import (fuse_wqkv,
                                                       load_torch_state_dict)


def _f32(x):
    """A float32 numpy copy of a leaf: a torch tensor (bf16 widened exactly)
    or anything numpy takes."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, np.float32)


def _stack(weights, template, n, transpose=False):
    arrs = []
    for i in range(n):
        w = np.asarray(weights[template.format(i=i)], dtype=np.float32)
        arrs.append(w.T if transpose else w)
    return np.stack(arrs, axis=0)


def _layer_stack(weights, prefix, n, qk_norm, qkv_bias, o_bias):
    layers = {
        "attn_norm": _stack(weights, prefix + "layers.{i}.attention_norm.weight", n),
        "wqkv": _stack(
            weights, prefix + "layers.{i}.attention.wqkv.weight", n, transpose=True
        ),
        "wo": _stack(
            weights, prefix + "layers.{i}.attention.wo.weight", n, transpose=True
        ),
        "ffn_norm": _stack(weights, prefix + "layers.{i}.ffn_norm.weight", n),
        "w1": _stack(
            weights, prefix + "layers.{i}.feed_forward.w1.weight", n, transpose=True
        ),
        "w3": _stack(
            weights, prefix + "layers.{i}.feed_forward.w3.weight", n, transpose=True
        ),
        "w2": _stack(
            weights, prefix + "layers.{i}.feed_forward.w2.weight", n, transpose=True
        ),
    }
    if qkv_bias:
        layers["bqkv"] = _stack(weights, prefix + "layers.{i}.attention.wqkv.bias", n)
    if o_bias:
        layers["bo"] = _stack(weights, prefix + "layers.{i}.attention.wo.bias", n)
    if qk_norm:
        layers["q_norm"] = _stack(
            weights, prefix + "layers.{i}.attention.q_norm.weight", n
        )
        layers["k_norm"] = _stack(
            weights, prefix + "layers.{i}.attention.k_norm.weight", n
        )
    return layers


def convert_dual_ar(weights_or_path, cfg: DualARConfig):
    """Torch state dict (or checkpoint path) -> native param pytree (numpy)."""
    cfg = cfg.resolve()
    if not isinstance(weights_or_path, dict):
        weights = load_torch_state_dict(weights_or_path)
    else:
        weights = dict(weights_or_path)
    weights = fuse_wqkv(weights)
    w = {k: np.asarray(v) for k, v in weights.items()}

    params = {
        "embeddings": np.asarray(w["embeddings.weight"], np.float32),
        "codebook_embeddings": np.asarray(w["codebook_embeddings.weight"], np.float32),
        "layers": _layer_stack(
            w, "", cfg.n_layer, cfg.attention_qk_norm, cfg.attention_qkv_bias,
            cfg.attention_o_bias,
        ),
        "norm": np.asarray(w["norm.weight"], np.float32),
        "fast": {
            "embeddings": np.asarray(w["fast_embeddings.weight"], np.float32),
            "layers": _layer_stack(
                w, "fast_", cfg.n_fast_layer, cfg.fast_attention_qk_norm,
                cfg.fast_attention_qkv_bias, cfg.fast_attention_o_bias,
            ),
            "norm": np.asarray(w["fast_norm.weight"], np.float32),
            "output": np.asarray(w["fast_output.weight"], np.float32).T,
        },
    }
    if not cfg.tie_word_embeddings:
        params["output"] = np.asarray(w["output.weight"], np.float32).T
    if cfg.fast_dim != cfg.dim:
        params["fast"]["project_in"] = {
            "w": np.asarray(w["fast_project_in.weight"], np.float32).T,
            "b": np.asarray(
                w.get(
                    "fast_project_in.bias",
                    np.zeros(cfg.fast_dim, np.float32),
                ),
                np.float32,
            ),
        }
    return params


def export_dual_ar(params, cfg: DualARConfig):
    """Native param pytree (numpy or torch leaves) -> torch-style flat state
    dict (float32 numpy), the inverse mapping (for interop /
    `save_pretrained` parity)."""
    cfg = cfg.resolve()
    out = {
        "embeddings.weight": _f32(params["embeddings"]),
        "codebook_embeddings.weight": _f32(params["codebook_embeddings"]),
        "norm.weight": _f32(params["norm"]),
        "fast_embeddings.weight": _f32(params["fast"]["embeddings"]),
        "fast_norm.weight": _f32(params["fast"]["norm"]),
        "fast_output.weight": _f32(params["fast"]["output"]).T,
    }

    def emit_layers(layers, prefix):
        n = layers["wqkv"].shape[0]
        for i in range(n):
            base = f"{prefix}layers.{i}."
            out[base + "attention_norm.weight"] = _f32(layers["attn_norm"][i])
            out[base + "attention.wqkv.weight"] = _f32(layers["wqkv"][i]).T
            out[base + "attention.wo.weight"] = _f32(layers["wo"][i]).T
            out[base + "ffn_norm.weight"] = _f32(layers["ffn_norm"][i])
            for name in ("w1", "w2", "w3"):
                out[base + f"feed_forward.{name}.weight"] = _f32(
                    layers[name][i]).T
            if "bqkv" in layers:
                out[base + "attention.wqkv.bias"] = _f32(layers["bqkv"][i])
            if "bo" in layers:
                out[base + "attention.wo.bias"] = _f32(layers["bo"][i])
            if "q_norm" in layers:
                out[base + "attention.q_norm.weight"] = _f32(layers["q_norm"][i])
                out[base + "attention.k_norm.weight"] = _f32(layers["k_norm"][i])

    emit_layers(params["layers"], "")
    emit_layers(params["fast"]["layers"], "fast_")
    if "output" in params:
        out["output.weight"] = _f32(params["output"]).T
    if "project_in" in params["fast"]:
        out["fast_project_in.weight"] = _f32(params["fast"]["project_in"]["w"]).T
        out["fast_project_in.bias"] = _f32(params["fast"]["project_in"]["b"])
    return out
