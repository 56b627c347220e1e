"""LoRA fine-tuning for the Dual-AR model, in PyTorch.

Port of `fish_speech_tpu/models/lora.py`: target modules "attention" (wqkv
+ wo), "mlp" (w1/w2/w3), "embeddings" (text + codebook + fast embeddings),
"output" (LM head + fast head); unprefixed names also target the fast
stack, `fast_*` names target only it. A is Gaussian x 0.01, B zeros; the
forward adds (alpha / r) * x @ A @ B (`cfg.lora_scale`).

LoRA leaves live inside the parameter tree (a layer stack gets a "lora"
sub-dict keyed by weight name; the top-level tables get "lora_embeddings" /
"lora_codebook_embeddings" / "lora_output" siblings). `add_lora` marks the
base tensors `requires_grad_(False)` and the LoRA tensors
`requires_grad_(True)`, so autograd never builds a base-weight gradient.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List

import torch

from fish_speech_tpu_torch.config import DualARConfig


@dataclass
class LoraConfig:
    r: int
    lora_alpha: float
    lora_dropout: float = 0.0
    target_modules: List[str] = field(
        default_factory=lambda: ["attention", "mlp", "embeddings", "output"]
    )

    @property
    def scale(self) -> float:
        return self.lora_alpha / self.r


def apply_lora_config(cfg: DualARConfig, lora_cfg: LoraConfig) -> DualARConfig:
    """Return a config with the LoRA runtime scale set."""
    return dataclasses.replace(cfg, lora_scale=lora_cfg.scale)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def add_lora(params, cfg: DualARConfig, lora_cfg: LoraConfig, seed: int,
             dtype=torch.bfloat16):
    """Return params with LoRA leaves added; the base tensors are the same
    objects, frozen. The A matrices are drawn on the parameters' device from
    a torch.Generator seeded with `seed`."""
    cfg = cfg.resolve()
    t = set(lora_cfg.target_modules)
    slow_attn, slow_mlp = "attention" in t, "mlp" in t
    slow_emb, slow_out = "embeddings" in t, "output" in t
    fast_attn = slow_attn or "fast_attention" in t
    fast_mlp = slow_mlp or "fast_mlp" in t
    fast_emb = slow_emb or "fast_embeddings" in t
    fast_out = slow_out or "fast_output" in t
    r = lora_cfg.r
    device = params["embeddings"].device
    gen = torch.Generator(device=device).manual_seed(seed)

    def ab(*lead_in, d_out):
        a = torch.empty((*lead_in, r), dtype=torch.float32, device=device)
        a.normal_(0.0, 1.0, generator=gen)
        b = torch.zeros((*lead_in[:-1], r, d_out), dtype=dtype, device=device)
        return {"a": (a * 0.01).to(dtype), "b": b}

    params = _tree_map(lambda x: x.requires_grad_(False), params)

    def layer_lora(layers, n_layer, dim, n_head, n_kv, head_dim, inter,
                   attn, mlp):
        lora = {}
        if attn:
            lora["wqkv"] = ab(n_layer, dim, d_out=(n_head + 2 * n_kv) * head_dim)
            lora["wo"] = ab(n_layer, n_head * head_dim, d_out=dim)
        if mlp:
            lora["w1"] = ab(n_layer, dim, d_out=inter)
            lora["w3"] = ab(n_layer, dim, d_out=inter)
            lora["w2"] = ab(n_layer, inter, d_out=dim)
        if lora:
            layers = dict(layers)
            layers["lora"] = lora
        return layers

    params["layers"] = layer_lora(
        params["layers"], cfg.n_layer, cfg.dim, cfg.n_head, cfg.n_local_heads,
        cfg.head_dim, cfg.intermediate_size, slow_attn, slow_mlp)
    fast = dict(params["fast"])
    fast["layers"] = layer_lora(
        fast["layers"], cfg.n_fast_layer, cfg.fast_dim, cfg.fast_n_head,
        cfg.fast_n_local_heads, cfg.fast_head_dim, cfg.fast_intermediate_size,
        fast_attn, fast_mlp)
    if fast_emb:
        fast["lora_embeddings"] = ab(cfg.codebook_size, d_out=cfg.fast_dim)
    if fast_out:
        fast["lora_output"] = ab(cfg.fast_dim, d_out=cfg.codebook_size)
    params["fast"] = fast
    if slow_emb:
        params["lora_embeddings"] = ab(cfg.vocab_size, d_out=cfg.dim)
        params["lora_codebook_embeddings"] = ab(
            cfg.codebook_size * cfg.num_codebooks, d_out=cfg.dim)
    if slow_out and not cfg.tie_word_embeddings:
        params["lora_output"] = ab(cfg.dim, d_out=cfg.vocab_size)
    return _mark_lora(params)


def _mark_lora(params, in_lora=False):
    """Sets requires_grad on every LoRA leaf, in place; returns params."""
    for k, v in params.items():
        lora = in_lora or "lora" in k
        if isinstance(v, dict):
            _mark_lora(v, lora)
        elif lora:
            v.requires_grad_(True)
    return params


def lora_filter(params, _in_lora=False):
    """Bool tree: True exactly on LoRA leaves (any path segment holds
    "lora")."""
    return {k: lora_filter(v, _in_lora or "lora" in k) if isinstance(v, dict)
            else _in_lora or "lora" in k
            for k, v in params.items()}


def extract_lora(params):
    """Keep only the LoRA leaves (LoRA-only checkpoints)."""

    def walk(node, in_lora):
        out = {}
        for k, v in node.items():
            lora = in_lora or "lora" in k
            if isinstance(v, dict):
                sub = walk(v, lora)
                if sub:
                    out[k] = sub
            elif lora:
                out[k] = v
        return out

    return walk(params, False)


def merge_lora(params, cfg: DualARConfig):
    """Fold the LoRA deltas into the base weights (in fp32, cast back to each
    weight's dtype) and drop the LoRA leaves; new tensors, the input tree is
    unchanged."""
    cfg = cfg.resolve()
    scale = cfg.lora_scale
    if scale == 0.0:
        raise ValueError("merge_lora called without an active lora_scale")

    def merge_ab(w, ab):
        delta = torch.einsum("...ir,...ro->...io", ab["a"].float(),
                             ab["b"].float())
        return (w.float() + scale * delta).to(w.dtype)

    def merge_layers(layers):
        layers = dict(layers)
        for name, ab in layers.pop("lora", {}).items():
            layers[name] = merge_ab(layers[name], ab)
        return layers

    with torch.no_grad():
        out = dict(params)
        out["layers"] = merge_layers(params["layers"])
        fast = dict(params["fast"])
        fast["layers"] = merge_layers(fast["layers"])
        for name in ("embeddings", "output"):
            if f"lora_{name}" in fast:
                fast[name] = merge_ab(fast[name], fast.pop(f"lora_{name}"))
        out["fast"] = fast
        for name in ("embeddings", "codebook_embeddings", "output"):
            if f"lora_{name}" in out:
                out[name] = merge_ab(out[name], out.pop(f"lora_{name}"))
    return out
