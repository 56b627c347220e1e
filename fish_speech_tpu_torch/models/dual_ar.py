"""Dual-AR text->semantic transformer in PyTorch: inference, training, LoRA.

Port of `fish_speech_tpu/models/dual_ar.py`. Parameters are a nested dict
of tensors with the JAX package's layout: every transformer layer stacked
on a leading axis, weights stored (in, out) and used as `x @ w`:

  embeddings            (V, D)
  codebook_embeddings   (C*K, D)
  layers/attn_norm      (L, D)
  layers/wqkv           (L, D, (H + 2*Hkv) * Dh)   [+ bqkv]
  layers/q_norm, k_norm (L, Dh)                     [if qk_norm]
  layers/wo             (L, H*Dh, D)                [+ bo]
  layers/ffn_norm       (L, D)
  layers/w1, w3         (L, D, I)   (or w13 (L, D, 2I) after fuse_ffn_weights)
  layers/w2             (L, I, D)
  norm                  (D,)
  output                (D, V)                      [if untied]
  fast/project_in/{w,b} (D, Df), (Df,)              [if Df != D]
  fast/embeddings       (K, Df)
  fast/layers/...       (same structure, Lf stacked)
  fast/norm             (Df,)
  fast/output           (Df, K)

LoRA leaves (`models/lora.py`) live inside the same tree: a layer stack
gets a "lora" sub-dict keyed by weight name ({"a": (L, in, r), "b": (L, r,
out)}), the top-level tables get "lora_embeddings" / "lora_codebook_embeddings"
/ "lora_output" siblings, and every projection adds `lora_scale * (x @ A) @ B`
where its LoRA exists, as the JAX package does.

Quantized weights (`ops/quant.py`: int8 {"q","s"}, int4 {"p","gs"}) may
stand for any projection weight and for the untied heads; every product
goes through `mm`, except an int8 FFN of up to 32 rows without LoRA, which
runs as one fused product, `ops/int8_ffn.py:int8_ffn` (`_ffn`).

Activations are (B, T, H, Dh); the KV caches are (L, B, S, Hkv, Dh) and are
written IN PLACE (JAX threads them functionally; here the returned cache is
the same tensors). The slow cache may be int8 (`init_kv_cache(quant=True)`:
int8 k/v with bf16 per-(position, head) scales "ks"/"vs"); the fast cache is
always bf16. Prefill attention runs `flash_prefill_attention` over the fresh
k/v (also under the int8 cache, which is only stored quantized), decode
attention runs `flash_decode_attention` with `lengths = pos + 1`, or
`flash_decode_attention_kv8` over the int8 cache, and the teacher-forced
training forward's slow stack runs `flash_train_attention`: on CUDA tensors
those are the hand-written kernels.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from fish_speech_tpu_torch.config import DualARConfig
from fish_speech_tpu_torch.ops.attention import causal_mask, gqa_attention
from fish_speech_tpu_torch.ops.flash_decode import (
    flash_decode_attention, flash_decode_attention_kv8)
from fish_speech_tpu_torch.ops.flash_prefill import flash_prefill_attention
from fish_speech_tpu_torch.ops.flash_train import flash_train_attention
from fish_speech_tpu_torch.ops.int8_ffn import MAX_ROWS as INT8_FFN_ROWS
from fish_speech_tpu_torch.ops.int8_ffn import int8_ffn
from fish_speech_tpu_torch.ops.norms import rms_norm
from fish_speech_tpu_torch.ops.quant import fp32_scales, mm
from fish_speech_tpu_torch.ops.rope import apply_rope, rope_table
from fish_speech_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

# ---------------------------------------------------------------------------
# Initialization (random weights; real checkpoints go through convert/)
# ---------------------------------------------------------------------------


def _dense(gen, shape, std, dtype, device):
    w = torch.empty(shape, dtype=torch.float32, device=device)
    w.normal_(0.0, std, generator=gen)
    return w.to(dtype)


def _init_layer_stack(gen, n_layer, dim, n_head, n_kv, head_dim, inter,
                      qkv_bias, o_bias, qk_norm, std, dtype, device):
    total_qkv = (n_head + 2 * n_kv) * head_dim

    def dense(shape):
        return _dense(gen, shape, std, dtype, device)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    layers = {
        "attn_norm": ones((n_layer, dim)),
        "wqkv": dense((n_layer, dim, total_qkv)),
        "wo": dense((n_layer, n_head * head_dim, dim)),
        "ffn_norm": ones((n_layer, dim)),
        "w1": dense((n_layer, dim, inter)),
        "w3": dense((n_layer, dim, inter)),
        "w2": dense((n_layer, inter, dim)),
    }
    if qkv_bias:
        layers["bqkv"] = torch.zeros((n_layer, total_qkv), dtype=dtype, device=device)
    if o_bias:
        layers["bo"] = torch.zeros((n_layer, dim), dtype=dtype, device=device)
    if qk_norm:
        layers["q_norm"] = ones((n_layer, head_dim))
        layers["k_norm"] = ones((n_layer, head_dim))
    return layers


def init_dual_ar(seed: int, cfg: DualARConfig, dtype=torch.bfloat16,
                 device=DEFAULT_DEVICE):
    """Random-weight parameters with `init_dual_ar`'s shapes and scales,
    drawn from a torch.Generator seeded with `seed` directly on `device`
    (the values differ from the JAX package's, whose RNG is threefry).
    Each tensor is drawn in fp32 and cast, one at a time, so the 5B model
    never holds a second full copy. Raises without CUDA unless `device` is
    the CPU."""
    cfg = cfg.resolve()
    device = resolve_device(device, "init_dual_ar")
    gen = torch.Generator(device=device).manual_seed(seed)
    std = cfg.initializer_range

    def dense(shape):
        return _dense(gen, shape, std, dtype, device)

    params = {
        "embeddings": dense((cfg.vocab_size, cfg.dim)),
        "codebook_embeddings": dense((cfg.codebook_size * cfg.num_codebooks, cfg.dim)),
        "layers": _init_layer_stack(
            gen, cfg.n_layer, cfg.dim, cfg.n_head, cfg.n_local_heads,
            cfg.head_dim, cfg.intermediate_size, cfg.attention_qkv_bias,
            cfg.attention_o_bias, cfg.attention_qk_norm, std, dtype, device,
        ),
        "norm": torch.ones((cfg.dim,), dtype=dtype, device=device),
        "fast": {
            "embeddings": dense((cfg.codebook_size, cfg.fast_dim)),
            "layers": _init_layer_stack(
                gen, cfg.n_fast_layer, cfg.fast_dim, cfg.fast_n_head,
                cfg.fast_n_local_heads, cfg.fast_head_dim,
                cfg.fast_intermediate_size, cfg.fast_attention_qkv_bias,
                cfg.fast_attention_o_bias, cfg.fast_attention_qk_norm, std,
                dtype, device,
            ),
            "norm": torch.ones((cfg.fast_dim,), dtype=dtype, device=device),
            "output": dense((cfg.fast_dim, cfg.codebook_size)),
        },
    }
    if not cfg.tie_word_embeddings:
        params["output"] = dense((cfg.dim, cfg.vocab_size))
    if cfg.audio_feature_dim > 0:
        raise NotImplementedError(
            "audio-feature conditioning (the audio_projector) is not ported "
            "(ROADMAP §1 item 11: remaining modules)")
    if cfg.fast_dim != cfg.dim:
        params["fast"]["project_in"] = {
            "w": dense((cfg.dim, cfg.fast_dim)),
            "b": torch.zeros((cfg.fast_dim,), dtype=dtype, device=device),
        }
    return params


def param_count(params) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return params.numel()


# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: DualARConfig, batch: int, max_seq: int,
                  dtype=torch.bfloat16, device=None, quant: bool = False):
    """Slow-transformer cache: k/v (L, B, S, Hkv, Dh).

    quant=True stores k/v int8 with per-(position, head) absmax scales
    ("ks"/"vs", (L, B, S, Hkv) bf16), as the JAX package does: half the
    decode-time KV bytes. Prefill attends the fresh k/v and only the store
    is quantized, so prefill logits are exact; decode sees the rounding."""
    cfg = cfg.resolve()
    shape = (cfg.n_layer, batch, max_seq, cfg.n_local_heads, cfg.head_dim)
    if quant:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "ks": torch.zeros(shape[:-1], dtype=torch.bfloat16, device=device),
                "vs": torch.zeros(shape[:-1], dtype=torch.bfloat16, device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _kv_quant(x):
    """Per-(position, head) absmax int8: (..., D) -> (int8 (..., D), bf16
    scales (...)), bitwise as `fish_speech_tpu.models.dual_ar._kv_quant`."""
    xf = x.float()
    s = xf.abs().amax(dim=-1) / 127.0
    q = torch.round(xf / torch.clamp(s, min=1e-8)[..., None])
    return q.to(torch.int8), s.to(torch.bfloat16)


def _kv_dequant(q, s, dtype):
    """Inverse of `_kv_quant`."""
    return (q.float() * s[..., None].float()).to(dtype)


def _store_kv(cache, i, sl, k, v):
    """Write k/v (B, T, Hkv, Dh) into layer i of the cache at positions
    `sl`: a slice, an int with T == 1, or a (1,) int64 device tensor with
    T == 1 (written by `index_copy_`, so a CUDA graph reads the position
    at replay); quantized under the int8 cache."""
    if "ks" in cache:
        (k, ks), (v, vs) = _kv_quant(k), _kv_quant(v)
        pairs = ((cache["k"], k), (cache["v"], v), (cache["ks"], ks),
                 (cache["vs"], vs))
    else:
        pairs = ((cache["k"], k), (cache["v"], v))
    if isinstance(sl, int):
        sl = slice(sl, sl + 1)
    for dst, src in pairs:
        if isinstance(sl, torch.Tensor):
            dst[i].index_copy_(1, sl, src.to(dst.dtype))
        else:
            dst[i, :, sl] = src.to(dst.dtype)


def _store_kv_rows(cache, i, flat_pos, active, k, v):
    """Write row b's k/v (B, 1, Hkv, Dh) into layer i of the cache at
    position `flat_pos[b] - b * S` where `active[b]`, and rewrite what is
    there where not (JAX's `write_rows`, `fish_speech_tpu/models/dual_ar.py:
    449-463`); quantized under the int8 cache. flat_pos (B,) int64 indexes
    the layer's (B * S) rows; everything stays on the device, so a CUDA
    graph of the step reads the positions at replay."""
    if "ks" in cache:
        (k, ks), (v, vs) = _kv_quant(k), _kv_quant(v)
        pairs = ((cache["k"], k), (cache["v"], v), (cache["ks"], ks),
                 (cache["vs"], vs))
    else:
        pairs = ((cache["k"], k), (cache["v"], v))
    b, s = cache["k"].shape[1:3]
    for dst, src in pairs:
        flat = dst[i].view(b * s, *dst.shape[3:])
        new = src[:, 0].to(dst.dtype)
        keep = flat.index_select(0, flat_pos)
        act = active.view(b, *([1] * (new.dim() - 1)))
        flat.index_copy_(0, flat_pos, torch.where(act, new, keep))


def init_fast_kv_cache(cfg: DualARConfig, batch: int, dtype=torch.bfloat16,
                       device=None):
    """Fast-transformer cache: the sequence axis is the codebook index."""
    cfg = cfg.resolve()
    shape = (cfg.n_fast_layer, batch, cfg.num_codebooks,
             cfg.fast_n_local_heads, cfg.fast_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------


def _lora_embed(params, name, idx, scale):
    """Low-rank embedding delta `scale * A[idx] @ B` when `name` has LoRA."""
    if name in params:
        la = params[name]
        return scale * (F.embedding(idx, la["a"]) @ la["b"])
    return 0


def embed_tokens(params, cfg: DualARConfig, inp, inference: bool = True):
    """inp (B, C+1, T) int — row 0 text ids, rows 1..C codebook values ->
    token + summed codebook embedding (gated by the semantic id range),
    (B, T, D). `scale_codebook_embeddings` applies on the inference path
    only: the training forward passes inference=False, as the JAX package
    does. The audio-feature path is not ported."""
    inp = inp.long()
    codes = inp[:, 1:, :]  # (B, C, T)
    offsets = (torch.arange(cfg.num_codebooks, device=inp.device)
               * cfg.codebook_size)[None, :, None]
    cb_idx = codes + offsets
    cb = F.embedding(cb_idx, params["codebook_embeddings"])
    vq_sum = (cb + _lora_embed(params, "lora_codebook_embeddings", cb_idx,
                               cfg.lora_scale)).sum(dim=1)

    main = inp[:, 0, :]
    is_semantic = ((main >= cfg.semantic_begin_id)
                   & (main <= cfg.semantic_end_id))[..., None]
    x = F.embedding(main, params["embeddings"])
    x = x + _lora_embed(params, "lora_embeddings", main, cfg.lora_scale)
    x = x + torch.where(is_semantic, vq_sum, torch.zeros_like(vq_sum))
    if cfg.scale_codebook_embeddings and inference:
        scale = 1.0 / math.sqrt(cfg.num_codebooks + 1)
        x = torch.where(is_semantic, x * scale, x)
    return x


# ---------------------------------------------------------------------------
# Transformer block pieces (shared by the slow and fast stacks)
# ---------------------------------------------------------------------------


def _lora_delta(lp, name, x, scale):
    """Low-rank delta `scale * (x @ A) @ B` when this weight has LoRA."""
    lora = lp.get("lora")
    if lora is not None and name in lora:
        return scale * ((x @ lora[name]["a"]) @ lora[name]["b"])
    return 0


def _qkv(lp, spec, h):
    """Project + split + per-head norm. Returns q, k, v (B, T, H*, Dh)."""
    n_head, n_kv, head_dim, eps, lora_scale = spec
    qkv = mm(h, lp["wqkv"]) + _lora_delta(lp, "wqkv", h, lora_scale)
    if "bqkv" in lp:
        qkv = qkv + lp["bqkv"]
    b, t, _ = qkv.shape
    q_size = n_head * head_dim
    kv_size = n_kv * head_dim
    q = qkv[..., :q_size].reshape(b, t, n_head, head_dim)
    k = qkv[..., q_size : q_size + kv_size].reshape(b, t, n_kv, head_dim)
    v = qkv[..., q_size + kv_size :].reshape(b, t, n_kv, head_dim)
    if "q_norm" in lp:
        q = rms_norm(q, lp["q_norm"], eps)
        k = rms_norm(k, lp["k_norm"], eps)
    return q, k, v


def _attn_out(lp, spec, y):
    """Output projection with optional bias/LoRA. y: (B, T, H*Dh)."""
    out = mm(y, lp["wo"]) + _lora_delta(lp, "wo", y, spec[4])
    if "bo" in lp:
        out = out + lp["bo"]
    return out


def _takes_int8_ffn(lp, rows):
    """Whether the layer's FFN over `rows` rows runs `int8_ffn`: every FFN
    weight int8, no LoRA on w1, w3 or w2, and 1 to 32 rows (more rows, int4,
    bf16 and LoRA layers keep `mm` and torch's gate)."""
    names = ("w13", "w2") if "w13" in lp else ("w1", "w3", "w2")
    lora = lp.get("lora", {})
    return (0 < rows <= INT8_FFN_ROWS
            and all(isinstance(lp[n], dict) and "q" in lp[n] for n in names)
            and not any(n in lora for n in ("w1", "w3", "w2")))


def _ffn(lp, spec, h2):
    rows = h2.numel() // h2.shape[-1]
    if _takes_int8_ffn(lp, rows):
        # the kernel takes fp32 scales: a no-op on the trees of `fp32_scales`
        w13 = fp32_scales(lp["w13"] if "w13" in lp else (lp["w1"], lp["w3"]))
        y = int8_ffn(h2.reshape(rows, h2.shape[-1]).contiguous(), w13,
                     fp32_scales(lp["w2"]))
        return y.reshape(h2.shape)
    lora_scale = spec[4]
    if "w13" in lp:  # fused w1|w3 (`fuse_ffn_weights`); LoRA stays split
        u = mm(h2, lp["w13"])
        i = u.shape[-1] // 2
        u1 = u[..., :i] + _lora_delta(lp, "w1", h2, lora_scale)
        u3 = u[..., i:] + _lora_delta(lp, "w3", h2, lora_scale)
    else:
        u1 = mm(h2, lp["w1"]) + _lora_delta(lp, "w1", h2, lora_scale)
        u3 = mm(h2, lp["w3"]) + _lora_delta(lp, "w3", h2, lora_scale)
    g = F.silu(u1) * u3
    return mm(g, lp["w2"]) + _lora_delta(lp, "w2", g, lora_scale)


def _layer_slice(layers, i):
    """Layer i of a stacked layer tree (LoRA sub-dicts included)."""
    return {name: _layer_slice(w, i) if isinstance(w, dict) else w[i]
            for name, w in layers.items()}


def _run_stack_decode(layers, spec, x, freqs, cache, pos, lengths):
    """Decode-mode layer loop.

    x (B, 1, D). Lockstep: freqs (1, Dh/2, 2) and the cache is written in
    place at `pos` (an int or a (1,) int64 tensor). Per row (the decode
    pool): freqs (B, 1, Dh/2, 2) and `pos` is (flat_pos, active) for
    `_store_kv_rows`. int8 plus scales under the int8 cache; each layer's
    attention reads its first `lengths[b]` positions."""
    n_head, n_kv, head_dim, eps, _ = spec
    b = x.shape[0]
    quant = "ks" in cache
    for i in range(cache["k"].shape[0]):
        lp = _layer_slice(layers, i)
        h = rms_norm(x, lp["attn_norm"], eps)
        q, k, v = _qkv(lp, spec, h)
        q = apply_rope(q, freqs)
        k = apply_rope(k, freqs)
        if isinstance(pos, tuple):
            _store_kv_rows(cache, i, *pos, k, v)
        else:
            _store_kv(cache, i, pos, k, v)
        qg = q.reshape(b, n_kv, n_head // n_kv, head_dim).contiguous()
        if quant:
            y = flash_decode_attention_kv8(qg, cache["k"], cache["ks"],
                                           cache["v"], cache["vs"], i, lengths)
        else:
            y = flash_decode_attention(qg, cache["k"], cache["v"], i, lengths)
        x = x + _attn_out(lp, spec, y.reshape(b, 1, -1))
        h2 = rms_norm(x, lp["ffn_norm"], eps)
        x = x + _ffn(lp, spec, h2)
    return x, cache


def _slow_spec(cfg: DualARConfig):
    return (cfg.n_head, cfg.n_local_heads, cfg.head_dim, cfg.norm_eps,
            cfg.lora_scale)


def _fast_spec(cfg: DualARConfig):
    return (cfg.fast_n_head, cfg.fast_n_local_heads, cfg.fast_head_dim,
            cfg.norm_eps, cfg.lora_scale)


# ---------------------------------------------------------------------------
# Training forward
# ---------------------------------------------------------------------------


def _block_train(lp, spec, x, freqs, kvalid=None, mask=None):
    """One pre-norm block, self-attention over x itself (no cache).

    With `kvalid` (B, T) int32 the attention is `flash_train_attention`
    (causal & key-valid; the hand-written kernels on CUDA tensors, at any
    T); without it, plain `gqa_attention` under `mask` (the fast stack)."""
    eps = spec[3]
    h = rms_norm(x, lp["attn_norm"], eps)
    q, k, v = _qkv(lp, spec, h)
    q = apply_rope(q, freqs)
    k = apply_rope(k, freqs)
    if kvalid is not None:
        y = flash_train_attention(q, k, v.contiguous(), kvalid)
    else:
        y = gqa_attention(q, k, v, mask)
    b, t = y.shape[:2]
    x = x + _attn_out(lp, spec, y.reshape(b, t, -1))
    h2 = rms_norm(x, lp["ffn_norm"], eps)
    return x + _ffn(lp, spec, h2)


def _run_stack_train(layers, spec, x, freqs, remat: bool, kvalid=None,
                     mask=None):
    """The layer loop; with `remat` each layer is recomputed in the backward
    (`torch.utils.checkpoint`, the counterpart of `jax.checkpoint`)."""
    for i in range(layers["attn_norm"].shape[0]):
        lp = _layer_slice(layers, i)
        if remat:
            x = checkpoint(_block_train, lp, spec, x, freqs, kvalid, mask,
                           use_reentrant=False)
        else:
            x = _block_train(lp, spec, x, freqs, kvalid, mask)
    return x


def forward_train(params, cfg: DualARConfig, inp, labels=None, pad_mask=None,
                  remat=None):
    """Full teacher-forced forward.

    inp (B, C+1, T) int inputs; labels (B, C+1, T) (the fast stack is
    teacher-forced on rows 1..C-1; defaults to inp); pad_mask (B, T) bool,
    True where PADDING. remat defaults to `cfg.use_gradient_checkpointing`.

    Returns token_logits (B, T, V) fp32 and codebook_logits (B, T, C, K)
    fp32, the fast logits at every position (the loss masks them)."""
    cfg = cfg.resolve()
    if remat is None:
        remat = cfg.use_gradient_checkpointing
    b, _, t = inp.shape
    x = embed_tokens(params, cfg, inp, inference=False)
    freqs = rope_table(cfg.max_seq_len, cfg.head_dim, cfg.rope_base,
                       x.device)[:t]
    if pad_mask is None:
        kvalid = torch.ones((b, t), dtype=torch.int32, device=x.device)
    else:
        kvalid = (~pad_mask.to(x.device)).to(torch.int32)
    x = _run_stack_train(params["layers"], _slow_spec(cfg), x, freqs, remat,
                         kvalid=kvalid)
    slow_out = rms_norm(x, params["norm"], cfg.norm_eps)
    token_logits = _lm_head(params, cfg, slow_out)
    hidden = slow_out if cfg.norm_fastlayer_input else x

    if labels is None:
        labels = inp
    teacher = labels[:, 1:-1, :].long().clamp(0, cfg.codebook_size - 1)
    teacher = teacher.transpose(1, 2).reshape(b * t, cfg.num_codebooks - 1)
    codebook_logits = fast_forward_train(
        params, cfg, hidden.reshape(b * t, cfg.dim), teacher, remat)
    return token_logits, codebook_logits.reshape(
        b, t, cfg.num_codebooks, cfg.codebook_size)


def fast_forward_train(params, cfg: DualARConfig, hidden, codebooks,
                       remat: bool = False):
    """Teacher-forced fast transformer: hidden (N, D) slow states, codebooks
    (N, C-1) ground-truth codebooks 0..C-2 -> (N, C, K) fp32 logits;
    position i predicts codebook i."""
    cfg = cfg.resolve()
    x0 = fast_project_in(params, cfg, hidden)
    emb = fast_embed(params, cfg, codebooks)
    x = torch.cat([x0[:, None, :].to(emb.dtype), emb], dim=1)  # (N, C, Df)
    c = cfg.num_codebooks
    freqs = rope_table(c, cfg.fast_head_dim, cfg.rope_base, x.device)
    x = _run_stack_train(params["fast"]["layers"], _fast_spec(cfg), x, freqs,
                         remat, mask=causal_mask(c, x.device))
    out = rms_norm(x, params["fast"]["norm"], cfg.norm_eps)
    return _fast_head(params, cfg, out)


def _lm_head(params, cfg: DualARConfig, slow_out):
    if cfg.tie_word_embeddings:
        logits = slow_out @ params["embeddings"].T
        if "lora_embeddings" in params:
            la = params["lora_embeddings"]
            logits = logits + cfg.lora_scale * ((slow_out @ la["b"].T) @ la["a"].T)
    else:
        logits = mm(slow_out, params["output"])
        if "lora_output" in params:
            la = params["lora_output"]
            logits = logits + cfg.lora_scale * ((slow_out @ la["a"]) @ la["b"])
    return logits.float()


def fast_project_in(params, cfg: DualARConfig, hidden):
    if "project_in" in params["fast"]:
        p = params["fast"]["project_in"]
        return hidden @ p["w"] + p["b"]
    return hidden


def fast_embed(params, cfg: DualARConfig, codes):
    """Fast-codebook embedding lookup with optional LoRA."""
    codes = codes.long()
    return (F.embedding(codes, params["fast"]["embeddings"])
            + _lora_embed(params["fast"], "lora_embeddings", codes,
                          cfg.lora_scale))


def _fast_head(params, cfg: DualARConfig, out):
    logits = mm(out, params["fast"]["output"])
    if "lora_output" in params["fast"]:
        la = params["fast"]["lora_output"]
        logits = logits + cfg.lora_scale * ((out @ la["a"]) @ la["b"])
    return logits.float()


# ---------------------------------------------------------------------------
# Inference: prefill and single-step decode
# ---------------------------------------------------------------------------


def _prefill_tail(params, cfg: DualARConfig, x, t_end, cache):
    """Last-real-position extraction, final norm, LM head. t_end is an int
    or a (B,) tensor of per-row end positions."""
    b = x.shape[0]
    t_last = torch.as_tensor(t_end, device=x.device).long().reshape(-1) - 1
    x_last = x[torch.arange(b, device=x.device), t_last.expand(b)]  # (B, D)
    slow_out = rms_norm(x_last, params["norm"], cfg.norm_eps)
    logits = _lm_head(params, cfg, slow_out[:, None])[:, 0]
    hidden = slow_out if cfg.norm_fastlayer_input else x_last
    return logits, hidden, cache


def prefill(params, cfg: DualARConfig, inp, cache, offsets, t_end):
    """Run the prompt (B, C+1, Tpad) through the slow stack, writing k/v at
    [0, Tpad) of the cache (quantized under the int8 cache). Row i's prompt
    occupies [offsets[i], t_end); attention is the prefill kernel over the
    fresh k/v (every prompt length, not only >= 512 as on the TPU).

    Returns (logits_last (B, V) fp32, hidden_last (B, D), cache)."""
    cfg = cfg.resolve()
    t = inp.shape[2]
    x = embed_tokens(params, cfg, inp)
    freqs = rope_table(cfg.max_seq_len, cfg.head_dim, cfg.rope_base,
                       x.device)[:t]
    offsets = offsets.to(device=x.device, dtype=torch.int32)
    spec = _slow_spec(cfg)
    b = x.shape[0]
    for i in range(cache["k"].shape[0]):
        lp = _layer_slice(params["layers"], i)
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(lp, spec, h)
        q = apply_rope(q, freqs)
        k = apply_rope(k, freqs)
        _store_kv(cache, i, slice(0, t), k, v)
        y = flash_prefill_attention(q, k, v.contiguous(), offsets)
        x = x + _attn_out(lp, spec, y.reshape(b, t, -1))
        h2 = rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
        x = x + _ffn(lp, spec, h2)
    return _prefill_tail(params, cfg, x, t_end, cache)


def _lengths(b: int, pos: int, device):
    return torch.full((b,), pos + 1, dtype=torch.int32, device=device)


def decode_slow_step(params, cfg: DualARConfig, token, cache, pos):
    """One slow-transformer step at absolute position `pos`: a host int or
    an int tensor of one element on the model's device. Everything that
    depends on it is computed on the device (the RoPE row, the cache
    write, the attention lengths), so a CUDA graph of the step reads the
    position at replay.

    token: (B, C+1) int current column. Returns (hidden (B, D) for the fast
    stack, slow_out (B, D) normed, cache)."""
    cfg = cfg.resolve()
    x = embed_tokens(params, cfg, token[:, :, None])  # (B, 1, D)
    b = x.shape[0]
    pos = torch.as_tensor(pos, device=x.device).reshape(1).long()
    table = rope_table(cfg.max_seq_len, cfg.head_dim, cfg.rope_base, x.device)
    # past the table JAX's dynamic_slice clamps; overshoot steps past the
    # budget are discarded on the host either way
    freqs = table.index_select(0, pos.clamp(max=table.shape[0] - 1))
    lengths = (pos + 1).to(torch.int32).expand(b).contiguous()
    x, cache = _run_stack_decode(params["layers"], _slow_spec(cfg), x, freqs,
                                 cache, pos, lengths)
    x = x[:, 0]
    slow_out = rms_norm(x, params["norm"], cfg.norm_eps)
    hidden = slow_out if cfg.norm_fastlayer_input else x
    return hidden, slow_out, cache


def decode_slow_step_multi(params, cfg: DualARConfig, token, cache, pos,
                           active):
    """One slow step with a position per row (the decode pool's rows are
    sequences of their own; `fish_speech_tpu/models/dual_ar.py:860-888`).

    token (B, C+1) int; pos (B,) int64 and active (B,) bool on the model's
    device. Row b writes its k/v at pos[b] only where active[b] (an
    inactive row's cache stays as it is) and attends positions [0,
    pos[b]]: inactive rows still attend, as in JAX, so their pos keeps the
    length >= 1. Positions past the cache or the RoPE table clamp (the
    pool's headroom keeps them inside). Nothing is read on the host, so a
    CUDA graph of the step reads pos and active at replay.

    Returns (hidden (B, D) for the fast stack, slow_out (B, D) normed, cache)."""
    cfg = cfg.resolve()
    x = embed_tokens(params, cfg, token[:, :, None])  # (B, 1, D)
    b = x.shape[0]
    s = cache["k"].shape[2]
    table = rope_table(cfg.max_seq_len, cfg.head_dim, cfg.rope_base, x.device)
    freqs = table.index_select(0, pos.clamp(0, table.shape[0] - 1))[:, None]
    at = pos.clamp(0, s - 1)
    flat_pos = torch.arange(b, device=x.device) * s + at
    x, cache = _run_stack_decode(params["layers"], _slow_spec(cfg), x, freqs,
                                 cache, (flat_pos, active),
                                 (at + 1).to(torch.int32))
    x = x[:, 0]
    slow_out = rms_norm(x, params["norm"], cfg.norm_eps)
    hidden = slow_out if cfg.norm_fastlayer_input else x
    return hidden, slow_out, cache


def fast_decode_step(params, cfg: DualARConfig, x, fast_cache, pos: int,
                     with_logits: bool = True):
    """One fast-transformer step at codebook position `pos` (host int).

    x: (B, Df). Returns (logits (B, K) fp32 or None, fast_cache)."""
    cfg = cfg.resolve()
    table = rope_table(cfg.num_codebooks, cfg.fast_head_dim, cfg.rope_base,
                       x.device)
    y, fast_cache = _run_stack_decode(
        params["fast"]["layers"], _fast_spec(cfg), x[:, None],
        table[pos : pos + 1], fast_cache, pos,
        _lengths(x.shape[0], pos, x.device),
    )
    if not with_logits:
        return None, fast_cache
    out = rms_norm(y[:, 0], params["fast"]["norm"], cfg.norm_eps)
    return _fast_head(params, cfg, out), fast_cache


# ---------------------------------------------------------------------------
# Heads and inference-time weight preparation
# ---------------------------------------------------------------------------


def _rows_16_bytes_apart(q):
    """An int8 (I, O) matrix as a view of an (I, O') buffer, O' = O rounded
    up to 16 bytes: the int8 kernel streams rows by TMA, which needs row
    strides of a multiple of 16 bytes (the semantic head has S + 1
    columns)."""
    o = q.shape[-1]
    if o % 16 == 0:
        return q.contiguous()
    buf = q.new_zeros((*q.shape[:-1], o + (-o % 16)))
    buf[..., :o] = q
    return buf[..., :o]


def precompute_semantic_head(params, cfg: DualARConfig):
    """Return params plus `_semantic_head`: the (D, S+1) slice of the LM
    head over the semantic ids and im_end, materialized once (an int8 head
    keeps its int8 columns, rows 16 bytes apart, and their scales)."""
    cfg = cfg.resolve()
    sb, se, end = cfg.semantic_begin_id, cfg.semantic_end_id, cfg.im_end_id
    if cfg.tie_word_embeddings:
        emb = params["embeddings"]
        head = {"w": torch.cat([emb[sb : se + 1], emb[end][None]], dim=0).T}
    elif isinstance(params["output"], dict):
        out_w = params["output"]
        head = {"q": torch.cat([out_w["q"][:, sb : se + 1],
                                out_w["q"][:, end][:, None]], dim=1),
                "s": torch.cat([out_w["s"][sb : se + 1], out_w["s"][end][None]])}
    else:
        out_w = params["output"]
        head = {"w": torch.cat([out_w[:, sb : se + 1], out_w[:, end][:, None]],
                               dim=1)}
    new = dict(params)
    new["_semantic_head"] = {k: _rows_16_bytes_apart(v) if k == "q" else
                             v.contiguous() for k, v in head.items()}
    return new


def fuse_ffn_weights(params):
    """Concatenate each stack's w1|w3 into w13 (one (D, 2I) matmul), also
    for int8 ({"q","s"}) and int4 ({"p","gs"}) weights: every leaf keeps
    the output dim last, so the fused product is the split one's. The
    concatenation materializes a copy; the split tensors are dropped from
    the returned dict."""
    def fuse_stack(layers):
        if "w1" not in layers:
            return layers
        w1, w3 = layers["w1"], layers["w3"]
        out = {k: v for k, v in layers.items() if k not in ("w1", "w3")}
        if isinstance(w1, dict):
            out["w13"] = {k: torch.cat([w1[k], w3[k]], dim=-1) for k in w1}
        else:
            out["w13"] = torch.cat([w1, w3], dim=-1)
        return out

    new = dict(params)
    new["layers"] = fuse_stack(params["layers"])
    fast = dict(params["fast"])
    fast["layers"] = fuse_stack(fast["layers"])
    new["fast"] = fast
    return new


def semantic_head_logits(params, cfg: DualARConfig, slow_out):
    """Constrained-decoding head: logits over the semantic ids (columns
    [0, S)) plus im_end (column S), fp32 (B, S+1), with the LM head's LoRA
    term restricted to those columns. Needs the params from
    `precompute_semantic_head`."""
    cfg = cfg.resolve()
    head = params["_semantic_head"]
    logits = mm(slow_out, head["w"] if "w" in head else head)
    sb, se, end = cfg.semantic_begin_id, cfg.semantic_end_id, cfg.im_end_id
    la = params.get("lora_embeddings" if cfg.tie_word_embeddings
                    else "lora_output")
    if la is not None:
        if cfg.tie_word_embeddings:
            # effective rows (W + s*A@B)[rows]: delta = (x @ B.T) @ A[rows].T
            a_rows = torch.cat([la["a"][sb : se + 1], la["a"][end][None]], dim=0)
            logits = logits + cfg.lora_scale * ((slow_out @ la["b"].T) @ a_rows.T)
        else:
            b_cols = torch.cat([la["b"][:, sb : se + 1], la["b"][:, end][:, None]],
                               dim=1)
            logits = logits + cfg.lora_scale * ((slow_out @ la["a"]) @ b_cols)
    return logits.float()


def semantic_index_to_token(cfg: DualARConfig, idx):
    """Map a restricted-head sample index back to a text-vocab id."""
    n_sem = cfg.semantic_end_id - cfg.semantic_begin_id + 1
    return torch.where(idx >= n_sem, torch.full_like(idx, cfg.im_end_id),
                       cfg.semantic_begin_id + idx)
