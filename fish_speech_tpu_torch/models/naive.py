"""Naive transformer variant: a single stack predicts all codebooks per
position through a `codebook_output` head (no fast transformer). Port of
`fish_speech_tpu/models/naive.py`.

Reference: `llama.py:614-657` (NaiveTransformer, model_type "naive") —
legacy architecture kept for checkpoint compatibility; the reference's own
inference path only supports DualAR (`inference.py:368-373`), so this
variant supports training/teacher-forced use. Its stack is the Dual-AR
slow stack's training forward (`models/dual_ar.py:_run_stack_train`), so
its attention is `flash_train_attention`: on CUDA tensors the training
forward kernel (bf16: the tensor-core route).
"""

from __future__ import annotations

import torch

from fish_speech_tpu_torch.config import DualARConfig
from fish_speech_tpu_torch.models.dual_ar import (_dense, _init_layer_stack,
                                                  _lm_head, _run_stack_train,
                                                  _slow_spec, embed_tokens)
from fish_speech_tpu_torch.ops.norms import rms_norm
from fish_speech_tpu_torch.ops.rope import rope_table
from fish_speech_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


def init_naive(seed: int, cfg: DualARConfig, dtype=torch.bfloat16,
               device=DEFAULT_DEVICE):
    """Random-weight parameters with the JAX `init_naive`'s shapes and
    scales, drawn from a torch.Generator seeded with `seed` on `device`.
    Raises without CUDA unless `device` is the CPU."""
    cfg = cfg.resolve()
    device = resolve_device(device, "init_naive")
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
        "codebook_norm": torch.ones((cfg.dim,), dtype=dtype, device=device),
        "codebook_output": dense((cfg.dim, cfg.codebook_size * cfg.num_codebooks)),
    }
    if not cfg.tie_word_embeddings:
        params["output"] = dense((cfg.dim, cfg.vocab_size))
    return params


def forward_train_naive(params, cfg: DualARConfig, inp, pad_mask=None,
                        remat=False):
    """Teacher-forced forward. inp (B, C+1, T) int; pad_mask (B, T) bool,
    True where PADDING (keys there are masked).

    Returns (token_logits (B,T,V), codebook_logits (B,T,C,K)), both fp32.
    """
    cfg = cfg.resolve()
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
    cb = rms_norm(x, params["codebook_norm"], cfg.norm_eps)
    codebook_logits = (cb @ params["codebook_output"]).float()
    codebook_logits = codebook_logits.reshape(
        b, t, cfg.num_codebooks, cfg.codebook_size)
    return token_logits, codebook_logits
