"""Analytic FLOPs accounting for MFU reporting, the port of
`fish_speech_tpu/utils/flops.py` (the same counts).

The formulas count matmul and attention FLOPs from the shapes;
elementwise work (norms, activations, softmax, the CE loss) is under 1%
at these shapes and is not counted, and causal attention is counted at
half its context (the useful work). `tests/test_torch_eval_tools.py` holds
them to `torch.utils.flop_counter.FlopCounterMode` on the port's 1-layer
forward and training step.

MFU convention (PaLM-style "model FLOPs utilization"): the numerator is
the FLOPs the MODEL needs — forward + backward GEMMs — excluding
rematerialization recompute. `train_step_flops` also returns the
remat-inclusive number (`hfu_total`) for hardware-utilization questions.
The denominator is the card's peak for the type, e.g. 989e12 dense bf16
FLOPs/s on one H100 SXM at 700 W (NVIDIA's data sheet).
"""

from __future__ import annotations

from fish_speech_tpu_torch.config import DACConfig, DualARConfig


def _attn_flops(tokens: float, ctx: float, n_head: int, head_dim: int,
                causal: bool = True, window: int | None = None) -> float:
    """QK^T + AV for `tokens` query positions against `ctx` keys.

    Causal halves the average effective context; a sliding window caps it.
    2 GEMMs x 2 flops/MAC = 4 * tokens * ctx_eff * n_head * head_dim.
    """
    ctx_eff = min(ctx, window) if window else ctx
    if causal and not window:
        ctx_eff = ctx_eff / 2.0
    return 4.0 * tokens * ctx_eff * n_head * head_dim


def _layer_flops(tokens: float, dim: int, n_head: int, n_local: int,
                 head_dim: int, inter: int, ctx: float,
                 causal: bool = True, window: int | None = None) -> dict:
    """One transformer layer: qkv + o projections, SwiGLU FFN, attention."""
    qkv = 2.0 * tokens * dim * (n_head + 2 * n_local) * head_dim
    o = 2.0 * tokens * n_head * head_dim * dim
    ffn = 2.0 * tokens * dim * inter * 3  # w1, w3, w2
    attn = _attn_flops(tokens, ctx, n_head, head_dim, causal, window)
    return {"weights": qkv + o + ffn, "attn": attn}


# ---------------------------------------------------------------------------
# Dual-AR LM
# ---------------------------------------------------------------------------


def dual_ar_forward_flops(cfg: DualARConfig, batch: int, seq: int,
                          fast_positions: int | None = None) -> dict:
    """Teacher-forced `forward_train` FLOPs (matmuls + attention).

    The fast stack runs at every position over `num_codebooks` teacher
    tokens (`models/dual_ar.py:forward_train` — static shapes, masked in
    the loss), so its token count is batch*seq*num_codebooks unless
    `fast_positions` overrides the number of slow positions that feed it.
    """
    cfg = cfg.resolve()
    t_slow = float(batch * seq)
    lay = _layer_flops(t_slow, cfg.dim, cfg.n_head, cfg.n_local_heads,
                       cfg.head_dim, cfg.intermediate_size, float(seq))
    slow_w = cfg.n_layer * lay["weights"]
    slow_attn = cfg.n_layer * lay["attn"]
    lm_head = 2.0 * t_slow * cfg.dim * cfg.vocab_size

    n_fast_pos = float(fast_positions if fast_positions is not None
                       else batch * seq)
    t_fast = n_fast_pos * cfg.num_codebooks
    flay = _layer_flops(t_fast, cfg.fast_dim, cfg.fast_n_head,
                        cfg.fast_n_local_heads, cfg.fast_head_dim,
                        cfg.fast_intermediate_size, float(cfg.num_codebooks))
    fast_w = cfg.n_fast_layer * flay["weights"]
    fast_attn = cfg.n_fast_layer * flay["attn"]
    if cfg.fast_dim != cfg.dim:
        fast_w += 2.0 * n_fast_pos * cfg.dim * cfg.fast_dim  # project_in
    fast_head = 2.0 * t_fast * cfg.fast_dim * cfg.codebook_size

    return {
        "slow_weights": slow_w, "slow_attn": slow_attn, "lm_head": lm_head,
        "fast_weights": fast_w, "fast_attn": fast_attn,
        "fast_head": fast_head,
        "total": slow_w + slow_attn + lm_head + fast_w + fast_attn + fast_head,
    }


def dual_ar_train_step_flops(cfg: DualARConfig, batch: int, seq: int,
                             mode: str = "full",
                             remat: bool = True) -> dict:
    """One optimizer step (forward + backward) of `make_train_step`.

    Per weight GEMM: forward 1x, backward dX 1x, backward dW 1x — so
    trainable weights cost 3x forward, FROZEN weights (LoRA mode) skip dW
    and cost 2x. Attention GEMMs have no weights but their backward is
    two GEMMs per forward GEMM -> 3x in both modes. LoRA adapter matmuls
    themselves are O(r/dim) of the base and are not counted. `total` is
    the MFU numerator (no remat recompute); `hfu_total` adds one extra
    forward for the rematerialized stacks when `remat`.
    """
    if mode not in ("full", "lora"):
        raise ValueError(f"mode must be full|lora, got {mode!r}")
    f = dual_ar_forward_flops(cfg, batch, seq)
    w_mult = 3.0 if mode == "full" else 2.0
    weights = f["slow_weights"] + f["fast_weights"] + f["lm_head"] \
        + f["fast_head"]
    attn = f["slow_attn"] + f["fast_attn"]
    total = w_mult * weights + 3.0 * attn
    return {
        "forward": f["total"],
        "total": total,
        "hfu_total": total + (f["total"] if remat else 0.0),
    }


def dual_ar_prefill_flops(cfg: DualARConfig, rows: int, bucket: int) -> float:
    """Group prefill of `rows` prompts at prompt-bucket `bucket`: slow
    forward over every position + LM head and one fast-decode frame
    (num_codebooks sequential single-token fast steps) at the last
    position of each row (`generate.py` prefill emits the first frame).
    """
    cfg = cfg.resolve()
    f = dual_ar_forward_flops(cfg, rows, bucket, fast_positions=rows)
    return (f["slow_weights"] + f["slow_attn"] + f["lm_head"]
            + f["fast_weights"] + f["fast_attn"] + f["fast_head"])


def dual_ar_decode_step_flops(cfg: DualARConfig, rows: int,
                              kv_len: float) -> float:
    """One decode frame for `rows` streams: slow step (1 token, `kv_len`
    average context) + fast codebook loop + both heads. Decode is
    bandwidth-bound on this architecture — this exists for completeness
    of the roofline report, not because MFU is the binding metric there.
    """
    cfg = cfg.resolve()
    t = float(rows)
    lay = _layer_flops(t, cfg.dim, cfg.n_head, cfg.n_local_heads,
                       cfg.head_dim, cfg.intermediate_size, kv_len,
                       causal=False)
    slow = cfg.n_layer * (lay["weights"] + lay["attn"])
    lm_head = 2.0 * t * cfg.dim * cfg.vocab_size
    t_fast = t * cfg.num_codebooks
    flay = _layer_flops(t_fast, cfg.fast_dim, cfg.fast_n_head,
                        cfg.fast_n_local_heads, cfg.fast_head_dim,
                        cfg.fast_intermediate_size,
                        float(cfg.num_codebooks) / 2.0, causal=False)
    fast = cfg.n_fast_layer * (flay["weights"] + flay["attn"])
    if cfg.fast_dim != cfg.dim:
        fast += 2.0 * t * cfg.dim * cfg.fast_dim
    fast_head = 2.0 * t_fast * cfg.fast_dim * cfg.codebook_size
    return slow + lm_head + fast + fast_head


# ---------------------------------------------------------------------------
# Modded-DAC codec
# ---------------------------------------------------------------------------


def _conv_flops(length: float, kernel: int, c_in: int, c_out: int,
                groups: int = 1) -> float:
    """Conv1d at `length` OUTPUT positions (causal padding keeps
    stride-1 convs length-preserving; callers pass the output length for
    strided / transposed convs)."""
    return 2.0 * length * kernel * (c_in // groups) * c_out


def _residual_unit_flops(length: float, dim: int) -> float:
    # conv1 k=7 (dilation changes receptive field, not FLOPs) + conv2 k=1
    return _conv_flops(length, 7, dim, dim) + _conv_flops(length, 1, dim, dim)


def _codec_transformer_flops(tokens: float, dim: int, n_layer: int,
                             window: int, length: float) -> float:
    n_head = max(dim // 64, 1)
    head_dim = 64 if dim >= 64 else dim
    lay = _layer_flops(tokens, dim, n_head, n_head, head_dim, dim * 3,
                       length, causal=True, window=window)
    return n_layer * (lay["weights"] + lay["attn"])


def _convnext_flops(length: float, dim: int, mlp_ratio: float = 4.0) -> float:
    # depthwise k=7 + pointwise MLP (models/dac/rvq.py:186-196)
    hidden = int(mlp_ratio * dim)
    return (_conv_flops(length, 7, dim, dim, groups=dim)
            + 2.0 * length * dim * hidden * 2)


def _rvq_encode_flops(cfg, enc_frames: float) -> float:
    """`downsample_rvq_codes`, what `dac_encode` runs (codes only: no up
    path and no post transformer, which only the reconstruction needs): the
    downsample convs + convnext, the optional pre transformer, and per VQ
    stage the in-projection, the distance GEMM against its codebook, and
    the out-projection (needed live: the residual chain subtracts the
    projected-back z_q, `models/dac/rvq.py:280-294`)."""
    r = cfg.rvq
    d = r.input_dim
    total = 0.0
    ln = enc_frames
    for f in r.downsample_factor:
        ln = ln / f
        total += _conv_flops(ln, f, d, d) + _convnext_flops(ln, d)
    if r.pre_transformer is not None:
        total += _codec_transformer_flops(
            ln, d, r.pre_transformer.n_layer,
            r.pre_transformer.window_size, ln)
    for k in [r.semantic_codebook_size] + [r.codebook_size] * r.n_codebooks:
        total += 2.0 * ln * d * r.codebook_dim * 2  # in + out projection
        total += 2.0 * ln * r.codebook_dim * k      # distance GEMM
    return total


def _rvq_decode_flops(cfg, frames: float) -> float:
    """`downsample_rvq_decode`: codebook gathers (no GEMM) + per-stage
    out-projection, optional post transformer, then the upsample path."""
    r = cfg.rvq
    d = r.input_dim
    total = 2.0 * frames * r.codebook_dim * d * (1 + r.n_codebooks)
    if r.post_transformer is not None:
        total += _codec_transformer_flops(
            frames, d, r.post_transformer.n_layer,
            r.post_transformer.window_size, frames)
    ln = frames
    for f in reversed(r.downsample_factor):
        # conv_transpose kernel=f, stride=f: MACs = in_len * k * cin * cout
        total += _conv_flops(ln, f, d, d)
        ln = ln * f
        total += _convnext_flops(ln, d)
    return total


def dac_encode_flops(cfg: DACConfig, batch: int, samples: int) -> float:
    """`dac_encode`: conv encoder + RVQ encode for `samples` of audio."""
    cfg = cfg if isinstance(cfg, DACConfig) else DACConfig()
    t = float(batch * samples)
    d = cfg.encoder_dim
    total = _conv_flops(t, 7, 1, d)
    ln = t
    for stride, n_t in zip(cfg.encoder_rates, cfg.encoder_transformer_layers):
        total += 3 * _residual_unit_flops(ln, d)
        ln = ln / stride
        total += _conv_flops(ln, 2 * stride, d, 2 * d)
        d *= 2
        if n_t:
            total += _codec_transformer_flops(
                ln, d, n_t, cfg.encoder_transformer_window, ln)
    total += _conv_flops(ln, 3, d, cfg.resolved_latent_dim)
    total += _rvq_encode_flops(cfg, ln)
    return total


def dac_decode_flops(cfg: DACConfig, batch: int, frames: int) -> float:
    """`dac_from_indices`: RVQ decode + conv decoder for `frames` codec
    frames (one frame = `frame_length` output samples)."""
    cfg = cfg if isinstance(cfg, DACConfig) else DACConfig()
    f = float(batch * frames)
    total = _rvq_decode_flops(cfg, f)
    ln = f * cfg.rvq.downsample_total
    d = cfg.decoder_dim
    total += _conv_flops(ln, 7, cfg.resolved_latent_dim, d)
    for stride in cfg.decoder_rates:
        # conv_transpose kernel=2*stride: MACs = in_len * k * cin * cout
        total += _conv_flops(ln, 2 * stride, d, d // 2)
        ln = ln * stride
        d //= 2
        total += 3 * _residual_unit_flops(ln, d)
    total += _conv_flops(ln, 7, d, 1)
    return total
