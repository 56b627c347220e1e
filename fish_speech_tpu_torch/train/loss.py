"""Dual cross-entropy loss for the Dual-AR model, in PyTorch.

Port of `fish_speech_tpu/train/loss.py`: base CE over the text row,
semantic CE over all codebooks at semantic positions (selected by the row-0
labels), top-5 accuracy excluding the codebook pad (code 0).
"""

from __future__ import annotations

import torch

from fish_speech_tpu.config import DualARConfig
from fish_speech_tpu_torch.models.dual_ar import forward_train

IGNORE_INDEX = -100
CODEBOOK_PAD_TOKEN_ID = 0


def masked_cross_entropy(logits, labels, valid):
    """Mean CE over positions where valid; logits (..., V), labels (...)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    safe = labels.long().clamp(0, logits.shape[-1] - 1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    valid = valid.float()
    return (nll * valid).sum() / valid.sum().clamp(min=1.0)


def dual_ar_loss(params, cfg: DualARConfig, batch, remat=None):
    """(loss, metrics) of one batch.

    batch: inputs (B, C+1, T) int, labels (B, C+1, T) int with IGNORE_INDEX
    outside loss positions, pad_mask (B, T) bool True where padded
    (optional)."""
    labels = batch["labels"]
    token_logits, codebook_logits = forward_train(
        params, cfg, batch["inputs"], labels=labels,
        pad_mask=batch.get("pad_mask"), remat=remat)

    token_labels = labels[:, 0]  # (B, T)
    base_loss = masked_cross_entropy(token_logits, token_labels,
                                     token_labels != IGNORE_INDEX)

    semantic_mask = ((token_labels >= cfg.semantic_begin_id)
                     & (token_labels <= cfg.semantic_end_id))  # (B, T)
    cb_labels = labels[:, 1:, :].transpose(1, 2)  # (B, T, C)
    cb_valid = (cb_labels != IGNORE_INDEX) & semantic_mask[..., None]
    semantic_loss = masked_cross_entropy(codebook_logits, cb_labels, cb_valid)
    loss = base_loss + semantic_loss

    # top-5 accuracy (excluding the codebook pad), rank-count form: the
    # label is in the top 5 iff fewer than 5 logits strictly exceed its own
    with torch.no_grad():
        acc_mask = cb_valid & (cb_labels != CODEBOOK_PAD_TOKEN_ID)
        safe_cb = cb_labels.long().clamp(0, codebook_logits.shape[-1] - 1)
        label_logit = torch.gather(codebook_logits, -1, safe_cb[..., None])
        rank = (codebook_logits > label_logit).sum(dim=-1)  # (B, T, C)
        correct = (rank < 5) & acc_mask
        accuracy = correct.sum() / acc_mask.sum().clamp(min=1)

    metrics = {
        "loss": loss.detach(),
        "base_loss": base_loss.detach(),
        "semantic_loss": semantic_loss.detach(),
        "top_5_accuracy": accuracy,
    }
    return loss, metrics
