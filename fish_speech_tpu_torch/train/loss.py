"""Dual cross-entropy loss for the Dual-AR model, in PyTorch.

Port of `fish_speech_tpu/train/loss.py`: base CE over the text row,
semantic CE over all codebooks at semantic positions (selected by the row-0
labels), top-5 accuracy excluding the codebook pad (code 0).

Under data parallelism (`dp`, the mesh's dp axis) each rank holds its rows
of the global batch. The means stay the global batch's, as JAX's over its
dp-sharded batch: each rank divides its sum by the global count, so its
loss is its share of the global loss and the ranks' gradients sum to the
global gradient; the metrics are summed over dp.
"""

from __future__ import annotations

import torch

from fish_speech_tpu_torch.config import DualARConfig
from fish_speech_tpu_torch.models.dual_ar import forward_train

IGNORE_INDEX = -100
CODEBOOK_PAD_TOKEN_ID = 0


def _global(x, dp):
    """x summed over the dp ranks (a copy; x itself without dp)."""
    return x if dp is None else dp.all_reduce(x.detach().clone())


def masked_cross_entropy(logits, labels, valid, dp=None):
    """Mean CE over positions where valid; logits (..., V), labels (...).
    With `dp`: this rank's sum over the count of every dp rank."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    safe = labels.long().clamp(0, logits.shape[-1] - 1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    valid = valid.float()
    return (nll * valid).sum() / _global(valid.sum(), dp).clamp(min=1.0)


def dual_ar_loss(params, cfg: DualARConfig, batch, remat=None, dp=None):
    """(loss, metrics) of one batch.

    batch: inputs (B, C+1, T) int, labels (B, C+1, T) int with IGNORE_INDEX
    outside loss positions, pad_mask (B, T) bool True where padded
    (optional). With `dp` (an `Axis`) the batch is this rank's rows: the
    loss is this rank's share of the global batch's, the metrics are the
    global batch's."""
    labels = batch["labels"]
    token_logits, codebook_logits = forward_train(
        params, cfg, batch["inputs"], labels=labels,
        pad_mask=batch.get("pad_mask"), remat=remat)

    token_labels = labels[:, 0]  # (B, T)
    base_loss = masked_cross_entropy(token_logits, token_labels,
                                     token_labels != IGNORE_INDEX, dp)

    semantic_mask = ((token_labels >= cfg.semantic_begin_id)
                     & (token_labels <= cfg.semantic_end_id))  # (B, T)
    cb_labels = labels[:, 1:, :].transpose(1, 2)  # (B, T, C)
    cb_valid = (cb_labels != IGNORE_INDEX) & semantic_mask[..., None]
    semantic_loss = masked_cross_entropy(codebook_logits, cb_labels, cb_valid,
                                         dp)
    loss = base_loss + semantic_loss

    # top-5 accuracy (excluding the codebook pad), rank-count form: the
    # label is in the top 5 iff fewer than 5 logits strictly exceed its own
    with torch.no_grad():
        acc_mask = cb_valid & (cb_labels != CODEBOOK_PAD_TOKEN_ID)
        safe_cb = cb_labels.long().clamp(0, codebook_logits.shape[-1] - 1)
        label_logit = torch.gather(codebook_logits, -1, safe_cb[..., None])
        rank = (codebook_logits > label_logit).sum(dim=-1)  # (B, T, C)
        correct = (rank < 5) & acc_mask
        accuracy = (_global(correct.sum(), dp)
                    / _global(acc_mask.sum(), dp).clamp(min=1))

    metrics = {
        "loss": _global(loss.detach(), dp),
        "base_loss": _global(base_loss.detach(), dp),
        "semantic_loss": _global(semantic_loss.detach(), dp),
        "top_5_accuracy": accuracy,
    }
    return loss, metrics
