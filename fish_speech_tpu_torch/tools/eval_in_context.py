"""In-context evaluation: per-frame semantic-loss curves across checkpoints
(reference `tools/llama/eval_in_context.py`), the port of
`fish_speech_tpu/tools/eval_in_context.py`.

Feeds (reference audio codes + target audio codes) through the model
teacher-forced (`models/dual_ar.py:forward_train`) and reports the
per-frame loss on the target span — lower and flatter = better in-context
voice following.

    python -m fish_speech_tpu_torch.tools.eval_in_context \
        --checkpoint-path A --checkpoint-path B \
        --reference-codes ref.npy --reference-text "..." \
        --target-codes tgt.npy --target-text "..."

It runs on `cuda:0` and fails where there is none; `--cpu` runs it on the
CPU. The weights load in float32, as the JAX tool loads them;
`--precision bfloat16` evaluates the model as it serves.
"""

from __future__ import annotations

import json
from pathlib import Path

import click
import numpy as np


def per_frame_semantic_loss(params, cfg, inp, labels):
    """Teacher-forced codebook NLL per frame of `inp` (C+1, T) under
    `labels` (C+1, T), numpy int32: returns (per_frame (T,) float, valid
    (T,) bool), a frame valid where its row-0 label is a loss-bearing
    semantic token and some codebook label is set."""
    import torch

    from fish_speech_tpu_torch.models.dual_ar import forward_train

    dev = params["embeddings"].device
    with torch.no_grad():
        _, codebook_logits = forward_train(
            params, cfg, torch.from_numpy(inp[None]).to(dev),
            labels=torch.from_numpy(labels[None]).to(dev), remat=False)
        logp = torch.log_softmax(codebook_logits[0], dim=-1)  # (T, C, K)
    cb_labels = np.transpose(labels[1:], (1, 0))  # (T, C)
    safe = torch.from_numpy(np.clip(cb_labels, 0, cfg.codebook_size - 1))
    nll = -torch.gather(logp, -1, safe[..., None].long().to(dev))[..., 0]
    nll = nll.cpu().numpy()
    # train-loss mask semantics (train/loss.py): codebook loss counts only
    # where the row-0 label is a LOSS-BEARING semantic token — the encode
    # stores codebook labels under the reference prompt too (cal_loss only
    # gates row 0), so without this intersection the "in-context" curve
    # would silently average the reference span in with the target span
    sem_valid = (labels[0] >= cfg.semantic_begin_id) & (
        labels[0] <= cfg.semantic_end_id
    )
    valid = (cb_labels != -100) & sem_valid[:, None]
    per_frame = (nll * valid).sum(-1) / np.maximum(valid.sum(-1), 1)
    return per_frame, valid.any(-1)


def in_context_inputs(tokenizer, cfg, reference_codes, reference_text,
                      target_codes, target_text):
    """The teacher-forced (inp, labels), each (C+1, T) int32, of a chat
    whose system turn holds the reference (text and codes) and whose
    assistant turn is the target codes (loss-bearing), as the JAX tool
    builds them."""
    from fish_speech_tpu_torch.generate import build_base_conversation
    from fish_speech_tpu_torch.sequence import Message, TextPart, VQPart

    conv = build_base_conversation([reference_text], [reference_codes])
    conv.append(Message(role="user", parts=[TextPart(text=target_text)]))
    conv.append(
        Message(role="assistant", modality="voice",
                parts=[VQPart(codes=target_codes, cal_loss=True)], cal_loss=True)
    )
    enc = conv.encode(tokenizer, add_shift=True)
    t = len(enc.tokens)
    inp = np.zeros((cfg.num_codebooks + 1, t), dtype=np.int32)
    inp[0] = enc.tokens
    all_vq = np.concatenate(enc.vq_parts, axis=1)
    inp[1:, enc.vq_mask_tokens] = all_vq[:, : enc.vq_mask_tokens.sum()]
    labels = np.full((cfg.num_codebooks + 1, t), -100, dtype=np.int32)
    labels[0] = enc.labels
    labels[1:, enc.vq_mask_labels] = all_vq[
        :, all_vq.shape[1] - enc.vq_mask_labels.sum() :
    ]
    return inp, labels


@click.command()
@click.option("--checkpoint-path", "checkpoints", type=click.Path(exists=True),
              multiple=True, required=True)
@click.option("--reference-codes", type=click.Path(exists=True), required=True)
@click.option("--reference-text", type=str, required=True)
@click.option("--target-codes", type=click.Path(exists=True), required=True)
@click.option("--target-text", type=str, required=True)
@click.option("--output", type=click.Path(path_type=Path),
              default=Path("output/in_context_loss.json"))
@click.option("--precision", type=click.Choice(["float32", "bfloat16"]),
              default="float32", help="the weights' dtype")
@click.option("--cpu", is_flag=True, help="run on the CPU (else on cuda:0)")
def main(checkpoints, reference_codes, reference_text, target_codes,
         target_text, output, precision, cpu):
    import dataclasses

    import torch

    from fish_speech_tpu_torch.tokenizer import FishTokenizer
    from fish_speech_tpu_torch.utils.checkpoint import load_dual_ar

    device = "cpu" if cpu else "cuda:0"
    dtype = torch.bfloat16 if precision == "bfloat16" else torch.float32
    ref = np.load(reference_codes)
    tgt = np.load(target_codes)

    results = {}
    for ckpt in checkpoints:
        params, cfg = load_dual_ar(ckpt, dtype=dtype, device=device)
        tokenizer = FishTokenizer.from_pretrained(ckpt)
        cfg = dataclasses.replace(
            cfg,
            semantic_begin_id=tokenizer.semantic_begin_id,
            semantic_end_id=tokenizer.semantic_end_id,
            im_end_id=tokenizer.im_end_id,
        ).resolve()
        inp, labels = in_context_inputs(tokenizer, cfg, ref, reference_text,
                                        tgt, target_text)
        per_frame, mask = per_frame_semantic_loss(params, cfg, inp, labels)
        curve = per_frame[mask].tolist()
        results[str(ckpt)] = {
            "mean_loss": float(np.mean(curve)),
            "per_frame": curve,
        }
        click.echo(f"{ckpt}: mean in-context semantic loss {np.mean(curve):.4f}")
        del params

    output.parent.mkdir(parents=True, exist_ok=True)
    output.write_text(json.dumps(results, indent=2))
    click.echo(f"Wrote {output}")


if __name__ == "__main__":
    main()
