"""Fine-tuning CLI of the PyTorch port (the JAX package's
`python -m fish_speech_tpu.train.cli`, same flags):

    python -m fish_speech_tpu_torch.train.cli \\
        --checkpoint-path checkpoints/s2-pro \\
        --data data/protos --output results/my_run \\
        --lora-r 8 --lora-alpha 16

Runs on `cuda:0`, and on the CPU only with `--cpu`: without it, a machine
with no CUDA device raises instead of training on the CPU. `--tiny` (or no
checkpoint) trains a tiny random model sized to the data's codebook count.
The multi-device flags (`--dp` > 1, `--tp` > 1, `--zero1`,
`--coordinator`/`--num-hosts`/`--host-id`) are not ported and raise.
"""

from __future__ import annotations

import dataclasses
import logging
import sys

import click


def _peek_num_codebooks(paths):
    """Codebook count of the first sentence in the data (None if no data
    is readable) — the tiny dev model is sized to match."""
    from fish_speech_tpu_torch.data.dataset import expand_proto_files
    from fish_speech_tpu_torch.data.stream import read_pb_stream

    for f in expand_proto_files(list(paths)):
        try:
            with open(f, "rb") as fh:
                for group in read_pb_stream(fh):
                    for sentence in group.sentences:
                        return len(sentence.semantics)
        except OSError:
            continue
    return None


@click.command()
@click.option("--checkpoint-path", type=str, default=None,
              help="native checkpoint dir (None = random init, tiny dev run)")
@click.option("--data", "data_paths", type=str, multiple=True, required=True)
@click.option("--val-data", "val_paths", type=str, multiple=True)
@click.option("--output", type=str, default="results/finetune")
@click.option("--max-steps", type=int, default=10000)
@click.option("--batch-size", type=int, default=4)
@click.option("--grad-accum", type=int, default=1,
              help="microbatches accumulated per optimizer step")
@click.option("--max-length", type=int, default=4096)
@click.option("--lr", type=float, default=1e-4)
@click.option("--warmup-steps", type=int, default=100)
@click.option("--ckpt-every", type=int, default=1000)
@click.option("--val-every", type=int, default=100)
@click.option("--lora-r", type=int, default=None)
@click.option("--lora-alpha", type=float, default=16.0)
@click.option("--lora-targets", type=str,
              default="attention,mlp,embeddings,output")
@click.option("--dp", type=int, default=None, help="not ported (must be 1)")
@click.option("--tp", type=int, default=1, help="not ported (must be 1)")
@click.option("--zero1", is_flag=True, help="not ported")
@click.option("--seed", type=int, default=42)
@click.option("--precision", type=click.Choice(["bfloat16", "float32"]),
              default="bfloat16")
@click.option("--tiny", is_flag=True, help="tiny random model (dev smoke run)")
@click.option("--no-resume", is_flag=True)
@click.option("--coordinator", type=str, default=None, help="not ported")
@click.option("--num-hosts", type=int, default=None, help="not ported")
@click.option("--host-id", type=int, default=None, help="not ported")
@click.option("--cpu", is_flag=True, help="train on the CPU")
def main(checkpoint_path, data_paths, val_paths, output, max_steps, batch_size,
         grad_accum, max_length, lr, warmup_steps, ckpt_every, val_every, lora_r,
         lora_alpha, lora_targets, dp, tp, zero1, seed, precision, tiny,
         no_resume, coordinator, num_hosts, host_id, cpu):
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    if coordinator is not None or num_hosts is not None or host_id is not None:
        raise NotImplementedError(
            "multi-host training is not ported yet (ROADMAP: multi-device "
            "trainer)")

    import torch

    from fish_speech_tpu_torch.config import dual_ar_tiny
    from fish_speech_tpu_torch.data.dataset import (DataLoader,
                                                    SemanticIterableDataset,
                                                    TextDataCollator)
    from fish_speech_tpu_torch.tokenizer import FishTokenizer, build_test_tokenizer
    from fish_speech_tpu_torch.models.lora import LoraConfig
    from fish_speech_tpu_torch.train.trainer import TrainConfig, Trainer
    from fish_speech_tpu_torch.utils.checkpoint import load_dual_ar

    if not cpu and not torch.cuda.is_available():
        raise click.UsageError("no CUDA device: pass --cpu to train on the CPU")
    device = torch.device("cpu" if cpu else "cuda:0")
    logging.getLogger(__name__).info("training on %s", device)
    if tiny or checkpoint_path is None:
        tokenizer = build_test_tokenizer()
        cfg = dual_ar_tiny(
            vocab_size=tokenizer.vocab_size,
            semantic_begin_id=tokenizer.semantic_begin_id,
            semantic_end_id=tokenizer.semantic_end_id,
            im_end_id=tokenizer.im_end_id,
            max_seq_len=max_length,
            # the packer indexes rows 1..C by the model config, so the tiny
            # model takes the DATA's codebook count
            num_codebooks=_peek_num_codebooks(data_paths) or 4,
        )
        params = None
    else:
        dtype = torch.bfloat16 if precision == "bfloat16" else torch.float32
        params, cfg = load_dual_ar(checkpoint_path, dtype=dtype, device=device)
        tokenizer = FishTokenizer.from_pretrained(checkpoint_path)
        cfg = dataclasses.replace(
            cfg,
            semantic_begin_id=tokenizer.semantic_begin_id,
            semantic_end_id=tokenizer.semantic_end_id,
            im_end_id=tokenizer.im_end_id,
            max_seq_len=max_length,
        ).resolve()

    lora = None
    if lora_r is not None:
        lora = LoraConfig(r=lora_r, lora_alpha=lora_alpha,
                          target_modules=lora_targets.split(","))

    tcfg = TrainConfig(
        output_dir=output, project="run", max_steps=max_steps,
        batch_size=batch_size, grad_accum_steps=grad_accum,
        max_length=max_length, lr=lr, warmup_steps=warmup_steps,
        ckpt_every_steps=ckpt_every, val_every_steps=val_every, seed=seed,
        precision=precision, dp=dp, tp=tp, zero1=zero1, lora=lora,
    )

    def make_loader(paths):
        ds = SemanticIterableDataset(list(paths), tokenizer, seed=seed,
                                     max_length=max_length,
                                     num_codebooks=cfg.num_codebooks)
        return DataLoader(ds, batch_size, TextDataCollator(tokenizer, max_length))

    trainer = Trainer(cfg, tcfg, params=params, device=device)
    trainer.fit(make_loader(data_paths),
                val_loader=make_loader(val_paths) if val_paths else None,
                resume=not no_resume)


if __name__ == "__main__":
    main()
