"""Merge LoRA weights from a training checkpoint into a base model, the port
of `fish_speech_tpu/tools/merge_lora.py` (reference
`tools/llama/merge_lora.py`, with its L1-validation step).

    python -m fish_speech_tpu_torch.tools.merge_lora \
        --base checkpoints/s2-pro-native \
        --lora results/run/checkpoints/step_00001000 \
        --lora-r 8 --lora-alpha 16 \
        --output checkpoints/s2-pro-merged

`--lora` is a step directory of the port's trainer (`train/trainer.py`):
its `state.pt` holds, under "params", the LoRA leaves (`extract_lora`).
The base is loaded in fp32, as the JAX tool loads it, the LoRA leaves are
put in its tree, and `models/lora.py:merge_lora` folds them in on
`cuda:0` (`--cpu`: on the CPU). The merged tree is written with
`save_dual_ar` under the base's config, `tokenizer.json` copied along.
"""

from __future__ import annotations

import shutil
from pathlib import Path

import click


def graft(node, sub):
    """Put the leaves of `sub` into the same places of `node`, in place,
    each cast to the dtype and device of the leaf it replaces."""
    for k, v in sub.items():
        if isinstance(v, dict):
            graft(node[k], v)
        else:
            node[k] = v.to(node[k].device, node[k].dtype)


@click.command()
@click.option("--base", type=click.Path(exists=True), required=True)
@click.option("--lora", "lora_path", type=click.Path(exists=True), required=True)
@click.option("--lora-r", type=int, required=True)
@click.option("--lora-alpha", type=float, required=True)
@click.option("--lora-targets", type=str,
              default="attention,mlp,embeddings,output")
@click.option("--output", type=click.Path(), required=True)
@click.option("--cpu", is_flag=True, help="run on the CPU (else on cuda:0)")
def main(base, lora_path, lora_r, lora_alpha, lora_targets, output, cpu):
    import torch

    from fish_speech_tpu_torch.models.lora import (LoraConfig, add_lora,
                                                   apply_lora_config, merge_lora)
    from fish_speech_tpu_torch.utils.checkpoint import load_dual_ar, save_dual_ar
    from fish_speech_tpu_torch.utils.device import resolve_device

    device = resolve_device("cpu" if cpu else "cuda:0", "merge_lora")
    params, cfg = load_dual_ar(base, dtype=torch.float32, device=device)
    lcfg = LoraConfig(r=lora_r, lora_alpha=lora_alpha,
                      target_modules=lora_targets.split(","))
    params = add_lora(params, cfg, lcfg, 0, dtype=torch.float32)
    cfg_l = apply_lora_config(cfg, lcfg)

    # the LoRA-only leaves of the training checkpoint
    state = torch.load(Path(lora_path) / "state.pt", map_location=device,
                       weights_only=True)
    graft(params, state["params"])

    before = params["layers"]["wqkv"][0].detach().clone()
    merged = merge_lora(params, cfg_l)

    # L1 validation: merged weights should differ from base where LoRA
    # was active (reference `merge_lora.py:77-92`)
    l1 = float((merged["layers"]["wqkv"][0] - before).abs().mean())
    click.echo(f"L1 delta on layers.0.wqkv after merge: {l1:.6f}")

    save_dual_ar(output, merged, cfg)
    for name in ("tokenizer.json",):
        src = Path(base) / name
        if src.exists():
            shutil.copy(src, Path(output) / name)
    click.echo(f"Merged model -> {output}")


if __name__ == "__main__":
    main()
