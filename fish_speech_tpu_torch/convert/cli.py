"""Checkpoint conversion CLI, the port's copy of
`fish_speech_tpu/convert/cli.py`.

    # Dual-AR LM (+ tokenizer): reference dir -> native dir
    python -m fish_speech_tpu_torch.convert.cli dual-ar \
        --input checkpoints/s2-pro --output checkpoints/s2-pro-native

    # Codec
    python -m fish_speech_tpu_torch.convert.cli dac \
        --input checkpoints/s2-pro/codec.pth --output checkpoints/s2-pro-native

    # Native -> torch-layout state dict
    python -m fish_speech_tpu_torch.convert.cli export-dual-ar \
        --input checkpoints/s2-pro-native --output checkpoints/s2-pro-export

File-to-file transforms: every command reshapes arrays on the host and
claims no device, as the JAX CLI pins itself to the CPU.
"""

from __future__ import annotations

import shutil
from pathlib import Path

import click

TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json",
                   "special_tokens_map.json")


@click.group()
def cli():
    pass


@cli.command("dual-ar")
@click.option("--input", "input_path", type=click.Path(exists=True), required=True)
@click.option("--output", "output_path", type=click.Path(), required=True)
def dual_ar_cmd(input_path, output_path):
    from fish_speech_tpu_torch.config import DualARConfig
    from fish_speech_tpu_torch.convert.dual_ar import convert_dual_ar
    from fish_speech_tpu_torch.utils.checkpoint import save_params

    input_path, output_path = Path(input_path), Path(output_path)
    cfg = DualARConfig.from_json(input_path)
    params = convert_dual_ar(input_path, cfg)
    output_path.mkdir(parents=True, exist_ok=True)
    cfg.to_json(str(output_path / "config.json"))
    save_params(output_path, params)
    # carry the tokenizer along
    for name in TOKENIZER_FILES:
        src = input_path / name
        if src.exists():
            shutil.copy(src, output_path / name)
    click.echo(f"Converted Dual-AR checkpoint -> {output_path}")


@cli.command("dac")
@click.option("--input", "input_path", type=click.Path(exists=True), required=True)
@click.option("--output", "output_path", type=click.Path(), required=True)
@click.option("--config", "config_name", default="s2_pro",
              type=click.Choice(["s2_pro", "tiny"]))
def dac_cmd(input_path, output_path, config_name):
    from fish_speech_tpu_torch.config import dac_s2_pro, dac_tiny
    from fish_speech_tpu_torch.convert.dac import convert_dac
    from fish_speech_tpu_torch.utils.checkpoint import save_dac

    cfg = dac_s2_pro() if config_name == "s2_pro" else dac_tiny()
    params = convert_dac(input_path, cfg)
    save_dac(output_path, params, cfg)
    click.echo(f"Converted DAC codec -> {output_path}")


@cli.command("export-dual-ar")
@click.option("--input", "input_path", type=click.Path(exists=True), required=True)
@click.option("--output", "output_path", type=click.Path(), required=True)
def export_dual_ar_cmd(input_path, output_path):
    """Native -> torch-layout state dict (saved as safetensors)."""
    import numpy as np
    from safetensors.numpy import save_file

    from fish_speech_tpu_torch.convert.dual_ar import export_dual_ar
    from fish_speech_tpu_torch.utils.checkpoint import load_dual_ar

    params, cfg = load_dual_ar(input_path, dtype=None, device="cpu")
    state = export_dual_ar(params, cfg)
    out = Path(output_path)
    out.mkdir(parents=True, exist_ok=True)
    cfg.to_json(str(out / "config.json"))
    save_file({k: np.ascontiguousarray(v) for k, v in state.items()},
              str(out / "model.safetensors"))
    click.echo(f"Exported torch-layout checkpoint -> {out}")


if __name__ == "__main__":
    cli()
