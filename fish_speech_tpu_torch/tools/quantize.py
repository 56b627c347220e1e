"""Offline weight-only PTQ: write an int8- or int4-quantized native
checkpoint, the port of `fish_speech_tpu/tools/quantize.py` (reference
`tools/llama/quantize.py:242-420`; int4 is the packed half-split layout of
`ops/quant.quantize_int4` that `mm` and the int4 kernels read directly).

    python -m fish_speech_tpu_torch.tools.quantize \
        --checkpoint-path checkpoints/s2-pro-native --mode int8
    python -m fish_speech_tpu_torch.tools.quantize \
        --checkpoint-path checkpoints/s2-pro-native \
        --mode int4 --group-size 128

The tree is loaded as stored (`load_dual_ar(dtype=None)`) on `cuda:0`,
quantized there one layer at a time (`quantize_dual_ar_lowmem`, whose tree
equals the JAX package's `quantize_dual_ar`) and written with
`save_dual_ar`; `--cpu` does it on the CPU. The heads stay int8 in both
modes. `tokenizer.json` and a bundled codec are copied along.
"""

from __future__ import annotations

import shutil
from pathlib import Path

import click


@click.command()
@click.option("--checkpoint-path", type=click.Path(exists=True), required=True)
@click.option("--output", type=click.Path(), default=None,
              help="default: <checkpoint>-<mode>")
@click.option("--mode", type=click.Choice(["int8", "int4"]), default="int8")
@click.option("--group-size", type=int, default=128,
              help="int4 quantization group size along the input dim "
                   "(auto-halved per layer until it divides the dim, "
                   "matching the runtime rule)")
@click.option("--cpu", is_flag=True, help="run on the CPU (else on cuda:0)")
def main(checkpoint_path, output, mode, group_size, cpu):
    from fish_speech_tpu_torch.ops.quant import quantize_dual_ar_lowmem
    from fish_speech_tpu_torch.utils.checkpoint import load_dual_ar, save_dual_ar

    src = Path(checkpoint_path)
    out = Path(output) if output else src.with_name(src.name + f"-{mode}")

    params, cfg = load_dual_ar(src, dtype=None,
                               device="cpu" if cpu else "cuda:0")
    qparams = quantize_dual_ar_lowmem(params, mode=mode, group_size=group_size)
    del params
    save_dual_ar(out, qparams, cfg)
    for name in ("tokenizer.json",):
        if (src / name).exists():
            shutil.copy(src / name, out / name)
    if (src / "codec.safetensors").exists():
        shutil.copy(src / "codec.safetensors", out / "codec.safetensors")
        shutil.copy(src / "codec_config.json", out / "codec_config.json")
    click.echo(f"Quantized checkpoint -> {out}")


if __name__ == "__main__":
    main()
