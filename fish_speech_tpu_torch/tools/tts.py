"""Main TTS inference CLI, the port of `fish_speech_tpu/tools/tts.py`.

    python -m fish_speech_tpu_torch.tools.tts \
        --text "<|speaker:0|>Hello world" \
        --checkpoint-path checkpoints/s2-pro-tpu \
        --output output/out.wav

Voice cloning through --prompt-audio/--prompt-tokens + --prompt-text;
writes codes_N.npy per sample and, with --output, decodes them to a WAV.
Generation runs `generate_long` on a `GenerationSession` (its CUDA graphs
captured at first use), the codec eagerly. It runs on `cuda:0` and fails
where there is none; `--cpu` runs it on the CPU. `--int8` quantizes the
weights per channel at load (`quantize_dual_ar_lowmem(mode="int8")`, the
JAX CLI's `quantize_dual_ar`); `--tiny` takes the server's random tiny
models (`server.main.tiny_models`).
"""

from __future__ import annotations

import os
import time
from pathlib import Path

import click
import numpy as np


@click.command()
@click.option("--text", type=str,
              default="<|speaker:0|>Hello, this is a test sentence.")
@click.option("--prompt-text", type=str, default=None, multiple=True)
@click.option("--prompt-tokens", type=click.Path(path_type=Path, exists=True),
              default=None, multiple=True)
@click.option("--prompt-audio", type=click.Path(path_type=Path, exists=True),
              default=None, multiple=True)
@click.option("--output", type=click.Path(path_type=Path), default=None)
@click.option("--num-samples", type=int, default=1)
@click.option("--max-new-tokens", type=int, default=0)
@click.option("--top-p", type=float, default=0.9)
@click.option("--top-k", type=int, default=30)
@click.option("--temperature", type=float, default=1.0)
@click.option("--checkpoint-path", type=click.Path(path_type=Path),
              default=Path("checkpoints/s2-pro-tpu"))
@click.option("--seed", type=int, default=42)
@click.option("--chunk-length", type=int, default=300)
@click.option("--output-dir", type=Path, default=Path("output"))
@click.option("--int8", is_flag=True, help="int8 weight-only quantization")
@click.option("--tiny", is_flag=True, help="tiny random models (smoke test)")
@click.option("--cpu", is_flag=True, help="run on the CPU (else on cuda:0)")
def main(text, prompt_text, prompt_tokens, prompt_audio, output, num_samples,
         max_new_tokens, top_p, top_k, temperature, checkpoint_path, seed,
         chunk_length, output_dir, int8, tiny, cpu):
    import torch

    from fish_speech_tpu_torch.audio.io import load_audio, write_wav
    from fish_speech_tpu_torch.config import SamplingConfig
    from fish_speech_tpu_torch.generate import GenerationSession, generate_long
    from fish_speech_tpu_torch.models.dac.model import dac_encode, dac_from_indices

    if prompt_text and not prompt_audio and not prompt_tokens:
        raise click.UsageError(
            "--prompt-text requires either --prompt-audio or --prompt-tokens")
    os.makedirs(output_dir, exist_ok=True)
    device = torch.device("cpu" if cpu else "cuda:0")

    t0 = time.time()
    if tiny:
        from fish_speech_tpu_torch.server.main import tiny_models

        tokenizer, cfg, params, dac_cfg, dac_params = tiny_models(device)
        dtype = torch.float32
    else:
        import dataclasses

        from fish_speech_tpu_torch.tokenizer import FishTokenizer
        from fish_speech_tpu_torch.utils.checkpoint import load_codec, load_dual_ar

        dtype = torch.bfloat16
        params, cfg = load_dual_ar(checkpoint_path, dtype=dtype, device=device)
        tokenizer = FishTokenizer.from_pretrained(str(checkpoint_path))
        cfg = dataclasses.replace(
            cfg, semantic_begin_id=tokenizer.semantic_begin_id,
            semantic_end_id=tokenizer.semantic_end_id,
            im_end_id=tokenizer.im_end_id).resolve()
        dac_params, dac_cfg = load_codec(checkpoint_path, device=device)
    if int8:
        from fish_speech_tpu_torch.ops.quant import quantize_dual_ar_lowmem

        params = quantize_dual_ar_lowmem(params, mode="int8")
    click.echo(f"Models ready in {time.time() - t0:.1f}s", err=True)
    session = GenerationSession(params, cfg, SamplingConfig(), dtype=dtype)
    del params  # the session holds its own (fused) copy

    with torch.no_grad():
        # prompts: --prompt-audio takes priority over --prompt-tokens
        prompt_tokens_list = None
        if prompt_audio:
            prompt_tokens_list = []
            for p in prompt_audio:
                wav = torch.from_numpy(load_audio(str(p), dac_cfg.sample_rate))
                codes, lens = dac_encode(dac_params, dac_cfg,
                                         wav[None, None].to(device))
                prompt_tokens_list.append(codes[0, :, : int(lens[0])].cpu().numpy())
        elif prompt_tokens:
            prompt_tokens_list = [np.load(p) for p in prompt_tokens]

        idx = 0
        codes_acc = []
        t0 = time.time()
        for response in generate_long(
            session=session, tokenizer=tokenizer, text=text,
            num_samples=num_samples, max_new_tokens=max_new_tokens, top_p=top_p,
            top_k=top_k, temperature=temperature, chunk_length=chunk_length,
            prompt_text=list(prompt_text) if prompt_text else None,
            prompt_tokens=prompt_tokens_list, seed=seed,
        ):
            if response.action == "sample":
                codes_acc.append(response.codes)
                n = response.codes.shape[1]
                dt = time.time() - t0
                click.echo(f"Sampled {n} frames in {dt:.2f}s "
                           f"({n / max(dt, 1e-9):.1f} tok/s): {response.text!r}",
                           err=True)
                t0 = time.time()
            elif response.action == "next" and codes_acc:
                merged = np.concatenate(codes_acc, axis=1)
                codes_path = output_dir / f"codes_{idx}.npy"
                np.save(codes_path, merged)
                click.echo(f"Saved codes to {codes_path}", err=True)
                if output:
                    audio = dac_from_indices(
                        dac_params, dac_cfg, torch.from_numpy(merged[None]).to(device))
                    out_path = (output if num_samples == 1
                                else output.with_stem(f"{output.stem}_{idx}"))
                    write_wav(out_path, audio[0, 0].float().cpu().numpy(),
                              dac_cfg.sample_rate)
                    click.echo(f"Saved audio to {out_path}", err=True)
                codes_acc = []
                idx += 1


if __name__ == "__main__":
    main()
