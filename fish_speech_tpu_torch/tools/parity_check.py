"""Reference-checkpoint parity harness, the port of
`fish_speech_tpu/tools/parity_check.py` (BASELINE.md gates).

Given a native checkpoint, runs three gates and prints a JSON report:

  1. codec round-trip: encode a WAV (or 8 frames of noise from seed 0),
     decode the codes, report the frames, the codes' hash and the SNR;
  2. greedy semantic-token decode of a fixed prompt (`generate_long`,
     top_k 1): the first row's ids and the codes' hash, so two frameworks
     can be diffed exactly;
  3. teacher-forced logit fingerprint (`forward_train` on the fp32 model):
     mean/std/top-1 of the slow and fast logits over a fixed prompt.

    python -m fish_speech_tpu_torch.tools.parity_check \
        --checkpoint-path checkpoints/s2-pro-native \
        --wav ref.wav --text "hello world" \
        [--golden golden.json] [--save-golden golden.json]

A golden file saved by one framework's tool is checked by the other's:
floats agree within 1e-3 relative or 1e-4 absolute, everything else
exactly (`_diff`, the JAX tool's rule); a mismatch prints `MISMATCH: ...`
lines and exits 1, agreement prints `PARITY OK`. Everything runs in fp32
with TF32 off on `cuda:0`; `--cpu` runs it on the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
from pathlib import Path

import click
import numpy as np


@contextlib.contextmanager
def _true_fp32():
    """cuBLAS and cuDNN in full fp32 (no TF32) for the block."""
    import torch

    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def parity_report(checkpoint_path, wav=None, text="Hello world.",
                  max_new_tokens=64, device="cuda:0") -> dict:
    """The three gates' report of the checkpoint in `checkpoint_path`, run
    on `device` (raises without CUDA unless it is the CPU)."""
    import torch

    from fish_speech_tpu_torch.audio.io import load_audio
    from fish_speech_tpu_torch.config import SamplingConfig
    from fish_speech_tpu_torch.generate import GenerationSession, generate_long
    from fish_speech_tpu_torch.models import dual_ar
    from fish_speech_tpu_torch.models.dac.model import dac_encode, dac_from_indices
    from fish_speech_tpu_torch.tokenizer import FishTokenizer
    from fish_speech_tpu_torch.utils.checkpoint import load_codec, load_dual_ar
    from fish_speech_tpu_torch.utils.device import resolve_device

    device = resolve_device(device, "parity_check")
    report = {}
    with torch.no_grad(), _true_fp32():
        params, cfg = load_dual_ar(checkpoint_path, dtype=torch.float32,
                                   device=device)
        tokenizer = FishTokenizer.from_pretrained(checkpoint_path)
        cfg = dataclasses.replace(
            cfg,
            semantic_begin_id=tokenizer.semantic_begin_id,
            semantic_end_id=tokenizer.semantic_end_id,
            im_end_id=tokenizer.im_end_id,
        ).resolve()

        # -- gate 3: teacher-forced logit fingerprint --
        prompt_ids = tokenizer.encode(text)
        inp = np.zeros((1, cfg.num_codebooks + 1, len(prompt_ids)), np.int32)
        inp[0, 0] = prompt_ids
        tok_logits, cb_logits = dual_ar.forward_train(
            params, cfg, torch.from_numpy(inp).to(device), remat=False)
        tok = tok_logits.cpu().numpy()
        cb = cb_logits.cpu().numpy()
        report["logit_fingerprint"] = {
            "token_mean": float(np.mean(tok)),
            "token_std": float(np.std(tok)),
            "token_argmax_last": int(np.argmax(tok[0, -1])),
            "codebook_mean": float(np.mean(cb)),
            "codebook_argmax_last": int(np.argmax(cb[0, -1, -1])),
        }

        # -- gate 2: greedy semantic decode --
        session = GenerationSession(params, cfg, SamplingConfig(),
                                    dtype=torch.float32)
        responses = list(generate_long(
            session=session, tokenizer=tokenizer, text=text,
            max_new_tokens=max_new_tokens,
            temperature=0.01, top_p=1.0, top_k=1,  # greedy
            seed=0,
        ))
        codes = [r.codes for r in responses if r.action == "sample"]
        merged = (np.concatenate(codes, axis=1) if codes
                  else np.zeros((cfg.num_codebooks, 0)))
        report["greedy_decode"] = {
            "n_frames": int(merged.shape[1]),
            "codes_row0": merged[0, :32].tolist(),
            "codes_sha": _sha(merged),
        }
        del session, params

        # -- gate 1: codec round trip --
        try:
            dac_params, dac_cfg = load_codec(checkpoint_path, dtype=torch.float32,
                                             device=device)
        except FileNotFoundError:
            report["codec_roundtrip"] = "no codec in checkpoint"
            return report
        if wav:
            audio = load_audio(wav, dac_cfg.sample_rate)
        else:
            rng = np.random.default_rng(0)
            audio = (rng.normal(size=dac_cfg.frame_length * 8) * 0.1).astype(
                np.float32)
        enc, lens = dac_encode(dac_params, dac_cfg,
                               torch.from_numpy(audio[None, None]).to(device))
        codes_np = enc[0].cpu().numpy()[:, : int(lens[0])]
        out = dac_from_indices(dac_params, dac_cfg,
                               torch.from_numpy(codes_np[None]).to(device))
        out_np = out[0, 0].cpu().numpy()[: len(audio)]
        noise = audio[: len(out_np)] - out_np
        snr = 10 * np.log10(
            (audio[: len(out_np)] ** 2).mean() / max((noise ** 2).mean(), 1e-12))
        report["codec_roundtrip"] = {
            "n_frames": int(lens[0]),
            "codes_sha": _sha(codes_np),
            "snr_db": float(snr),
        }
    return report


@click.command()
@click.option("--checkpoint-path", type=click.Path(exists=True), required=True)
@click.option("--wav", type=click.Path(exists=True), default=None)
@click.option("--text", type=str, default="Hello world.")
@click.option("--max-new-tokens", type=int, default=64)
@click.option("--golden", type=click.Path(exists=True), default=None,
              help="compare against a saved golden file")
@click.option("--save-golden", type=click.Path(), default=None)
@click.option("--cpu", is_flag=True, help="run on the CPU (else on cuda:0)")
def main(checkpoint_path, wav, text, max_new_tokens, golden, save_golden, cpu):
    report = parity_report(checkpoint_path, wav, text, max_new_tokens,
                           device="cpu" if cpu else "cuda:0")
    click.echo(json.dumps(report, indent=2))

    if save_golden:
        Path(save_golden).write_text(json.dumps(report, indent=2))
        click.echo(f"Saved golden -> {save_golden}")
    if golden:
        want = json.loads(Path(golden).read_text())
        mismatches = _diff(want, report)
        if mismatches:
            for m in mismatches:
                click.echo(f"MISMATCH: {m}")
            raise SystemExit(1)
        click.echo("PARITY OK")


def _sha(arr) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr, np.int32).tobytes()).hexdigest()[:16]


def _diff(want, got, path=""):
    out = []
    if isinstance(want, dict) and isinstance(got, dict):
        for k in want:
            out.extend(_diff(want[k], got.get(k), f"{path}.{k}"))
    elif isinstance(want, float) and isinstance(got, float):
        if abs(want - got) > max(1e-3 * abs(want), 1e-4):
            out.append(f"{path}: {want} != {got}")
    elif want != got:
        out.append(f"{path}: {want} != {got}")
    return out


if __name__ == "__main__":
    main()
