"""Streaming TTS inference engine: request -> audio segments, in PyTorch.

Port of `fish_speech_tpu/engine/tts.py` for plain TTS. A request runs
`generate_long` on the engine's `GenerationSession` and decodes codes to
PCM with the codec per decode chunk (streaming) or per text segment,
yielding header / segment / final / error results.

Not ported yet (ROADMAP): references (`references` / `reference_id`; they
need `dac_encode` and the reference loader), the raw-codec encode cache,
device partials, and the HTTP server's backend selection.
"""

from __future__ import annotations

import dataclasses
import threading
from dataclasses import dataclass
from typing import Generator, List, Optional, Tuple

import numpy as np
import torch

from fish_speech_tpu_torch.audio.io import wav_chunk_header
from fish_speech_tpu_torch.config import DACConfig
from fish_speech_tpu_torch.generate import GenerationSession, generate_long
from fish_speech_tpu_torch.models.dac.model import dac_from_indices


@dataclass
class InferenceResult:
    code: str  # "header" | "segment" | "error" | "final"
    audio: Optional[Tuple[int, np.ndarray]]
    error: Optional[Exception] = None


@dataclass
class TTSRequest:
    """Mirror of the server schema (see `fish_speech_tpu/engine/tts.py`)."""

    text: str
    chunk_length: int = 200
    format: str = "wav"
    references: list = dataclasses.field(default_factory=list)
    reference_id: Optional[str] = None
    seed: Optional[int] = None
    use_memory_cache: str = "off"
    normalize: bool = True
    streaming: bool = False
    max_new_tokens: int = 1024
    top_p: float = 0.8
    repetition_penalty: float = 1.1
    temperature: float = 0.8
    top_k: int = 30


class TTSInferenceEngine:
    # code-length buckets: segment decodes run at a few shapes only. The
    # codec is causal, so pad-then-slice is exact.
    code_buckets = (32, 64, 128, 256, 512, 1024, 2048)
    VQ_MICRO_BATCH = 8

    def __init__(self, session: GenerationSession, tokenizer, codec_params,
                 codec_cfg: DACConfig):
        self.session = session
        self.tokenizer = tokenizer
        self.codec_params = codec_params
        self.codec_cfg = codec_cfg
        self.lock = threading.Lock()  # one request on the session at a time

    @property
    def sample_rate(self) -> int:
        return self.codec_cfg.sample_rate

    @property
    def _codec_device(self):
        return self.codec_params["decoder"]["conv_in"]["w"].device

    def decode_vq_tokens(self, codes: np.ndarray) -> np.ndarray:
        """(num_codebooks, T) codes -> (T * frame_length,) float32 waveform."""
        return self.decode_vq_batch([np.asarray(codes, dtype=np.int32)])[0]

    def _micro_rows(self, n: int) -> int:
        for r in (1, 2, 4, 8):
            if n <= r:
                return r
        return self.VQ_MICRO_BATCH

    def decode_vq_batch(self, tokens_list) -> list:
        """[(num_codebooks, T_i) codes] -> [(T_i * frame_length,) float32],
        padded per code bucket and decoded in micro-batches of up to 8."""
        out = [None] * len(tokens_list)
        groups = {}
        for i, codes in enumerate(tokens_list):
            t = codes.shape[1]
            bucket = next((b for b in self.code_buckets if t <= b), t)
            groups.setdefault(bucket, []).append((i, codes, t))
        frame = self.codec_cfg.frame_length
        for bucket, items in groups.items():
            for j in range(0, len(items), self.VQ_MICRO_BATCH):
                chunk = items[j : j + self.VQ_MICRO_BATCH]
                padded = np.zeros((self._micro_rows(len(chunk)),
                                   tokens_list[0].shape[0], bucket), np.int32)
                for r, (_, codes, t) in enumerate(chunk):
                    padded[r, :, :t] = codes
                with torch.no_grad():
                    audio = dac_from_indices(
                        self.codec_params, self.codec_cfg,
                        torch.from_numpy(padded).to(self._codec_device),
                    )
                audio = audio.float().cpu().numpy()
                for r, (i, _, t) in enumerate(chunk):
                    out[i] = audio[r, 0, : t * frame]
        return out

    def inference(self, req: TTSRequest) -> Generator[InferenceResult, None, None]:
        if req.references or req.reference_id is not None:
            raise NotImplementedError(
                "references are not ported yet (ROADMAP: dac_encode and "
                "references)")

        if req.streaming:
            yield InferenceResult(
                code="header",
                audio=(self.sample_rate,
                       np.frombuffer(wav_chunk_header(sample_rate=self.sample_rate),
                                     dtype=np.uint8)),
            )

        segments: List[np.ndarray] = []
        emitted = 0  # samples of the segment in progress already streamed
        try:
            with self.lock:
                for response in generate_long(
                    session=self.session, tokenizer=self.tokenizer,
                    text=req.text, max_new_tokens=req.max_new_tokens,
                    top_p=req.top_p, top_k=req.top_k,
                    temperature=req.temperature,
                    chunk_length=req.chunk_length,
                    seed=req.seed if req.seed is not None else 42,
                    stream_partials=req.streaming,
                ):
                    if response.action == "partial":
                        # decode the cumulative prefix (the codec is causal,
                        # so earlier samples are stable) and emit the new ones
                        full = self.decode_vq_tokens(response.codes)
                        if len(full) > emitted:
                            yield InferenceResult(
                                code="segment",
                                audio=(self.sample_rate, full[emitted:]))
                            emitted = len(full)
                        continue
                    if response.action != "sample":
                        continue
                    segment = self.decode_vq_tokens(response.codes)
                    segments.append(segment)
                    if req.streaming and len(segment) > emitted:
                        yield InferenceResult(
                            code="segment",
                            audio=(self.sample_rate, segment[emitted:]))
                    emitted = 0  # the next text segment starts afresh
        except Exception as e:  # reported to the caller as an error result
            yield InferenceResult(code="error", audio=None, error=e)
            return

        if not segments:
            yield InferenceResult(
                code="error", audio=None,
                error=RuntimeError("No audio generated, please check the input text."),
            )
        else:
            yield InferenceResult(code="final",
                                  audio=(self.sample_rate,
                                         np.concatenate(segments, axis=0)))
