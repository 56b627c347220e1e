"""Streaming TTS inference engine: request -> audio segments, in PyTorch.

Port of `fish_speech_tpu/engine/tts.py`. A request loads its references
(by id or by content hash, `ReferenceLoader`), encoding each clip once
(a sha256 LRU of codes), runs `generate_long` on the engine's
`GenerationSession` with the clip codes and texts as the voice-clone
prompt, and decodes codes to PCM with the codec per decode chunk
(streaming) or per text segment, yielding header / segment / final /
error results.

Where JAX jits the codec's decode and encode once per code bucket, each
codec call here replays a CUDA graph keyed by (kind, rows, bucket): kind
"decode" (codes -> waveform) or "encode" (waveform -> codes). A graph
reads a fixed input buffer and writes a fixed output buffer, which is
copied to the host before the next replay; it is captured at its first
use or ahead of time by `precompile`, each after one eager run of its
body, into a memory pool of the engine's own. On the CPU the bodies run
eagerly.

Not ported yet (ROADMAP): device partials, `cancel_check`, and the HTTP
server's backend selection.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import threading
import time
from dataclasses import dataclass
from typing import Generator, List, Optional, Tuple

import numpy as np
import torch

from fish_speech_tpu_torch.audio.io import load_audio, wav_chunk_header
from fish_speech_tpu_torch.config import DACConfig
from fish_speech_tpu_torch.engine.reference_loader import ReferenceLoader
from fish_speech_tpu_torch.generate import (GenerationSession, capture_graph,
                                            generate_long, replay_graph)
from fish_speech_tpu_torch.models.dac.model import dac_encode, dac_from_indices


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


@dataclass
class CodecGraph:
    """One codec graph's fixed buffers: `inp` (decode: (rows, 1+N, bucket)
    int32 codes; encode: (rows, 1, bucket * frame_length) float32 audio)
    and `out` (decode: (rows, 1, bucket * frame_length) audio; encode:
    (rows, 1+N, bucket) codes); the graph and the launches a replay adds
    once captured."""

    inp: torch.Tensor
    out: torch.Tensor
    graph: Optional[torch.cuda.CUDAGraph] = None
    launches: dict = dataclasses.field(default_factory=dict)


class TTSInferenceEngine:
    # code-length buckets: codec calls run at a few shapes only. The codec
    # is causal, so pad-then-slice is exact.
    code_buckets = (32, 64, 128, 256, 512, 1024, 2048)
    VQ_CACHE_SIZE = 10_000  # reference model_utils.py:31
    VQ_MICRO_BATCH = 8  # reference model_utils.py:75

    def __init__(self, session: GenerationSession, tokenizer, codec_params,
                 codec_cfg: DACConfig, references_dir: str = "references"):
        self.session = session
        self.tokenizer = tokenizer
        self.codec_params = codec_params
        self.codec_cfg = codec_cfg
        self.references = ReferenceLoader(references_dir)
        self.references.encode_reference = self.encode_reference
        self.lock = threading.Lock()  # one request on the session at a time
        # per-clip sha256 -> codes (see encode_references_batch)
        self._vq_cache = collections.OrderedDict()
        self._vq_cache_lock = threading.Lock()
        self.vq_cache_hits = 0
        self.vq_cache_misses = 0
        # (kind, rows, bucket) -> CodecGraph; one codec call at a time, as
        # every call of a key shares its buffers
        self.codec_graphs = {}
        self._codec_lock = threading.Lock()
        self._codec_pool = None
        self.codec_capture_seconds = {}
        self.codec_pool_bytes = 0
        self.codec_replays = collections.Counter()
        self.codec_eager_runs = collections.Counter()

    @property
    def sample_rate(self) -> int:
        return self.codec_cfg.sample_rate

    @property
    def _codec_device(self):
        return self.codec_params["decoder"]["conv_in"]["w"].device

    def _code_bucket(self, t: int) -> int:
        return next((b for b in self.code_buckets if t <= b), t)

    def _micro_rows(self, n: int) -> int:
        """Pad a micro-batch to 1, 2, 4 or 8 rows, so each bucket has at
        most four graphs."""
        for r in (1, 2, 4, 8):
            if n <= r:
                return r
        return self.VQ_MICRO_BATCH

    # -- codec graphs --

    def _codec_graph(self, key) -> CodecGraph:
        """The buffers of graph `key` = (kind, rows, bucket), made at first
        use (the graph is captured by `_capture_codec`)."""
        entry = self.codec_graphs.get(key)
        if entry is None:
            kind, rows, bucket = key
            n_codes = self.codec_cfg.rvq.total_codebooks
            samples = bucket * self.codec_cfg.frame_length
            dev = self._codec_device
            codes = torch.zeros((rows, n_codes, bucket), dtype=torch.int32, device=dev)
            audio = torch.zeros((rows, 1, samples), dtype=torch.float32, device=dev)
            entry = (CodecGraph(codes, audio) if kind == "decode"
                     else CodecGraph(audio, codes))
            self.codec_graphs[key] = entry
        return entry

    def _codec_body(self, key):
        """The body graph `key` replays: the codec on `inp`, into `out`."""
        entry = self.codec_graphs[key]
        params, cfg = self.codec_params, self.codec_cfg

        def decode():
            entry.out.copy_(dac_from_indices(params, cfg, entry.inp))

        def encode():
            entry.out.copy_(dac_encode(params, cfg, entry.inp)[0])

        return decode if key[0] == "decode" else encode

    def _capture_codec(self, key) -> CodecGraph:
        """Capture graph `key`: one eager run of its body, then the capture
        into the codec's pool (`generate.capture_graph`)."""
        t0 = time.perf_counter()
        entry = self._codec_graph(key)
        body = self._codec_body(key)
        with torch.no_grad():
            body()
            self.codec_eager_runs[key] += 1
            if self._codec_pool is None:
                self._codec_pool = torch.cuda.graph_pool_handle()
            entry.graph, entry.launches, grown = capture_graph(
                body, self._codec_pool, self._codec_device)
        self.codec_pool_bytes += grown
        self.codec_capture_seconds[key] = time.perf_counter() - t0
        return entry

    def _run_codec(self, kind: str, padded: np.ndarray) -> np.ndarray:
        """The codec on a padded batch (decode: (rows, 1+N, bucket) codes;
        encode: (rows, 1, bucket * frame_length) audio), as a replay of its
        graph on CUDA (captured at first use) or its body on the CPU.
        Returns a host copy of the output buffer."""
        rows, bucket = padded.shape[0], padded.shape[-1]
        if kind == "encode":
            bucket //= self.codec_cfg.frame_length
        key = (kind, rows, bucket)
        with self._codec_lock:
            entry = self._codec_graph(key)
            entry.inp.copy_(torch.from_numpy(padded))
            if self._codec_device.type != "cuda":
                with torch.no_grad():
                    self._codec_body(key)()
                self.codec_eager_runs[key] += 1
            else:
                if entry.graph is None:
                    self._capture_codec(key)
                replay_graph(entry.graph, entry.launches)
                self.codec_replays[key] += 1
            # a copy: on the CPU .cpu() is the buffer the next call writes
            return entry.out.to("cpu", copy=True).numpy()

    def precompile(self, code_buckets=(), reference_buckets=()) -> dict:
        """Capture, ahead of the first request, the codec graphs a request
        reaches: the one-row decode of each code bucket in `code_buckets`
        (a streamed request decodes its cumulative codes at the bucket of
        each partial: a first chunk of 8 frames reaches 32) and the one-row
        encode of each frame bucket in `reference_buckets` (a reference
        clip of n frames reaches the bucket of n). Values are mapped to
        their bucket. The counterpart of the JAX server's codec warm-up.
        Returns {(kind, rows, bucket): seconds} of the graphs captured by
        this call (each with its eager run); on the CPU nothing is captured
        and it returns {}."""
        if self._codec_device.type != "cuda":
            return {}
        keys = [("decode", 1, self._code_bucket(t)) for t in code_buckets]
        keys += [("encode", 1, self._code_bucket(t)) for t in reference_buckets]
        out = {}
        with self._codec_lock:
            for key in keys:
                entry = self.codec_graphs.get(key)
                if entry is None or entry.graph is None:
                    self._capture_codec(key)
                    out[key] = self.codec_capture_seconds[key]
        return out

    # -- codec glue (reference `vq_manager.py`) --

    def encode_reference(self, audio_bytes: bytes) -> np.ndarray:
        """Audio bytes -> (num_codebooks, T) codes, through the batched and
        cached path."""
        return self.encode_references_batch([audio_bytes])[0]

    def decode_vq_tokens(self, codes: np.ndarray) -> np.ndarray:
        """(num_codebooks, T) codes -> (T * frame_length,) float32 waveform."""
        return self.decode_vq_batch([np.asarray(codes, dtype=np.int32)])[0]

    def encode_references_batch(self, audios) -> list:
        """[audio bytes] -> [(num_codebooks, T) codes], LRU-cached per clip
        (sha256 of its bytes, 10,000 entries) and encoded per frame bucket
        in micro-batches of 1, 2, 4 or 8 rows for the misses; each clip's
        codes are trimmed to ceil(len / frame_length) frames."""
        keys = [hashlib.sha256(a).digest() for a in audios]
        out = [None] * len(audios)
        misses = []
        with self._vq_cache_lock:
            for i, k in enumerate(keys):
                if k in self._vq_cache:
                    self._vq_cache.move_to_end(k)
                    out[i] = self._vq_cache[k]
                    self.vq_cache_hits += 1
                else:
                    misses.append(i)
                    self.vq_cache_misses += 1
        if not misses:
            return out

        frame = self.codec_cfg.frame_length
        groups = {}  # bucket -> [(idx, wav, n_frames)]
        for i in misses:
            wav = load_audio(audios[i], self.codec_cfg.sample_rate)
            n_frames = max(-(-len(wav) // frame), 1)
            groups.setdefault(self._code_bucket(n_frames), []).append(
                (i, wav, n_frames))
        for bucket, items in groups.items():
            for j in range(0, len(items), self.VQ_MICRO_BATCH):
                chunk = items[j : j + self.VQ_MICRO_BATCH]
                padded = np.zeros((self._micro_rows(len(chunk)), 1, bucket * frame),
                                  dtype=np.float32)
                for r, (_, wav, _) in enumerate(chunk):
                    padded[r, 0, : len(wav)] = wav
                codes = self._run_codec("encode", padded)
                for r, (i, _, n_frames) in enumerate(chunk):
                    out[i] = codes[r][:, :n_frames]
        with self._vq_cache_lock:
            for i in misses:
                self._vq_cache[keys[i]] = out[i]
                self._vq_cache.move_to_end(keys[i])
            while len(self._vq_cache) > self.VQ_CACHE_SIZE:
                self._vq_cache.popitem(last=False)
        return out

    def decode_vq_batch(self, tokens_list) -> list:
        """[(num_codebooks, T_i) codes] -> [(T_i * frame_length,) float32],
        padded per code bucket and decoded in micro-batches of up to 8."""
        out = [None] * len(tokens_list)
        groups = {}
        for i, codes in enumerate(tokens_list):
            t = codes.shape[1]
            groups.setdefault(self._code_bucket(t), []).append((i, codes, t))
        frame = self.codec_cfg.frame_length
        for bucket, items in groups.items():
            for j in range(0, len(items), self.VQ_MICRO_BATCH):
                chunk = items[j : j + self.VQ_MICRO_BATCH]
                padded = np.zeros((self._micro_rows(len(chunk)),
                                   tokens_list[0].shape[0], bucket), np.int32)
                for r, (_, codes, t) in enumerate(chunk):
                    padded[r, :, :t] = codes
                audio = self._run_codec("decode", padded)
                for r, (i, _, t) in enumerate(chunk):
                    out[i] = audio[r, 0, : t * frame]
        return out

    def inference(self, req: TTSRequest) -> Generator[InferenceResult, None, None]:
        prompt_tokens: List[np.ndarray] = []
        prompt_texts: List[str] = []
        try:
            if req.reference_id is not None:
                prompt_tokens, prompt_texts = self.references.load_by_id(
                    req.reference_id, req.use_memory_cache)
            elif req.references:
                prompt_tokens, prompt_texts = self.references.load_by_hash(
                    req.references, req.use_memory_cache)
        except Exception as e:  # reference load failures -> error result
            yield InferenceResult(code="error", audio=None, error=e)
            return

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
                    prompt_text=list(prompt_texts) or None,
                    prompt_tokens=list(prompt_tokens) or None,
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
