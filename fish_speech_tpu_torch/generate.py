"""Token-level generation runtime for the Dual-AR model, in PyTorch.

Port of `fish_speech_tpu/generate.py` for the single-stream path. Where the
JAX package ran a decode chunk as one `lax.scan` program, here it is a
Python loop that enqueues every step's kernels without waiting on the
device; the host syncs once per chunk, when it reads the chunk's columns,
as in JAX. Steps run past `<|im_end|>` and are cut on the host.

Positions are host integers, so the decode attention kernel reads exactly
`pos + 1` cache positions: the JAX package's fixed kv-length buckets are
not needed. Sampling draws its uniforms from one `torch.Generator` per
request (seeded from the request's seed), on the model's device.

Not ported yet (ROADMAP): prefix caching (`prefill_suffix`), device
partials (`StreamPartial`), AOT precompile, batched lockstep generation.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Optional, Union

import numpy as np
import torch

from fish_speech_tpu.config import DualARConfig, SamplingConfig
from fish_speech_tpu_torch.models import dual_ar
from fish_speech_tpu_torch.ops.sampling import (check_top_k, ras_select,
                                                 sample_topk, topk_state)

PROMPT_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096, 8192)


def pick_bucket(t: int, max_seq: int) -> int:
    for b in PROMPT_BUCKETS:
        if t <= b and b <= max_seq:
            return b
    if t <= max_seq:
        return max_seq
    raise ValueError(f"Prompt length {t} exceeds max_seq_len {max_seq}")


# ---------------------------------------------------------------------------
# Device-side steps
# ---------------------------------------------------------------------------


def _sample_column(params, cfg: DualARConfig, scfg: SamplingConfig, logits,
                   hidden, window, generator, temperature, top_p, top_k):
    """Sample one (B, C+1) token column from the slow-head logits: the main
    token (top-k/top-p, RAS when `window` is given) and then codebooks
    1..C-1 through the fast stack."""
    b = logits.shape[0]
    if scfg.mask_im_end:  # benchmark-only, see SamplingConfig
        logits = logits.clone()
        logits[:, -1] = float("-inf")

    state = topk_state(logits)
    idx_normal = sample_topk(state, temperature, top_p, top_k, generator)
    tok_normal = dual_ar.semantic_index_to_token(cfg, idx_normal)
    if window is not None:
        idx_high = sample_topk(state, scfg.ras_high_temp, scfg.ras_high_top_p,
                               top_k, generator)
        tok_high = dual_ar.semantic_index_to_token(cfg, idx_high)
        main = ras_select(tok_normal, tok_high, window, cfg.semantic_begin_id,
                          cfg.semantic_end_id)
    else:
        main = tok_normal

    code = torch.clamp(main - cfg.semantic_begin_id, 0, cfg.codebook_size - 1)
    codes = [main, code]
    fast_cache = dual_ar.init_fast_kv_cache(cfg, b, dtype=hidden.dtype,
                                            device=hidden.device)
    h0 = dual_ar.fast_project_in(params, cfg, hidden)
    _, fast_cache = dual_ar.fast_decode_step(params, cfg, h0, fast_cache, 0,
                                             with_logits=False)
    for i in range(1, cfg.num_codebooks):
        x = dual_ar.fast_embed(params, cfg, code)
        logits_i, fast_cache = dual_ar.fast_decode_step(params, cfg, x,
                                                        fast_cache, i)
        code = sample_topk(topk_state(logits_i), temperature, top_p, top_k,
                           generator)
        codes.append(code)
    return torch.stack(codes, dim=1).to(torch.int32)  # (B, C+1)


def _restricted_logits(cfg: DualARConfig, logits_full):
    """Full-vocab logits -> the constrained head layout (semantic ids +
    im_end; see `dual_ar.semantic_head_logits`)."""
    sb, se = cfg.semantic_begin_id, cfg.semantic_end_id
    return torch.cat([logits_full[:, sb : se + 1],
                      logits_full[:, cfg.im_end_id][:, None]], dim=1)


def prefill_step(params, cfg: DualARConfig, scfg: SamplingConfig, inp, cache,
                 offsets, t_end, generator, temperature, top_p, top_k):
    """Prefill the cache from the prompt and sample the first column."""
    logits_full, hidden, cache = dual_ar.prefill(params, cfg, inp, cache,
                                                 offsets, t_end)
    column = _sample_column(params, cfg, scfg,
                            _restricted_logits(cfg, logits_full), hidden,
                            None, generator, temperature, top_p, top_k)
    return column, cache


def _decode_one(params, cfg, scfg, token, cache, pos, window, generator,
                temperature, top_p, top_k):
    hidden, slow_out, cache = dual_ar.decode_slow_step(params, cfg, token,
                                                       cache, pos)
    logits = dual_ar.semantic_head_logits(params, cfg, slow_out)
    column = _sample_column(params, cfg, scfg, logits, hidden, window,
                            generator, temperature, top_p, top_k)
    return column, cache


def decode_chunk(params, cfg: DualARConfig, scfg: SamplingConfig,
                 n_steps: int, token, cache, pos: int, window, generator,
                 temperature, top_p, top_k):
    """Enqueue n_steps decode steps; nothing here waits on the device.

    Returns (columns (n, B, C+1), token, cache, pos, window)."""
    cols = []
    for step in range(n_steps):
        token, cache = _decode_one(params, cfg, scfg, token, cache, pos + step,
                                   window, generator, temperature, top_p,
                                   top_k)
        window = torch.cat([window[:, 1:], token[:, :1]], dim=1)
        cols.append(token)
    return torch.stack(cols), token, cache, pos + n_steps, window


# ---------------------------------------------------------------------------
# Host-side generation driver
# ---------------------------------------------------------------------------


@dataclass
class GenerateResponse:
    action: str  # "sample" | "next" | "partial"
    codes: Optional[np.ndarray] = None
    text: Optional[str] = None


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    return tree.detach()


class GenerationSession:
    """Owns the KV cache and the inference-prepared weights of one model,
    for one stream at a time (batching is not ported yet).

    The session re-uses one cache for every request (each prefill writes
    the positions it reads); `params` are augmented with the restricted LM
    head and the fused w1|w3 FFN weight. Fusing copies the FFN weights: the
    caller should drop its own reference to `params`."""

    def __init__(self, params, cfg: DualARConfig, scfg: SamplingConfig = None,
                 dtype=torch.bfloat16, decode_chunk_size: int = 32,
                 first_chunk_size: int = 0, pipeline_lookahead: int = 1):
        # detached views: a tree fresh from training (LoRA tensors that
        # require grad) must not make decoding record an autograd graph
        params = _detached(params)
        self.params = dual_ar.fuse_ffn_weights(
            dual_ar.precompute_semantic_head(params, cfg))
        self.cfg = cfg.resolve()
        self.scfg = scfg or SamplingConfig()
        self.device = params["embeddings"].device
        self.decode_chunk_size = decode_chunk_size
        self.first_chunk_size = first_chunk_size or decode_chunk_size
        # chunks dispatched ahead of the one being read in generate()
        self.pipeline_lookahead = pipeline_lookahead
        # headroom so a chunk's overshoot never writes past the buffer
        self.cache_len = self.cfg.max_seq_len + decode_chunk_size
        self.cache = dual_ar.init_kv_cache(self.cfg, 1, self.cache_len, dtype,
                                           self.device)

    def new_generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def generate(self, prompt: np.ndarray, generator, max_new_tokens: int = 0,
                 temperature: float = 1.0, top_p: float = 0.9,
                 top_k: int = 30) -> np.ndarray:
        """Generate until im_end or the budget; returns (C+1, N) columns
        including the final im_end column."""
        last = None
        for last in self.generate_stream(
            prompt, generator, max_new_tokens=max_new_tokens,
            temperature=temperature, top_p=top_p, top_k=top_k,
            pipeline_lookahead=self.pipeline_lookahead,
        ):
            pass
        return last

    def generate_stream(self, prompt: np.ndarray, generator,
                        max_new_tokens: int = 0, temperature: float = 1.0,
                        top_p: float = 0.9, top_k: int = 30,
                        pipeline_lookahead: int = 0):
        """Yield the CUMULATIVE (C+1, n) host columns after the prefill frame
        and after every decode chunk; the last yield is the whole sequence.

        pipeline_lookahead > 0 enqueues that many chunks beyond the one
        being read, so the device runs chunks back to back."""
        cfg, scfg = self.cfg, self.scfg
        check_top_k(top_k)
        t = prompt.shape[1]
        if t >= cfg.max_seq_len:
            raise ValueError(
                f"Input sequence length {t} exceeds max_seq_len {cfg.max_seq_len}"
            )
        if max_new_tokens and t + max_new_tokens <= cfg.max_seq_len:
            budget = max_new_tokens
        else:
            budget = cfg.max_seq_len - t

        bucket = min(pick_bucket(t, self.cache_len), cfg.max_seq_len)
        inp = np.zeros((1, cfg.num_codebooks + 1, bucket), dtype=np.int32)
        inp[0, :, :t] = prompt
        offsets = torch.zeros((1,), dtype=torch.int32, device=self.device)
        column, self.cache = prefill_step(
            self.params, cfg, scfg, torch.from_numpy(inp).to(self.device),
            self.cache, offsets, t, generator, temperature, top_p, top_k,
        )
        columns = [column.cpu().numpy()]  # list of (B, C+1)
        yield np.concatenate(columns, axis=0).T
        if int(columns[0][0, 0]) == cfg.im_end_id:
            return

        pos = t
        token = column
        window = torch.zeros((1, scfg.ras_win_size), dtype=torch.int32,
                             device=self.device)
        dispatch_left = budget - 1  # steps not yet enqueued
        emit_left = budget - 1  # steps not yet yielded
        first = True
        inflight = []  # FIFO of (cols_device, n)
        while dispatch_left > 0 or inflight:
            while dispatch_left > 0 and len(inflight) <= pipeline_lookahead:
                # always a FULL chunk, cut on the host; the cache has
                # decode_chunk_size positions of headroom for the overshoot
                n = self.first_chunk_size if first else self.decode_chunk_size
                first = False
                cols, token, self.cache, pos, window = decode_chunk(
                    self.params, cfg, scfg, n, token, self.cache, pos, window,
                    generator, temperature, top_p, top_k,
                )
                inflight.append((cols, n))
                dispatch_left -= n
            cols_dev, n = inflight.pop(0)
            cols = cols_dev.cpu().numpy()[:, 0][: max(emit_left, 0)]
            emit_left -= n
            ends = cols[:, 0] == cfg.im_end_id
            if ends.any():
                stop = int(np.argmax(ends))
                columns.append(cols[: stop + 1])
                yield np.concatenate(columns, axis=0).T
                return
            columns.append(cols)
            yield np.concatenate(columns, axis=0).T


# ---------------------------------------------------------------------------
# Text chunking and long-form generation
# ---------------------------------------------------------------------------

_SPEAKER_PATTERN = r"(<\|speaker:\d+\|>)"


def split_text_by_speaker(text: str) -> List[str]:
    parts = re.split(_SPEAKER_PATTERN, text)
    turns = []
    i = 0
    while i < len(parts):
        part = parts[i].strip()
        if re.match(_SPEAKER_PATTERN, part):
            if i + 1 < len(parts):
                turns.append((part + parts[i + 1]).strip())
                i += 2
            else:
                turns.append(part)
                i += 1
        else:
            i += 1
    return turns


def group_turns_into_batches(turns: List[str], max_speakers: int = 5,
                             max_bytes: int = 300) -> List[str]:
    batches: List[str] = []
    current: List[str] = []
    current_bytes = 0
    for turn in turns:
        turn_bytes = len(turn.encode("utf-8"))
        if len(current) >= max_speakers or (
            current and current_bytes + turn_bytes > max_bytes
        ):
            batches.append("\n".join(current))
            current = [turn]
            current_bytes = turn_bytes
        else:
            current.append(turn)
            current_bytes += turn_bytes
    if current:
        batches.append("\n".join(current))
    return batches


SYSTEM_PROMPT_CLONE = (
    "convert the provided text to speech reference to the following:\n\nText:\n"
)
SYSTEM_PROMPT_PLAIN = "convert the provided text to speech"


def build_base_conversation(prompt_text: Optional[List[str]],
                            prompt_tokens: Optional[List[np.ndarray]]):
    """System message for voice cloning (reference texts + VQ codes) or
    plain TTS. Imports the shared host `sequence` module here, not at module
    import: it pulls in the `tokenizers` package."""
    from fish_speech_tpu.sequence import Conversation, Message, TextPart, VQPart

    conv = Conversation()
    use_prompt = (bool(prompt_text) and prompt_tokens is not None
                  and len(prompt_tokens))
    if use_prompt:
        tagged = [t if re.search(_SPEAKER_PATTERN, t) else f"<|speaker:{i}|>{t}"
                  for i, t in enumerate(prompt_text)]
        parts = [
            TextPart(text=SYSTEM_PROMPT_CLONE, cal_loss=False),
            TextPart(text="\n".join(tagged), cal_loss=False),
            TextPart(text="\n\nSpeech:\n", cal_loss=False),
            VQPart(codes=np.concatenate(prompt_tokens, axis=1), cal_loss=False),
        ]
    else:
        parts = [TextPart(text=SYSTEM_PROMPT_PLAIN, cal_loss=False)]
    conv.append(Message(role="system", parts=parts, cal_loss=False,
                        add_im_start=True, add_im_end=True))
    return conv


def generate_long(*, session: GenerationSession, tokenizer, text: str,
                  max_new_tokens: int = 0, top_p: float = 0.9, top_k: int = 30,
                  temperature: float = 1.0, chunk_length: int = 300,
                  prompt_text: Optional[Union[str, List[str]]] = None,
                  prompt_tokens: Optional[Union[np.ndarray, List[np.ndarray]]] = None,
                  seed: int = 42, stream_partials: bool = False):
    """Chunked long-form generation: split the text on speaker tags, batch
    the turns, generate each batch in turn with the earlier batches' codes
    as conversation context.

    prompt_text / prompt_tokens: an optional voice-clone prompt (reference
    texts and their (num_codebooks, T) codes) for the system message.
    stream_partials: also yield action="partial" with the cumulative codes
    of the segment in progress after every decode chunk; the closing
    action="sample" repeats the whole segment."""
    from fish_speech_tpu.sequence import Conversation, Message, TextPart, VQPart

    if not 0 < top_p <= 1:
        raise ValueError("top_p must be in (0, 1]")
    if not 0 < temperature < 2:
        raise ValueError("temperature must be in (0, 2)")

    cfg = session.cfg
    if isinstance(prompt_text, str):
        prompt_text = [prompt_text]
    if isinstance(prompt_tokens, np.ndarray):
        prompt_tokens = [prompt_tokens]
    if prompt_text and prompt_tokens and len(prompt_text) != len(prompt_tokens):
        raise ValueError("Prompt text and tokens must have the same length")

    base_conversation = build_base_conversation(prompt_text, prompt_tokens)
    turns = split_text_by_speaker(text)
    if turns:
        batches = group_turns_into_batches(turns, max_bytes=chunk_length)
    else:
        batches = [text]

    generator = session.new_generator(seed)
    conversation = Conversation(list(base_conversation.messages))
    for batch_text in batches:
        conversation.append(Message(role="user",
                                    parts=[TextPart(text=batch_text)],
                                    cal_loss=False, add_im_start=True,
                                    add_im_end=True))
        gen_conv = Conversation(list(conversation.messages))
        gen_conv.append(Message(role="assistant", parts=[], cal_loss=False,
                                modality="voice", add_im_start=True,
                                add_im_end=False))
        encoded, _, _ = gen_conv.encode_for_inference(
            tokenizer, num_codebooks=cfg.num_codebooks)
        if encoded.shape[1] > cfg.max_seq_len - 2048 and cfg.max_seq_len > 2048:
            raise ValueError(f"Prompt is too long: {encoded.shape[1]} > "
                             f"{cfg.max_seq_len - 2048}")

        if stream_partials:
            seq = None
            for seq in session.generate_stream(
                encoded, generator, max_new_tokens=max_new_tokens,
                temperature=temperature, top_p=top_p, top_k=top_k,
            ):
                n_p = seq.shape[1]
                end_p = (n_p - 1 if n_p and int(seq[0, -1]) == cfg.im_end_id
                         else n_p)
                if end_p > 0:
                    yield GenerateResponse(
                        action="partial",
                        codes=np.ascontiguousarray(seq[1:, :end_p]),
                        text=batch_text,
                    )
        else:
            seq = session.generate(
                encoded, generator, max_new_tokens=max_new_tokens,
                temperature=temperature, top_p=top_p, top_k=top_k,
            )
        # drop the trailing im_end column; keep the codebook rows
        n = seq.shape[1]
        end = n - 1 if int(seq[0, -1]) == cfg.im_end_id else n
        codes = np.ascontiguousarray(seq[1:, :end])
        if (codes < 0).any():
            raise RuntimeError("negative code generated")
        conversation.append(Message(role="assistant",
                                    parts=[VQPart(codes=codes, cal_loss=False)],
                                    cal_loss=False, modality="voice",
                                    add_im_start=True, add_im_end=True))
        yield GenerateResponse(action="sample", codes=codes, text=batch_text)
    yield GenerateResponse(action="next")
