"""Prompt/sequence representation: content parts, sequences, conversations.

This is the load-bearing abstraction shared by inference and training: it
builds the `(num_codebooks+1, T)` token matrix the Dual-AR model consumes
(row 0 = text-vocab ids with semantic tokens mapped by arithmetic offset,
rows 1..N = raw codebook values at VQ positions, 0 elsewhere).

Reference semantics: `fish_speech/content_sequence.py` and
`fish_speech/conversation.py`. Pure numpy — device arrays enter only at the
model boundary.

Kept in the port as its own copy of `fish_speech_tpu/sequence.py`, so the port
never imports the JAX package; the tests hold the two to each other.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Literal, Optional, Sequence, Union

import numpy as np

from fish_speech_tpu_torch.tokenizer import (
    IM_END_TOKEN,
    IM_START_TOKEN,
    MODALITY_TOKENS,
    FishTokenizer,
)

IGNORE_INDEX = -100


def restore_ndarray(obj, dtype=np.int32) -> np.ndarray:
    """Restore an ndarray from msgpack transport form (`{"__ndarray__": ...}`).

    Reference: `content_sequence.py:14-21`.
    """
    if isinstance(obj, dict) and "__ndarray__" in obj:
        obj = np.frombuffer(obj["data"], dtype=obj["dtype"]).reshape(obj["shape"])
    if isinstance(obj, np.ndarray):
        return np.ascontiguousarray(obj)
    return np.asarray(obj, dtype=dtype)


# ---------------------------------------------------------------------------
# Parts
# ---------------------------------------------------------------------------


@dataclass
class TextPart:
    text: Optional[str] = None
    tokens: Optional[List[int]] = None
    cal_loss: bool = False
    type: str = "text"

    def __post_init__(self):
        self.type = "text"
        if self.text is None and self.tokens is None:
            raise ValueError("Either text or tokens must be provided")


@dataclass
class VQPart:
    codes: np.ndarray  # (num_codebooks, T) int
    cal_loss: bool = False
    type: str = "vq"

    def __post_init__(self):
        self.type = "vq"
        self.codes = restore_ndarray(self.codes).astype(np.int32)


@dataclass
class AudioPart:
    features: np.ndarray
    cal_loss: bool = False
    type: str = "audio"

    def __post_init__(self):
        self.type = "audio"
        self.features = restore_ndarray(self.features, dtype=np.float32)


Part = Union[TextPart, VQPart, AudioPart]


def part_from_dict(d: dict) -> Part:
    kind = d.get("type")
    body = {k: v for k, v in d.items() if k != "type"}
    if kind == "text":
        return TextPart(**body)
    if kind == "vq":
        return VQPart(**body)
    if kind == "audio":
        return AudioPart(**body)
    raise ValueError(f"Unsupported part type: {kind}")


# ---------------------------------------------------------------------------
# Encoded result
# ---------------------------------------------------------------------------


@dataclass
class EncodedSequence:
    tokens: np.ndarray  # (T,) int32 text-vocab ids
    labels: np.ndarray  # (T,) int32, IGNORE_INDEX where no loss
    vq_parts: List[np.ndarray]  # list of (num_codebooks, t) code matrices
    vq_mask_tokens: np.ndarray  # (T,) bool: position holds a VQ token (input side)
    vq_mask_labels: np.ndarray  # (T,) bool: label at position is a VQ token
    vq_require_losses: np.ndarray  # (num_vq_parts,) bool
    audio_parts: List[np.ndarray]
    audio_masks: np.ndarray  # (T,) bool
    metadata: Optional[dict] = None


# ---------------------------------------------------------------------------
# ContentSequence
# ---------------------------------------------------------------------------


class ContentSequence:
    """A flat sequence of multimodal parts.

    Example format:
    `<|interleave|><|speaker:1|> TEXT AUDIO <|im_end|><|speaker:2|> ...`
    """

    def __init__(
        self,
        parts: Optional[Sequence[Union[Part, dict]]] = None,
        modality: Optional[Literal["text", "voice", "interleave"]] = None,
        metadata: Optional[dict] = None,
    ):
        self.modality = modality
        self.metadata = metadata or {}
        self.parts: List[Part] = [
            part_from_dict(p) if isinstance(p, dict) else p for p in (parts or [])
        ]
        if self.modality:
            token = MODALITY_TOKENS[self.modality]
            already = (
                self.parts
                and isinstance(self.parts[0], TextPart)
                and self.parts[0].text is not None
                and self.parts[0].text.startswith(token)
            )
            if not already:
                self.parts.insert(0, TextPart(text=token))

    def append(
        self,
        part_or_parts: Union[Part, List[Part]],
        add_end: bool = False,
        speaker: Union[str, int, None] = None,
    ):
        parts = part_or_parts if isinstance(part_or_parts, list) else [part_or_parts]
        if speaker is not None:
            self.parts.append(TextPart(text=f"<|speaker:{speaker}|>"))
        self.parts.extend(parts)
        if add_end:
            self.parts.append(
                TextPart(text=IM_END_TOKEN, cal_loss=self.parts[-1].cal_loss)
            )

    def encode(
        self,
        tokenizer: FishTokenizer,
        add_shift: bool = True,
        ignore_loss_tokens: Sequence[str] = (),
    ) -> EncodedSequence:
        all_tokens: List[np.ndarray] = []
        all_labels: List[np.ndarray] = []
        vq_parts: List[np.ndarray] = []
        vq_masks: List[np.ndarray] = []
        vq_require_losses: List[bool] = []
        audio_parts: List[np.ndarray] = []
        audio_masks: List[np.ndarray] = []

        for part in self.parts:
            if isinstance(part, TextPart):
                ids = (
                    part.tokens
                    if part.tokens is not None
                    else tokenizer.encode(part.text, add_special_tokens=False)
                )
                tokens = np.asarray(ids, dtype=np.int32)
                vq_masks.append(np.zeros(len(tokens), dtype=bool))
                audio_masks.append(np.zeros(len(tokens), dtype=bool))
            elif isinstance(part, VQPart):
                codes = part.codes.astype(np.int32)
                # Arithmetic offset mapping: code -> `<|semantic:code|>` id.
                # Requires a contiguous semantic id block (checked at load).
                tokens = codes[0] + tokenizer.semantic_begin_id
                vq_parts.append(codes)
                vq_require_losses.append(bool(part.cal_loss))
                vq_masks.append(np.ones(len(tokens), dtype=bool))
                audio_masks.append(np.zeros(len(tokens), dtype=bool))
            elif isinstance(part, AudioPart):
                n = len(part.features)
                tokens = np.zeros(n, dtype=np.int32)  # placeholder ids
                audio_parts.append(part.features)
                vq_masks.append(np.zeros(n, dtype=bool))
                amask = np.ones(n, dtype=bool)
                if n > 0:
                    amask[0] = False
                    amask[-1] = False
                audio_masks.append(amask)
            else:
                raise ValueError(f"Unsupported part type: {type(part)}")

            all_tokens.append(tokens)
            if part.cal_loss and not isinstance(part, AudioPart):
                all_labels.append(tokens.copy())
            else:
                all_labels.append(np.full(len(tokens), IGNORE_INDEX, dtype=np.int32))

        if all_tokens:
            tokens = np.concatenate(all_tokens)
            labels = np.concatenate(all_labels)
            vq_mask = np.concatenate(vq_masks)
            audio_mask = np.concatenate(audio_masks)
        else:
            tokens = np.zeros(0, dtype=np.int32)
            labels = np.zeros(0, dtype=np.int32)
            vq_mask = np.zeros(0, dtype=bool)
            audio_mask = np.zeros(0, dtype=bool)

        vq_mask_tokens = vq_mask
        vq_mask_labels = vq_mask
        if add_shift and len(tokens) > 0:
            tokens = tokens[:-1]
            labels = labels[1:]
            vq_mask_tokens = vq_mask_tokens[:-1]
            vq_mask_labels = vq_mask_labels[1:]
            audio_mask = audio_mask[:-1]

        for t in ignore_loss_tokens:
            try:
                tid = tokenizer.get_token_id(t)
            except KeyError:
                continue
            labels = np.where(labels == tid, IGNORE_INDEX, labels)

        return EncodedSequence(
            tokens=tokens,
            labels=labels,
            vq_parts=vq_parts,
            vq_mask_tokens=vq_mask_tokens,
            vq_mask_labels=vq_mask_labels,
            vq_require_losses=np.asarray(vq_require_losses, dtype=bool),
            audio_parts=audio_parts,
            audio_masks=audio_mask,
            metadata=self.metadata,
        )

    @staticmethod
    def align_audio_features(encoded: "EncodedSequence") -> Optional[np.ndarray]:
        """Scatter the ragged `audio_parts` into a (T, F) buffer aligned with
        `encoded.tokens`, zeros elsewhere — the static-shape layout
        `models.dual_ar.embed_tokens` consumes (the reference gathers with a
        boolean index, `llama.py:427-431`, a dynamic shape; on TPU we keep T
        static and mask).

        Each AudioPart contributes features[1:-1]: its first/last frames are
        start/end delimiter positions that keep their token embeddings
        (`content_sequence.py:224-226`).
        """
        if not encoded.audio_parts:
            return None
        feat_dim = encoded.audio_parts[0].shape[-1]
        t = len(encoded.tokens)
        out = np.zeros((t, feat_dim), dtype=np.float32)
        inner = np.concatenate(
            [p[1:-1] if len(p) > 2 else p[:0] for p in encoded.audio_parts]
        )
        idx = np.nonzero(encoded.audio_masks)[0]
        # encode() may trim the final position (add_shift); trim features too
        out[idx] = inner[: len(idx)]
        return out

    def encode_for_inference(
        self,
        tokenizer: FishTokenizer,
        num_codebooks: int,
    ):
        """Produce the `(num_codebooks+1, T)` inference prompt matrix.

        Returns (values, audio_masks, audio_parts); the audio outputs are
        None unless AudioParts are present (parity with
        `content_sequence.py:282-324`).
        """
        encoded = self.encode(tokenizer, add_shift=False)
        tokens = encoded.tokens
        values = np.zeros((num_codebooks + 1, len(tokens)), dtype=np.int32)
        values[0] = tokens

        if not encoded.vq_parts and not encoded.audio_parts:
            return values, None, None

        if encoded.vq_parts:
            all_vq = np.concatenate(encoded.vq_parts, axis=1)
            values[1:, encoded.vq_mask_tokens] = all_vq

        audio_parts = None
        audio_masks = None
        if encoded.audio_parts:
            audio_parts = np.concatenate(encoded.audio_parts, axis=0)
            audio_masks = encoded.audio_masks[None, :]

        return values, audio_masks, audio_parts

    def visualize(
        self,
        tokenizer: FishTokenizer,
        ignore_loss_tokens: Sequence[str] = (),
        merge_semantic_tokens: bool = False,
        use_color: bool = True,
    ) -> str:
        """Render the encoded sequence; loss-bearing tokens in blue/cyan,
        non-loss in green. Returns the rendered string (also printable)."""
        encoded = self.encode(
            tokenizer, add_shift=False, ignore_loss_tokens=ignore_loss_tokens
        )
        out: List[str] = []
        palette = {
            True: ["\033[94m", "\033[96m"],  # loss: blue/cyan
            False: ["\033[92m", "\033[32m"],  # no loss: greens
        }
        counters = {True: 0, False: 0}

        def emit(text: str, has_loss: bool):
            if use_color:
                color = palette[has_loss][counters[has_loss] % 2]
                out.append(f"{color}{text}\033[0m")
                counters[has_loss] += 1
            else:
                out.append(text)

        run_count = 0
        run_loss = None
        for tok, lab in zip(encoded.tokens, encoded.labels):
            tid = int(tok)
            is_semantic = (
                tokenizer.semantic_begin_id <= tid <= tokenizer.semantic_end_id
            )
            has_loss = int(lab) != IGNORE_INDEX
            if merge_semantic_tokens and is_semantic and run_loss in (None, has_loss):
                run_count += 1
                run_loss = has_loss
                continue
            if run_count > 0:
                emit(f"[<|semantic|>x{run_count}]", bool(run_loss))
                run_count, run_loss = 0, None
            if merge_semantic_tokens and is_semantic:
                run_count, run_loss = 1, has_loss
                continue
            text = tokenizer.decode([tid]) or f"<{tid}>"
            emit(text, has_loss)
        if run_count > 0:
            emit(f"[<|semantic|>x{run_count}]", bool(run_loss))

        rendered = "".join(out)
        return rendered


# ---------------------------------------------------------------------------
# Conversation
# ---------------------------------------------------------------------------


@dataclass(kw_only=True)
class Message:
    role: Literal["system", "user", "assistant"]
    parts: List[Part] = field(default_factory=list)
    add_im_start: bool = True
    add_im_end: bool = True
    cal_loss: bool = False
    modality: Optional[Literal["text", "voice", "interleave"]] = None
    # By default, no loss on the auto-generated im_start framing
    ignore_im_start_loss: bool = True


class Conversation:
    """Chat framing: `<|im_start|>role\\n<|modality|> ... <|im_end|>\\n`.

    Handles cal_loss inheritance from message to part level
    (`conversation.py:39-77`).
    """

    def __init__(self, messages: Optional[List[Message]] = None):
        self.messages: List[Message] = list(messages or [])

    def append(self, message: Message):
        self.messages.append(message)

    def to_content_sequence(self, metadata: Optional[dict] = None) -> ContentSequence:
        all_parts: List[Part] = []
        for message in self.messages:
            if message.add_im_start:
                modality_token = (
                    MODALITY_TOKENS[message.modality] if message.modality else ""
                )
                all_parts.append(
                    TextPart(
                        text=f"{IM_START_TOKEN}{message.role}\n{modality_token}",
                        cal_loss=not message.ignore_im_start_loss,
                    )
                )
            for part in message.parts:
                if not getattr(part, "cal_loss", False):
                    part = dataclasses.replace(part, cal_loss=message.cal_loss)
                all_parts.append(part)
            if message.add_im_end:
                all_parts.append(
                    TextPart(text=IM_END_TOKEN + "\n", cal_loss=message.cal_loss)
                )
        return ContentSequence(parts=all_parts, modality=None, metadata=metadata)

    def encode(
        self,
        tokenizer: FishTokenizer,
        add_shift: bool = True,
        ignore_loss_tokens: Sequence[str] = (),
        metadata: Optional[dict] = None,
    ) -> EncodedSequence:
        return self.to_content_sequence(metadata).encode(
            tokenizer, add_shift=add_shift, ignore_loss_tokens=ignore_loss_tokens
        )

    def encode_for_inference(
        self,
        tokenizer: FishTokenizer,
        num_codebooks: int,
        metadata: Optional[dict] = None,
    ):
        return self.to_content_sequence(metadata).encode_for_inference(
            tokenizer, num_codebooks=num_codebooks
        )

    def visualize(self, tokenizer: FishTokenizer, **kwargs) -> str:
        return self.to_content_sequence().visualize(tokenizer, **kwargs)
