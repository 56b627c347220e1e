"""Semantic-token-aware tokenizer.

Re-implements the behavior of the reference `fish_speech/tokenizer.py`:
a text tokenizer whose vocabulary additionally contains 4096 contiguous
`<|semantic:i|>` tokens plus chat/modality special tokens. The contiguous
semantic id range enables arithmetic mapping between codec codebook-0 values
and text-vocab ids (`content_sequence.py:203-211`).

Built directly on the `tokenizers` Rust library (kept as a dependency, like
the reference keeps tiktoken/HF tokenizers — serialization, not compute).

Kept in the port as its own copy of `fish_speech_tpu/tokenizer.py`, so the port
never imports the JAX package; the tests hold the two to each other.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import List, Union

from tokenizers import AddedToken, Tokenizer

logger = logging.getLogger(__name__)

# --- Protocol constants (shared vocabulary contract with the reference) ---
EOS_TOKEN = "<|endoftext|>"
PAD_TOKEN = "<|pad|>"
IM_START_TOKEN = "<|im_start|>"
IM_END_TOKEN = "<|im_end|>"
PHONEME_START_TOKEN = "<|phoneme_start|>"
PHONEME_END_TOKEN = "<|phoneme_end|>"

MODALITY_TEXT_TOKEN = "<|text|>"
MODALITY_VOICE_TOKEN = "<|voice|>"
MODALITY_INTERLEAVE_TOKEN = "<|interleave|>"
AUDIO_START_TOKEN = "<|audio_start|>"
AUDIO_END_TOKEN = "<|audio_end|>"
AUDIO_EMBED_TOKEN = "<|audio_pad|>"

MODALITY_TOKENS = {
    "text": MODALITY_TEXT_TOKEN,
    "voice": MODALITY_VOICE_TOKEN,
    "interleave": MODALITY_INTERLEAVE_TOKEN,
}

SEMANTIC_TOKEN_TEMPLATE = "<|semantic:{i}|>"
NUM_SEMANTIC_TOKENS = 4096

BASE_SPECIAL_TOKENS = [
    EOS_TOKEN,
    PAD_TOKEN,
    IM_START_TOKEN,
    IM_END_TOKEN,
    PHONEME_START_TOKEN,
    PHONEME_END_TOKEN,
    MODALITY_TEXT_TOKEN,
    MODALITY_VOICE_TOKEN,
    MODALITY_INTERLEAVE_TOKEN,
    AUDIO_START_TOKEN,
    AUDIO_END_TOKEN,
    AUDIO_EMBED_TOKEN,
]


class FishTokenizer:
    """Wraps a `tokenizers.Tokenizer`, discovering the semantic id range.

    Reference behavior: `fish_speech/tokenizer.py:55-129`. Special tokens are
    always parsed inline in input text (the reference forces
    `allowed_special="all"` on tiktoken backends, `tokenizer.py:105-116`;
    the `tokenizers` library does this natively for added special tokens).
    """

    def __init__(self, tokenizer: Tokenizer):
        self._tokenizer = tokenizer
        vocab = tokenizer.get_vocab()

        self.semantic_id_to_token_id = {}
        valid_ids = []
        for code_idx in range(NUM_SEMANTIC_TOKENS):
            token = SEMANTIC_TOKEN_TEMPLATE.format(i=code_idx)
            if token in vocab:
                token_id = vocab[token]
                self.semantic_id_to_token_id[code_idx] = token_id
                valid_ids.append(token_id)

        if not valid_ids:
            logger.error(
                "No semantic tokens found in vocab; audio cannot be synthesized."
            )
            self.semantic_begin_id = 0
            self.semantic_end_id = 0
        else:
            self.semantic_begin_id = min(valid_ids)
            self.semantic_end_id = max(valid_ids)
            # The Dual-AR arithmetic mapping requires contiguity.
            span = self.semantic_end_id - self.semantic_begin_id + 1
            if span != len(valid_ids):
                logger.warning(
                    "Semantic token ids are not contiguous (%d ids over span %d)",
                    len(valid_ids),
                    span,
                )

        self._vocab = vocab
        logger.info(
            "Loaded tokenizer; semantic range: %d -> %d",
            self.semantic_begin_id,
            self.semantic_end_id,
        )

    # -- basic api --

    @property
    def vocab_size(self) -> int:
        return self._tokenizer.get_vocab_size()

    @property
    def pad_token_id(self) -> int:
        return self._vocab.get(PAD_TOKEN, 0)

    @property
    def eos_token_id(self) -> int:
        return self._vocab.get(EOS_TOKEN, 0)

    @property
    def im_end_id(self) -> int:
        return self._vocab[IM_END_TOKEN]

    def get_token_id(self, token: str) -> int:
        tid = self._tokenizer.token_to_id(token)
        if tid is None:
            raise KeyError(f"Token not in vocab: {token!r}")
        return tid

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        return self._tokenizer.encode(text, add_special_tokens=add_special_tokens).ids

    def decode(self, tokens: Union[List[int], int], skip_special_tokens=False) -> str:
        if isinstance(tokens, int):
            tokens = [tokens]
        return self._tokenizer.decode(
            list(map(int, tokens)), skip_special_tokens=skip_special_tokens
        )

    # -- persistence --

    def save_pretrained(self, path: str):
        p = Path(path)
        p.mkdir(parents=True, exist_ok=True)
        self._tokenizer.save(str(p / "tokenizer.json"))

    @classmethod
    def from_pretrained(cls, path: str) -> "FishTokenizer":
        p = Path(path)
        if p.is_dir():
            p = p / "tokenizer.json"
        return cls(Tokenizer.from_file(str(p)))


def build_test_tokenizer(num_semantic: int = NUM_SEMANTIC_TOKENS) -> FishTokenizer:
    """Build a self-contained byte-level tokenizer with the full special-token
    protocol. Used for tests and random-weight demos (no checkpoint needed).

    Vocabulary layout: 256 byte tokens, then base specials, then the
    contiguous semantic block — so semantic ids are [268, 268+num_semantic).
    """
    from tokenizers import decoders, models, pre_tokenizers

    alphabet = pre_tokenizers.ByteLevel.alphabet()
    vocab = {ch: i for i, ch in enumerate(sorted(alphabet))}
    tok = Tokenizer(models.BPE(vocab=vocab, merges=[]))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()

    specials = list(BASE_SPECIAL_TOKENS) + [
        SEMANTIC_TOKEN_TEMPLATE.format(i=i) for i in range(num_semantic)
    ]
    tok.add_special_tokens([AddedToken(s, special=True) for s in specials])
    return FishTokenizer(tok)
