"""Typed configuration for all fish-speech-tpu components.

One dataclass-based config system replaces the reference's three overlapping
systems (Hydra YAML, click CLIs, per-checkpoint config.json) — see reference
`fish_speech/models/text2semantic/llama.py:27-194` (model args),
`fish_speech/models/dac/modded_dac.py:34-62` (codec transformer args) and
`fish_speech/configs/modded_dac_vq.yaml` (codec instantiation) for the
behaviors being reproduced.

All config classes are frozen (hashable).

Kept in the port as its own copy of `fish_speech_tpu/config.py`, so the port
never imports the JAX package; the tests hold the two to each other.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional


def find_multiple(n: int, k: int) -> int:
    """Round n up to a multiple of k."""
    if n % k == 0:
        return n
    return n + k - (n % k)


# ---------------------------------------------------------------------------
# Dual-AR text->semantic LM
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DualARConfig:
    """Configuration of the Dual-AR transformer (slow LM + fast codebook LM).

    Mirrors the semantics of the reference `BaseModelArgs`/`DualARModelArgs`
    (`fish_speech/models/text2semantic/llama.py:27-194`): defaults that the
    reference derives in `__post_init__` are resolved by `resolve()` here
    because frozen dataclasses cannot self-mutate.
    """

    model_type: str = "dual_ar"

    # Slow transformer
    vocab_size: int = 32000
    n_layer: int = 32
    n_head: int = 32
    dim: int = 4096
    intermediate_size: Optional[int] = None
    n_local_heads: int = -1
    head_dim: int = 64
    rope_base: float = 10000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 2048
    dropout: float = 0.0
    tie_word_embeddings: bool = True
    attention_qkv_bias: bool = False
    attention_o_bias: bool = False
    attention_qk_norm: bool = False

    # Codebooks
    codebook_size: int = 160
    num_codebooks: int = 4

    # Semantic token id range in the text vocab (injected from tokenizer)
    semantic_begin_id: int = 0
    semantic_end_id: int = 0
    # `<|im_end|>` id for constrained decoding / stop detection
    im_end_id: int = 0

    scale_codebook_embeddings: bool = False
    norm_fastlayer_input: bool = False

    # Continuous audio-feature conditioning (AudioPart). 0 disables the
    # projector. The reference declares this pathway (`llama.py:421-433`,
    # `content_sequence.py:53-58`) but never initializes the projector and
    # its encoder raises on AudioPart — here it is fully wired.
    audio_feature_dim: int = 0

    # Fast transformer (None -> inherit from slow at resolve())
    n_fast_layer: int = 4
    fast_dim: Optional[int] = None
    fast_n_head: Optional[int] = None
    fast_n_local_heads: Optional[int] = None
    fast_head_dim: Optional[int] = None
    fast_intermediate_size: Optional[int] = None
    fast_attention_qkv_bias: Optional[bool] = None
    fast_attention_qk_norm: Optional[bool] = None
    fast_attention_o_bias: Optional[bool] = None

    # Training
    use_gradient_checkpointing: bool = True
    initializer_range: float = 0.02

    # LoRA runtime scale (alpha / r); 0.0 = no LoRA paths active. Static so
    # jitted programs specialize (no branch cost when disabled).
    lora_scale: float = 0.0

    def resolve(self) -> "DualARConfig":
        """Fill derived/None fields (the reference's `__post_init__` logic)."""
        n_local_heads = self.n_local_heads if self.n_local_heads != -1 else self.n_head
        intermediate_size = self.intermediate_size
        if intermediate_size is None:
            hidden_dim = 4 * self.dim
            n_hidden = int(2 * hidden_dim / 3)
            intermediate_size = find_multiple(n_hidden, 256)
        head_dim = self.head_dim if self.head_dim is not None else self.dim // self.n_head

        fast_dim = self.fast_dim or self.dim
        fast_n_head = self.fast_n_head or self.n_head
        fast_n_local_heads = self.fast_n_local_heads or n_local_heads
        fast_head_dim = self.fast_head_dim or head_dim
        fast_intermediate_size = self.fast_intermediate_size or intermediate_size

        def inherit(v, default):
            return default if v is None else v

        return dataclasses.replace(
            self,
            n_local_heads=n_local_heads,
            intermediate_size=intermediate_size,
            head_dim=head_dim,
            fast_dim=fast_dim,
            fast_n_head=fast_n_head,
            fast_n_local_heads=fast_n_local_heads,
            fast_head_dim=fast_head_dim,
            fast_intermediate_size=fast_intermediate_size,
            fast_attention_qkv_bias=inherit(
                self.fast_attention_qkv_bias, self.attention_qkv_bias
            ),
            fast_attention_qk_norm=inherit(
                self.fast_attention_qk_norm, self.attention_qk_norm
            ),
            fast_attention_o_bias=inherit(
                self.fast_attention_o_bias, self.attention_o_bias
            ),
        )

    # -- json io (reference-compatible: accepts the reference's config.json) --

    @staticmethod
    def from_json(path_or_dict) -> "DualARConfig":
        """Load from a config.json (ours or the reference's).

        Supports the reference's `dual_ar` and `fish_qwen3_omni` layouts
        (`llama.py:75-143`).
        """
        if isinstance(path_or_dict, (str, Path)):
            p = Path(path_or_dict)
            if p.is_dir():
                p = p / "config.json"
            with open(p, "r", encoding="utf-8") as f:
                data = json.load(f)
        else:
            data = dict(path_or_dict)

        if data.get("model_type") == "fish_qwen3_omni":
            data = _flatten_fish_qwen3_omni(data)

        valid = {f.name for f in dataclasses.fields(DualARConfig)}
        data = {k: v for k, v in data.items() if k in valid}
        return DualARConfig(**data).resolve()

    def to_json(self, path: Optional[str] = None) -> dict:
        data = dataclasses.asdict(self)
        if path is not None:
            with open(path, "w", encoding="utf-8") as f:
                json.dump(data, f, indent=2, sort_keys=True, ensure_ascii=False)
        return data


def _flatten_fish_qwen3_omni(data: dict) -> dict:
    """Translate the nested fish_qwen3_omni config layout to flat DualAR keys.

    Reference: `llama.py:101-143` (`_from_fish_qwen3_omni`).
    """
    tc = data["text_config"]
    adc = data["audio_decoder_config"]
    flat = dict(
        model_type="dual_ar",
        vocab_size=tc["vocab_size"],
        n_layer=tc["n_layer"],
        n_head=tc["n_head"],
        n_local_heads=tc.get("n_local_heads", -1),
        head_dim=tc.get("head_dim"),
        dim=tc["dim"],
        intermediate_size=tc.get("intermediate_size"),
        rope_base=tc.get("rope_base", 10000),
        norm_eps=tc.get("norm_eps", 1e-5),
        max_seq_len=tc.get("max_seq_len", 2048),
        dropout=tc.get("dropout", 0.0),
        tie_word_embeddings=tc.get("tie_word_embeddings", True),
        attention_qkv_bias=tc.get("attention_qkv_bias", False),
        attention_o_bias=tc.get("attention_o_bias", False),
        attention_qk_norm=tc.get("attention_qk_norm", False),
        use_gradient_checkpointing=tc.get("use_gradient_checkpointing", True),
        initializer_range=tc.get("initializer_range", 0.02),
        semantic_begin_id=data.get("semantic_start_token_id", 0),
        semantic_end_id=data.get("semantic_end_token_id", 0),
        scale_codebook_embeddings=True,
        norm_fastlayer_input=True,
        codebook_size=adc["vocab_size"],
        num_codebooks=adc["num_codebooks"],
        n_fast_layer=adc["n_layer"],
        fast_dim=adc.get("dim"),
        fast_n_head=adc.get("n_head"),
        fast_n_local_heads=adc.get("n_local_heads"),
        fast_head_dim=adc.get("head_dim"),
        fast_intermediate_size=adc.get("intermediate_size"),
        fast_attention_qkv_bias=adc.get("attention_qkv_bias"),
        fast_attention_qk_norm=adc.get("attention_qk_norm"),
        fast_attention_o_bias=adc.get("attention_o_bias"),
    )
    return {k: v for k, v in flat.items() if v is not None}


# ---------------------------------------------------------------------------
# DAC codec
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CodecTransformerConfig:
    """Window-limited transformer inside the codec.

    Mirrors `fish_speech/models/dac/modded_dac.py:34-62` (ModelArgs).
    """

    n_layer: int = 8
    n_head: int = 8
    dim: int = 512
    intermediate_size: int = 1536
    n_local_heads: int = -1
    head_dim: int = 64
    rope_base: float = 10000.0
    norm_eps: float = 1e-5
    window_size: Optional[int] = 512  # None -> plain causal attention

    def resolve(self) -> "CodecTransformerConfig":
        n_local = self.n_local_heads if self.n_local_heads != -1 else self.n_head
        return dataclasses.replace(self, n_local_heads=n_local)


@dataclass(frozen=True)
class RVQConfig:
    """Downsampling semantic+residual RVQ quantizer.

    Mirrors `fish_speech/models/dac/rvq.py:204-286` +
    `fish_speech/configs/modded_dac_vq.yaml:22-50`.
    """

    input_dim: int = 1024
    n_codebooks: int = 9  # residual codebooks (semantic codebook is separate)
    codebook_dim: int = 8
    codebook_size: int = 1024
    semantic_codebook_size: int = 4096
    downsample_factor: tuple = (2, 2)
    quantizer_dropout: float = 0.5
    pre_transformer: Optional[CodecTransformerConfig] = None
    post_transformer: Optional[CodecTransformerConfig] = None

    @property
    def total_codebooks(self) -> int:
        return 1 + self.n_codebooks

    @property
    def downsample_total(self) -> int:
        total = 1
        for f in self.downsample_factor:
            total *= f
        return total


@dataclass(frozen=True)
class DACConfig:
    """Full modded-DAC codec.

    Mirrors `fish_speech/models/dac/modded_dac.py:804-861` and
    `fish_speech/configs/modded_dac_vq.yaml`. The decoder transformer layers
    are intentionally absent: the reference constructs but never wires them
    into the decoder (`modded_dac.py:741-742` keeps the module out of the
    Sequential and never registers it), so no checkpoint contains them.
    """

    sample_rate: int = 44100
    encoder_dim: int = 64
    encoder_rates: tuple = (2, 4, 8, 8)
    decoder_dim: int = 1536
    decoder_rates: tuple = (8, 8, 4, 2)
    latent_dim: Optional[int] = None
    causal: bool = True
    encoder_transformer_layers: tuple = (0, 0, 0, 4)
    encoder_transformer_window: int = 512
    rvq: RVQConfig = field(default_factory=RVQConfig)

    @property
    def resolved_latent_dim(self) -> int:
        if self.latent_dim is not None:
            return self.latent_dim
        return self.encoder_dim * (2 ** len(self.encoder_rates))

    @property
    def hop_length(self) -> int:
        total = 1
        for r in self.encoder_rates:
            total *= r
        return total

    @property
    def frame_length(self) -> int:
        # hop * RVQ internal downsampling (`modded_dac.py:861`)
        return self.hop_length * self.rvq.downsample_total

    @property
    def tokens_per_second(self) -> float:
        return self.sample_rate / self.frame_length


# ---------------------------------------------------------------------------
# Generation / sampling
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SamplingConfig:
    """Sampling parameters (reference defaults: CLI `inference.py:824-826`,
    server `utils/schema.py:102-107`)."""

    temperature: float = 1.0
    top_p: float = 0.9
    top_k: int = 30
    # Repetition-Aware Sampling (`inference.py:49-51`)
    ras_win_size: int = 10
    ras_high_temp: float = 1.0
    ras_high_top_p: float = 0.9
    # Accepted for API parity; the reference plumbs it through but the RAS
    # sampler never applies it (`schema.py:102`, unused in `sample()`).
    repetition_penalty: float = 1.1
    # Benchmark-only: mask the <|im_end|> slot so streams never stop. With
    # RANDOM weights the restricted head draws im_end with p ~ 1/(range+1)
    # per step, so a throughput bench's counted frames vary run to run (this
    # was the entire round-1 -> round-2 "858 -> 797 f/s regression": wall
    # time was within 1%, the frame COUNT differed). Sustained serving keeps
    # slots full via the continuous batcher, so masking measures the real
    # steady state. Never set for actual synthesis.
    mask_im_end: bool = False


@dataclass(frozen=True)
class GenerateConfig:
    """Long-form generation parameters (`inference.py:523-733`)."""

    max_new_tokens: int = 0  # 0 -> up to max_seq_len
    chunk_length: int = 300  # max UTF-8 bytes per text batch
    max_speakers_per_batch: int = 5
    decode_chunk_size: int = 32  # device steps per host sync
    sampling: SamplingConfig = field(default_factory=SamplingConfig)


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------


def dual_ar_tiny(vocab_size: int = 4608, **overrides) -> DualARConfig:
    """Tiny config for tests / CPU smoke runs."""
    kw = dict(
        vocab_size=vocab_size,
        n_layer=2,
        n_head=2,
        dim=64,
        intermediate_size=128,
        n_local_heads=1,
        head_dim=32,
        max_seq_len=256,
        codebook_size=32,
        num_codebooks=4,
        n_fast_layer=2,
        fast_dim=32,
        fast_n_head=2,
        fast_n_local_heads=1,
        fast_head_dim=16,
        fast_intermediate_size=64,
        tie_word_embeddings=True,
    )
    kw.update(overrides)
    return DualARConfig(**kw).resolve()


def dual_ar_s2_pro(**overrides) -> DualARConfig:
    """Flagship-scale config: slow ~4B + fast ~400M, 10 codebooks @ ~21.5 Hz.

    The reference publishes the scale (README.md:118-123) but not the exact
    dims; this preset is a Qwen3-4B-like layout matching that parameter count.
    Real checkpoints carry their own config.json which takes precedence.
    """
    cfg = DualARConfig(
        vocab_size=155136,  # ~151k text vocab + 4096 semantic tokens
        n_layer=36,
        n_head=32,
        n_local_heads=8,
        dim=2560,
        head_dim=128,
        intermediate_size=9728,
        max_seq_len=4096,
        rope_base=1000000.0,
        attention_qk_norm=True,
        tie_word_embeddings=False,
        codebook_size=4096,
        num_codebooks=10,
        n_fast_layer=12,
        fast_dim=1536,
        fast_n_head=12,
        fast_n_local_heads=4,
        fast_head_dim=128,
        fast_intermediate_size=6144,
        scale_codebook_embeddings=True,
        norm_fastlayer_input=True,
        **overrides,
    )
    return cfg.resolve()


def dac_tiny(**overrides) -> DACConfig:
    """Tiny codec for tests (same topology, small dims)."""
    tconf = CodecTransformerConfig(
        n_layer=1, n_head=2, dim=32, intermediate_size=64, head_dim=16, window_size=16
    ).resolve()
    rvq = RVQConfig(
        input_dim=32,
        n_codebooks=2,
        codebook_dim=4,
        codebook_size=16,
        semantic_codebook_size=32,
        downsample_factor=(2, 2),
        pre_transformer=tconf,
        post_transformer=tconf,
    )
    base = DACConfig(
        sample_rate=44100,
        encoder_dim=2,
        encoder_rates=(2, 4, 8, 8),
        decoder_dim=32,
        decoder_rates=(8, 8, 4, 2),
        encoder_transformer_layers=(0, 0, 0, 1),
        encoder_transformer_window=16,
        rvq=rvq,
    )
    return dataclasses.replace(base, **overrides) if overrides else base


def dac_s2_pro(**overrides) -> DACConfig:
    """The production codec config (`fish_speech/configs/modded_dac_vq.yaml`)."""
    tconf = CodecTransformerConfig(
        n_layer=8,
        n_head=16,
        dim=1024,
        intermediate_size=3072,
        head_dim=64,
        window_size=128,
    ).resolve()
    rvq = RVQConfig(
        input_dim=1024,
        n_codebooks=9,
        codebook_dim=8,
        codebook_size=1024,
        semantic_codebook_size=4096,
        downsample_factor=(2, 2),
        pre_transformer=tconf,
        post_transformer=tconf,
    )
    base = DACConfig(
        sample_rate=44100,
        encoder_dim=64,
        encoder_rates=(2, 4, 8, 8),
        decoder_dim=1536,
        decoder_rates=(8, 8, 4, 2),
        encoder_transformer_layers=(0, 0, 0, 4),
        encoder_transformer_window=512,
        rvq=rvq,
    )
    return dataclasses.replace(base, **overrides) if overrides else base
