"""API request/response schemas (pydantic).
(The port's copy of `fish_speech_tpu/server/schema.py`.)

Mirrors the reference contract (`fish_speech/utils/schema.py`) so clients of
the reference server work unchanged.
"""

from __future__ import annotations

import base64
from typing import ClassVar, Literal, Optional

from pydantic import BaseModel, Field, conint, model_validator
from typing_extensions import Annotated


class ServeReferenceAudio(BaseModel):
    audio: bytes
    text: str

    @model_validator(mode="before")
    def decode_audio(cls, values):
        audio = values.get("audio")
        if isinstance(audio, str) and len(audio) > 255:
            try:
                values["audio"] = base64.b64decode(audio)
            except Exception:
                pass
        return values

    def __repr__(self) -> str:
        return f"ServeReferenceAudio(text={self.text!r}, audio_size={len(self.audio)})"


class ServeTTSRequest(BaseModel):
    text: str
    chunk_length: Annotated[int, conint(ge=100, le=1000, strict=True)] = 200
    # reference schema is wav|pcm|mp3|opus (`schema.py:85`); flac is added
    # here because it has a native zero-dependency encoder (audio/transcode)
    # and the reference's own server already serves audio/flac content-type
    # (`api_utils.py:86`)
    format: Literal["wav", "pcm", "mp3", "opus", "flac"] = "wav"
    latency: Literal["normal", "balanced"] = "normal"
    references: list[ServeReferenceAudio] = []
    reference_id: Optional[str] = None
    seed: Optional[int] = None
    use_memory_cache: Literal["on", "off"] = "off"
    normalize: bool = True
    streaming: bool = False
    max_new_tokens: int = 1024
    top_p: Annotated[float, Field(ge=0.1, le=1.0)] = 0.8
    repetition_penalty: Annotated[float, Field(ge=0.9, le=2.0)] = 1.1
    temperature: Annotated[float, Field(ge=0.1, le=1.0)] = 0.8


class OpenAISpeechRequest(BaseModel):
    """OpenAI `/v1/audio/speech` request (drop-in for OpenAI SDK clients).

    Beyond-reference surface: fish-speech has no OpenAI-compatible route, so
    existing OpenAI-TTS integrations need a rewrite to adopt it; this maps
    the OpenAI contract onto the engine. `voice` is either one of OpenAI's
    built-in voice names (served with the model's default voice) or a stored
    reference id (served voice-cloned). `speed` is a pitch-preserving tempo
    change (WSOLA, `audio/stretch.py`). `instructions` is accepted for SDK
    compatibility but has no effect (the underlying model takes style from
    reference audio, not free-text instructions).
    """

    # OpenAI's built-in voice names map to the default (un-cloned) voice
    BUILTIN_VOICES: ClassVar[frozenset] = frozenset(
        {"alloy", "ash", "ballad", "coral", "echo", "fable",
         "nova", "onyx", "sage", "shimmer", "verse"}
    )

    model: str = "fish-speech"  # accepted and ignored (single-model server)
    input: str = Field(..., min_length=1, max_length=4096)
    voice: str = "alloy"
    response_format: Literal["mp3", "opus", "flac", "wav", "pcm"] = "mp3"
    speed: Annotated[float, Field(ge=0.25, le=4.0)] = 1.0
    stream_format: Literal["audio", "sse"] = "audio"
    instructions: Optional[str] = None
    # extension beyond the OpenAI contract: generation budget cap (frames);
    # OpenAI SDKs pass extra body fields through `extra_body`
    max_new_tokens: Annotated[int, Field(ge=1, le=8192)] = 1024


class LiveStartEvent(BaseModel):
    """`{"event": "start"}` options on the `/v1/tts/live` WebSocket.

    Configures the live (streaming-text-input) session: voice, sampling,
    and the buffering policy that decides when accumulated text fragments
    are worth synthesizing (`utils/textseg.py`).
    """

    reference_id: Optional[str] = None
    temperature: Annotated[float, Field(ge=0.1, le=1.0)] = 0.8
    top_p: Annotated[float, Field(ge=0.1, le=1.0)] = 0.8
    seed: Optional[int] = None
    max_new_tokens: Annotated[int, Field(ge=1, le=8192)] = 1024
    # force-flush budget: terminator-free text synthesizes once the buffer
    # exceeds this many UTF-8 bytes
    max_buffer: Annotated[int, Field(ge=20, le=4000)] = 400


class ServeVQGANEncodeRequest(BaseModel):
    audios: list[bytes]


class ServeVQGANEncodeResponse(BaseModel):
    tokens: list[list[list[int]]]


class ServeVQGANDecodeRequest(BaseModel):
    tokens: list[list[list[int]]]


class ServeVQGANDecodeResponse(BaseModel):
    audios: list[bytes]


class AddReferenceRequest(BaseModel):
    id: str = Field(..., min_length=1, max_length=255, pattern=r"^[a-zA-Z0-9\-_ ]+$")
    audio: bytes
    text: str = Field(..., min_length=1)

    @model_validator(mode="before")
    def decode_audio(cls, values):
        audio = values.get("audio")
        if isinstance(audio, str) and len(audio) > 255:
            try:
                values["audio"] = base64.b64decode(audio)
            except Exception:
                pass
        return values


class AddReferenceResponse(BaseModel):
    success: bool
    message: str
    reference_id: str


class ListReferencesResponse(BaseModel):
    success: bool
    reference_ids: list[str]
    message: str = "Success"


class DeleteReferenceResponse(BaseModel):
    success: bool
    message: str
    reference_id: str


class UpdateReferenceResponse(BaseModel):
    success: bool
    message: str
    old_reference_id: str
    new_reference_id: str
