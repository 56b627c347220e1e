"""Incremental text segmentation for live (streaming-input) synthesis.
(The port's copy of `fish_speech_tpu/utils/textseg.py`.)

Backs the `/v1/tts/live` WebSocket route (`server/app.py`): text arrives in
arbitrary fragments (an LLM's token stream, a user typing), and the server
must decide when enough has accumulated to synthesize without waiting for
the full script. The policy mirrors the spirit of the reference's offline
chunker (`tools/../inference.py:485-520` groups turns by byte budget): cut
at the LAST sentence terminator seen, and force a cut when the buffer
exceeds a byte budget so pathological terminator-free input still bounds
latency.
"""

from __future__ import annotations

from typing import Tuple

# sentence-final punctuation across the model's supported scripts
# (ASCII, CJK fullwidth, Arabic question mark, ellipsis)
TERMINATORS = ".!?;。！？；…؟\n"


def split_ready(
    buf: str, force: bool = False, max_buffer: int = 400
) -> Tuple[str, str]:
    """Return `(ready, rest)`: the prefix worth synthesizing now and the
    text to keep buffering.

    `ready` is everything through the last sentence terminator; empty when
    no terminator has arrived yet (unless `force`, or the buffer exceeds
    `max_buffer` UTF-8 bytes, in which case the whole buffer flushes).
    """
    idx = max((buf.rfind(c) for c in TERMINATORS), default=-1)
    if idx >= 0:
        return buf[: idx + 1].strip(), buf[idx + 1 :].lstrip()
    if force or len(buf.encode("utf-8")) >= max_buffer:
        return buf.strip(), ""
    return "", buf
