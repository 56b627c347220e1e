"""Text cleaning (reference `fish_speech/text/clean.py` behavior).

Kept in the port as its own copy of `fish_speech_tpu/data/clean.py`, so the port
never imports the JAX package; the tests hold the two to each other.
"""

import re

SYMBOLS_MAPPING = {
    "‘": "'",
    "’": "'",
}

REPLACE_SYMBOL_REGEX = re.compile(
    "|".join(re.escape(p) for p in SYMBOLS_MAPPING.keys())
)

EMOJI_REGEX = re.compile(
    "["
    "\U0001f600-\U0001f64f"
    "\U0001f300-\U0001f5ff"
    "\U0001f680-\U0001f6ff"
    "\U0001f1e0-\U0001f1ff"
    "]+",
    flags=re.UNICODE,
)


def clean_text(text: str) -> str:
    text = text.strip()
    text = REPLACE_SYMBOL_REGEX.sub(lambda x: SYMBOLS_MAPPING[x.group()], text)
    text = EMOJI_REGEX.sub(r"", text)
    text = re.sub(r"[,]{2,}", lambda m: m.group()[0], text)
    return text
