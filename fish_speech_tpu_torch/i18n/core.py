"""UI-string localization (reference `fish_speech/i18n/core.py`).
(The port's copy of `fish_speech_tpu/i18n/core.py`.)

Locale files live in `locale/<lang>.json`; the language comes from
$LANG/$LC_ALL, falling back to en_US.
"""

from __future__ import annotations

import json
import locale as locale_mod
import os
from pathlib import Path

I18N_FILE_PATH = Path(__file__).parent / "locale"
DEFAULT_LANGUAGE = "en_US"


def load_language_list(language: str) -> dict:
    path = I18N_FILE_PATH / f"{language}.json"
    if not path.exists():
        return {}
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


class I18nAuto:
    def __init__(self, language: str | None = None):
        if language is None:
            language = os.environ.get("LANGUAGE")
        if language is None:
            try:
                language = locale_mod.getdefaultlocale()[0]
            except Exception:
                language = None
        if language is None or not (I18N_FILE_PATH / f"{language}.json").exists():
            language = DEFAULT_LANGUAGE
        self.language = language
        self.language_map = load_language_list(language)

    def __call__(self, key: str) -> str:
        return self.language_map.get(key, key)

    def __repr__(self):
        return f"Use Language: {self.language}"


i18n = I18nAuto()
