"""Reference-audio management for voice cloning.

Two lookup paths (reference `inference_engine/reference_loader.py`):
  * by id — `references/<id>/` directory containing an audio file and a
    same-stem `.lab` text file;
  * by content hash — sha256 of the uploaded audio bytes, cached.

Encoding audio -> VQ codes goes through the codec callable injected by the
engine.

A copy of `fish_speech_tpu/engine/reference_loader.py` (stdlib + numpy),
kept here so the port never imports the JAX package;
`tests/test_torch_hostcopy.py` holds it to the original.
"""

from __future__ import annotations

import hashlib
import io
import re
import shutil
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

AUDIO_EXTENSIONS = {".wav", ".mp3", ".flac", ".ogg", ".m4a", ".aac"}
_ID_RE = re.compile(r"^[a-zA-Z0-9\-_ ]+$")


class ReferenceLoader:
    def __init__(self, references_dir: str = "references"):
        self.references_dir = Path(references_dir)
        # cache: key -> (prompt_tokens list, prompt_texts list)
        self.ref_by_id: Dict[str, Tuple[list, list]] = {}
        self.ref_by_hash: Dict[str, Tuple[list, list]] = {}
        # injected by the engine:
        self.encode_reference: Optional[Callable] = None

    # -- lookup --

    @staticmethod
    def validate_id(ref_id: str) -> bool:
        return bool(_ID_RE.match(ref_id))

    def _id_dir(self, ref_id: str) -> Path:
        if not self.validate_id(ref_id):
            raise ValueError(f"Invalid reference id: {ref_id!r}")
        return self.references_dir / ref_id

    def load_by_id(self, ref_id: str, use_cache: str = "off"):
        if use_cache == "on" and ref_id in self.ref_by_id:
            return self.ref_by_id[ref_id]

        ref_dir = self._id_dir(ref_id)
        if not ref_dir.is_dir():
            raise FileNotFoundError(f"Reference dir not found: {ref_dir}")

        prompt_tokens, prompt_texts = [], []
        for audio_file in sorted(ref_dir.iterdir()):
            if audio_file.suffix.lower() not in AUDIO_EXTENSIONS:
                continue
            lab = audio_file.with_suffix(".lab")
            if not lab.exists():
                continue
            text = lab.read_text(encoding="utf-8").strip()
            tokens = self.encode_reference(audio_file.read_bytes())
            prompt_tokens.append(tokens)
            prompt_texts.append(text)

        result = (prompt_tokens, prompt_texts)
        self.ref_by_id[ref_id] = result
        return result

    def load_by_hash(self, references: List, use_cache: str = "off"):
        """references: list of objects with .audio (bytes) and .text (str)."""
        audios = [r.audio for r in references]
        texts = [r.text for r in references]
        digest = hashlib.sha256(b"".join(audios)).hexdigest()
        if use_cache == "on" and digest in self.ref_by_hash:
            return self.ref_by_hash[digest]
        prompt_tokens = [self.encode_reference(a) for a in audios]
        result = (prompt_tokens, texts)
        self.ref_by_hash[digest] = result
        return result

    # -- CRUD (server endpoints) --

    def add_reference(self, ref_id: str, audio: bytes, text: str,
                      ext: str = ".wav"):
        ref_dir = self._id_dir(ref_id)
        if ref_dir.exists():
            raise FileExistsError(f"Reference {ref_id!r} already exists")
        ref_dir.mkdir(parents=True)
        (ref_dir / f"sample{ext}").write_bytes(audio)
        (ref_dir / "sample.lab").write_text(text, encoding="utf-8")

    def list_references(self) -> List[str]:
        if not self.references_dir.is_dir():
            return []
        return sorted(
            d.name for d in self.references_dir.iterdir() if d.is_dir()
        )

    def delete_reference(self, ref_id: str):
        ref_dir = self._id_dir(ref_id)
        if not ref_dir.is_dir():
            raise FileNotFoundError(f"Reference {ref_id!r} not found")
        shutil.rmtree(ref_dir)
        self.ref_by_id.pop(ref_id, None)

    def update_reference(self, old_id: str, new_id: str,
                         audio: Optional[bytes] = None,
                         text: Optional[str] = None):
        old_dir = self._id_dir(old_id)
        new_dir = self._id_dir(new_id)
        if not old_dir.is_dir():
            raise FileNotFoundError(f"Reference {old_id!r} not found")
        if old_id != new_id:
            if new_dir.exists():
                raise FileExistsError(f"Reference {new_id!r} already exists")
            old_dir.rename(new_dir)
        if audio is not None:
            (new_dir / "sample.wav").write_bytes(audio)
        if text is not None:
            (new_dir / "sample.lab").write_text(text, encoding="utf-8")
        self.ref_by_id.pop(old_id, None)
        self.ref_by_id.pop(new_id, None)
