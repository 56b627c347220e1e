"""The port's native host code: its copy of the JAX package's FLAC frame
encoder (`flac_encode.c`), built with the system C compiler at first use
into `build_dir()`, keyed by the source's hash, never beside the source.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

FLAC_SRC = Path(__file__).parent / "flac_encode.c"


def build_dir() -> Path:
    """Where the native libraries are built: `build/native/` at the root of
    the checkout (ignored by git) when the package runs from its source
    tree, else the user's cache (`$XDG_CACHE_HOME` or `~/.cache`,
    `fish_speech_tpu_torch/native/`), never inside an installed package."""
    root = Path(__file__).resolve().parents[2]
    if (root / "pyproject.toml").is_file() and (root / "fish_speech_tpu_torch").is_dir():
        return root / "build" / "native"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "fish_speech_tpu_torch" / "native"


def build_flac() -> Path:
    """The FLAC frame encoder's shared library, built once per source hash
    (`gcc -O2 -shared -fPIC ... -lm`); raises if the build fails."""
    tag = hashlib.sha256(FLAC_SRC.read_bytes()).hexdigest()[:16]
    out = build_dir()
    lib = out / f"libflac_encode-{tag}.so"
    if lib.exists():
        return lib
    out.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(["gcc", "-O2", "-shared", "-fPIC", str(FLAC_SRC), "-o",
                    str(tmp), "-lm"], check=True, capture_output=True)
    os.replace(tmp, lib)  # atomic: a concurrent builder sees all or nothing
    return lib
