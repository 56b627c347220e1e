"""The port's native host code, its copies of the JAX package's
`fish_speech_tpu/native/` sources: the FLAC frame encoder
(`flac_encode.c`), the training-shard parser (`pb_stream.cc`, bound in
`native/loader.py`) and the ffmpeg-backed audio decoder (`av_decode.c`,
bound in `audio/libav.py`). Each is built with the system C or C++
compiler at first use into `build_dir()`, keyed by the source's hash,
never beside the source.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

FLAC_SRC = Path(__file__).parent / "flac_encode.c"
PB_SRC = Path(__file__).parent / "pb_stream.cc"
AV_SRC = Path(__file__).parent / "av_decode.c"


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


def _build(src: Path, cmd: list, libs: list) -> Path:
    """`src`'s shared library, built once per source hash with `cmd` (the
    compiler and its flags) and linked with `libs`; raises
    CalledProcessError (the compiler's output in `stderr`) or
    FileNotFoundError (no compiler) if the build fails."""
    tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = build_dir()
    lib = out / f"lib{src.stem}-{tag}.so"
    if lib.exists():
        return lib
    out.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run([*cmd, str(src), "-o", str(tmp), *libs], check=True,
                   capture_output=True, text=True)
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    return lib


def build_flac() -> Path:
    """The FLAC frame encoder's shared library (`gcc -O2 -shared -fPIC ...
    -lm`)."""
    return _build(FLAC_SRC, ["gcc", "-O2", "-shared", "-fPIC"], ["-lm"])


def build_pb() -> Path:
    """The training-shard parser's shared library (`g++ -O2 -shared -fPIC
    -std=c++17`, no dependencies)."""
    return _build(PB_SRC, ["g++", "-O2", "-shared", "-fPIC", "-std=c++17"], [])


def build_av() -> Path:
    """The ffmpeg-backed decoder's shared library (`gcc -O2 -shared -fPIC
    ... -lavformat -lavcodec -lavutil -lswresample`; needs ffmpeg's
    development headers and libraries)."""
    return _build(AV_SRC, ["gcc", "-O2", "-shared", "-fPIC"],
                  ["-lavformat", "-lavcodec", "-lavutil", "-lswresample"])
