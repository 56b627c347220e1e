"""Build and load the port's CUDA kernels.

The sources under `fish_speech_tpu_torch/csrc/` are compiled with `nvcc` for
Hopper (`sm_90a`), one `nvcc` per source, all started together, and linked
into one shared library with a plain C interface, bound with `ctypes`. The
build runs at first use, into `build/kernels-<hash>/` at the root of the
checkout, keyed by the hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads in milliseconds.

Nothing here runs at import time: the CPU tests import every module of the
port on a machine without `nvcc`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# dtype codes of the C entry points (csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    for cand in ([os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []) + [
        shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"
    ]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / f"kernels-{source_hash()}" / "libfs_kernels.so"


def _build(out: Path):
    cu, _ = _sources()
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    objs = [out.parent / f"{src.stem}.{tag}.o" for src in cu]
    compiles = [[_nvcc(), *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                for src, obj in zip(cu, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in compiles]
    logs = [(cmd, *proc.communicate()) for cmd, proc in zip(compiles, procs)]
    tmp = out.with_suffix(f".{tag}.tmp")
    link = [_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]
    failed = [proc.returncode for proc in procs if proc.returncode != 0]
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        logs.append((link, proc.stdout + proc.stderr, None))
        if proc.returncode != 0:
            failed.append(proc.returncode)
    text = "".join(" ".join(cmd) + "\n" + (log or "") for cmd, log, _ in logs)
    (out.parent / "build.log").write_text(text)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed ({failed}):\n{text}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


@functools.cache
def load_kernels() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    out = library_path()
    if not out.exists():
        _build(out)
    lib = ctypes.CDLL(str(out))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fs_flash_prefill.argtypes = [
        ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, f32, ptr
    ]
    lib.fs_flash_prefill.restype = i32
    lib.fs_flash_decode.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32,
        f32, ptr
    ]
    lib.fs_flash_decode.restype = i32
    lib.fs_flash_train_fwd.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, f32, ptr
    ]
    lib.fs_flash_train_fwd.restype = i32
    lib.fs_flash_train_bwd.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
        i32, i32, i32, i32, i32, i32, f32, ptr
    ]
    lib.fs_flash_train_bwd.restype = i32
    lib.fs_flash_train_bwd_occupancy.argtypes = [i32, ptr, ptr]
    lib.fs_flash_train_bwd_occupancy.restype = i32
    lib.fs_flash_decode_kv8.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
        i32, i32, i32, i32, i32, i32, i32, f32, ptr
    ]
    lib.fs_flash_decode_kv8.restype = i32
    lib.fs_int4_matmul.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, ptr
    ]
    lib.fs_int4_matmul.restype = i32
    lib.fs_faststack_probe.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, i32,
        i32, ptr
    ]
    lib.fs_faststack_probe.restype = i32
    lib.fs_l2_persistence_reset.argtypes = []
    lib.fs_l2_persistence_reset.restype = i32
    return lib


@functools.cache
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (the split kernels size
    their grids by it)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


# the current stream's raw handle without a Stream object (the public
# `torch.cuda.current_stream(device).cuda_stream` where torch lacks it)
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_ptr(x: torch.Tensor) -> int:
    """The raw handle of the current CUDA stream on x's device, for the C
    entry points' `stream` argument."""
    if _RAW_STREAM is not None:
        return _RAW_STREAM(x.get_device())
    return torch.cuda.current_stream(x.device).cuda_stream


_SCRATCH: dict = {}
_RETIRED: list = []


def scratch(name: str, device: torch.device, n_floats: int, n_counters: int):
    """(work, counters): an fp32 workspace and int32 counters of at least
    these sizes, made once per (name, device) and grown as needed. The
    counters start at 0 and the kernels that use them leave them at 0, so
    no call memsets them. A buffer that is outgrown stays allocated, so a
    CUDA graph that captured it stays valid. The kernels of one `name` share
    them, so they run on one stream at a time."""
    key = (name, device)
    have = _SCRATCH.get(key)
    if have is None or have[0].numel() < n_floats or have[1].numel() < n_counters:
        if have is not None:
            _RETIRED.append(have)
            n_floats = max(n_floats, have[0].numel())
            n_counters = max(n_counters, have[1].numel())
        have = (torch.empty(max(n_floats, 1), dtype=torch.float32, device=device),
                torch.zeros(max(n_counters, 1), dtype=torch.int32, device=device))
        _SCRATCH[key] = have
    return have


def check_launch(rc: int, name: str):
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def check_aligned(name: str, **tensors):
    """Raise unless every tensor starts on a 16-byte boundary (the
    tensor-core kernels copy rows in 16-byte pieces)."""
    for n, x in tensors.items():
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: {n} must start on a 16-byte boundary")
