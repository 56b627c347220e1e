"""ctypes bindings for the native shard parser, with transparent fallback
(the port's copy of `fish_speech_tpu/native/loader.py`).

`fast_read_shard(path)` returns a list of parsed records:
  {"sentences": [{"text": str, "semantics": np.ndarray (rows, T) int32}]}
matching what the Python-protobuf path produces, several times faster on the
single-core dataloader hosts. The first call builds the library if g++ is
available (`native.build_pb`, into `native.build_dir()`); otherwise callers
fall back to `data.stream.read_pb_stream`.
"""

from __future__ import annotations

import ctypes
import logging
from pathlib import Path
from typing import List, Optional

import numpy as np

logger = logging.getLogger(__name__)

_lib = None
_tried = False


def load_library() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        from fish_speech_tpu_torch.native import build_pb

        lib_path = build_pb()
        lib = ctypes.CDLL(str(lib_path))
        lib.fs_index_records.restype = ctypes.c_int64
        lib.fs_index_records.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
        ]
        lib.fs_parse_shard.restype = ctypes.c_int32
        lib.fs_parse_shard.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,   # values
            ctypes.POINTER(ctypes.c_int64),                   # row_starts
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,   # row_sentence
            ctypes.POINTER(ctypes.c_int64),                   # sent_record
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,   # text_spans
            ctypes.POINTER(ctypes.c_int64),                   # out_counts
        ]
        _lib = lib
    except Exception as e:  # no g++ / build failure -> python fallback
        logger.info("native parser unavailable (%s); using protobuf", e)
        _lib = None
    return _lib


def fast_parse_available() -> bool:
    return load_library() is not None


def _i64(n):
    return (ctypes.c_int64 * n)()


def _i32(n):
    return (ctypes.c_int32 * n)()


def parse_shard_flat(path):
    """One C call parses the whole shard into flat arrays.

    Returns (data bytes, dict of numpy arrays): values, row_starts,
    row_sentence, sent_record, text_spans, counts. Sentence matrices are
    materialized lazily by callers (the dataset only touches sampled
    sentences).
    """
    lib = load_library()
    if lib is None:
        raise RuntimeError("native parser not available")

    data = Path(path).read_bytes()
    buf = ctypes.create_string_buffer(data, len(data))

    val_cap = max(len(data), 4096)  # values can't outnumber input bytes
    row_cap = max(len(data) // 8, 1024)
    sent_cap = max(len(data) // 16, 1024)
    while True:
        values = _i32(val_cap)
        row_starts = _i64(row_cap + 1)
        row_sentence = _i64(row_cap)
        sent_record = _i64(sent_cap)
        text_spans = _i64(2 * sent_cap)
        counts = _i64(4)
        rc = lib.fs_parse_shard(
            buf, len(data), values, val_cap, row_starts, row_sentence,
            row_cap, sent_record, text_spans, sent_cap, counts,
        )
        if rc == 0:
            break
        if rc == -3:
            val_cap *= 2
            row_cap *= 2
            sent_cap *= 2
            continue
        raise ValueError(f"native parse error {rc} in {path}")

    n_rec, n_sent, n_rows, n_vals = (int(counts[i]) for i in range(4))
    flat = {
        "n_records": n_rec,
        "values": np.frombuffer(values, dtype=np.int32, count=n_vals),
        "row_starts": np.frombuffer(row_starts, dtype=np.int64, count=n_rows + 1),
        "row_sentence": np.frombuffer(row_sentence, dtype=np.int64, count=n_rows),
        "sent_record": np.frombuffer(sent_record, dtype=np.int64, count=n_sent),
        "text_spans": np.frombuffer(text_spans, dtype=np.int64, count=2 * n_sent),
    }
    # rows are emitted grouped by sentence (wire order) -> contiguous ranges
    flat["sent_row_start"] = np.searchsorted(
        flat["row_sentence"], np.arange(n_sent), side="left"
    )
    flat["sent_row_end"] = np.searchsorted(
        flat["row_sentence"], np.arange(n_sent), side="right"
    )
    return data, flat


def materialize_sentence(data: bytes, flat: dict, s: int) -> dict:
    """Build {"text", "semantics"} for global sentence index s."""
    starts = flat["row_starts"]
    r0 = int(flat["sent_row_start"][s])
    r1 = int(flat["sent_row_end"][s])
    if r1 > r0:
        lens = starts[r0 + 1 : r1 + 1] - starts[r0:r1]
        t = int(lens.min())
        base = starts[r0:r1]
        idx = base[:, None] + np.arange(t)[None, :]
        sem = flat["values"][idx].astype(np.int32)
    else:
        sem = np.zeros((0, 0), np.int32)
    toff = int(flat["text_spans"][2 * s])
    tlen = int(flat["text_spans"][2 * s + 1])
    text = (
        data[toff : toff + tlen].decode("utf-8", "replace") if toff >= 0 else ""
    )
    return {"text": text, "semantics": sem}


def fast_read_shard(path) -> List[dict]:
    """Eagerly materialized convenience API (tests/small shards)."""
    data, flat = parse_shard_flat(path)
    records = [{"sentences": []} for _ in range(flat["n_records"])]
    for s in range(len(flat["sent_record"])):
        records[int(flat["sent_record"][s])]["sentences"].append(
            materialize_sentence(data, flat, s)
        )
    return records
