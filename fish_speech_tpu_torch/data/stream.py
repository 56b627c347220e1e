"""Length-prefixed protobuf stream I/O (wire-compatible with the reference's
`text_data_stream.py`: 4-byte little-endian size + message bytes).

Kept in the port as its own copy of `fish_speech_tpu/data/stream.py`, so the port
never imports the JAX package; the tests hold the two to each other.
"""

from __future__ import annotations

import struct

from fish_speech_tpu_torch.data.protos import TextData


def read_pb_stream(f):
    while True:
        head = f.read(4)
        if len(head) == 0:
            break
        size = struct.unpack("I", head)[0]
        buf = f.read(size)
        text_data = TextData()
        text_data.ParseFromString(buf)
        yield text_data


def write_pb_stream(f, text_data):
    buf = text_data.SerializeToString()
    f.write(struct.pack("I", len(buf)))
    f.write(buf)


def pack_pb_stream(text_data) -> bytes:
    buf = text_data.SerializeToString()
    return struct.pack("I", len(buf)) + buf


def split_pb_stream(f):
    """Yield raw (header+body) record bytes without parsing."""
    while True:
        head = f.read(4)
        if len(head) == 0:
            break
        size = struct.unpack("I", head)[0]
        yield head + f.read(size)
