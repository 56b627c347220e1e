"""Brace expansion of data paths (`data/shard_{000..009}.protos`).

Copy of `braceexpand` from `fish_speech_tpu/utils/file.py`, kept here so the
port never imports the JAX package. Supports lists {a,b,c} and ranges
{1..9} (zero-padded when a bound is), nested.
"""

from __future__ import annotations

import re
from typing import Iterator

_RANGE_RE = re.compile(r"^(-?\d+)\.\.(-?\d+)(?:\.\.(-?\d+))?$")


def braceexpand(pattern: str) -> Iterator[str]:
    start = pattern.find("{")
    if start == -1:
        yield pattern
        return
    depth = 0
    for i in range(start, len(pattern)):
        if pattern[i] == "{":
            depth += 1
        elif pattern[i] == "}":
            depth -= 1
            if depth == 0:
                end = i
                break
    else:
        yield pattern
        return

    prefix, body, suffix = pattern[:start], pattern[start + 1 : end], pattern[end + 1 :]

    m = _RANGE_RE.match(body)
    if m:
        lo, hi = int(m.group(1)), int(m.group(2))
        step = int(m.group(3)) if m.group(3) else (1 if hi >= lo else -1)
        stop = hi + (1 if step > 0 else -1)
        width = None
        if m.group(1).lstrip("-").startswith("0") or m.group(2).lstrip("-").startswith("0"):
            width = max(len(m.group(1).lstrip("-")), len(m.group(2).lstrip("-")))
        options = [
            (f"{abs(v):0{width}d}" if width else str(abs(v)))
            if v >= 0 else "-" + (f"{abs(v):0{width}d}" if width else str(abs(v)))
            for v in range(lo, stop, step)
        ]
    else:
        # split on top-level commas
        options, buf, depth = [], "", 0
        for ch in body:
            if ch == "{":
                depth += 1
            elif ch == "}":
                depth -= 1
            if ch == "," and depth == 0:
                options.append(buf)
                buf = ""
            else:
                buf += ch
        options.append(buf)
        if len(options) == 1:  # not a real brace list
            for rest in braceexpand(suffix):
                yield prefix + "{" + body + "}" + rest
            return

    for opt in options:
        for expanded_opt in braceexpand(opt):
            for rest in braceexpand(suffix):
                yield prefix + expanded_opt + rest
