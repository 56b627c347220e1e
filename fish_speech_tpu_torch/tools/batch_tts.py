"""Bulk offline synthesis through the continuous batcher, the port of
`fish_speech_tpu/tools/batch_tts.py`.

    python -m fish_speech_tpu_torch.tools.batch_tts \
        --input lines.tsv --output-dir out \
        --checkpoint-path checkpoints/s2-pro-tpu --int8 --pool-size 8

This drives the serving throughput path (pooled decode slots, grouped
admissions) for offline jobs (audiobook chapters, dataset generation,
ad-read variants): the engine is the server's (`server.main.build_engine`,
with the server's model and engine flags), on `cuda:0` unless `--cpu`.

Input: a `.tsv` (``id<TAB>text``) or `.jsonl` (``{"id", "text",
"reference_id"?, "seed"?}``) file. Output: ``<output-dir>/<id>.<format>``
per item plus a ``manifest.jsonl`` with per-item timing/status. Items
synthesize concurrently (`--workers`, default = pool size) so the batcher
keeps every decode slot full; failures are per-item (logged, recorded in
the manifest, exit code 1) and never abort the rest of the job.
"""

from __future__ import annotations

import argparse
import json
import logging
import queue
import re
import sys
import threading
import time
from pathlib import Path

logger = logging.getLogger("fish_speech_tpu_torch.batch_tts")

_ID_RE = re.compile(r"^[a-zA-Z0-9._\- ]+$")


def read_items(path: Path) -> list:
    """Parse the work list: tsv (`id\\ttext`) or jsonl rows."""
    items = []
    with open(path, encoding="utf-8") as f:
        for ln, raw in enumerate(f, 1):
            raw = raw.strip()
            if not raw or raw.startswith("#"):
                continue
            if path.suffix == ".jsonl":
                row = json.loads(raw)
                if "id" not in row or "text" not in row:
                    raise ValueError(f"{path}:{ln}: need 'id' and 'text'")
            else:
                if "\t" not in raw:
                    raise ValueError(f"{path}:{ln}: expected 'id<TAB>text'")
                item_id, text = raw.split("\t", 1)
                row = {"id": item_id.strip(), "text": text.strip()}
            if not _ID_RE.match(row["id"]):
                raise ValueError(
                    f"{path}:{ln}: id {row['id']!r} must match {_ID_RE.pattern}"
                    " (it becomes a filename)"
                )
            items.append(row)
    ids = [r["id"] for r in items]
    dupes = {i for i in ids if ids.count(i) > 1}
    if dupes:
        raise ValueError(f"duplicate ids (outputs would overwrite): {sorted(dupes)}")
    return items


def write_output(path: Path, audio, sr: int, fmt: str):
    import numpy as np

    from fish_speech_tpu_torch.audio import transcode
    from fish_speech_tpu_torch.audio.io import write_wav

    if fmt == "wav":
        write_wav(path, audio, sr)
    elif fmt == "pcm":
        pcm = (np.clip(audio, -1, 1) * 32767).astype("<i2")
        path.write_bytes(pcm.tobytes())
    else:
        path.write_bytes(transcode.encode_audio(audio, sr, fmt))


def run_job(engine, items, output_dir: Path, fmt: str, workers: int,
            max_new_tokens: int, default_seed) -> list:
    """Synthesize every item; returns manifest rows (order of completion)."""
    from fish_speech_tpu_torch.engine.tts import TTSRequest

    work: queue.Queue = queue.Queue()
    for i, row in enumerate(items):
        work.put((i, row))
    manifest = []
    mlock = threading.Lock()
    t_start = time.time()

    def worker():
        while True:
            try:
                i, row = work.get_nowait()
            except queue.Empty:
                return
            req = TTSRequest(
                text=row["text"],
                reference_id=row.get("reference_id"),
                use_memory_cache="on" if row.get("reference_id") else "off",
                seed=row.get("seed", default_seed),
                max_new_tokens=max_new_tokens,
            )
            t0 = time.time()
            entry = {"id": row["id"], "status": "ok"}
            try:
                final = None
                error = None
                for result in engine.inference(req):
                    if result.code == "final":
                        final = result
                    elif result.code == "error":
                        error = result
                if final is None:
                    raise RuntimeError(
                        str(error.error) if error else "no audio generated"
                    )
                sr, audio = final.audio
                out_path = output_dir / f"{row['id']}.{fmt}"
                write_output(out_path, audio, sr, fmt)
                entry["seconds_of_audio"] = round(len(audio) / sr, 3)
                entry["file"] = str(out_path)
            except Exception as e:  # per-item isolation: job keeps going
                logger.error("item %s failed: %s", row["id"], e)
                entry["status"] = "error"
                entry["error"] = str(e)
            entry["wall_s"] = round(time.time() - t0, 3)
            with mlock:
                manifest.append(entry)
                done = len(manifest)
            logger.info("[%d/%d] %s (%s, %.1fs)", done, len(items),
                        row["id"], entry["status"], entry["wall_s"])

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(max(workers, 1))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    wall = time.time() - t_start
    ok = [m for m in manifest if m["status"] == "ok"]
    audio_s = sum(m["seconds_of_audio"] for m in ok)
    logger.info(
        "done: %d ok / %d failed, %.1f s of audio in %.1f s wall (%.1fx realtime)",
        len(ok), len(manifest) - len(ok), audio_s, wall,
        audio_s / wall if wall > 0 else 0.0,
    )
    return manifest


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--input", type=Path, required=True,
                   help="tsv (id<TAB>text) or jsonl work list")
    p.add_argument("--output-dir", type=Path, required=True)
    p.add_argument("--format", default="wav",
                   choices=["wav", "pcm", "flac", "mp3", "opus"])
    p.add_argument("--workers", type=int, default=0,
                   help="concurrent requests (default: pool size)")
    p.add_argument("--max-new-tokens", type=int, default=1024)
    p.add_argument("--seed", type=int, default=42,
                   help="per-item default seed (jsonl rows may override)")
    # model/engine flags shared with the server entry (build_engine)
    p.add_argument("--checkpoint-path", type=Path,
                   default=Path("checkpoints/s2-pro-tpu"))
    p.add_argument("--decoder-checkpoint-path", type=Path, default=None)
    p.add_argument("--references-dir", default="references")
    p.add_argument("--pool-size", type=int, default=8,
                   help="continuous-batcher decode slots (1 = plain session)")
    p.add_argument("--decode-chunk-size", type=int, default=64)
    p.add_argument("--admit-every", type=int, default=4,
                   help="pooled decode sub-chunk length (0 = monolithic "
                        "chunks); see server --admit-every")
    p.add_argument("--int8", action="store_true")
    p.add_argument("--kv-int8", dest="kv_int8", action="store_true")
    p.add_argument("--prefix-cache", type=int, default=0)
    p.add_argument("--half", action="store_true",
                   help="fp16 LM and codec")
    p.add_argument("--tiny", action="store_true",
                   help="random tiny models (smoke tests/demos)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (else on cuda:0, or fail)")
    # the server's multi-host flags, which `build_engine` checks: not ported
    p.set_defaults(coordinator=None, num_hosts=None, host_id=None)
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    items = read_items(args.input)
    if not items:
        logger.info("work list is empty — nothing to do")
        return 0
    args.output_dir.mkdir(parents=True, exist_ok=True)

    if args.format not in ("wav", "pcm"):
        from fish_speech_tpu_torch.audio import transcode

        if args.format not in transcode.available_formats():
            p.error(f"format {args.format!r} has no encoder backend; "
                    f"available: {transcode.available_formats()}")

    from fish_speech_tpu_torch.server.main import build_engine

    engine = build_engine(args)
    workers = args.workers or max(args.pool_size, 1)
    manifest = run_job(engine, items, args.output_dir, args.format,
                       workers, args.max_new_tokens, args.seed)

    with open(args.output_dir / "manifest.jsonl", "w", encoding="utf-8") as f:
        for row in manifest:
            f.write(json.dumps(row) + "\n")
    return 1 if any(m["status"] != "ok" for m in manifest) else 0


if __name__ == "__main__":
    sys.exit(main())
