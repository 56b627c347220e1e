"""Locale maintenance tool: scan the package for `i18n("...")` call sites
(The port's copy of `fish_speech_tpu/i18n/scan.py`.)
and reconcile every locale JSON against them (reference
`fish_speech/i18n/scan.py` — AST-based scanner + standalone-key cleaner).

Usage:
    python -m fish_speech_tpu_torch.i18n.scan            # report drift
    python -m fish_speech_tpu_torch.i18n.scan --write    # add missing / drop stale
"""

from __future__ import annotations

import argparse
import ast
import json
from pathlib import Path
from typing import Dict, Set

from fish_speech_tpu_torch.i18n.core import DEFAULT_LANGUAGE, I18N_FILE_PATH

PACKAGE_ROOT = Path(__file__).resolve().parents[1]


def extract_i18n_keys(source: str) -> Set[str]:
    """String literals passed as the sole argument to a call of a callable
    named `i18n` (``i18n("...")``) anywhere in `source`."""
    keys: Set[str] = set()
    tree = ast.parse(source)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        name = fn.id if isinstance(fn, ast.Name) else (
            fn.attr if isinstance(fn, ast.Attribute) else None
        )
        if name != "i18n" or len(node.args) != 1:
            continue
        arg = node.args[0]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            keys.add(arg.value)
    return keys


def scan_package(root: Path = PACKAGE_ROOT) -> Set[str]:
    keys: Set[str] = set()
    for py in sorted(root.rglob("*.py")):
        if "__pycache__" in py.parts:
            continue
        try:
            keys |= extract_i18n_keys(py.read_text(encoding="utf-8"))
        except SyntaxError:
            pass
    return keys


def reconcile(keys: Set[str], write: bool = False) -> Dict[str, dict]:
    """Compare every locale file against the scanned key set.

    Returns {locale: {"missing": [...], "stale": [...]}}. With write=True,
    missing keys are added (value = key for en_US, empty otherwise) and
    stale keys removed, preserving sorted order.
    """
    report: Dict[str, dict] = {}
    for path in sorted(I18N_FILE_PATH.glob("*.json")):
        lang = path.stem
        data = json.loads(path.read_text(encoding="utf-8"))
        missing = sorted(keys - set(data))
        stale = sorted(set(data) - keys)
        report[lang] = {"missing": missing, "stale": stale}
        if write and (missing or stale):
            for k in stale:
                del data[k]
            for k in missing:
                data[k] = k if lang == DEFAULT_LANGUAGE else ""
            path.write_text(
                json.dumps(dict(sorted(data.items())), ensure_ascii=False,
                           indent=2) + "\n",
                encoding="utf-8",
            )
    return report


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--write", action="store_true",
                        help="update locale files in place")
    args = parser.parse_args(argv)
    keys = scan_package()
    print(f"found {len(keys)} i18n keys in {PACKAGE_ROOT}")
    report = reconcile(keys, write=args.write)
    clean = True
    for lang, r in report.items():
        if r["missing"] or r["stale"]:
            clean = False
            print(f"{lang}: +{len(r['missing'])} missing, "
                  f"-{len(r['stale'])} stale")
    if clean:
        print("all locale files in sync")
    return 0 if (clean or args.write) else 1


if __name__ == "__main__":
    raise SystemExit(main())
