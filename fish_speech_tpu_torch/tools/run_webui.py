"""Web UI launcher (reference `tools/run_webui.py`), the port of
`fish_speech_tpu/tools/run_webui.py`: starts the port's API server
(`server.main`, on `cuda:0` unless `--cpu`) with the built-in browser UI
at /ui, on 127.0.0.1:7860 unless `--listen` is given.

    python -m fish_speech_tpu_torch.tools.run_webui --checkpoint-path ...
"""

from __future__ import annotations

import sys


def main():
    # The UI is served by the API server; this launcher exists for CLI parity
    # with the reference and defaults to opening on all interfaces.
    from fish_speech_tpu_torch.server.main import main as server_main

    argv = sys.argv[1:]
    if not any(a.startswith("--listen") for a in argv):
        argv += ["--listen", "127.0.0.1:7860"]
    print("Open http://127.0.0.1:7860/ui in your browser", file=sys.stderr)
    server_main(argv)


if __name__ == "__main__":
    main()
