"""Command-line tools of the port: `tts` (text to codes and a WAV),
`batch_tts` (a job file through the serving engine), `codec` (audio to
codes and back) and `extract_vq` (a folder of audio to code files). Each
runs on `cuda:0`; `--cpu` is the only way to the CPU."""
