"""Command-line tools of the port: `tts` (text to codes and a WAV),
`batch_tts` (a job file through the serving engine), `codec` (audio to
codes and back), `extract_vq` (a folder of audio to code files),
`build_dataset` (code files and transcripts to protobuf shards),
`create_train_split` (train and val file lists), `quantize` (an int8 or
int4 checkpoint), `merge_lora` (a trainer's LoRA folded into a
checkpoint), `parity_check` (the three parity gates, against a golden
file from either framework), `eval_quality` (a manifest through the
serving engine: WER/CER and speaker-SIM, the opt-in flags' A/B),
`eval_in_context` (per-frame in-context losses), `api_client` (the HTTP
API's client, with `playback`) and `run_webui` (the server with its UI).
The tools that compute run on `cuda:0`; `--cpu` is the only way to the
CPU. `build_dataset`, `create_train_split` and `api_client` only read and
write files or talk HTTP."""
