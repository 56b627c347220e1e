"""Command-line tools of the port: `tts` (text to codes and a WAV),
`batch_tts` (a job file through the serving engine), `codec` (audio to
codes and back), `extract_vq` (a folder of audio to code files),
`build_dataset` (code files and transcripts to protobuf shards),
`create_train_split` (train and val file lists), `quantize` (an int8 or
int4 checkpoint), `merge_lora` (a trainer's LoRA folded into a
checkpoint) and `parity_check` (the three parity gates, against a golden
file from either framework). The tools that compute run on `cuda:0`;
`--cpu` is the only way to the CPU. `build_dataset` and
`create_train_split` only read and write files."""
