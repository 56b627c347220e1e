"""Modded-DAC codec, decode half, in PyTorch (port of
`fish_speech_tpu/models/dac/`). Channels-last (B, T, C) at every public
function, like the JAX package; conv weights in torch layout (see
`fish_speech_tpu_torch/convert/from_jax.py`)."""
