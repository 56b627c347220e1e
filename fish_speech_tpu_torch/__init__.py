"""PyTorch/CUDA port of fish_speech_tpu for NVIDIA Hopper GPUs.

The JAX package `fish_speech_tpu` is the reference: each module here keeps
the name and the public layouts of its counterpart there, and the tests hold
the two to each other on the same weights. This package imports `torch` and
never `jax`; from the JAX package it imports only the host modules that are
free of jax (`config`, `tokenizer`, `sequence`, `audio.io`,
`utils.textseg`, `convert.*`), and `tokenizer`/`sequence` only inside the
functions that encode text.

The two attention kernels of the main path are hand-written CUDA for
`sm_90a` (`csrc/`), built at first use; on CPU tensors their wrappers run
the plain PyTorch versions beside them.
"""

__version__ = "0.1.0"
