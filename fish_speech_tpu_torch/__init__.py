"""PyTorch/CUDA port of fish_speech_tpu for NVIDIA Hopper GPUs.

The JAX package `fish_speech_tpu` is the reference: each module here keeps
the name and the public layouts of its counterpart there, and the tests hold
the two to each other on the same weights. This package imports `torch` and
never `jax`, and nothing of the JAX package: it keeps its own copies of the
host modules it needs (`config`, `tokenizer`, `sequence`, `data/`,
`audio/io`, `utils/file`), and imports `tokenizer`/`sequence` only inside
the functions that encode text.

Every TPU kernel of the JAX package has a counterpart hand-written in CUDA
for `sm_90a` (`csrc/`: prefill, decode (bf16 and int8 K/V) and training
attention, the int4 matmul, the fast-stack probe), built at first use; on
CPU tensors their wrappers run the plain PyTorch versions beside them.
"""

__version__ = "0.1.0"
