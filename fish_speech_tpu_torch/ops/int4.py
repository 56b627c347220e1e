"""int4 group-wise weight-only matmul: y = x @ W, W packed two per byte.

Port of the Pallas TPU kernel `fish_speech_tpu/ops/pallas_int4.py`
(`_int4_mm_kernel` / `int4_matmul`). Layout (per 2D weight, see
`ops/quant.py`):

  p:  (I/2, O) uint8 -- low nibble = row i, high nibble = row i + I/2, +8
  gs: (I/g, O) fp32  -- group scales over the original row index

and a group never straddles the half split: (I/2) % g == 0.

The kernel is hand-written CUDA for Hopper (`csrc/int4_mm.cu`): it reads
the packed bytes once, coalesced along O, unpacks both nibbles and
dequantizes in fp32 with the group's scale, accumulates in fp32 and writes
x's dtype. `int4_matmul_reference` is the plain version (the JAX package's
`int4_matmul_reference`: fp32 product of the unpacked weight); the wrapper
runs it for CPU tensors only, and for a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from fish_speech_tpu_torch.ops._kernels import (DTYPE_CODES, check_launch,
                                                 load_kernels)

GEMV_MAX_ROWS = 8  # rows of x up to which the split-K matvec kernel runs


def _group(i: int, n_groups: int) -> int:
    g = i // n_groups
    if g * n_groups != i or (i // 2) % g:
        raise ValueError(f"int4_matmul: {n_groups} groups over I={i} straddle "
                         f"the half split ((I/2) % g must be 0)")
    return g


def int4_matmul_reference(x, p, gs):
    """x (B, I) @ the unpacked weight (I, O), in fp32, cast to x's dtype."""
    half = p.shape[-2]
    _group(2 * half, gs.shape[-2])
    lo = (p & 0xF).to(torch.int8) - 8
    hi = (p >> 4).to(torch.int8) - 8
    q = torch.cat([lo, hi], dim=-2)
    g = q.shape[-2] // gs.shape[-2]
    w = q.float() * torch.repeat_interleave(gs.float(), g, dim=-2)
    return (x.float() @ w).to(x.dtype)


def _check(x, p, gs):
    if not (x.is_cuda and p.device == x.device and gs.device == x.device):
        raise ValueError("int4_matmul: x, p and gs must lie on one CUDA device")
    if x.dtype not in DTYPE_CODES or p.dtype != torch.uint8 or gs.dtype != torch.float32:
        raise TypeError(f"int4_matmul: x bf16/fp32, p uint8, gs fp32; got "
                        f"{x.dtype}/{p.dtype}/{gs.dtype}")
    if x.dim() != 2 or p.dim() != 2 or gs.dim() != 2:
        raise ValueError("int4_matmul: x (B, I), p (I/2, O), gs (I/g, O)")
    b, i = x.shape
    half, o = p.shape
    if 2 * half != i or gs.shape[1] != o:
        raise ValueError(f"int4_matmul: shapes x {tuple(x.shape)}, p "
                         f"{tuple(p.shape)}, gs {tuple(gs.shape)} disagree")
    for name, t in (("x", x), ("p", p), ("gs", gs)):
        if not t.is_contiguous():
            raise ValueError(f"int4_matmul: {name} must be contiguous")
    return b, i, o, _group(i, gs.shape[0])


def int4_matmul(x, p, gs):
    """x (B, I) bf16/fp32 @ packed int4 W -> (B, O) in x's dtype. On CUDA
    tensors runs the hand-written kernel (a split-K matvec for B <= 8, a
    tiled product for larger B)."""
    if x.device.type == "cpu":
        return int4_matmul_reference(x, p, gs)
    b, i, o, g = _check(x, p, gs)
    lib = load_kernels()
    out = torch.empty((b, o), dtype=x.dtype, device=x.device)
    n_split = (i // 2) // g
    part = (torch.empty((n_split, b, o), dtype=torch.float32, device=x.device)
            if b <= GEMV_MAX_ROWS else out)
    rc = lib.fs_int4_matmul(
        x.data_ptr(), p.data_ptr(), gs.data_ptr(), out.data_ptr(),
        part.data_ptr(), b, i, o, g, DTYPE_CODES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    check_launch(rc, "int4_matmul")
    int4_matmul.launches += 1
    return out


int4_matmul.launches = 0
