"""The tensor-parallel collectives of the sharded model, as autograd
functions (Megatron's f and g), so that one sharded forward serves decoding
and `forward_train` alike.

Every function takes the tp `Axis` of the stack or table it serves, or None
outside a mesh (or for a part that stays whole): then it returns its input
untouched, so the unsharded model is what it was. Activations between the
blocks are replicated over tp; a replicated tensor that feeds a split
product passes `copy_to_tp`, whose backward sums the ranks' partial
gradients, so every replicated parameter gets the whole gradient on every
rank. Without autograd (decoding, CUDA graphs) each is one plain
collective, or none.
"""

from __future__ import annotations

import torch


def _grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_reduce(g.clone()), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return axis.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis, ctx.n = axis, x.shape[-1]
        return axis.all_gather(x, dim=-1)

    @staticmethod
    def backward(ctx, g):
        r = ctx.axis.rank
        return g[..., r * ctx.n:(r + 1) * ctx.n].contiguous(), None


class _SliceReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, dim, idx, axis):
        ctx.dim, ctx.idx, ctx.axis, ctx.shape = dim, idx, axis, w.shape
        return w.index_select(dim, idx)

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        full.index_copy_(ctx.dim, ctx.idx, g)
        return ctx.axis.all_reduce(full), None, None, None


def copy_to_tp(x, axis):
    """f: identity forward; backward, the sum of the ranks' gradients."""
    if axis is None or not _grad(x):
        return x
    return _CopyToTP.apply(x, axis)


def reduce_from_tp(x, axis):
    """g: the sum of the ranks' partials forward; identity backward.
    Without autograd it sums `x` in place (pass a fresh result)."""
    if axis is None:
        return x
    if not _grad(x):
        return axis.all_reduce(x)
    return _ReduceFromTP.apply(x, axis)


def gather_from_tp(x, axis):
    """Every rank's last-axis columns concatenated in rank order (the
    column-parallel heads' logits); backward, this rank's columns."""
    if axis is None:
        return x
    if not _grad(x):
        return axis.all_gather(x, dim=-1)
    return _GatherFromTP.apply(x, axis)


def slice_replicated(w, dim: int, idx, axis):
    """This rank's positions `idx` of a replicated tensor `w` along `dim`
    (a LoRA factor of a split product); backward, the ranks' gradients
    summed into the whole shape, so the replicated leaf's gradient is whole
    on every rank."""
    if axis is None:
        return w
    if not _grad(w):
        return w.index_select(dim, idx)
    return _SliceReplicated.apply(w, dim % w.dim(), idx, axis)
