"""The collectives the port's modules call over a mesh's groups.

Under a mesh every rank of a seq group computes the same activations
(replicated), and each data rank its own rows. The differentiable ones
follow from that:
- `all_reduce_sum`: y = sum over the group of x; its gradient is the
  sum of the ranks' gradients of y (BatchNorm's statistics over `data`);
- `sum_gradients`: identity forward; backward sums the gradients over
  the group, for a replicated input each rank uses only part of (the
  queries of its block, its share of the keys and of the table);
- `gather_blocks`: all-gather of each rank's block along an axis; its
  gradient is this rank's block of the (replicated) output gradient.
The rest are not differentiable: rows gathered over `data`, means and
minima of values every data rank holds its share of.

Each call runs the collective even on a group of one rank, so a run at
world size 1 goes through every call site.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _flat32(tensors):
    return torch.cat([t.reshape(-1).float() for t in tensors])


def _all_gather(x, group):
    """[n * x.shape[0], ...]: the ranks' x stacked along axis 0, in rank order."""
    x = x.contiguous()
    out = x.new_empty((dist.get_world_size(group), *x.shape))
    dist.all_gather(list(out.unbind(0)), x, group=group)
    return out.reshape(-1, *x.shape[1:])


def _unflatten(flat, like):
    parts = flat.split([t.numel() for t in like])
    return [p.view_as(t).to(t.dtype) for p, t in zip(parts, like)]


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over the group, on every rank; differentiable."""
    return _AllReduceSum.apply(x, group)


class _SumGradients(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        # one all-reduce for all of them, summed in float32
        flat = _flat32(grads)
        dist.all_reduce(flat, group=ctx.group)
        return (None, *_unflatten(flat, grads))


def sum_gradients(tensors, group):
    """The tensors unchanged; their gradients are summed over the group
    (each rank contributes the part it computed)."""
    return _SumGradients.apply(group, *tensors)


class _GatherBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.block = group, dim, x.shape[dim]
        ctx.rank = dist.get_rank(group)
        return _all_gather(x.movedim(dim, 0), group).movedim(0, dim)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.rank * ctx.block
        return grad.narrow(ctx.dim, lo, ctx.block).contiguous(), None, None


def gather_blocks(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """The ranks' blocks of x concatenated along `dim`, in rank order, on
    every rank; the gradient flows back to this rank's block."""
    return _GatherBlocks.apply(x, group, dim)


@torch.no_grad()
def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' rows of x concatenated along axis 0, in rank order."""
    return _all_gather(x, group)


@torch.no_grad()
def average_(tensors, group):
    """Replace each tensor by its mean over the group, in place, through
    one all-reduce of a flat float32 buffer."""
    tensors = list(tensors)
    flat = _flat32(tensors)
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    for t, part in zip(tensors, _unflatten(flat, tensors)):
        t.copy_(part)
    return tensors


@torch.no_grad()
def minimum(x: torch.Tensor, group) -> torch.Tensor:
    """The least of x's value over the group (x a 0-d tensor), on the device."""
    x = x.float().clone()
    dist.all_reduce(x, op=dist.ReduceOp.MIN, group=group)
    return x
