"""Megatron's collectives for tensor-parallel layers, as autograd functions.

XLA inserts these from the reference's shardings (ray_tpu/models/
transformer.py, `param_shardings`); eager torch makes them by hand. With
`group=None` (no tensor axis, or one of size 1) each is the identity.

- `copy_to`: identity forward, all-reduce backward (Megatron's f), before a
  column-parallel product, whose input gradient is partial on each rank;
- `reduce_from`: all-reduce forward, identity backward (Megatron's g),
  after a row-parallel product, whose output is a partial sum;
- `gather_from`: all-gather forward along a dim; the backward takes this
  rank's slice, because every rank then computes the same function of the
  gathered whole and so holds the whole gradient already.
"""

from __future__ import annotations

import torch


def _size(group) -> int:
    import torch.distributed as dist

    return 1 if group is None else dist.get_world_size(group)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim: int):
        import torch.distributed as dist

        ctx.rank, ctx.dim, ctx.n = dist.get_rank(group), dim, x.shape[dim]
        parts = [torch.empty_like(x.contiguous()) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None


def copy_to(x, group):
    return x if _size(group) == 1 else _CopyTo.apply(x, group)


def reduce_from(x, group):
    return x if _size(group) == 1 else _ReduceFrom.apply(x, group)


def gather_from(x, group, dim: int):
    return x if _size(group) == 1 else _GatherFrom.apply(x, group, dim)


@torch.no_grad()
def all_reduce_(tensors, group, scale: float = 1.0) -> None:
    """Sum each tensor over `group` in place (one flat all-reduce), then
    multiply by `scale`."""
    import torch.distributed as dist

    tensors = list(tensors)
    if _size(group) == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    if scale != 1.0:
        flat.mul_(scale)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
