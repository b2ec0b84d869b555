"""Ulysses-style sequence parallelism: all-to-all head/sequence exchange.

Port of ray_tpu/parallel/ulysses.py. Instead of rotating K/V blocks, one
all-to-all (`dist.all_to_all_single`) regathers the full sequence while
splitting heads across the group, each rank runs attention on its head
subset through `mha` (the flash kernels on the card), and a second
all-to-all restores sequence sharding. Better when heads >= the group size
and all-to-all bandwidth is plentiful; ring wins on very long sequences.
`ulysses_attention_on_group` runs it over a collective group's process
group (its engine, ray_tpu_torch/util/collective/mesh_ops.py).
"""

from __future__ import annotations

from typing import Optional

import torch

from ray_tpu_torch.ops.flash_attention import mha


def _all_to_all(x, group, split_dim: int, concat_dim: int, wait=None):
    """Split `split_dim` into the group's size, send piece j to rank j, and
    concatenate the pieces received along `concat_dim` in rank order
    (jax.lax.all_to_all(..., tiled=True)). `wait(work, what)` waits on the
    exchange (a collective group's death watch); None waits plainly."""
    import torch.distributed as dist

    n = 1 if group is None else dist.get_world_size(group)
    if n == 1:
        return x
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not split over {n} ranks")
    pieces = x.movedim(split_dim, 0)
    pieces = pieces.reshape(n, pieces.shape[0] // n, *pieces.shape[1:]).contiguous()
    got = torch.empty_like(pieces)
    work = dist.all_to_all_single(got, pieces, group=group, async_op=True)
    if wait is None:
        work.wait()
    else:
        wait(work, "ulysses_attention")
    return torch.cat([p.movedim(0, split_dim) for p in got.unbind(0)], dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    """`_all_to_all` whose backward is the inverse all-to-all."""

    @staticmethod
    def forward(ctx, x, group, split_dim: int, concat_dim: int, wait=None):
        ctx.group, ctx.split_dim, ctx.concat_dim, ctx.wait = group, split_dim, concat_dim, wait
        return _all_to_all(x, group, split_dim, concat_dim, wait)

    @staticmethod
    def backward(ctx, g):
        return (_all_to_all(g, ctx.group, ctx.concat_dim, ctx.split_dim, ctx.wait),
                None, None, None, None)


def ulysses_attention(q, k, v, group=None, causal: bool = False, scale: Optional[float] = None,
                      impl: str = "auto", wait=None):
    """q/k/v: [B, T_local, H, D] local shards, sequence sharded over `group`
    (None: one shard); H (and the kv heads) divisible by the group size.
    `impl` is mha's; `wait(work, what)` waits on each all-to-all (None:
    plainly). Returns [B, T_local, H, D]."""
    # [B, T/N, H, D] -> [B, T, H/N, D]
    q2, k2, v2 = (_AllToAll.apply(t, group, 2, 1, wait) for t in (q, k, v))
    out = mha(q2, k2, v2, causal=causal, scale=scale, impl=impl)
    # [B, T, H/N, D] -> [B, T/N, H, D]
    return _AllToAll.apply(out, group, 1, 2, wait)


def ulysses_attention_on_group(q, k, v, causal: bool = False, group_name: str = "default"):
    """Ulysses attention over a collective group (nccl or gloo backend), the
    shards as in ring_attention_on_group; heads divisible by the group's
    size."""
    from ray_tpu_torch.util.collective import get_group_collectives

    eng = get_group_collectives(group_name)
    if eng is None:
        raise ValueError(
            f"group {group_name!r} has no mesh engine (nccl or gloo backend required)"
        )
    return eng.ulysses_attention(q, k, v, causal=causal)


def ulysses_attention_sharded(q, k, v, mesh, causal: bool = False, seq_axis: str = "sequence",
                              batch_axes=("data", "fsdp"), impl: str = "auto"):
    """Global view: q/k/v are the whole [B, T, H, D], the same on every rank
    of `mesh`; this rank's block (batch over `batch_axes`, sequence over
    `seq_axis`) goes through Ulysses over `seq_axis`, and that block of the
    output comes back."""
    from ray_tpu_torch.parallel.mesh import axis_group, shard_of

    present = set(mesh.mesh_dim_names)
    dims = {0: tuple(a for a in batch_axes if a in present),
            1: (seq_axis,) if seq_axis in present else ()}
    q, k, v = (shard_of(mesh, t, dims) for t in (q, k, v))
    group = axis_group(mesh, seq_axis) if seq_axis in present else None
    return ulysses_attention(q, k, v, group, causal=causal, impl=impl)
