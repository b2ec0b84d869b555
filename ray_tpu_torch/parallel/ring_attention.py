"""Ring attention: exact attention over a sequence-sharded axis.

Port of ray_tpu/parallel/ring_attention.py. Each rank of the sequence group
keeps its Q chunk while the K/V chunks rotate around the ring
(`dist.batch_isend_irecv`), so after S hops every Q chunk has met every K/V
chunk; chunk r holds global positions [r*T, (r+1)*T).

Two routes share the hop schedule:

- plain (CPU tensors): the reference's f32 online softmax, every hop masked
  in global positions;
- kernel (CUDA tensors): with chunks of equal length the global causal
  mask of a hop is one of three cases: all visible (an earlier chunk),
  the local diagonal (its own chunk) or empty (a later chunk, skipped). So
  each hop is one flash forward with LSE (B2), causal on the diagonal, and
  the hops merge by their LSE; the backward runs B3 and B4 per hop with the
  GLOBAL LSE and delta = rowsum(dO * O) of the merged output, which is what
  the kernels take, so they need no offset. In f32 each hop's q, k, v and
  dO are split into their bf16 parts once, for both backward kernels.

The backward is a custom autograd function: the dK/dV accumulators travel
around the ring with K/V and reach their owner after S hops. The hop math
is apart from the transport: `_GroupRing` rotates over a process group,
`_LoopbackRing` runs all S shards of one tensor in this process by list
indexing, the same math without a second rank. `ring_attention_on_group`
runs the ring over a collective group's process group (its engine,
ray_tpu_torch/util/collective/mesh_ops.py).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ray_tpu_torch.ops.flash_attention import (
    _to_bhtd,
    flash_bwd_dkv,
    flash_bwd_dkv_parts,
    flash_bwd_dq,
    flash_bwd_dq_parts,
    flash_fwd,
    kernel_width,
    parts_route,
    split_parts,
)

_BIG_NEG = -1e30


class _GroupRing:
    """The ring of a process group: this process holds one shard, and a
    rotation hands each tensor to the next rank. `wait(work, what)` waits
    on each transfer (a collective group's death watch); None waits
    plainly."""

    def __init__(self, group, wait=None):
        import torch.distributed as dist

        self.group = group
        self.wait = wait
        self.size = 1 if group is None else dist.get_world_size(group)
        self.ranks = [0 if group is None else dist.get_rank(group)]

    def split(self, x):
        return [x]

    def join(self, xs):
        return xs[0]

    def rotate(self, *lists):
        """Each list holds this rank's tensor; returns the previous rank's."""
        if self.size == 1:
            return lists
        import torch.distributed as dist

        r = self.ranks[0]
        nxt = dist.get_global_rank(self.group, (r + 1) % self.size)
        prv = dist.get_global_rank(self.group, (r - 1) % self.size)
        ops, outs = [], []
        for tag, (t,) in enumerate(lists):
            got = torch.empty_like(t)
            ops += [dist.P2POp(dist.isend, t.contiguous(), nxt, self.group, tag),
                    dist.P2POp(dist.irecv, got, prv, self.group, tag)]
            outs.append([got])
        for work in dist.batch_isend_irecv(ops):
            if self.wait is None:
                work.wait()
            else:
                self.wait(work, "ring_attention")
        return tuple(outs)


class _LoopbackRing:
    """All `size` shards of a tensor (split on dim 1) in this process; a
    rotation hands shard r the tensor of shard r - 1 by indexing."""

    def __init__(self, size: int):
        self.size = size
        self.ranks = list(range(size))

    def split(self, x):
        if x.shape[1] % self.size:
            raise ValueError(f"length {x.shape[1]} does not split into {self.size} shards")
        return [c.contiguous() for c in x.chunk(self.size, dim=1)]

    def join(self, xs):
        return torch.cat(xs, dim=1)

    def rotate(self, *lists):
        return tuple([lst[(r - 1) % self.size] for r in self.ranks] for lst in lists)


def _hop_case(rank: int, src: int, causal: bool) -> str:
    """The global causal mask of chunk `src`'s keys for chunk `rank`'s
    queries: "full", "diag" (the local causal mask) or "skip" (empty)."""
    if not causal or src < rank:
        return "full"
    return "diag" if src == rank else "skip"


def _positions(chunk: int, T: int, device) -> torch.Tensor:
    return chunk * T + torch.arange(T, device=device)


def _plain_hop(q, k, v, state, q_pos, k_pos, causal: bool, scale: float):
    """One step of the reference's online softmax (f32, global mask)."""
    o, m, l = state
    s = torch.einsum("btd,bsd->bts", q.float(), k.float()) * scale
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]
        s = s.masked_fill(~mask, _BIG_NEG)
    m_new = torch.maximum(m, s.amax(-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    if causal:
        p = p.masked_fill(~mask, 0.0)
    l = l * alpha + p.sum(-1)
    o = o * alpha[..., None] + torch.einsum("bts,bsd->btd", p, v.float())
    return o, m_new, l


def _plain_hop_bwd(q, k, v, do, lse, delta, q_pos, k_pos, causal: bool, scale: float):
    """(dq, dk, dv) of one hop in f32, from the global lse and delta."""
    s = torch.einsum("btd,bsd->bts", q.float(), k.float()) * scale
    if causal:
        s = s.masked_fill(~(q_pos[:, None] >= k_pos[None, :]), -math.inf)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("btd,bsd->bts", do.float(), v.float())
    ds = p * (dp - delta[..., None]) * scale
    return (torch.einsum("bts,bsd->btd", ds, k.float()),
            torch.einsum("bts,btd->bsd", ds, q.float()),
            torch.einsum("bts,btd->bsd", p, do.float()))


def _merge(o, lse, o_h, lse_h):
    """Two partial softmax outputs (normalised, f32 o) into one by their LSE."""
    lse_new = torch.logaddexp(lse, lse_h)
    return (o * torch.exp(lse - lse_new)[..., None]
            + o_h.float() * torch.exp(lse_h - lse_new)[..., None]), lse_new


def _ring_fwd(ring, qs, ks, vs, causal: bool, scale: float, impl: str):
    """Per held shard: (o in q's dtype, lse [BH, T] f32)."""
    S, T, dev = ring.size, qs[0].shape[1], qs[0].device
    if impl == "plain":
        states = [(torch.zeros(q.shape, dtype=torch.float32, device=dev),
                   torch.full(q.shape[:2], _BIG_NEG, dtype=torch.float32, device=dev),
                   torch.zeros(q.shape[:2], dtype=torch.float32, device=dev)) for q in qs]
    else:
        states = [None] * len(qs)
    for s in range(S):
        for i, r in enumerate(ring.ranks):
            src = (r - s) % S
            if impl == "plain":
                states[i] = _plain_hop(qs[i], ks[i], vs[i], states[i], _positions(r, T, dev),
                                       _positions(src, T, dev), causal, scale)
                continue
            case = _hop_case(r, src, causal)
            if case == "skip":
                continue
            o_h, lse_h = flash_fwd(qs[i], ks[i], vs[i], causal=case == "diag", scale=scale,
                                   with_lse=True)
            states[i] = (o_h.float(), lse_h) if states[i] is None else _merge(*states[i], o_h, lse_h)
        if s < S - 1:
            ks, vs = ring.rotate(ks, vs)
    if impl == "plain":
        out = [((o / l.clamp_min(1e-30)[..., None]).to(q.dtype), m + torch.log(l))
               for q, (o, m, l) in zip(qs, states)]
    else:
        out = [(o.to(q.dtype), lse) for q, (o, lse) in zip(qs, states)]
    return [o for o, _ in out], [lse for _, lse in out]


def _ring_bwd(ring, qs, ks, vs, dos, lses, deltas, causal: bool, scale: float, impl: str):
    """Per held shard: (dq, dk, dv) in f32. dK/dV accumulate into buffers
    that travel with K/V and are back at their owner after S rotations."""
    S, T, dev = ring.size, qs[0].shape[1], qs[0].device
    f32 = dict(dtype=torch.float32, device=dev)
    dqs = [torch.zeros(q.shape, **f32) for q in qs]
    dks = [torch.zeros(k.shape, **f32) for k in ks]
    dvs = [torch.zeros(v.shape, **f32) for v in vs]
    for s in range(S):
        for i, r in enumerate(ring.ranks):
            src = (r - s) % S
            args = (qs[i], ks[i], vs[i], dos[i], lses[i], deltas[i])
            if impl == "plain":
                dq, dk, dv = _plain_hop_bwd(*args, _positions(r, T, dev), _positions(src, T, dev),
                                            causal, scale)
            else:
                case = _hop_case(r, src, causal)
                if case == "skip":
                    continue
                kw = dict(causal=case == "diag", scale=scale)
                if parts_route(qs[i]):  # f32: the hop's operands split once for both kernels
                    parts = split_parts(*args[:4])
                    dq = flash_bwd_dq_parts(parts, *args[4:], **kw)
                    dk, dv = flash_bwd_dkv_parts(parts, *args[4:], **kw)
                else:
                    dq = flash_bwd_dq(*args, **kw)
                    dk, dv = flash_bwd_dkv(*args, **kw)
            dqs[i] += dq
            dks[i] += dk
            dvs[i] += dv
        if s < S - 1:
            ks, vs, dks, dvs = ring.rotate(ks, vs, dks, dvs)
        else:
            dks, dvs = ring.rotate(dks, dvs)
    return dqs, dks, dvs


class _RingAttention(torch.autograd.Function):
    """Ring attention on [BH, T_local, D] (or, for the loopback, the whole
    [BH, T, D]) with the ring's backward."""

    @staticmethod
    def forward(ctx, q, k, v, ring, causal: bool, scale: float, impl: str):
        o, lse = _ring_fwd(ring, ring.split(q), ring.split(k), ring.split(v), causal, scale, impl)
        o, lse = ring.join(o), ring.join(lse)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.ring, ctx.causal, ctx.scale, ctx.impl = ring, causal, scale, impl
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(-1)
        ring = ctx.ring
        grads = _ring_bwd(ring, *(ring.split(t) for t in (q, k, v, do, lse, delta)),
                          ctx.causal, ctx.scale, ctx.impl)
        dq, dk, dv = (ring.join(g).to(t.dtype) for g, t in zip(grads, (q, k, v)))
        return dq, dk, dv, None, None, None, None


def _ring_bthd(q, k, v, ring, causal: bool, scale: Optional[float], impl: str):
    B, T, H, D = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"ring attention takes q, k, v of one shape (repeat kv heads first); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if impl == "auto":
        impl = "kernel" if q.device.type == "cuda" else "plain"
    if impl not in ("kernel", "plain"):
        raise ValueError(f"unknown ring attention impl {impl!r}")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    # The kernel route runs at the kernels' next width up from D: padded
    # once here, not at each hop (flash_attention.kernel_width).
    width = kernel_width(D) if impl == "kernel" else D
    qf, kf, vf = (_to_bhtd(x, 1, width) for x in (q, k, v))
    o = _RingAttention.apply(qf, kf, vf, ring, causal, scale, impl)
    return o[..., :D].reshape(B, H, T, D).transpose(1, 2)


def ring_attention(q, k, v, group=None, causal: bool = False, scale: Optional[float] = None,
                   impl: str = "auto"):
    """Exact attention across the ring of `group` (the sequence group; None:
    one shard, no communication). Every rank of the group calls it.

    q, k, v: [B, T_local, H, D] local shards, rank r of the group holding
    global positions [r*T_local, (r+1)*T_local); `causal` masks in global
    positions. impl: 'auto' (the kernels for CUDA tensors, the plain route
    for CPU ones) | 'kernel' | 'plain'. Returns [B, T_local, H, D].
    """
    return _ring_bthd(q, k, v, _GroupRing(group), causal, scale, impl)


def ring_attention_loopback(q, k, v, size: int, causal: bool = False,
                            scale: Optional[float] = None, impl: str = "auto"):
    """The ring's schedule in one process: [B, T, H, D] split into `size`
    sequence shards, every hop of every shard run here, hops made by
    indexing. Computes what `ring_attention` computes over `size` ranks."""
    return _ring_bthd(q, k, v, _LoopbackRing(size), causal, scale, impl)


def ring_attention_sharded(q, k, v, mesh, causal: bool = False, seq_axis: str = "sequence",
                           batch_axes=("data", "fsdp"), head_axis: str = "tensor",
                           impl: str = "auto"):
    """Global view: q/k/v are the whole [B, T, H, D], the same on every rank
    of `mesh`; this rank attends its block (batch over `batch_axes`,
    sequence over `seq_axis`, heads over `head_axis`) around the ring of
    `seq_axis` and returns that block of the output."""
    from ray_tpu_torch.parallel.mesh import axis_group, shard_of

    present = set(mesh.mesh_dim_names)
    dims = {0: tuple(a for a in batch_axes if a in present), 1: (seq_axis,) if seq_axis in present else (),
            2: (head_axis,) if head_axis in present else ()}
    q, k, v = (shard_of(mesh, t, dims) for t in (q, k, v))
    group = axis_group(mesh, seq_axis) if seq_axis in present else None
    return ring_attention(q, k, v, group, causal=causal, impl=impl)


def ring_attention_on_group(q, k, v, causal: bool = False, group_name: str = "default"):
    """Ring attention over a collective group (nccl or gloo backend): q/k/v
    are this rank's [B, T_local, H, D] sequence shards on the group's
    device, rank r of the group holding global positions
    [r*T_local, (r+1)*T_local). Every rank of the group calls it."""
    from ray_tpu_torch.util.collective import get_group_collectives

    eng = get_group_collectives(group_name)
    if eng is None:
        raise ValueError(
            f"group {group_name!r} has no mesh engine (nccl or gloo backend required)"
        )
    return eng.ring_attention(q, k, v, causal=causal)


def full_attention(q, k, v, causal: bool = False, scale: Optional[float] = None):
    """Plain (unsharded) softmax attention in f32; reference for tests and
    the no-sequence-axis fallback. Shapes [B, T, H, D]."""
    B, T, H, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    if causal:
        S = k.shape[1]
        mask = torch.arange(T, device=q.device)[:, None] >= torch.arange(S, device=q.device)[None, :]
        scores = scores.masked_fill(~mask, _BIG_NEG)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhts,bshd->bthd", p, v.float()).to(q.dtype)
