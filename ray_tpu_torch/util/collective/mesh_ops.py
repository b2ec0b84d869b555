"""The collective group's engine: every group op on the group's
torch.distributed process group.

Port of ray_tpu/util/collective/mesh_ops.py, whose engine lowers each op to a
compiled shard_map program over the group's mesh. Here the group IS a
process group (NCCL on the card, gloo on the CPU), and each op is one
torch.distributed call on it, issued with ``async_op=True`` and waited
through the group's death watch (collective.py `_watched_wait`):

    allreduce      -> all_reduce              (SUM / PRODUCT / MIN / MAX)
    allgather      -> all_gather
    reducescatter  -> reduce_scatter_tensor   (NCCL; gloo: all_reduce + slice)
    broadcast      -> broadcast
    permute        -> batch_isend_irecv [(src, dst), ...]
    barrier        -> a one-element all_reduce
    ring_attention / ulysses_attention -> ray_tpu_torch.parallel's, with the
                      group's process group as the sequence group

Inputs are tensors on the group's device (``engine.device``); no op writes
into its input. Rank i of the group is rank i of the process group.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence, Tuple

SUM, PRODUCT, MIN, MAX = "sum", "product", "min", "max"

# -- telemetry (docs/observability.md) ----------------------------------------
_LAT = None
_BYTES = None


def _observe(op: str, group: str, nbytes: int, dt: float) -> None:
    global _LAT, _BYTES
    if _LAT is None:
        from ray_tpu_torch._private import telemetry

        _LAT = telemetry.histogram(
            "collective",
            "op_latency_s",
            "wall time of one group op (issue + wait on its work handle)",
            buckets=telemetry.LATENCY_BUCKETS_S,
        )
        _BYTES = telemetry.counter(
            "collective",
            "bytes",
            "payload bytes contributed per rank through group ops",
        )
    _LAT.cell(op=op, group=group).observe(dt)
    _BYTES.cell(op=op, group=group).inc(nbytes)
    # Every collective funnels through here (store + torch backends), so
    # this is the one place a group op becomes a trace span when the caller
    # is inside a traced task.
    from ray_tpu_torch._private import rpc

    if rpc._trace_ctx.get() is not None:
        import time as _time

        from ray_tpu_torch.util import tracing

        tracing.record_span(
            f"collective.{op}",
            "collective",
            _time.time() - dt,
            dt,
            group=group,
            nbytes=nbytes,
        )


def _reduce_op(op: str):
    import torch.distributed as dist

    ops = {SUM: dist.ReduceOp.SUM, PRODUCT: dist.ReduceOp.PRODUCT,
           MIN: dist.ReduceOp.MIN, MAX: dist.ReduceOp.MAX}
    if op not in ops:
        raise ValueError(f"unknown reduce op {op!r}")
    return ops[op]


def _plain_wait(work, what: str) -> None:
    work.wait()


class MeshCollectives:
    """Group ops over one process group.

    ``wait(work, what)`` waits on an op's work handle; the collective group
    passes its death watch, and a bare engine waits plainly.
    """

    def __init__(self, pg, device, group_name: str = "default",
                 wait: Optional[Callable] = None):
        import torch.distributed as dist

        self.pg = pg
        self.device = device
        self.group_name = group_name
        self.world = dist.get_world_size(pg)
        self.rank = dist.get_rank(pg)
        self.backend = dist.get_backend(pg)
        self.wait = wait or _plain_wait

    def _global(self, rank: int) -> int:
        import torch.distributed as dist

        return dist.get_global_rank(self.pg, rank)

    def _own(self, t):
        """A private copy of input `t` on the group's device."""
        return t.to(self.device, copy=True).contiguous()

    def _timed(self, op: str, nbytes: int, fn):
        t0 = time.perf_counter()
        out = fn()
        _observe(op, self.group_name, nbytes, time.perf_counter() - t0)
        return out

    # -- ops -------------------------------------------------------------------

    def allreduce(self, t, op: str = SUM):
        """This rank's S -> S reduced over the ranks."""
        import torch.distributed as dist

        def run():
            out = self._own(t)
            self.wait(dist.all_reduce(out, op=_reduce_op(op), group=self.pg,
                                      async_op=True), "allreduce")
            return out

        return self._timed("allreduce", t.nbytes, run)

    def allgather(self, t) -> List:
        """This rank's S -> [S of rank 0, ..., S of rank world-1]."""
        import torch
        import torch.distributed as dist

        def run():
            src = self._own(t)
            outs = [torch.empty_like(src) for _ in range(self.world)]
            self.wait(dist.all_gather(outs, src, group=self.pg, async_op=True),
                      "allgather")
            return outs

        return self._timed("allgather", t.nbytes, run)

    def reducescatter(self, t, op: str = SUM):
        """This rank's T (T[0] divisible by world) -> rank's block of T
        reduced over the ranks."""
        import torch
        import torch.distributed as dist

        if not t.dim() or t.shape[0] % self.world:
            raise ValueError(
                f"reducescatter needs dim0 of {tuple(t.shape)} divisible by "
                f"world {self.world}"
            )
        block = t.shape[0] // self.world

        def run():
            src = self._own(t)
            if self.backend != "nccl":  # gloo has no reduce_scatter
                self.wait(dist.all_reduce(src, op=_reduce_op(op), group=self.pg,
                                          async_op=True), "reducescatter")
                return src[self.rank * block:(self.rank + 1) * block].clone()
            out = torch.empty((block, *t.shape[1:]), dtype=t.dtype, device=self.device)
            self.wait(dist.reduce_scatter_tensor(out, src, op=_reduce_op(op), group=self.pg,
                                                 async_op=True), "reducescatter")
            return out

        return self._timed("reducescatter", t.nbytes, run)

    def broadcast(self, t, src: int):
        """Every rank's S -> rank src's S."""
        import torch.distributed as dist

        def run():
            out = self._own(t)
            self.wait(dist.broadcast(out, src=self._global(src), group=self.pg,
                                     async_op=True), "broadcast")
            return out

        return self._timed("broadcast", t.nbytes, run)

    def permute(self, t, perm: Sequence[Tuple[int, int]]):
        """Rank dst takes rank src's S for each (src, dst) pair; a rank that
        is no pair's destination gets zeros. The compiled-channel payload hop
        of the reference."""
        import torch
        import torch.distributed as dist

        def run():
            out = torch.zeros(t.shape, dtype=t.dtype, device=self.device)
            src_t = self._own(t)
            ops = []
            for s, d in perm:
                if s == self.rank and d == self.rank:
                    out.copy_(src_t)
                elif s == self.rank:
                    ops.append(dist.P2POp(dist.isend, src_t, self._global(d), self.pg))
                elif d == self.rank:
                    ops.append(dist.P2POp(dist.irecv, out, self._global(s), self.pg))
            if ops:
                for work in dist.batch_isend_irecv(ops):
                    self.wait(work, "permute")
            return out

        return self._timed("permute", t.nbytes, run)

    def barrier(self) -> None:
        """All ranks rendezvous on a one-element all_reduce."""
        import torch

        self.allreduce(torch.ones(1, device=self.device))

    def isend(self, t, dst: int, tag: int = 0):
        """Start sending `t` to rank dst; returns the work handle."""
        import torch.distributed as dist

        return dist.isend(t, self._global(dst), group=self.pg, tag=tag)

    def irecv(self, out, src: int, tag: int = 0):
        """Start receiving rank src's tensor into `out`; returns the work."""
        import torch.distributed as dist

        return dist.irecv(out, self._global(src), group=self.pg, tag=tag)

    # -- sequence-parallel attention (parallel/ring_attention.py, ulysses.py) --

    def ring_attention(self, q, k, v, causal: bool = False):
        """Ring attention over the group: q/k/v are this rank's sequence
        shards [B, T_local, H, D] (rank r holds global positions
        [r*T_local, (r+1)*T_local)). The kernel route on CUDA tensors: a
        flash forward with LSE per hop, merged by LSE, and the two backward
        kernels per hop with the global LSE; every K/V rotation waits
        through the group's death watch. Differentiable."""
        from ray_tpu_torch.parallel.ring_attention import _GroupRing, _ring_bthd

        return self._timed(
            "ring_attention", q.nbytes,
            lambda: _ring_bthd(q, k, v, _GroupRing(self.pg, wait=self.wait), causal,
                               None, "auto"))

    def ulysses_attention(self, q, k, v, causal: bool = False):
        """Ulysses all-to-all attention over the group (shards as in
        ring_attention); heads must divide by world. Differentiable."""
        from ray_tpu_torch.parallel.ulysses import ulysses_attention as _ulysses

        return self._timed(
            "ulysses_attention", q.nbytes,
            lambda: _ulysses(q, k, v, self.pg, causal=causal, wait=self.wait))
