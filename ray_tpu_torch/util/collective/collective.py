"""Collective communication across actors/tasks.

Port of ray_tpu/util/collective/collective.py. The API surface mirrors the
reference's ray.util.collective (python/ray/util/collective/collective.py:
120-615: init_collective_group, allreduce/allgather/reducescatter/broadcast/
send/recv/barrier), with two kinds of backend:

- "nccl" / "gloo": torch.distributed. Ranks rendezvous through the GCS KV
  for rank 0's store address (rank 0 binds the store's port itself, so no
  other process can take it in between), join one process group, and every
  op runs on it through the group's MeshCollectives engine
  (ray_tpu_torch/util/collective/mesh_ops.py). "nccl" puts tensors on
  ``cuda:{local rank}`` and needs a card in the process (it never becomes
  gloo); "gloo" is for ranks without one and runs only when named. In a
  process whose default process group already spans the same ranks (a
  TorchTrainer's gang), the group is a ``new_group`` over those ranks
  instead of a second rendezvous. A process joins one torch-backed group at
  a time otherwise (torch.distributed has one default group per process).
- "store": pure control-plane fallback (the pygloo-analog): a named async
  rendezvous actor reduces numpy payloads. Correct anywhere, including CPU
  actors; bandwidth-bound by the object path, so use it for small tensors and
  coordination, not gradient traffic.

Like NCCL, all ranks must issue collectives in the same order; a per-group
sequence number enforces matching.

Ops take numpy arrays or torch tensors. On a torch backend they return the
input's kind (a tensor on the input's device, or a numpy array); the store
backend returns numpy, as in the reference, and carries a bf16 tensor as
float32 (numpy has no bf16). send/recv keep the reference's per-(src, dst,
tag) FIFO order: the shape and dtype travel through the GCS KV and the
payload by ``isend``/``irecv``, which NCCL orders per pair whatever the tag
(gloo matches tags). A send to this rank itself queues locally.

A rank that dies mid-collective must not hang the survivors: store-backend
ops poll peer actor liveness through the GCS while blocked, and torch ops
are issued with ``async_op=True`` and their work handle polled, and both
raise `CollectiveGroupDiedError` (typed, within ~one health-check interval
of the GCS marking the actor dead) instead of waiting out the full timeout.
A torch group that died runs no op again and rebuilds no communicator.
What the watch cannot do is interrupt an NCCL kernel already stuck on the
card: that needs the communicator's abort, and the process stays unfit for
another NCCL group.
"""

from __future__ import annotations

import logging
import os
import sys
import time as _time
from typing import Any, Dict, List, Optional

import numpy as np

from ray_tpu_torch._private.common import (
    ActorDiedError,
    ActorUnavailableError,
    GetTimeoutError,
    RayTpuError,
    WorkerCrashedError,
)

logger = logging.getLogger(__name__)

SUM, PRODUCT, MIN, MAX = "sum", "product", "min", "max"
_OPS = {
    SUM: lambda arrs: np.sum(arrs, axis=0),
    PRODUCT: lambda arrs: np.prod(arrs, axis=0),
    MIN: lambda arrs: np.min(arrs, axis=0),
    MAX: lambda arrs: np.max(arrs, axis=0),
}

# Blocked store-backend ops re-check peer liveness at this cadence; the
# overall op deadline stays RAY_TPU_COLLECTIVE_TIMEOUT_S.
_HEALTH_INTERVAL_S = float(
    os.environ.get("RAY_TPU_COLLECTIVE_HEALTH_INTERVAL_S", "0.5")
)
_OP_TIMEOUT_S = float(os.environ.get("RAY_TPU_COLLECTIVE_TIMEOUT_S", "300"))
# The backends that run on torch.distributed (the group's MeshCollectives).
TORCH_BACKENDS = ("nccl", "gloo")


class CollectiveGroupDiedError(RayTpuError):
    """A participant (rank actor or the rendezvous store) died while a group
    op was in flight. The whole group op fails — collectives are
    all-or-nothing, exactly like a NCCL communicator abort."""

    def __init__(self, group_name: str, detail: str = ""):
        self.group_name = group_name
        self.detail = detail
        super().__init__(
            f"collective group {group_name!r} died mid-op: {detail}"
        )

    def __reduce__(self):
        # Default Exception.__reduce__ would replay the composed message as
        # group_name; rebuild from the original parts so the error survives
        # the worker->driver serialization boundary intact.
        return (type(self), (self.group_name, self.detail))


def _store_actor_cls():
    import ray_tpu_torch

    @ray_tpu_torch.remote
    class _CollectiveStore:
        """Async rendezvous actor: one per group; reduces contributions."""

        def __init__(self, world_size: int):
            import asyncio

            self.world = world_size
            self.pending: Dict[int, Dict[int, Any]] = {}
            self.results: Dict[int, Any] = {}
            self.events: Dict[int, asyncio.Event] = {}
            self.reads: Dict[int, int] = {}
            self.p2p: Dict[tuple, Any] = {}
            self.p2p_events: Dict[tuple, asyncio.Event] = {}

        def _event(self, seq):
            import asyncio

            if seq not in self.events:
                self.events[seq] = asyncio.Event()
            return self.events[seq]

        async def contribute(self, seq: int, rank: int, arr, op: str, mode: str):
            ev = self._event(seq)
            bucket = self.pending.setdefault(seq, {})
            bucket[rank] = arr
            if len(bucket) == self.world:
                arrs = [bucket[r] for r in sorted(bucket)]
                if mode == "allreduce":
                    self.results[seq] = _OPS[op](np.stack(arrs))
                elif mode == "allgather":
                    self.results[seq] = arrs
                elif mode == "broadcast":
                    src = int(op)
                    self.results[seq] = bucket[src]
                elif mode == "barrier":
                    self.results[seq] = True
                elif mode == "reducescatter":
                    red = _OPS[SUM if op == "barrier" else op](np.stack(arrs))
                    self.results[seq] = np.array_split(red, self.world, axis=0)
                del self.pending[seq]
                ev.set()
            else:
                await ev.wait()
            res = self.results[seq]
            if mode == "reducescatter":
                res = res[rank]
            # Evict once every rank has read its result.
            self.reads[seq] = self.reads.get(seq, 0) + 1
            if self.reads[seq] == self.world:
                self.results.pop(seq, None)
                self.events.pop(seq, None)
                self.reads.pop(seq, None)
            return res

        async def send(self, src: int, dst: int, tag: int, arr):
            import asyncio

            # Per-key FIFO so back-to-back sends never overwrite each other.
            key = (src, dst, tag)
            self.p2p.setdefault(key, []).append(arr)
            if key not in self.p2p_events:
                self.p2p_events[key] = asyncio.Event()
            self.p2p_events[key].set()

        async def recv(self, src: int, dst: int, tag: int):
            import asyncio

            key = (src, dst, tag)
            while not self.p2p.get(key):
                if key not in self.p2p_events:
                    self.p2p_events[key] = asyncio.Event()
                await self.p2p_events[key].wait()
                self.p2p_events[key].clear()
            queue = self.p2p[key]
            arr = queue.pop(0)
            if not queue:
                self.p2p.pop(key, None)
                self.p2p_events.pop(key, None)
            return arr

    return _CollectiveStore


class _Group:
    def __init__(self, name: str, world_size: int, rank: int, backend: str):
        self.name = name
        self.world_size = world_size
        self.rank = rank
        self.backend = backend
        self.seq = 0
        self.store = None  # store backend: actor handle
        self.mesh = None  # torch backends: the ("world",) DeviceMesh
        self.engine = None  # torch backends: MeshCollectives over the group
        self.pg = None  # torch backends: the process group
        self.device = None  # torch backends: where the group's tensors live
        self.nodes: List[str] = []  # torch backends: node id of each rank
        self.died: Optional[str] = None  # torch backends: why the group died
        self._rendezvous = None  # torch backends: the store ranks met through
        self._owns_world = False  # the group started the default process group
        self._self_queue: Dict[int, List[tuple]] = {}  # tag -> sends to this rank
        self._inflight: List[tuple] = []  # (done, tensor) of sends in flight
        self._waiters: Dict[str, Any] = {}  # gloo: threads that wait on work
        self._p2p_seq: Dict[tuple, int] = {}
        self._members: Optional[Dict[int, str]] = None  # rank -> actor_id

    def next_seq(self) -> int:
        self.seq += 1
        return self.seq


class GroupManager:
    """Per-process registry (reference: collective.py:40)."""

    def __init__(self):
        self.groups: Dict[str, _Group] = {}

    def get(self, name: str) -> _Group:
        if name not in self.groups:
            raise ValueError(f"collective group {name!r} is not initialized")
        return self.groups[name]


_manager = GroupManager()


def is_group_initialized(group_name: str = "default") -> bool:
    return group_name in _manager.groups


def init_collective_group(
    world_size: int,
    rank: int,
    backend: str = "store",
    group_name: str = "default",
) -> None:
    """Join a collective group. Must be called by every rank (typically from
    inside each participating actor)."""
    import ray_tpu_torch

    if group_name in _manager.groups:
        raise ValueError(f"group {group_name!r} already initialized")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} out of range for world size {world_size}")
    group = _Group(group_name, world_size, rank, backend)
    if backend == "store":
        cls = _store_actor_cls()
        group.store = cls.options(
            name=f"__collective_{group_name}", get_if_exists=True, num_cpus=0.1
        ).remote(world_size)
        _register_member(group)
    elif backend in TORCH_BACKENDS:
        _init_torch_backend(group)
        _register_member(group)
    else:
        raise ValueError(f"unknown collective backend {backend!r}")
    _manager.groups[group_name] = group


def _register_member(group: _Group) -> None:
    """Publish this rank's actor id in the GCS KV so blocked peers can watch
    for its death (ns=collective, key member_{group}_{rank}). Driver-side
    ranks have no actor id and publish an empty value (unwatchable)."""
    try:
        from ray_tpu_torch._private import worker as worker_mod

        core = worker_mod._core()
        aid = getattr(core, "current_actor_id", None) or ""
        worker_mod.global_worker.run_async(
            core.gcs.kv_put(
                f"member_{group.name}_{group.rank}",
                aid.encode(),
                ns="collective",
            )
        )
    except Exception:
        logger.debug("collective member registration failed", exc_info=True)


def _rendezvous_store(group: _Group, timeout_s: float):
    """The store the group's ranks meet through: an in-memory one for a
    world of one; otherwise rank 0 binds a TCPStore on a port the OS picks
    at its node's address and publishes host:port in the GCS KV
    (ns=collective, key dist_coord_{group}), where the other ranks read it."""
    import datetime
    import socket

    import torch.distributed as dist

    if group.world_size == 1:
        return dist.HashStore()
    from ray_tpu_torch._private import worker as worker_mod

    core = worker_mod._core()
    key = f"dist_coord_{group.name}"
    timeout = datetime.timedelta(seconds=timeout_s)
    if group.rank == 0:
        # Advertise this node's address (not loopback) so ranks on other
        # hosts can reach the store; raylet_addr holds the node IP.
        host = core.raylet_addr[0] if core.raylet_addr else socket.gethostbyname(
            socket.gethostname()
        )
        store = dist.TCPStore(host, 0, group.world_size, is_master=True,
                              wait_for_workers=False, timeout=timeout)
        worker_mod.global_worker.run_async(
            core.gcs.kv_put(key, f"{host}:{store.port}".encode(), ns="collective")
        )
        return store
    coord = None
    for _ in range(300):
        val = worker_mod.global_worker.run_async(core.gcs.kv_get(key, ns="collective"))
        if val:
            coord = val.decode()
            break
        _time.sleep(0.1)
    if coord is None:
        raise TimeoutError("torch collective store rendezvous timed out")
    host, port = coord.rsplit(":", 1)
    return dist.TCPStore(host, int(port), group.world_size, is_master=False,
                         timeout=timeout)


def _node_id() -> str:
    try:
        from ray_tpu_torch._private import worker as worker_mod

        return worker_mod._core().node_id
    except Exception:
        import socket

        return socket.gethostname()


def _init_torch_backend(group: _Group, timeout_s: float = 120.0) -> None:
    """torch.distributed bootstrap: rendezvous, each rank's node through the
    store, this rank's device, then the process group (the default one, or
    a new_group over a default group that already spans these ranks), its
    ("world",) DeviceMesh and the MeshCollectives engine over it."""
    import datetime

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from ray_tpu_torch.util.collective.mesh_ops import MeshCollectives

    if group.backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError(
            "collective backend 'nccl' needs a CUDA card in this process; "
            "name backend='gloo' for ranks without one"
        )
    store = _rendezvous_store(group, timeout_s)
    group._rendezvous = store
    store.set(f"node_{group.rank}", _node_id())
    group.nodes = [store.get(f"node_{r}").decode() for r in range(group.world_size)]
    if group.backend == "nccl":
        local_rank = group.nodes[: group.rank].count(group.nodes[group.rank])
        group.device = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(group.device)
    else:
        group.device = torch.device("cpu")
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (group.world_size, group.rank):
            raise ValueError(
                f"group {group.name!r} (rank {group.rank} of {group.world_size}) "
                f"does not match this process's default process group (rank "
                f"{dist.get_rank()} of {dist.get_world_size()})"
            )
        group.pg = dist.new_group(list(range(group.world_size)), backend=group.backend)
    else:
        dist.init_process_group(
            group.backend,
            store=store,
            rank=group.rank,
            world_size=group.world_size,
            timeout=datetime.timedelta(seconds=timeout_s),
            device_id=group.device if group.backend == "nccl" else None,
        )
        group.pg = dist.group.WORLD
        group._owns_world = True
    group.mesh = DeviceMesh.from_group(group.pg, group.device.type,
                                       mesh_dim_names=("world",))
    group.engine = MeshCollectives(
        group.pg, group.device, group_name=group.name,
        wait=lambda work, what: _watched_wait(group, work, what),
    )


def _shutdown_torch_backend(group: _Group) -> None:
    """Leave the process group, unless the group died: a dead peer may hold
    an op in flight, which destroying the communicator would wait on."""
    import torch.distributed as dist

    group.engine = group.mesh = None
    group._inflight.clear()
    for waiter in group._waiters.values():
        waiter.shutdown(wait=False)  # a dead peer's op never returns
    if group.died is None and dist.is_initialized():
        if group._owns_world:
            dist.destroy_process_group()
        elif group.pg is not None:
            dist.destroy_process_group(group.pg)
    group.pg = group._rendezvous = None


def destroy_collective_group(group_name: str = "default") -> None:
    group = _manager.groups.pop(group_name, None)
    if group is not None and group.backend in TORCH_BACKENDS:
        # Leave the process group so a later torch group can initialize
        # again in this process.
        _shutdown_torch_backend(group)
    if group is not None and group.rank == 0:
        # Rank 0 reaps the rendezvous state so a later group with the same
        # name starts clean (fresh seq/result tables, coordinator address).
        import ray_tpu_torch
        from ray_tpu_torch._private import worker as worker_mod

        if group.store is not None:
            try:
                ray_tpu_torch.kill(group.store)
            except Exception:
                pass
        try:
            core = worker_mod._core()

            async def _reap():
                await core.gcs.kv_del(
                    f"dist_coord_{group_name}", ns="collective"
                )
                for r in range(group.world_size):
                    await core.gcs.kv_del(
                        f"member_{group_name}_{r}", ns="collective"
                    )

            worker_mod.global_worker.run_async(_reap())
        except Exception:
            pass


# -- store backend: liveness-watched round trips ------------------------------


def _group_members(group: _Group) -> Dict[int, str]:
    """rank -> actor_id map published at init; cached once complete."""
    if group._members is not None and len(group._members) == group.world_size:
        return group._members
    from ray_tpu_torch._private import worker as worker_mod

    core = worker_mod._core()

    async def _fetch():
        out = {}
        for r in range(group.world_size):
            val = await core.gcs.kv_get(
                f"member_{group.name}_{r}", ns="collective"
            )
            if val is not None:
                out[r] = val.decode()
        return out

    try:
        group._members = worker_mod.global_worker.run_async(_fetch(), timeout=10)
    except Exception:
        group._members = group._members or {}
    return group._members


def _dead_members(group: _Group) -> List[int]:
    """Ranks whose registered actors the GCS has marked DEAD."""
    from ray_tpu_torch._private import worker as worker_mod

    members = _group_members(group)
    core = worker_mod._core()

    async def _check():
        dead = []
        for rank, aid in members.items():
            if not aid or rank == group.rank:
                continue
            try:
                resp = await core.gcs.call("GetActor", {"actor_id": aid})
            except Exception:
                continue
            actor = resp.get("actor")
            if actor is not None and actor.get("state") == "DEAD":
                dead.append(rank)
        return dead

    try:
        return worker_mod.global_worker.run_async(_check(), timeout=10)
    except Exception:
        return []


def _watched_get(group: _Group, ref, what: str):
    """ray_tpu_torch.get with a death watch: while the result is pending, poll the
    GCS for dead group members and fail fast with CollectiveGroupDiedError
    instead of hanging until the 300s op deadline."""
    import ray_tpu_torch

    deadline = _time.monotonic() + _OP_TIMEOUT_S
    while True:
        try:
            return ray_tpu_torch.get(ref, timeout=_HEALTH_INTERVAL_S)
        except GetTimeoutError:
            dead = _dead_members(group)
            if dead:
                raise CollectiveGroupDiedError(
                    group.name,
                    f"rank(s) {sorted(dead)} died while {what} was in flight",
                ) from None
            if _time.monotonic() > deadline:
                raise GetTimeoutError(
                    f"collective {what} on group {group.name!r} timed out "
                    f"after {_OP_TIMEOUT_S:.0f}s"
                ) from None
        except (ActorDiedError, WorkerCrashedError, ActorUnavailableError) as e:
            # The rendezvous store itself is gone: the group cannot complete
            # any op again.
            raise CollectiveGroupDiedError(
                group.name, f"rendezvous store died: {e}"
            ) from None


def _roundtrip(group: _Group, arr, op: str, mode: str):
    t0 = _time.perf_counter()
    np_arr = _host_array(arr)
    seq = group.next_seq()
    ref = group.store.contribute.remote(seq, group.rank, np_arr, op, mode)
    out = _watched_get(group, ref, mode)
    from ray_tpu_torch.util.collective.mesh_ops import _observe

    _observe(mode, group.name, np_arr.nbytes, _time.perf_counter() - t0)
    return out


def _host_array(x) -> np.ndarray:
    """The store backend's payload: numpy as given; a torch tensor copied to
    the host, bf16 as float32 (numpy has no bf16)."""
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


# -- torch backends: ops through the group's engine ---------------------------


def _completion(group: _Group, work, waiter: str = "op"):
    """(done, result) of a work handle. gloo's send/recv work reports
    completion only from inside wait(), so on gloo a helper thread of the
    group waits and the caller polls that: one thread for the op the caller
    waits on, another for the sends in flight, which complete only when
    their peers post the matching receives."""
    if group.backend != "gloo":
        return work.is_completed, work.wait
    if waiter not in group._waiters:
        from concurrent.futures import ThreadPoolExecutor

        group._waiters[waiter] = ThreadPoolExecutor(
            1, thread_name_prefix=f"collective-{group.name}-{waiter}")
    waited = group._waiters[waiter].submit(work.wait)
    return waited.done, waited.result


def _watched_wait(group: _Group, work, what: str) -> None:
    """work.wait() with a death watch: poll the async work handle and, every
    _HEALTH_INTERVAL_S, the GCS for dead group members, and fail fast with
    CollectiveGroupDiedError instead of blocking inside the C++ op."""
    if group.died is not None:
        raise CollectiveGroupDiedError(group.name, group.died)
    finished, result = _completion(group, work)
    start = _time.monotonic()
    next_check = start + _HEALTH_INTERVAL_S
    polls = 0
    while not finished():
        polls += 1
        now = _time.monotonic()
        if now >= next_check:
            next_check = now + _HEALTH_INTERVAL_S
            dead = _dead_members(group)
            if dead:
                group.died = f"rank(s) {sorted(dead)} died while {what} was in flight"
                raise CollectiveGroupDiedError(group.name, group.died)
            if now - start > _OP_TIMEOUT_S:
                raise GetTimeoutError(
                    f"collective {what} on group {group.name!r} timed out "
                    f"after {_OP_TIMEOUT_S:.0f}s"
                )
        # Yield while a hot op finishes, then back off (Channel.read's
        # schedule).
        _time.sleep(0 if polls < 2000 else 0.00005 if polls < 20000 else 0.001)
    try:
        result()
    except Exception as e:
        # The transport saw a peer go (gloo's connection closed): the group
        # cannot complete any op again.
        dead = _dead_members(group)
        who = f"rank(s) {sorted(dead)} died; " if dead else ""
        group.died = f"{who}{what} failed: {e}"
        raise CollectiveGroupDiedError(group.name, group.died) from None


def _as_tensor(x):
    """(tensor, caller's device or None for numpy) of an op's input."""
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(x, torch.Tensor):
        return x.detach(), x.device
    import torch

    arr = np.ascontiguousarray(x)
    t = torch.from_numpy(arr) if arr.flags.writeable else torch.tensor(arr)
    return t, None


def _restore(t, device):
    """An op's result in its input's kind: a tensor on `device`, or numpy."""
    return t.cpu().numpy() if device is None else t.to(device)


def _engine(group: _Group):
    if group.died is not None:
        raise CollectiveGroupDiedError(group.name, group.died)
    return group.engine


def allreduce(tensor, group_name: str = "default", op: str = SUM):
    """Reduce across all ranks; returns the reduced array on every rank."""
    group = _manager.get(group_name)
    if group.backend in TORCH_BACKENDS:
        t, dev = _as_tensor(tensor)
        return _restore(_engine(group).allreduce(t, op), dev)
    return _roundtrip(group, tensor, op, "allreduce")


def allgather(tensor, group_name: str = "default") -> List[np.ndarray]:
    group = _manager.get(group_name)
    if group.backend in TORCH_BACKENDS:
        t, dev = _as_tensor(tensor)
        return [_restore(x, dev) for x in _engine(group).allgather(t)]
    return _roundtrip(group, tensor, SUM, "allgather")


def reducescatter(tensor, group_name: str = "default", op: str = SUM):
    group = _manager.get(group_name)
    if group.backend in TORCH_BACKENDS:
        t, dev = _as_tensor(tensor)
        eng = _engine(group)
        if t.dim() and t.shape[0] % group.world_size == 0:
            return _restore(eng.reducescatter(t, op), dev)
        # Uneven split: reduce on the group, slice here (store-backend
        # parity via np.array_split's shards).
        red = eng.allreduce(t, op)
        return _restore(red.tensor_split(group.world_size, dim=0)[group.rank], dev)
    return _roundtrip(group, tensor, op, "reducescatter")


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    group = _manager.get(group_name)
    if group.backend in TORCH_BACKENDS:
        t, dev = _as_tensor(tensor)
        return _restore(_engine(group).broadcast(t, src_rank), dev)
    return _roundtrip(group, tensor, str(src_rank), "broadcast")


def barrier(group_name: str = "default") -> None:
    group = _manager.get(group_name)
    if group.backend in TORCH_BACKENDS:
        _engine(group).barrier()
        return
    _roundtrip(group, np.zeros(1), "barrier", "barrier")


def _p2p_meta_key(group: _Group, src: int, dst: int, tag: int, seq: int) -> str:
    return f"p2p_{group.name}_{src}_{dst}_{tag}_{seq}"


def _send_tensor(group: _Group, t, dst_rank: int, tag: int) -> None:
    """Send a copy of `t` to another rank without waiting for its receive
    (the store backend's send returns once the store holds the payload,
    too): the copy and its work handle stay in the group until the send is
    done."""
    eng = _engine(group)
    t = t.to(group.device, copy=True)
    group._inflight = [(done, x) for done, x in group._inflight if not done()]
    group._inflight.append((_completion(group, eng.isend(t, dst_rank, tag), "send")[0], t))


def _recv_tensor(group: _Group, shape, dtype, src_rank: int, tag: int):
    """The tensor of shape/dtype that another rank sent with `tag`, on the
    group's device."""
    import torch

    eng = _engine(group)
    out = torch.empty(tuple(shape), dtype=dtype, device=group.device)
    eng.wait(eng.irecv(out, src_rank, tag), "recv")
    return out


def _torch_send(group: _Group, tensor, dst_rank: int, tag: int) -> None:
    import json

    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch.util.collective.mesh_ops import _observe

    t0 = _time.perf_counter()
    t, dev = _as_tensor(tensor)
    if dst_rank == group.rank:  # to this rank itself: a local FIFO per tag
        _engine(group)
        group._self_queue.setdefault(tag, []).append((t.to(group.device, copy=True), dev is None))
        _observe("send", group.name, t.nbytes, _time.perf_counter() - t0)
        return
    key = (group.rank, dst_rank, tag)
    seq = group._p2p_seq[key] = group._p2p_seq.get(key, 0) + 1
    # Publish shape/dtype (and the sender's kind) so the receiver can post
    # a matching recv.
    core = worker_mod._core()
    meta = json.dumps({"shape": list(t.shape), "dtype": str(t.dtype),
                       "numpy": dev is None})
    worker_mod.global_worker.run_async(
        core.gcs.kv_put(
            _p2p_meta_key(group, group.rank, dst_rank, tag, seq),
            meta.encode(),
            ns="collective",
        )
    )
    _send_tensor(group, t, dst_rank, tag)
    _observe("send", group.name, t.nbytes, _time.perf_counter() - t0)


def _torch_recv(group: _Group, src_rank: int, tag: int):
    import json

    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch.dag.tensor_channel import _torch_dtype
    from ray_tpu_torch.util.collective.mesh_ops import _observe

    t0 = _time.perf_counter()
    if src_rank == group.rank:
        _engine(group)
        if not group._self_queue.get(tag):
            raise RuntimeError(
                f"recv from rank {src_rank} (this rank) with tag {tag} before "
                f"its send: it would wait forever"
            )
        out, as_numpy = group._self_queue[tag].pop(0)
        _observe("recv", group.name, out.nbytes, _time.perf_counter() - t0)
        return out.cpu().numpy() if as_numpy else out
    key = (src_rank, group.rank, tag)
    seq = group._p2p_seq[key] = group._p2p_seq.get(key, 0) + 1
    core = worker_mod._core()
    kv_key = _p2p_meta_key(group, src_rank, group.rank, tag, seq)
    meta = None
    deadline = _time.monotonic() + _OP_TIMEOUT_S
    next_check = _time.monotonic() + _HEALTH_INTERVAL_S
    while meta is None:
        val = worker_mod.global_worker.run_async(
            core.gcs.kv_get(kv_key, ns="collective")
        )
        if val:
            meta = json.loads(val.decode())
            break
        now = _time.monotonic()
        if now > deadline:
            raise GetTimeoutError(f"recv from rank {src_rank} timed out")
        if now >= next_check:
            next_check = now + _HEALTH_INTERVAL_S
            if src_rank in _dead_members(group):
                group.died = f"rank {src_rank} died before its send to rank {group.rank}"
                raise CollectiveGroupDiedError(group.name, group.died)
        _time.sleep(0.005)
    worker_mod.global_worker.run_async(
        core.gcs.kv_del(kv_key, ns="collective")
    )
    out = _recv_tensor(group, meta["shape"], _torch_dtype(meta["dtype"]), src_rank, tag)
    _observe("recv", group.name, out.nbytes, _time.perf_counter() - t0)
    return out.cpu().numpy() if meta["numpy"] else out


def send(tensor, dst_rank: int, group_name: str = "default", tag: int = 0) -> None:
    group = _manager.get(group_name)
    if group.backend in TORCH_BACKENDS:
        _torch_send(group, tensor, dst_rank, tag)
        return
    ref = group.store.send.remote(group.rank, dst_rank, tag, _host_array(tensor))
    _watched_get(group, ref, "send")


def recv(src_rank: int, group_name: str = "default", tag: int = 0):
    group = _manager.get(group_name)
    if group.backend in TORCH_BACKENDS:
        return _torch_recv(group, src_rank, tag)
    ref = group.store.recv.remote(src_rank, group.rank, tag)
    return _watched_get(group, ref, "recv")


def get_rank(group_name: str = "default") -> int:
    return _manager.get(group_name).rank


def get_collective_group_size(group_name: str = "default") -> int:
    return _manager.get(group_name).world_size


def get_group_mesh(group_name: str = "default"):
    """The torch group's DeviceMesh (one axis, "world": rank i is device i).
    None on the store backend — the group there is a rendezvous actor, not a
    device mesh."""
    return _manager.get(group_name).mesh


def get_group_collectives(group_name: str = "default"):
    """The torch group's MeshCollectives engine (the group's ops over its
    process group); None on the store backend."""
    return _manager.get(group_name).engine
