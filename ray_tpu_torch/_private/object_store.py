"""Object stores seen from inside a worker/driver process.

Two tiers, mirroring the reference's CoreWorker store providers
(src/ray/core_worker/store_provider/):

- MemoryStore: owner-local in-process store for small objects and for
  "where is it" markers of large objects that live in shm. Futures/waiters
  let `get` block until a pending task fills the slot.
- PlasmaClient: client of the local raylet's object directory; data moves
  through named shm segments (zero-copy reads via memoryview).
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch._private import rpc, shm, telemetry
from ray_tpu_torch._private.common import ObjectLostError, config

logger = logging.getLogger(__name__)

_TEL_PUT_BYTES = telemetry.counter(
    "object", "put_bytes", "bytes written into the local shm arena"
)
_TEL_GET_BYTES = telemetry.counter(
    "object", "get_bytes", "bytes mapped from the local shm arena by get()"
)
_TEL_PUT_LAT = telemetry.histogram(
    "object", "put_latency_s", "plasma put (create+write+seal) latency",
    buckets=telemetry.LATENCY_BUCKETS_S,
)
_TEL_GET_LAT = telemetry.histogram(
    "object", "get_latency_s", "plasma get round-trip latency",
    buckets=telemetry.LATENCY_BUCKETS_S,
)
_TEL_PULLS = telemetry.counter(
    "object", "pulls", "remote-object pulls requested via the local raylet"
)
_TEL_RELEASE_FLUSHES = telemetry.counter(
    "object", "release_flushes", "debounced batched-release flushes"
)
_TEL_RELEASE_OIDS = telemetry.counter(
    "object", "release_oids", "object holds dropped via batched release"
)

# Memory-store entry kinds.
INLINE = "inline"  # payload bytes present locally
IN_PLASMA = "plasma"  # payload in shm on some node (addr attached)


def _span(name: str, start: float, duration: float, **attrs) -> None:
    """Record an object-plane span into the active trace. Callers guard on
    ``rpc._trace_ctx`` being set, so the lazy import (which cycles through
    ray_tpu_torch.util at module scope) only runs when a trace is live."""
    from ray_tpu_torch.util import tracing

    tracing.record_span(name, "object", start, duration, **attrs)


class MemoryStoreEntry:
    __slots__ = ("kind", "payload", "plasma_addr")

    def __init__(self, kind: str, payload: Optional[bytes], plasma_addr=None):
        self.kind = kind
        self.payload = payload
        self.plasma_addr = plasma_addr  # raylet addr holding the primary copy


class MemoryStore:
    def __init__(self):
        self._entries: Dict[str, MemoryStoreEntry] = {}
        self._waiters: Dict[str, List[asyncio.Future]] = {}

    def contains(self, oid: str) -> bool:
        return oid in self._entries

    def get(self, oid: str) -> Optional[MemoryStoreEntry]:
        return self._entries.get(oid)

    def put_inline(self, oid: str, payload: bytes) -> None:
        self._entries[oid] = MemoryStoreEntry(INLINE, payload)
        self._notify(oid)

    def put_plasma_marker(self, oid: str, plasma_addr: Tuple[str, int]) -> None:
        self._entries[oid] = MemoryStoreEntry(IN_PLASMA, None, tuple(plasma_addr))
        self._notify(oid)

    def delete(self, oid: str) -> None:
        self._entries.pop(oid, None)

    def plasma_oids_at(self, addr) -> List[str]:
        """Objects whose primary copy lives in the arena at ``addr`` — the
        set a node death at that address makes candidates for lineage
        reconstruction."""
        addr = tuple(addr)
        return [
            oid
            for oid, e in self._entries.items()
            if e.kind == IN_PLASMA and e.plasma_addr == addr
        ]

    def _notify(self, oid: str) -> None:
        for fut in self._waiters.pop(oid, []):
            if not fut.done():
                fut.set_result(True)

    async def wait_for(self, oid: str, timeout: Optional[float]) -> Optional[MemoryStoreEntry]:
        entry = self._entries.get(oid)
        if entry is not None:
            return entry
        fut = asyncio.get_running_loop().create_future()
        self._waiters.setdefault(oid, []).append(fut)
        try:
            await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            return None
        return self._entries.get(oid)


class PlasmaClient:
    """Client of the local raylet's shm arena store.

    The node's whole object store is one shm arena; the client maps it once
    (read-write — puts write directly at raylet-assigned offsets) and every
    read is a zero-copy memoryview slice at an offset. Mirrors the reference
    plasma client's single-mmap attach (plasma/client.h).
    """

    def __init__(self, raylet_conn: rpc.Connection):
        self.conn = raylet_conn
        self._arenas: Dict[str, shm.Segment] = {}
        # Objects this client holds (the raylet counts a hold per ObjGet and
        # will not recycle their bytes until released / disconnect).
        self.held: Dict[str, int] = {}
        # Of `held`, the holds that follow a value's buffers (hold_for_value):
        # release_many leaves them to release_value_holds.
        self.value_held: Dict[str, int] = {}
        # Debounced release batch: oids queued by release() in one loop tick
        # flush as a single ObjRelease call (value drops arrive in bursts
        # when a task's deserialized arguments are collected together).
        self._release_pending: set = set()
        self._release_flush_scheduled = False
        # Last in-flight batched-release task (tests/benchmarks await it to
        # observe flush completion; the path itself is fire-and-forget).
        self._release_task: Optional[asyncio.Task] = None

    def _arena_view(self, name: str) -> memoryview:
        seg = self._arenas.get(name)
        if seg is None:
            seg = shm.open_rw(name)
            self._arenas[name] = seg
        return seg.view

    def _slice(self, meta: dict) -> memoryview:
        view = self._arena_view(meta["arena"])
        off, size = meta["offset"], meta["size"]
        return view[off : off + size]

    async def put_serialized(self, oid: str, serialized) -> None:
        t0 = time.monotonic()
        ws = time.time()
        size = max(1, serialized.total_size)
        reply = await self.conn.call("ObjCreate", {"oid": oid, "size": size, "pin": True})
        if reply.get("exists"):
            return  # already stored (e.g. deterministic re-execution)
        serialized.write_to(self._slice(reply))
        _TEL_PUT_BYTES.inc(size)
        _TEL_PUT_LAT.observe(time.monotonic() - t0)
        if rpc._trace_ctx.get() is not None:
            _span("object.put", ws, time.monotonic() - t0, oid=oid, size=size)
        # Seal as a one-way push: same-connection FIFO means our own later
        # ObjGet/ObjCreate calls observe the seal, and remote readers reach
        # the raylet after the owner advertises the object — both ordered
        # after this frame. Saves the second RTT of every large put.
        self.conn.push_nowait("ObjSeal", {"oid": oid})

    async def put_bytes(self, oid: str, payload: bytes) -> None:
        t0 = time.monotonic()
        reply = await self.conn.call(
            "ObjCreate", {"oid": oid, "size": max(1, len(payload)), "pin": True}
        )
        if reply.get("exists"):
            return
        shm.copy_into(self._slice(reply), payload)
        self.conn.push_nowait("ObjSeal", {"oid": oid})
        _TEL_PUT_BYTES.inc(max(1, len(payload)))
        _TEL_PUT_LAT.observe(time.monotonic() - t0)

    async def get(
        self, oids: List[str], timeout: Optional[float] = None, block: bool = True
    ) -> Tuple[Dict[str, memoryview], List[str]]:
        t0 = time.monotonic()
        reply = await self.conn.call(
            "ObjGet",
            {"oids": oids, "timeout": timeout, "block": block},
            timeout=None if timeout is None else timeout + 10,
        )
        found: Dict[str, memoryview] = {}
        for oid, meta in reply["found"].items():
            self.held[oid] = self.held.get(oid, 0) + 1
            found[oid] = self._slice(meta)
            _TEL_GET_BYTES.inc(meta["size"])
        _TEL_GET_LAT.observe(time.monotonic() - t0)
        if rpc._trace_ctx.get() is not None:
            _span(
                "object.get",
                time.time() - (time.monotonic() - t0),
                time.monotonic() - t0,
                count=len(oids),
            )
        return found, reply["missing"]

    async def contains(self, oids: List[str]) -> Dict[str, bool]:
        reply = await self.conn.call("ObjContains", {"oids": oids})
        return reply["contains"]

    async def pull(
        self, oid: str, from_addr: Tuple[str, int], purpose: str = "get"
    ) -> memoryview:
        """Ask the local raylet to fetch a remote object, then map it.
        purpose feeds the raylet's prioritized pull admission (reference:
        pull_manager.h): "get" > "wait" > "task_arg"."""
        _TEL_PULLS.inc()
        t0 = time.monotonic()
        ws = time.time()
        meta = await self.conn.call(
            "PullObject",
            {"oid": oid, "from_addr": list(from_addr), "purpose": purpose},
            timeout=config.rpc_pull_timeout_s,
        )
        if rpc._trace_ctx.get() is not None:
            _span(
                "object.pull", ws, time.monotonic() - t0, oid=oid, purpose=purpose
            )
        if meta.get("offset") is not None:
            self.held[oid] = self.held.get(oid, 0) + 1
            return self._slice(meta)
        found, missing = await self.get(
            [oid], timeout=config.rpc_object_get_timeout_s
        )
        if oid in found:
            return found[oid]
        raise ObjectLostError(f"pull of {oid[:12]} failed: {missing}")

    async def release_many(self, oids: List[str]) -> None:
        """Drop this client's holds on the given objects, all but those that
        follow a value's buffers."""
        await self.release_counts({oid: self.held.get(oid, 0) - self.value_held.get(oid, 0)
                                   for oid in oids})

    def hold_for_value(self, oid: str) -> None:
        """One of this client's holds on `oid` now follows a deserialized
        value's buffers: release_many keeps it, release_value_holds drops it."""
        self.value_held[oid] = self.value_held.get(oid, 0) + 1

    async def release_value_holds(self, counts: Dict[str, int]) -> None:
        """Drop holds that followed values whose buffers were collected."""
        for oid, n in counts.items():
            left = self.value_held.get(oid, 0) - n
            if left > 0:
                self.value_held[oid] = left
            else:
                self.value_held.pop(oid, None)
        await self.release_counts(counts)

    def release(self, oid: str) -> None:
        """Fire-and-forget release (LRU touch + all-holds drop). Coalesced:
        every release() in the same loop tick joins one debounced batch that
        flushes as a single ObjRelease call — N value drops used to cost N
        spawned tasks and N RPCs."""
        self._release_pending.add(oid)
        if self._release_flush_scheduled:
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:  # no running loop (sync teardown path)
            self._release_pending.discard(oid)
            return
        self._release_flush_scheduled = True
        loop.call_soon(self._flush_releases)

    def _flush_releases(self) -> None:
        self._release_flush_scheduled = False
        pending, self._release_pending = self._release_pending, set()
        if not pending or self.conn.closed:
            return
        _TEL_RELEASE_FLUSHES.inc()
        _TEL_RELEASE_OIDS.inc(len(pending))
        task = rpc.spawn(self.release_many(list(pending)))
        # Retrieve any exception so a closed connection doesn't log noise.
        task.add_done_callback(
            lambda t: t.exception() if not t.cancelled() else None
        )
        self._release_task = task

    async def release_counts(self, counts: Dict[str, int]) -> None:
        """Drop up to ``counts[oid]`` holds per object (value-lifetime holds:
        each deserialized value carries one hold, released when the value is
        garbage collected — reference: plasma client buffer refcounts)."""
        to_send = []
        for oid, n in counts.items():
            have = self.held.get(oid, 0)
            take = min(have, n)
            if take <= 0:
                continue
            if have - take <= 0:
                self.held.pop(oid, None)
            else:
                self.held[oid] = have - take
            to_send.extend([oid] * take)
        if not to_send:
            return
        try:
            await self.conn.call("ObjRelease", {"oids": to_send})
        except rpc.RpcError:
            pass

    async def delete(self, oids: List[str]) -> None:
        await self.conn.call("ObjDelete", {"oids": oids})

    async def spill(self, oids: List[str]) -> Dict[str, List[str]]:
        """Direct the raylet to spill the given sealed objects to external
        storage now (owner-driven eviction; ray._private.internal_api
        force-spill analog). Returns {"spilled": [...], "rejected": [...]} —
        held/unsealed/pinned objects are rejected, not errors."""
        return await self.conn.call(
            "SpillObjects", {"oids": oids},
            timeout=config.rpc_transfer_timeout_s,
        )

    async def restore(self, oid: str) -> bool:
        """Ask the raylet to restore one spilled object into the arena."""
        reply = await self.conn.call(
            "RestoreSpilled", {"oid": oid},
            timeout=config.rpc_transfer_timeout_s,
        )
        return bool(reply.get("restored"))

    async def pin(self, oid: str, pin: bool = True) -> bool:
        """Pin (or unpin) an object against spilling/eviction."""
        reply = await self.conn.call(
            "PinObject", {"oid": oid, "pin": pin},
            timeout=config.rpc_control_timeout_s,
        )
        return bool(reply.get("ok"))

    def close(self) -> None:
        for seg in self._arenas.values():
            try:
                seg.close()
            except Exception:
                pass  # live views into the arena keep the mapping alive
        self._arenas = {}
