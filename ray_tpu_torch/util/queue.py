"""Distributed FIFO queue backed by an actor.

Analog of python/ray/util/queue.py: Queue with put/get (blocking with
timeout), qsize/empty/full, shared across processes by passing the handle.
"""

from __future__ import annotations

import asyncio
from typing import Any, List, Optional

import ray_tpu_torch
from ray_tpu_torch._private.common import RayTpuError


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    def __init__(self, maxsize: int):
        self._q: asyncio.Queue = asyncio.Queue(maxsize)

    async def put(self, item, timeout: Optional[float] = None) -> bool:
        try:
            if timeout == 0:
                self._q.put_nowait(item)
            else:
                await asyncio.wait_for(self._q.put(item), timeout)
            return True
        except (asyncio.TimeoutError, asyncio.QueueFull):
            return False

    async def get(self, timeout: Optional[float] = None):
        try:
            if timeout == 0:
                return True, self._q.get_nowait()
            return True, await asyncio.wait_for(self._q.get(), timeout)
        except (asyncio.TimeoutError, asyncio.QueueEmpty):
            return False, None

    async def qsize(self) -> int:
        return self._q.qsize()

    async def maxsize(self) -> int:
        return self._q.maxsize


class Queue:
    def __init__(
        self,
        maxsize: int = 0,
        *,
        actor_options: Optional[dict] = None,
        _handle=None,
    ):
        if _handle is not None:
            self._actor = _handle
            return
        opts = dict(actor_options or {})
        opts.setdefault("num_cpus", 0.1)
        opts.setdefault("max_concurrency", 64)
        self._actor = ray_tpu_torch.remote(_QueueActor).options(**opts).remote(maxsize)

    def put(self, item: Any, block: bool = True, timeout: Optional[float] = None):
        t = (0 if not block else timeout)
        ok = ray_tpu_torch.get(self._actor.put.remote(item, t))
        if not ok:
            raise Full("queue is full")

    def get(self, block: bool = True, timeout: Optional[float] = None) -> Any:
        t = (0 if not block else timeout)
        ok, item = ray_tpu_torch.get(self._actor.get.remote(t))
        if not ok:
            raise Empty("queue is empty")
        return item

    def put_nowait(self, item: Any) -> None:
        self.put(item, block=False)

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def qsize(self) -> int:
        return ray_tpu_torch.get(self._actor.qsize.remote())

    def empty(self) -> bool:
        return self.qsize() == 0

    def full(self) -> bool:
        maxsize = ray_tpu_torch.get(self._actor.maxsize.remote())
        return maxsize > 0 and self.qsize() >= maxsize

    def shutdown(self) -> None:
        ray_tpu_torch.kill(self._actor)

    def __reduce__(self):
        return (_rebuild_queue, (self._actor,))


def _rebuild_queue(handle) -> "Queue":
    return Queue(_handle=handle)
