"""Long-poll config fan-out: controller hosts, routers/proxies listen.

Analog of python/ray/serve/_private/long_poll.py (LongPollHost:173,
LongPollClient): listeners send {key: last_seen_snapshot_id}; the host
replies as soon as any key has a newer snapshot, so config changes (replica
sets, route tables) propagate without polling on the data path.
"""

from __future__ import annotations

import asyncio

from ray_tpu_torch._private.common import config
from ray_tpu_torch._private.rpc import spawn as _spawn
from typing import Any, Callable, Dict, Optional, Tuple


class LongPollHost:
    """Lives inside the ServeController actor."""

    def __init__(self):
        self._snapshot_ids: Dict[str, int] = {}
        self._snapshots: Dict[str, Any] = {}
        self._changed = asyncio.Condition()

    def notify_changed(self, key: str, value: Any) -> None:
        self._snapshot_ids[key] = self._snapshot_ids.get(key, -1) + 1
        self._snapshots[key] = value

        async def _wake():
            async with self._changed:
                self._changed.notify_all()

        _spawn(_wake())

    async def listen_for_change(
        self, keys_to_snapshot_ids: Dict[str, int]
    ) -> Dict[str, Tuple[int, Any]]:
        """Block until any requested key is newer than the caller's snapshot,
        then return {key: (snapshot_id, value)} for all stale keys."""

        def stale() -> Dict[str, Tuple[int, Any]]:
            out = {}
            for key, seen in keys_to_snapshot_ids.items():
                cur = self._snapshot_ids.get(key, -1)
                if cur > seen:
                    out[key] = (cur, self._snapshots.get(key))
            return out

        out = stale()
        if out:
            return out
        try:
            async with self._changed:
                await asyncio.wait_for(
                    self._changed.wait_for(lambda: bool(stale())),
                    timeout=config.serve_long_poll_timeout_s,
                )
        except asyncio.TimeoutError:
            return {}
        return stale()


class LongPollClient:
    """Runs wherever a router lives; re-issues listen calls forever and feeds
    updates to callbacks. `listen` is an async callable
    (keys_to_snapshot_ids) -> updates dict."""

    def __init__(
        self,
        listen: Callable,
        key_listeners: Dict[str, Callable[[Any], None]],
    ):
        self._listen = listen
        self._key_listeners = key_listeners
        self._snapshot_ids = {k: -1 for k in key_listeners}
        self._task: Optional[asyncio.Task] = None
        self._stopped = False

    def start(self) -> None:
        self._task = _spawn(self._run())

    def stop(self) -> None:
        self._stopped = True
        if self._task is not None:
            self._task.cancel()

    async def _run(self) -> None:
        while not self._stopped:
            try:
                updates = await self._listen(dict(self._snapshot_ids))
            except asyncio.CancelledError:
                return
            except Exception:
                await asyncio.sleep(0.2)
                continue
            for key, (sid, value) in (updates or {}).items():
                # Single-writer: _run() is the only task that mutates this
                # client's _snapshot_ids, so the read-await-write is benign.
                self._snapshot_ids[key] = sid  # aio-lint: disable=await-interleave
                cb = self._key_listeners.get(key)
                if cb is not None:
                    cb(value)
