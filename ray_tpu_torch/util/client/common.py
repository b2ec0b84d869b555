"""Shared pieces of the client protocol (both ends import this).

Analog of python/ray/util/client/common.py: ClientObjectRef /
ClientActorHandle are thin handles around ids owned by a server-side proxy
session; the session's CoreWorker is the real owner of every object the
client touches (src/ray/protobuf/ray_client.proto:326 message shapes).
"""

from __future__ import annotations

from typing import Optional, Tuple

from ray_tpu_torch._private import serialization


class ClientObjectRef:
    """Client-side handle to an object owned by the proxy session's core
    worker. Serializes exactly like a plain ObjectRef (hex + owner addr) so
    it can ride inside task args and deserialize cluster-side as a real,
    resolvable reference."""

    __slots__ = ("_hex", "_owner_addr", "_ctx", "__weakref__")

    def __init__(self, hex_id: str, owner_addr: Tuple[str, int], ctx=None):
        self._hex = hex_id
        self._owner_addr = tuple(owner_addr) if owner_addr else None
        self._ctx = ctx

    def hex(self) -> str:
        return self._hex

    def binary(self) -> bytes:
        return bytes.fromhex(self._hex)

    @property
    def owner_addr(self):
        return self._owner_addr

    def __repr__(self):
        return f"ClientObjectRef({self._hex})"

    def __hash__(self):
        return hash(self._hex)

    def __eq__(self, other):
        return getattr(other, "_hex", None) == self._hex and (
            isinstance(other, ClientObjectRef) or type(other).__name__ == "ObjectRef"
        )

    def __reduce__(self):
        # Record for dependency counting during client-side serialize, then
        # pickle to a plain cluster-side ref (the session core is the owner).
        serialization.record_contained_ref(self)
        from ray_tpu_torch._private.core_worker import _plain_ref

        return (_plain_ref, (self._hex, self._owner_addr))

    def __del__(self):
        ctx = self._ctx
        if ctx is not None and not ctx.closed:
            try:
                ctx._schedule_release(self._hex)
            except Exception:
                pass


def payload_to_bytes(payload) -> bytes:
    return bytes(payload) if isinstance(payload, memoryview) else payload
