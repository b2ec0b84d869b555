"""Mutable shared-memory channels (single-writer, single-reader, one slot).

Analog of python/ray/experimental/channel/shared_memory_channel.py backed by
the C++ mutable-object machinery (experimental_mutable_object_manager.h:37):
a fixed shm segment reused for every message — no per-message allocation,
naming, or RPC. Synchronization is a seqlock: the writer bumps the sequence
to odd while writing and even when done; the reader spins (briefly) then
sleeps, and validates that the header (sequence and length) didn't move
mid-read.

Layout: [seq: u64][length: u64][payload...]

A sealed header whose length is shorter than any frame (0 is what a fresh
segment holds) is a write not yet visible, never a message: the reader
polls on instead of parsing it.
"""

from __future__ import annotations

import pickle
import struct
import time
from typing import Any, Optional, Tuple

import cloudpickle

from ray_tpu_torch._private import shm

HEADER = struct.Struct("<QQ")
DATA_OFFSET = 64  # keep payload cache-line aligned


class ChannelFullError(Exception):
    pass


class Channel:
    """One-slot mutable channel over a named shm segment."""

    # The shortest frame a writer seals: a pickle is at least one byte.
    MIN_FRAME = 1

    def __init__(self, name: str, max_buf_size: int = 10 * 1024 * 1024, *,
                 create: bool = False):
        self.name = name
        self.max_buf_size = max_buf_size
        if create:
            # A new segment is zero-filled, i.e. header (0, 0). Nothing here
            # writes the header: a store to it could only reset a live slot.
            self._seg = shm.create(name, DATA_OFFSET + max_buf_size)
        else:
            self._seg = shm.open_rw(name)
        self._last_read_seq = 0

    # -- writer side ---------------------------------------------------------

    def write(self, value: Any) -> None:
        payload = cloudpickle.dumps(value, protocol=pickle.HIGHEST_PROTOCOL)
        if len(payload) > self.max_buf_size:
            raise ChannelFullError(
                f"message of {len(payload)} bytes exceeds channel capacity "
                f"{self.max_buf_size}; recompile with a larger max_buf_size"
            )
        view = self._seg.view
        seq, _ = HEADER.unpack_from(view, 0)
        HEADER.pack_into(view, 0, seq + 1, len(payload))  # odd = writing
        view[DATA_OFFSET : DATA_OFFSET + len(payload)] = payload
        HEADER.pack_into(view, 0, seq + 2, len(payload))  # even = sealed

    # -- reader side ---------------------------------------------------------

    def read(self, timeout: Optional[float] = None) -> Any:
        """Block until a message newer than the last read arrives."""
        view = self._seg.view
        deadline = None if timeout is None else time.monotonic() + timeout
        polls = 0
        while True:
            seq, length = HEADER.unpack_from(view, 0)
            if seq % 2 == 0 and seq > self._last_read_seq and length >= self.MIN_FRAME:
                payload = bytes(view[DATA_OFFSET : DATA_OFFSET + length])
                # seqlock validate: no concurrent rewrite, and both header
                # fields as first read (they are two loads, not one).
                if HEADER.unpack_from(view, 0) == (seq, length):
                    # Decode strictly AFTER validation, from the private
                    # copy: torn slot bytes must be retried, never parsed.
                    self._last_read_seq = seq
                    return self._decode_payload(payload)
            polls += 1
            if deadline is not None and polls % 64 == 0 and time.monotonic() > deadline:
                raise TimeoutError(f"channel {self.name} read timed out")
            # sched_yield-style polling: busy-spinning starves the peer on
            # CPU-constrained hosts (measured 100x worse on 1 core), while
            # sleep(0) keeps hot ping-pong ~100us. Back off when idle.
            if polls < 2000:
                time.sleep(0)
            elif polls < 20000:
                time.sleep(0.00005)
            else:
                time.sleep(0.001)

    def _decode_payload(self, payload: bytes) -> Any:
        """Subclass hook: turn a validated snapshot of the slot into a value
        (TensorChannel parses a raw array header instead of unpickling)."""
        return cloudpickle.loads(payload)

    def close(self, unlink: bool = False) -> None:
        try:
            self._seg.close()
        except Exception:
            pass
        if unlink:
            try:
                shm.unlink(self.name)
            except Exception:
                pass


def make_channel(spec, *, create: bool = False) -> Channel:
    """Open a channel from its wire spec (name, size[, kind[, meta]]): kind
    "tensor" -> array-native TensorChannel, "device" -> compiled
    device-to-device DeviceTensorChannel (meta holds the collective group +
    src/dst ranks), else the pickle Channel."""
    name, size = spec[0], spec[1]
    kind = spec[2] if len(spec) > 2 else "chan"
    if kind == "tensor":
        from ray_tpu_torch.dag.tensor_channel import TensorChannel

        return TensorChannel(name, size, create=create)
    if kind == "device":
        from ray_tpu_torch.dag.tensor_channel import DeviceTensorChannel

        meta = spec[3] if len(spec) > 3 else None
        return DeviceTensorChannel(name, size, create=create, meta=meta)
    return Channel(name, size, create=create)
