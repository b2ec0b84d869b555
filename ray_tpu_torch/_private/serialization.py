"""Value serialization for the object store.

Analog of the reference's SerializationContext (python/ray/_private/serialization.py:111):
cloudpickle for arbitrary Python values, pickle protocol 5 ``buffer_callback`` for
out-of-band zero-copy of large contiguous buffers (numpy host arrays), and
custom reducers for ObjectRef so refs travel inside task args and returns.

Wire layout of a stored object (one contiguous byte region, shm- and
socket-friendly)::

    [4B header_len][msgpack header][pad to 64][buffer 0][pad][buffer 1] ...

header = {"p": pickled-meta-bytes, "o": [buffer offsets], "s": [buffer sizes],
          "e": bool is_exception}

Buffers are 64-byte aligned so deserialized numpy views over shm are
cache-line aligned and directly usable by torch.from_numpy / dlpack without
a copy. torch tensors, CUDA ones included, travel as their raw bytes in one
out-of-band buffer and come back as CPU tensors (`_torch_reducers`).
"""

from __future__ import annotations

import collections
import io
import os
import pickle
import struct
import sys
import threading
from typing import Any, Callable, List, Optional, Tuple

import msgpack

import cloudpickle

_ALIGN = 64
_LEN = struct.Struct("<I")
# Buffers smaller than this are cheaper to keep inline in the pickle stream.
_OOB_THRESHOLD = 512

try:
    from ray_tpu_torch._native._shm import parallel_copy as _parallel_copy
except ImportError:  # pragma: no cover - pure-python installs
    _parallel_copy = None

try:
    from ray_tpu_torch._native._shm import copy_nt as _copy_nt
except ImportError:  # pragma: no cover - pure-python installs
    _copy_nt = None

# copy_nt only beats a slice assign once the destination stops fitting in
# cache (its non-temporal path engages at 1 MiB; below that it is a plain
# memcpy behind an extra call).
_NT_MIN = 1 << 20

# Threads for the GIL-released multithreaded memcpy. On few-core hosts the
# fan-out/join overhead plus contention makes it SLOWER than one plain slice
# copy (measured: 1.2-1.8ms vs 0.72ms per 16 MiB on 1 core), so it only
# engages when enough cores exist to win.
_COPY_THREADS = min(4, os.cpu_count() or 1)
if _COPY_THREADS < 3:
    _parallel_copy = None


def _align(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


class _SerializationThreadContext(threading.local):
    def __init__(self):
        self.contained_refs: Optional[List[Any]] = None
        self.ref_deserializer: Optional[Callable] = None
        self.actor_handle_deserializer: Optional[Callable] = None


_ctx = _SerializationThreadContext()


def record_contained_ref(ref) -> None:
    """Called by ObjectRef.__reduce__ while a serialize() is in flight."""
    if _ctx.contained_refs is not None:
        _ctx.contained_refs.append(ref)


def get_ref_deserializer():
    return _ctx.ref_deserializer


def get_actor_handle_deserializer():
    return _ctx.actor_handle_deserializer


class SerializedObject:
    """A serialized value: header + list of out-of-band buffers.

    ``contained_refs`` lists every ObjectRef found inside the value — the
    caller uses it for distributed ref counting (the reference tracks the
    same set in CoreWorker::Put / TaskManager).
    """

    __slots__ = ("header", "buffers", "contained_refs", "is_exception", "_size")

    def __init__(self, header: bytes, buffers: List[memoryview], contained_refs, is_exception):
        self.header = header
        self.buffers = buffers
        self.contained_refs = contained_refs
        self.is_exception = is_exception
        self._size = None

    @property
    def total_size(self) -> int:
        if self._size is None:
            size = 4 + len(self.header)
            for buf in self.buffers:
                size = _align(size) + buf.nbytes
            self._size = size
        return self._size

    def write_to(self, dest: memoryview) -> int:
        """Write the full wire layout into ``dest``; returns bytes written."""
        offset = 0
        dest[0:4] = _LEN.pack(len(self.header))
        offset = 4
        dest[offset : offset + len(self.header)] = self.header
        offset += len(self.header)
        for buf in self.buffers:
            offset = _align(offset)
            flat = buf.cast("B") if buf.format != "B" or buf.ndim != 1 else buf
            n = flat.nbytes
            if n >= (4 << 20) and _parallel_copy is not None:
                # Multithreaded GIL-released memcpy (src/shm_buffer.cc):
                # large puts run at memory bandwidth, not one core's memcpy.
                _parallel_copy(dest[offset : offset + n], flat, _COPY_THREADS)
            elif n >= _NT_MIN and _copy_nt is not None:
                # Single-threaded cache-bypassing copy: shm destinations are
                # cold, so streaming stores skip the read-for-ownership that
                # dominates a regular large memcpy.
                _copy_nt(dest[offset : offset + n], flat)
            else:
                dest[offset : offset + n] = flat
            offset += n
        return offset

    def to_bytes(self) -> "bytes | bytearray":
        """The serialized region as one contiguous buffer. Returns the
        ``bytearray`` it was built into when out-of-band buffers are present
        — a final ``bytes(out)`` would copy the whole region again. Callers
        treat the result as read-only; anything crossing into native code
        that requires exact ``bytes`` (the fastpath channel's
        PyBytes_AsStringAndSize) must wrap it itself."""
        if not self.buffers:
            # Hot path: no out-of-band buffers — the region is just the
            # length-prefixed header.
            return _LEN.pack(len(self.header)) + self.header
        out = bytearray(self.total_size)
        self.write_to(memoryview(out))
        return out


_SIMPLE_SCALARS = (type(None), bool, int, float, str, bytes)


def _is_simple(value: Any, depth: int = 3) -> bool:
    """True when plain (C) pickle provably round-trips ``value`` with the
    same semantics as cloudpickle: scalars, numpy arrays, ObjectRefs (custom
    __reduce__), and shallow containers of those. Anything else — functions,
    classes, arbitrary instances — may pickle by module reference (wrong for
    __main__-defined objects), so it takes the cloudpickle path."""
    t = type(value)
    if t in _SIMPLE_SCALARS:
        return True
    name = t.__name__
    if name == "ndarray" and t.__module__ == "numpy":
        # object-dtype arrays can hold cloudpickle-only values.
        return not value.dtype.hasobject
    if (
        name in ("ObjectRef", "ActorHandle", "ClientObjectRef")
        and t.__module__.startswith("ray_tpu_torch")
    ):
        return True
    if depth > 0:
        if t is tuple or t is list:
            if len(value) <= 16:
                return all(_is_simple(v, depth - 1) for v in value)
            return False
        if t is dict:
            if len(value) <= 16:
                return all(
                    _is_simple(k, depth - 1) and _is_simple(v, depth - 1)
                    for k, v in value.items()
                )
            return False
    return False


def serialize(value: Any) -> SerializedObject:
    is_exception = isinstance(value, BaseException)
    buffers: List[pickle.PickleBuffer] = []
    prev = _ctx.contained_refs
    _ctx.contained_refs = []
    try:
        def buffer_cb(pb: pickle.PickleBuffer) -> bool:
            view = pb.raw()
            if view.nbytes < _OOB_THRESHOLD:
                return True  # keep small buffers inline
            buffers.append(pb)
            return False

        # C-pickle fast path for provably-safe values (~10x cheaper than
        # building a CloudPickler); cloudpickle for everything else.
        if _is_simple(value):
            meta = pickle.dumps(value, protocol=5, buffer_callback=buffer_cb)
        else:
            with io.BytesIO() as f:
                pickler = _TorchPickler(f, _torch_reducers(), protocol=5,
                                        buffer_callback=buffer_cb)
                pickler.dump(value)
                meta = f.getvalue()
        contained = _ctx.contained_refs
    finally:
        _ctx.contained_refs = prev

    raw_views = [pb.raw() for pb in buffers]
    # Compute offsets for the wire layout.
    offsets: List[int] = []
    sizes: List[int] = []
    # Header must be built before offsets are final; offsets are relative to
    # the start of the whole region, so build header iteratively: header size
    # changes offsets, so instead make offsets relative to the END of the
    # header region, which is itself aligned.
    rel = 0
    for view in raw_views:
        rel = _align(rel)
        offsets.append(rel)
        sizes.append(view.nbytes)
        rel += view.nbytes
    header = msgpack.packb(
        {"p": meta, "o": offsets, "s": sizes, "e": is_exception}, use_bin_type=True
    )
    return SerializedObject(header, raw_views, contained, is_exception)


def deserialize(region, on_release: Optional[Callable[[], None]] = None) -> Tuple[Any, bool]:
    """Inverse of serialize. ``region`` is a bytes-like over the wire layout.

    Returns (value, is_exception). Out-of-band buffers are zero-copy views
    into ``region`` — the caller must keep the backing memory alive as long
    as anything built on them is. With ``on_release``, each buffer is handed
    to the value as a _RegionBuffer, and on_release() runs once, when the
    last of them is gone: when nothing of the value, or of any array a
    caller took out of it, can read ``region`` any more (at once when the
    value kept none).
    """
    view = memoryview(region)
    (header_len,) = _LEN.unpack(view[0:4])
    header = msgpack.unpackb(view[4 : 4 + header_len], raw=False)
    base = _align(4 + header_len)
    # Offsets recorded relative to a zero base then shifted by aligned header.
    bufs = []
    for off, size in zip(header["o"], header["s"]):
        start = base + off
        bufs.append(view[start : start + size])
    if on_release is not None:
        bufs = _region_buffers(bufs, on_release)
    value = pickle.loads(header["p"], buffers=bufs)
    return value, header["e"]


class _RegionBuffer:
    """An out-of-band buffer over the caller's region (a PEP 688 exporter).
    Whatever is built on it (a numpy array and its views, an Arrow buffer)
    keeps it alive, so it is collected only when nothing can read the
    region through it."""

    __slots__ = ("_view", "__weakref__")

    def __init__(self, view: memoryview):
        self._view = view

    def __buffer__(self, flags: int) -> memoryview:
        return memoryview(self._view)

    def __release_buffer__(self, view: memoryview) -> None:
        view.release()


def _region_buffers(views: List[memoryview], on_release: Callable[[], None]) -> list:
    """Wrap each view in a _RegionBuffer; on_release() runs once, after the
    last wrapper is collected (or now, with no views)."""
    import weakref

    if not views:
        on_release()
        return views
    lock, left = threading.Lock(), [len(views)]

    def one_gone() -> None:
        with lock:
            left[0] -= 1
            last = left[0] == 0
        if last:
            on_release()

    wrapped = [_RegionBuffer(v) for v in views]
    for w in wrapped:
        weakref.finalize(w, one_gone)
    return wrapped


def header_buffer_base(region) -> int:
    view = memoryview(region)
    (header_len,) = _LEN.unpack(view[0:4])
    return _align(4 + header_len)


class DeserializationContext:
    """Installs ref/actor-handle deserializers for the current thread while
    deserializing (the worker sets this so unpickled ObjectRefs re-attach to
    the local core worker for ref counting and `get`)."""

    def __init__(self, ref_deserializer=None, actor_handle_deserializer=None):
        self._ref = ref_deserializer
        self._actor = actor_handle_deserializer

    def __enter__(self):
        self._prev = (_ctx.ref_deserializer, _ctx.actor_handle_deserializer)
        _ctx.ref_deserializer = self._ref
        _ctx.actor_handle_deserializer = self._actor
        return self

    def __exit__(self, *exc):
        _ctx.ref_deserializer, _ctx.actor_handle_deserializer = self._prev
        return False


def _rebuild_tensor(raw, dtype, shape, requires_grad: bool, is_param: bool):
    import torch

    # The store hands back read-only buffers, and a tensor cannot be made
    # read-only: the tensor gets memory of its own.
    t = torch.from_numpy(raw if raw.flags.writeable else raw.copy())
    t = t.view(dtype).reshape(shape)
    if is_param:
        return torch.nn.Parameter(t, requires_grad=requires_grad)
    return t.requires_grad_(requires_grad)


def _reduce_tensor(t):
    import torch

    if (t.layout != torch.strided or t.is_quantized or t.device.type not in ("cpu", "cuda")
            or (t.requires_grad and not t.is_leaf)):
        return t.__reduce_ex__(pickle.HIGHEST_PROTOCOL)  # torch's own, and its errors
    # Raw bytes, so that dtypes numpy lacks (bfloat16, float8) travel too.
    raw = t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy()
    return (_rebuild_tensor, (raw, t.dtype, tuple(t.shape), t.requires_grad,
                              isinstance(t, torch.nn.Parameter)))


def _torch_reducers() -> dict:
    """{type: reducer} for torch tensors, once user code has imported torch
    into this process: the runtime's daemons and plain workers never import
    it. A tensor travels as one out-of-band buffer of its bytes, fetched to
    the host at Put time, so a CUDA tensor comes back as a CPU tensor (as
    the JAX package's jax arrays come back as host numpy) and the consumer
    moves it to its own device. The table keys on the exact type, so
    Parameter is listed beside Tensor."""
    if "torch" not in sys.modules:
        return {}
    import torch

    return {torch.Tensor: _reduce_tensor, torch.nn.Parameter: _reduce_tensor}


class _TorchPickler(cloudpickle.Pickler):
    """cloudpickle's pickler with the torch reducers in its own dispatch
    table (the C pickler reads the table when it is made). Registering them
    with copyreg would change every pickle of the process: torch.save would
    write tensors that torch.load (weights_only) refuses."""

    def __init__(self, file, reducers: dict, **kwargs):
        self.dispatch_table = collections.ChainMap(reducers, cloudpickle.Pickler.dispatch_table)
        super().__init__(file, **kwargs)

