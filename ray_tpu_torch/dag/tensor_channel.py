"""Array-native channels for compiled DAGs and the CUDA device channel.

Port of ray_tpu/dag/tensor_channel.py. The reference moves GPU tensors
between compiled-DAG actors over NCCL (python/ray/experimental/channel/
torch_tensor_nccl_channel.py), skipping the object store and host memory.
Here there are three layers:

1. ``TensorChannel`` — a shm channel for numpy arrays and torch tensors:
   raw dtype/shape header + buffer memcpy instead of cloudpickle. A numpy
   payload's dtype field is numpy's dtype string, as in ray_tpu; a torch
   tensor's is the torch dtype's name (``torch.bfloat16``: numpy has no
   bf16), and it decodes back to a CPU tensor. A CUDA tensor on this wire
   is copied to the host and arrives as a CPU tensor.

2. ``DeviceTensorChannel`` — the compiled-graph device channel: the shm
   slot carries a CONTROL FRAME (magic + dtype + shape + a route record)
   and a CUDA tensor's payload moves device to device: by CUDA IPC between
   two processes of one host, by the collective group's send/recv across
   hosts, or by a device copy within one process (``loopback``).

3. ``make_cuda_hop`` — the building block of the loopback: one copy of a
   tensor from one CUDA device to another, ordered after the source
   device's queued work.
"""

from __future__ import annotations

import pickle
import struct
import sys
import zlib
from collections import Counter
from typing import Any

import numpy as np

from ray_tpu_torch.dag.channel import DATA_OFFSET, HEADER, Channel, ChannelFullError

_MAGIC_ARRAY = 0xA1
_MAGIC_ARRAY_OK = 0xA2  # array wrapped in the exec-loop ("ok", value) tuple
_MAGIC_PICKLE = 0xB2
_MAGIC_DEVICE = 0xD1  # control frame: payload moved device->device
_MAGIC_DEVICE_OK = 0xD2  # device frame wrapped in ("ok", value)
# [magic: u8][ndim: u8][dtype-len: u8][reserved: u8][nbytes: u64]
_AHDR = struct.Struct("<BBBxQ")
# The first byte of a device frame's body names the route the payload took.
_ROUTE_LOOPBACK, _ROUTE_IPC, _ROUTE_P2P = b"L", b"I", b"P"
_TORCH_DTYPE = "torch."

# Loopback handoff: when one process addresses both endpoint cards the
# tensor copied onto the dst card is parked here by channel name for the
# same-process reader. Cross-process readers fall back to the frame body.
_DEVICE_SLOTS: dict = {}
# Device payloads this process wrote or read, by route ("ipc", "p2p",
# "loopback"): what shows which route a run's device edges took.
routes: Counter = Counter()


def _is_tensor(value) -> bool:
    torch = sys.modules.get("torch")  # a process without torch holds no tensor
    return torch is not None and isinstance(value, torch.Tensor)


def _is_ok_wire(value) -> bool:
    return (
        type(value) is tuple
        and len(value) == 2
        and isinstance(value[0], str)
        and value[0] == "ok"
    )


def _torch_dtype(name: str):
    import torch

    return getattr(torch, name[len(_TORCH_DTYPE):])


def _tensor_bytes(t) -> np.ndarray:
    """A contiguous host copy of tensor `t`'s bytes, as uint8."""
    import torch

    t = t.detach()
    if t.device.type != "cpu":
        t = t.cpu()
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


def _tensor_from_bytes(data: np.ndarray, dtype_name: str, shape):
    """A CPU tensor of `shape` and torch dtype `dtype_name` over a private
    copy of the uint8 array `data` (the slot's snapshot is read-only)."""
    import torch

    dtype = _torch_dtype(dtype_name)
    if data.size == 0:
        return torch.empty(shape, dtype=dtype)
    return torch.from_numpy(data.copy()).view(dtype).reshape(shape)


class TensorChannel(Channel):
    """One-slot shm channel whose array payloads skip pickle entirely.

    Synchronization is inherited from Channel (seqlock read loop + decode
    hook); only the payload encoding differs.
    """

    MIN_FRAME = _AHDR.size  # every frame starts with its array header

    # -- writer side ---------------------------------------------------------

    def write(self, value: Any) -> None:
        magic = _MAGIC_ARRAY
        if _is_ok_wire(value):
            # Exec-loop wire tuple: keep the array fast path for the value.
            magic = _MAGIC_ARRAY_OK
            value = value[1]
        encoded = self._encode(value)
        if encoded is None:
            payload = _pickle_payload(
                ("ok", value) if magic == _MAGIC_ARRAY_OK else value
            )
            self._write_raw(_MAGIC_PICKLE, payload, b"", ())
            return
        self._write_raw(magic, *encoded)

    @staticmethod
    def _encode(value):
        """(uint8 body, dtype bytes, shape) of an array payload; None for a
        value that takes the pickle wire."""
        if isinstance(value, np.ndarray):
            if value.dtype.hasobject:
                return None
            shape = value.shape  # BEFORE ascontiguousarray (0-d becomes 1-d)
            arr = np.ascontiguousarray(value)
            return arr.view(np.uint8).reshape(-1), arr.dtype.str.encode(), shape
        if _is_tensor(value):
            import torch

            if value.layout != torch.strided or value.is_quantized:
                return None
            return (_tensor_bytes(value), str(value.dtype).encode(),
                    tuple(value.shape))
        return None

    def _write_raw(self, magic: int, body, dtype_b: bytes, shape) -> None:
        shape_b = b"".join(struct.pack("<q", d) for d in shape)
        nbytes = body.nbytes if isinstance(body, np.ndarray) else len(body)
        total = _AHDR.size + len(dtype_b) + len(shape_b) + nbytes
        if total > self.max_buf_size:
            raise ChannelFullError(
                f"message of {total} bytes exceeds channel capacity "
                f"{self.max_buf_size}; recompile with a larger max_buf_size"
            )
        view = self._seg.view
        seq, _ = HEADER.unpack_from(view, 0)
        HEADER.pack_into(view, 0, seq + 1, total)  # odd = writing
        off = DATA_OFFSET
        _AHDR.pack_into(view, off, magic, len(shape), len(dtype_b), nbytes)
        off += _AHDR.size
        view[off : off + len(dtype_b)] = dtype_b
        off += len(dtype_b)
        view[off : off + len(shape_b)] = shape_b
        off += len(shape_b)
        if isinstance(body, np.ndarray):
            np.frombuffer(view, dtype=np.uint8, count=nbytes, offset=off)[:] = body
        else:
            view[off : off + nbytes] = body
        HEADER.pack_into(view, 0, seq + 2, total)  # even = sealed

    # -- reader side ---------------------------------------------------------

    @staticmethod
    def _parse(payload: bytes):
        """(magic, dtype string, shape, body offset, body length) of a frame."""
        magic, ndim, dlen, nbytes = _AHDR.unpack_from(payload, 0)
        off = _AHDR.size
        dtype_s = payload[off : off + dlen].decode()
        off += dlen
        shape = tuple(
            struct.unpack_from("<q", payload, off + 8 * i)[0] for i in range(ndim)
        )
        return magic, dtype_s, shape, off + 8 * ndim, nbytes

    def _decode_payload(self, payload: bytes) -> Any:
        """Parse a validated snapshot (Channel.read's seqlock already copied
        it out of the slot)."""
        magic, dtype_s, shape, off, nbytes = self._parse(payload)
        if magic == _MAGIC_PICKLE:
            import cloudpickle

            return cloudpickle.loads(payload[off : off + nbytes])
        data = np.frombuffer(payload, dtype=np.uint8, count=nbytes, offset=off)
        if dtype_s.startswith(_TORCH_DTYPE):
            out = _tensor_from_bytes(data, dtype_s, shape)
        else:
            out = data.view(np.dtype(dtype_s)).reshape(shape)
        return ("ok", out) if magic == _MAGIC_ARRAY_OK else out


class DeviceTensorChannel(TensorChannel):
    """Compiled-graph device channel: shm control frame + device payload.

    ``meta`` names the producer/consumer collective ranks:
    ``{"group": <collective group>, "src": <rank>, "dst": <rank>}``.
    The first write or read resolves the channel's mode:

    - ``ipc``: the named group is initialized on a torch backend (nccl or
      gloo) in this process and spans both ranks, which sit on one host.
      The writer keeps one device staging buffer, copies each tensor into
      it and records an interprocess CUDA event; the frame carries the
      buffer's IPC handle and the event's. The reader opens both once,
      makes its stream wait on the event and copies the tensor out. Two
      actors sharing one card take this route too (NCCL refuses them).
    - ``p2p``: the same group, with the ranks on two hosts: the frame
      carries only [magic, dtype, shape] and the payload goes by the
      group's send/recv (NCCL on the card).
    - ``loopback``: no such group, and this process addresses both
      ``cuda:src`` and ``cuda:dst`` (two cards). The tensor is copied onto
      ``cuda:dst`` and parked in ``_DEVICE_SLOTS`` for a same-process
      reader, and the frame also carries its bytes so a reader in another
      process degrades to the TensorChannel path instead of deadlocking.
    - ``shm``: no device route; plain TensorChannel behavior.

    The device routes carry CUDA tensors. On a gloo group a CPU tensor is
    the group's own payload and takes ``p2p`` as well. Every other value
    (numpy arrays, STOP sentinel, errors, pickled results) takes the
    inherited shm path, so DAG teardown and error propagation are
    identical across modes. The one-slot channel has no back-pressure of
    its own: a compiled DAG writes an edge again only after its last
    output was read, which is what makes reusing one staging buffer safe.
    """

    def __init__(self, name: str, max_buf_size: int = 10 * 1024 * 1024, *,
                 create: bool = False, meta=None):
        super().__init__(name, max_buf_size, create=create)
        meta = meta or {}
        self.group_name = meta.get("group", "default")
        self.src = int(meta.get("src", 0))
        self.dst = int(meta.get("dst", 1))
        self._mode = None
        self._group = None
        self._tag = zlib.crc32(name.encode()) & 0x7FFFFFFF
        # ipc writer: the staging buffer, its event and their frame record;
        # buffers it outgrew stay alive until close (a reader may hold them).
        self._staging = None
        self._event = None
        self._ipc_record = b""
        self._retired: list = []
        # ipc reader: the last opened (record, buffer, event).
        self._opened = None

    # -- mode resolution -----------------------------------------------------

    def _resolve(self):
        if self._mode is not None:
            return self._mode
        from ray_tpu_torch.util.collective import collective as _col

        group = _col._manager.groups.get(self.group_name)
        if (
            group is not None
            and group.backend in _col.TORCH_BACKENDS
            and group.world_size > max(self.src, self.dst)
            and self.src != self.dst
        ):
            self._group = group
            same_host = group.nodes[self.src] == group.nodes[self.dst]
            self._mode = "ipc" if same_host else "p2p"
        elif group is None and self.src != self.dst and _cards() > max(self.src, self.dst):
            self._mode = "loopback"
        else:
            self._mode = "shm"
        return self._mode

    @property
    def mode(self) -> str:
        return self._resolve()

    def _route(self, value):
        """The device route `value` takes, None for the shm path."""
        if not _is_tensor(value) or value.is_sparse:
            return None
        mode = self._resolve()
        if value.device.type == "cuda":
            return None if mode == "shm" else mode
        if value.device.type == "cpu" and mode in ("ipc", "p2p") and self._group.backend == "gloo":
            return "p2p"
        return None

    # -- writer side ---------------------------------------------------------

    def write(self, value: Any) -> None:
        magic = _MAGIC_DEVICE
        if _is_ok_wire(value):
            magic = _MAGIC_DEVICE_OK
            value = value[1]
        route = self._route(value)
        if route is None:
            super().write(("ok", value) if magic == _MAGIC_DEVICE_OK else value)
            return
        t = value.detach().contiguous()
        dtype_b, shape = str(t.dtype).encode(), tuple(t.shape)
        routes[route] += 1
        if route == "ipc":
            self._write_raw(magic, _ROUTE_IPC + self._stage_ipc(t), dtype_b, shape)
        elif route == "p2p":
            # The frame seals first: the reader learns shape and dtype from
            # it and posts the matching recv; the send does not block.
            self._write_raw(magic, _ROUTE_P2P + t.device.type.encode(), dtype_b, shape)
            from ray_tpu_torch.util.collective import collective as _col

            _col._send_tensor(self._group, t, self.dst, self._tag)
        else:  # loopback
            _DEVICE_SLOTS[self.name] = make_cuda_hop(self.src, self.dst)(t)
            body = np.concatenate([np.frombuffer(_ROUTE_LOOPBACK, np.uint8),
                                   _tensor_bytes(t)])
            self._write_raw(magic, body, dtype_b, shape)

    def _stage_ipc(self, t) -> bytes:
        """Copy `t` into the staging buffer (regrown when too small), record
        the event after the copy, and return the frame's IPC record."""
        import torch
        from torch.multiprocessing.reductions import reduce_tensor

        nbytes = t.numel() * t.element_size()
        if (
            self._staging is None
            or self._staging.numel() < nbytes
            or self._staging.device != t.device
        ):
            if self._staging is not None:
                self._retired.append((self._staging, self._event))
            with torch.cuda.device(t.device):
                self._staging = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                                            device=t.device)
                self._event = torch.cuda.Event(interprocess=True)
                self._event.record()
            # reduce_tensor carries the caching allocator's block handle and
            # this storage's offset into it (the allocator sub-allocates).
            self._ipc_record = pickle.dumps(
                (reduce_tensor(self._staging), self._event.ipc_handle()),
                protocol=pickle.HIGHEST_PROTOCOL,
            )
        if nbytes:
            self._staging[:nbytes].copy_(t.reshape(-1).view(torch.uint8))
        self._event.record(torch.cuda.current_stream(t.device))
        return self._ipc_record

    # -- reader side ---------------------------------------------------------

    def _decode_payload(self, payload: bytes) -> Any:
        magic, dtype_s, shape, off, nbytes = self._parse(payload)
        if magic not in (_MAGIC_DEVICE, _MAGIC_DEVICE_OK):
            return super()._decode_payload(payload)
        route, body = payload[off : off + 1], payload[off + 1 : off + nbytes]
        if route == _ROUTE_IPC:
            routes["ipc"] += 1
            out = self._read_ipc(body, dtype_s, shape)
        elif route == _ROUTE_P2P:
            routes["p2p"] += 1
            out = self._read_p2p(body.decode(), dtype_s, shape)
        else:
            routes["loopback"] += 1
            out = _DEVICE_SLOTS.pop(self.name, None)
            if out is None:
                # A reader in another process: the frame body carries the
                # bytes (TensorChannel degradation).
                out = _tensor_from_bytes(np.frombuffer(body, np.uint8), dtype_s, shape)
        return ("ok", out) if magic == _MAGIC_DEVICE_OK else out

    def _read_ipc(self, record: bytes, dtype_s: str, shape):
        import torch

        if self._opened is None or self._opened[0] != record:
            # The record is what this channel's writer pickled.
            (rebuild, args), event_handle = pickle.loads(record)
            buf = rebuild(*args)  # cudaIpcOpenMemHandle: once per buffer
            event = torch.cuda.Event.from_ipc_handle(buf.device, event_handle)
            self._opened = (record, buf, event)
        _, buf, event = self._opened
        dtype = _torch_dtype(dtype_s)
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        dev = torch.device("cuda", torch.cuda.current_device())
        stream = torch.cuda.current_stream(dev)
        event.wait(stream)
        out = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        out.copy_(buf[:nbytes])
        # The writer refills the buffer on its next write: finish this copy
        # first.
        stream.synchronize()
        return out.view(dtype).reshape(shape)

    def _read_p2p(self, device_type: str, dtype_s: str, shape):
        from ray_tpu_torch.util.collective import collective as _col

        if self._resolve() not in ("ipc", "p2p"):
            raise RuntimeError(
                f"device channel {self.name}: control frame received but "
                f"group {self.group_name!r} is not initialized here"
            )
        out = _col._recv_tensor(self._group, shape, _torch_dtype(dtype_s),
                                self.src, self._tag)
        if device_type == "cuda" and out.device.type != "cuda":
            import torch

            out = out.to(torch.device("cuda", torch.cuda.current_device()))
        return out

    def close(self, unlink: bool = False) -> None:
        self._staging = self._event = None
        self._retired.clear()
        self._opened = None
        _DEVICE_SLOTS.pop(self.name, None)
        super().close(unlink)


def _cards() -> int:
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _pickle_payload(value) -> bytes:
    import cloudpickle

    return cloudpickle.dumps(value, protocol=pickle.HIGHEST_PROTOCOL)


def make_cuda_hop(src: int, dst: int):
    """One device hop between two CUDA devices: returns fn(x) that copies a
    tensor on ``cuda:src`` onto ``cuda:dst`` (reference analog: NCCL
    send/recv between aDAG actors; ray_tpu's make_ici_transfer is one ICI
    ppermute). The copy runs on dst's current stream after the work queued
    on src's current stream, so it reads what that work wrote."""
    import torch

    src_dev, dst_dev = torch.device("cuda", src), torch.device("cuda", dst)

    def hop(x):
        if x.device != src_dev:
            raise ValueError(f"the hop moves a tensor on {src_dev}, not on {x.device}")
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(src_dev))
        stream = torch.cuda.current_stream(dst_dev)
        stream.wait_event(ready)
        with torch.cuda.stream(stream):
            out = x.to(dst_dev, non_blocking=True)
        x.record_stream(stream)
        return out

    return hop
