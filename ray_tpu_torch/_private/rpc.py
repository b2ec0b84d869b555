"""Asyncio RPC layer: streaming msgpack frames over TCP.

TPU-native analog of the reference's rpc scaffolding (src/ray/rpc/): persistent
client connections with call multiplexing, a handler-registry server, and
server->client push for pubsub channels. The reference wraps gRPC; we use a
lean custom framing because every daemon here is an asyncio program and the
control-plane messages are small dicts — msgpack round-trips them with no
codegen step. Payloads that carry Python objects (task args, actor state)
are cloudpickled into opaque ``bytes`` fields by the caller.

Wire format: a raw msgpack stream; each message is ``[msgid, kind, method,
payload]``. Kinds: 0=request, 1=reply, 2=error-reply, 3=push (one-way),
4=blob (one-way when msgid==0, request otherwise), 5=blob-reply.
Requests may carry a fifth element: the remaining deadline budget (TTL) in
float seconds, stamped at the moment the frame is packed. The receiver
reconstructs an absolute deadline on its own clock (``loop.time() + ttl``)
— relative TTLs make the deadline clock-skew-free, and a frame a fault
schedule holds back arrives with its budget already shrunk. msgpack is
self-framing, so no length prefix is needed — the receiving side feeds
whole socket chunks to a streaming Unpacker and drains every complete
message per chunk with zero per-frame awaits.

Blob sidecar frames (kinds 4/5) are the zero-copy data plane: the control
frame is packed msgpack like any other, but its fifth element declares a
byte length and the next N bytes on the stream are the raw payload,
UN-packed. The sender hands ``memoryview``s straight to the transport (no
pack copy, no join); the receiver switches the read loop into blob mode
and streams the bytes into a *sink* — for object transfer that sink is
the destination shm arena at the object's assigned offset, so a remote
transfer costs one copy (socket -> arena), same as a local put. Sinks are
chosen per method (``Server.register_blob``), per call
(``Connection.call_into``), or default to an in-memory buffer delivered
to the regular handler as ``payload["data"]``.

Resilience (reference: retryable_grpc_client.h / gcs_rpc_client.h): every
``call`` with a timeout (explicit or inherited from the ambient handler
deadline) propagates its remaining budget downstream, so GCS -> raylet ->
worker chains shrink the budget at every hop and no hop outlives its
caller; servers shed requests that arrive already expired and cancel
handlers at their deadline. :class:`RetryPolicy` (full-jitter exponential
backoff with attempt + total-budget caps) drives both the ``connect`` dial
loop and :class:`RetryableConnection`, which re-dials dead links and
re-issues calls whose method the wire registry declares retry-safe.

Throughput design (reference: the C++ layer's batched stream writes in
ClientCallManager): the hot path is callback-based, not coroutine-based.
``call_nowait`` appends a pre-packed frame to a per-connection out-buffer and
schedules ONE flush per event-loop tick (``call_soon``), collapsing any number
of pipelined requests into a single ``transport.write`` syscall; replies are
dispatched inline from ``data_received``. ``call``/``push`` remain the
coroutine conveniences on top.
"""

from __future__ import annotations

import asyncio
import contextvars
import itertools
import logging
import os
import random
import tempfile
import traceback
from dataclasses import dataclass
from typing import Any, Awaitable, Callable, Dict, Iterator, List, Optional, Tuple

import msgpack

from ray_tpu_torch._private import telemetry
from ray_tpu_torch._private.common import config


def _uds_path(port: int) -> str:
    return os.path.join(tempfile.gettempdir(), f"ray_tpu_torch_uds_{port}.sock")


_LOOPBACK = frozenset({"127.0.0.1", "localhost", "::1"})

logger = logging.getLogger(__name__)

# The event loop holds only weak references to tasks: a fire-and-forget
# asyncio.create_task() whose result is dropped can be garbage-collected
# mid-flight (observed as lease requests silently vanishing under GC
# pressure). Every background task in the runtime goes through spawn(),
# which parks a strong reference until the task completes.
_BG_TASKS: set = set()


def spawn(coro) -> asyncio.Task:
    # The one sanctioned create_task call site: spawn() IS the wrapper the
    # raw-create-task rule points everyone at.
    task = asyncio.get_running_loop().create_task(coro)  # aio-lint: disable=raw-create-task
    _BG_TASKS.add(task)
    task.add_done_callback(_BG_TASKS.discard)
    return task


_KIND_REQ = 0
_KIND_REP = 1
_KIND_ERR = 2
_KIND_PUSH = 3
# Blob sidecar frames: the packed control message is [msgid, kind, method,
# payload, blob_len] and the blob_len bytes that follow on the stream are raw
# (not msgpack). kind 4 is one-way when msgid == 0 (PushChunk) and a request
# otherwise; kind 5 is a reply whose bulk data rides as the sidecar.
_KIND_BLOB = 4
_KIND_BLOB_REP = 5

_MAX_FRAME = 1 << 31

# msgpack fixarray headers (frames are 4-6 slots, always < 16): used when
# splicing a PackedPayload into a hand-assembled frame.
_FIXARRAY = [bytes([0x90 | i]) for i in range(16)]

# Per-kind frame/byte counters, cells bound once at import (indexable by the
# wire kind, so the send/receive hot paths do one list index + float add).
# Blob kinds count the sidecar bytes too — the data plane is the point.
_KIND_NAMES = ("req", "rep", "err", "push", "blob", "blob_rep")
_TEL_FRAMES_OUT = [
    telemetry.counter(
        "rpc", "frames_sent", "frames written, by wire kind"
    ).cell(kind=k)
    for k in _KIND_NAMES
]
_TEL_BYTES_OUT = [
    telemetry.counter(
        "rpc", "bytes_sent", "wire bytes written (control + blob sidecars)"
    ).cell(kind=k)
    for k in _KIND_NAMES
]
_TEL_FRAMES_IN = [
    telemetry.counter(
        "rpc", "frames_received", "frames decoded, by wire kind"
    ).cell(kind=k)
    for k in _KIND_NAMES
]
_TEL_BYTES_IN = telemetry.counter(
    "rpc", "bytes_received", "raw socket bytes received"
)
_TEL_DL_MET = telemetry.counter(
    "rpc", "deadline_met", "handlers finished inside their wire deadline"
)
_TEL_DL_SHED = telemetry.counter(
    "rpc", "deadline_shed", "requests dropped as already expired"
)
_TEL_DL_ENFORCED = telemetry.counter(
    "rpc", "deadline_enforced", "handlers cancelled at their wire deadline"
)
_TEL_DL_OVERRUNS = telemetry.counter(
    "rpc", "deadline_overruns", "handlers that outlived deadline + grace"
)

# _flush joins adjacent small buffers into one transport.write; buffers at or
# above this size are written individually so large blob memoryviews go to
# the socket without an intermediate join copy.
_WRITE_JOIN_MAX = 64 * 1024


def _blob_buffers(blob) -> list:
    """Normalize a blob argument (bytes/bytearray/memoryview or a list of
    them) into a flat list of 1-D byte memoryviews."""
    parts = [blob] if isinstance(blob, (bytes, bytearray, memoryview)) else list(blob)
    out = []
    for p in parts:
        v = p if isinstance(p, memoryview) else memoryview(p)
        if v.format != "B" or v.ndim != 1:
            v = v.cast("B")
        if v.nbytes:
            out.append(v)
    return out


def _blob_bytes(blob) -> bytes:
    """Materialize a blob into one stable bytes object (chaos interception:
    a delayed/duplicated frame must not reference live arena memory)."""
    bufs = _blob_buffers(blob)
    if len(bufs) == 1:
        return bytes(bufs[0])
    return b"".join(bufs)


class Blob:
    """Handler return value that ships as a blob-reply frame: ``payload`` is
    the msgpack meta, ``blob`` (bytes/memoryview or list of them) rides the
    stream raw. The buffers are written to the transport before the send
    call returns, so handlers may pass live arena views."""

    __slots__ = ("payload", "blob")

    def __init__(self, payload: Any, blob):
        self.payload = payload
        self.blob = blob


class BufferSink:
    """Default blob sink: accumulates the inbound blob into one buffer.
    ``value()`` returns the filled bytearray without a final copy."""

    __slots__ = ("_buf", "_pos")

    def __init__(self, size: int):
        self._buf = bytearray(size)
        self._pos = 0

    def write(self, view: memoryview) -> None:
        n = view.nbytes
        self._buf[self._pos : self._pos + n] = view
        self._pos += n

    def done(self, ok: bool) -> None:
        pass

    def value(self) -> bytearray:
        return self._buf


class _NullSink:
    """Discards an unwanted blob (declined by a sink factory) so the stream
    stays framed."""

    __slots__ = ()

    def write(self, view: memoryview) -> None:
        pass

    def done(self, ok: bool) -> None:
        pass


class SpanSink:
    """Blob sink writing sequentially into a caller-held memoryview span
    (e.g. an shm arena slice at an object's assigned offset)."""

    __slots__ = ("view", "pos", "written")

    def __init__(self, view: memoryview, pos: int = 0):
        self.view = view
        self.pos = pos
        self.written = 0

    def write(self, v: memoryview) -> None:
        n = v.nbytes
        self.view[self.pos : self.pos + n] = v
        self.pos += n
        self.written += n

    def done(self, ok: bool) -> None:
        pass

# Fault-injection hook (ray_tpu_torch.chaos): when set, every outbound frame from
# this process is offered to the interceptor BEFORE packing. The interceptor
# returns True to consume the frame (drop it, or re-deliver it later /
# duplicated / reordered via ``Connection._send_direct``) and False to let it
# flow normally. One module-global — not per-Connection — so a chaos schedule
# covers every link in the process (GCS, raylets, driver core) without the
# daemons knowing chaos exists. None (the default) costs one global read per
# frame on the hot path. Loop thread only, like every send.
_send_interceptor: Optional[Callable[["Connection", list], bool]] = None


def set_send_interceptor(fn: Optional[Callable[["Connection", list], bool]]) -> None:
    """Install (or clear, with None) the process-wide outbound-frame
    interceptor. Test/chaos tooling only; never used in production paths."""
    global _send_interceptor
    _send_interceptor = fn


def get_send_interceptor() -> Optional[Callable[["Connection", list], bool]]:
    return _send_interceptor


def pack_push(method: str, payload: Any = None) -> Optional[bytes]:
    """Pre-pack a one-way frame for fan-out via
    ``Connection.push_packed_nowait``. Returns None while a fault
    interceptor is installed: pre-packed bytes would bypass it, and a chaos
    schedule must see (and be able to drop/delay) every individual frame."""
    if _send_interceptor is not None:
        return None
    frame = [0, _KIND_PUSH, method, payload]
    if method in _native_methods():
        if _NATIVE_WIRE is not None:
            try:
                packed = _NATIVE_WIRE.pack_frame(frame)
                _TEL_NATIVE_PACK.inc()
                return packed
            except Exception:
                pass  # unexpected payload shape: fall through to msgpack
        _TEL_FALLBACK_PACK.inc()
    return _packb(frame)


# Sentinel error string delivered to call_cb callbacks on connection loss
# (distinguishes transport death from a handler-level error reply).
_CONNECTION_LOST = "__connection_lost__"


class RpcError(Exception):
    """Raised on the caller when the remote handler raised or the link died."""


class ConnectionLost(RpcError):
    pass


class DeadlineExceeded(RpcError):
    """A request arrived past its deadline (shed) or its handler was cut at
    the deadline. The error-reply text starts with this class name so the
    far side can tell budget exhaustion from a handler bug."""


class StaleLeaderError(RpcError):
    """A write carried a leader term older than the store's fence: the
    issuing GCS lost leadership (lease expired, standby promoted) and must
    not mutate control-plane state. Raised server-side by the replicated
    store and surfaced to clients as a typed error so callers can
    re-resolve the leader instead of retrying a doomed write."""


# Error-reply payloads are ``f"{type(e).__name__}: {e}"`` plus traceback;
# these prefixes re-type the caller-side exception so control flow (leader
# fencing, deadline budgeting) doesn't have to string-match at every site.
# Only RpcError subclasses belong here: callers' ``except RpcError`` blocks
# must keep catching every wire-level failure. Schemas in wire.py declare
# which of these (plus the RayTpuError family, which crosses inside reply
# payloads, not error frames) each method's handler can raise — the
# exc_flow lint pass keeps the declarations honest.
_TYPED_ERRORS = {
    "StaleLeaderError:": StaleLeaderError,
    "DeadlineExceeded:": DeadlineExceeded,
}


def _typed_error(payload) -> RpcError:
    if isinstance(payload, str):
        for prefix, cls in _TYPED_ERRORS.items():
            if payload.startswith(prefix):
                return cls(payload)
    return RpcError(payload)


_packb = msgpack.Packer(use_bin_type=True, autoreset=True).pack


# ---------------------------------------------------------------------------
# Native wire codec (src/fastpath.cc, ray_tpu_torch._native._fastpath).
#
# The hottest schemas — registered per-method in wire.NATIVE_WIRE_SCHEMAS —
# are packed by a C encoder that emits byte-identical msgpack (the parity
# fuzz in tests/test_fastpath_native.py holds both directions), and the
# whole inbound stream is decoded by a C streaming decoder with the same
# feed()/iterate/tell() surface as msgpack.Unpacker. Three ways back to the
# pure-Python path: the .so is absent (source checkout, masked import),
# RAY_TPU_NATIVE_WIRE=0, or the compiled schema versions disagree with
# wire.py (a drift the `wire-native-drift` lint rule catches at review
# time; the runtime check keeps a stale .so safe anyway).
# ---------------------------------------------------------------------------

_NATIVE_WIRE = None
if os.environ.get("RAY_TPU_NATIVE_WIRE", "1") != "0":  # pragma: no branch
    try:
        from ray_tpu_torch._native import _fastpath as _native_mod

        if hasattr(_native_mod, "pack_frame") and hasattr(_native_mod, "Decoder"):
            _NATIVE_WIRE = _native_mod
    except Exception:  # pragma: no cover - source checkout without the .so
        _NATIVE_WIRE = None

# Methods eligible for native pack: resolved lazily from wire.py (rpc.py is
# the bottom of the import graph and cannot import wire at module load).
# None = not resolved yet; frozenset once resolved.
_NATIVE_METHODS: Optional[frozenset] = None


def _native_methods() -> frozenset:
    global _NATIVE_METHODS
    if _NATIVE_METHODS is None:
        try:
            from ray_tpu_torch._private import wire  # lazy: avoid import cycle

            _NATIVE_METHODS = wire.native_method_set(_NATIVE_WIRE)
        except Exception:  # pragma: no cover - wire must stay importable
            logger.exception("native wire schema resolution failed")
            _NATIVE_METHODS = frozenset()
    return _NATIVE_METHODS


def native_wire_active() -> bool:
    """True when the C codec is loaded and at least one schema is bound."""
    return _NATIVE_WIRE is not None and bool(_native_methods())


_TEL_NATIVE_PACK = telemetry.counter(
    "rpc", "native_pack", "frames packed by the native (C) wire codec"
)
_TEL_FALLBACK_PACK = telemetry.counter(
    "rpc",
    "fallback_pack",
    "native-registered frames packed by Python msgpack instead "
    "(.so absent, RAY_TPU_NATIVE_WIRE=0, or a pack error)",
)
_TEL_BATCH_SIZE = telemetry.histogram(
    "rpc",
    "lease_batch_size",
    "entries coalesced per flushed lease batch (1 = singleton fast frame)",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128),
)


class PackedPayload(dict):
    """A payload carrying its own msgpack bytes, spliced verbatim into the
    frame by ``_pack_frame`` — the grant fan-out hot path: a raylet
    granting N queued leases packs the common reply skeleton once and
    patches per-lease fields, instead of paying a full dict encode per
    grant. Subclasses dict so in-process consumers (explorer scenarios,
    tests that call handlers directly) read it like the payload it encodes;
    ``raw`` MUST be exactly one msgpack value encoding the same mapping,
    and the mapping must not be mutated after construction (the bytes
    would go stale)."""

    __slots__ = ("raw",)

    def __init__(self, mapping: dict, raw: bytes):
        super().__init__(mapping)
        self.raw = raw


def _cancel_for_timeout(fut: asyncio.Future) -> None:
    """Deadline timer callback for Connection.call: mark-then-cancel so the
    awaiter can tell a timeout from a caller cancellation."""
    if not fut.done():
        fut.rpc_timed_out = True
        fut.cancel()


def install_event_loop() -> str:
    """Install the event-loop policy named by ``config.rpc_event_loop``.

    Returns the name actually in effect. "uvloop" requires the package;
    when it is not importable (this tree does not vendor it) the stock
    asyncio policy stays installed and a log line records the fallback, so
    the knob is safe to flip in config without a hard dependency."""
    choice = getattr(config, "rpc_event_loop", "asyncio")
    if choice == "uvloop":
        try:
            import uvloop  # type: ignore

            uvloop.install()
            return "uvloop"
        except ImportError:
            logger.info(
                "rpc_event_loop=uvloop requested but uvloop is not "
                "installed; using asyncio"
            )
    return "asyncio"


# ---------------------------------------------------------------------------
# End-to-end deadlines.
#
# The deadline of the request currently being dispatched, as an absolute
# loop.time() instant, set per handler task (each dispatch runs in its own
# task, whose context copy isolates the var). Any ``Connection.call`` made
# under it inherits the remaining budget — the mechanism by which a 120 s
# LeaseWorkerForActor clamps the CreateActor it fans out to.
# ---------------------------------------------------------------------------

_ambient_deadline: contextvars.ContextVar[Optional[float]] = contextvars.ContextVar(
    "ray_tpu_torch_rpc_deadline", default=None
)


def current_deadline() -> Optional[float]:
    """Absolute loop-time deadline of the request being handled, if any."""
    return _ambient_deadline.get()


def remaining_budget() -> Optional[float]:
    """Seconds left in the current handler's deadline budget (None if
    unbounded). Loop thread only."""
    deadline = _ambient_deadline.get()
    if deadline is None:
        return None
    return deadline - asyncio.get_running_loop().time()


# ---------------------------------------------------------------------------
# Trace-context propagation.
#
# The (trace_id, span_id) of the active tracing span, riding request frames
# exactly like the deadline TTL: stamped by the sender when set, restored
# around the handler on the receiving side (per dispatch task — same
# context-copy isolation as ``_ambient_deadline``). The var lives HERE, not
# in util/tracing.py, because this module is the bottom of the import graph
# (tracing builds on it; importing util from rpc would cycle through the
# worker stack). ``ray_tpu_torch.util.tracing`` owns everything above the raw
# contextvar: span recording, sampling, flushing, scopes.
# ---------------------------------------------------------------------------

_trace_ctx: contextvars.ContextVar[Optional[tuple]] = contextvars.ContextVar(
    "ray_tpu_torch_trace_ctx", default=None
)


def current_trace_ctx() -> Optional[tuple]:
    """(trace_id, span_id) of the active span, or None."""
    return _trace_ctx.get()


class DeadlineStats:
    """Process-wide counters for deadline enforcement; the chaos runner
    resets them per seed and the no-call-outlives-deadline invariant reads
    ``overruns`` (handlers that survived past deadline + grace — a stalled
    loop or a handler swallowing cancellation)."""

    __slots__ = ("met", "shed", "enforced", "overruns")

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.met = 0          # handlers that finished inside their deadline
        self.shed = 0         # requests dropped as already expired
        self.enforced = 0     # handlers cancelled at their deadline
        self.overruns: List[Tuple[str, float]] = []  # (method, seconds late)

    def snapshot(self) -> dict:
        return {
            "met": self.met,
            "shed": self.shed,
            "enforced": self.enforced,
            "overruns": list(self.overruns),
        }


deadline_stats = DeadlineStats()


# ---------------------------------------------------------------------------
# Retry policy (reference: retryable_grpc_client.h exponential backoff).
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RetryPolicy:
    """Full-jitter exponential backoff with an attempt cap and a total
    wall-clock budget. ``max_attempts``/``total_budget_s`` of 0 mean
    unbounded on that axis (the other cap still applies)."""

    initial_backoff_s: float = 0.05
    max_backoff_s: float = 2.0
    multiplier: float = 2.0
    max_attempts: int = 0
    total_budget_s: float = 30.0

    def backoff_cap(self, retry_index: int) -> float:
        """Upper bound of the jitter window before retry ``retry_index``
        (0-based)."""
        return min(
            self.max_backoff_s,
            self.initial_backoff_s * self.multiplier ** retry_index,
        )

    def backoffs(self, rng: Optional[random.Random] = None) -> Iterator[float]:
        """Infinite stream of jittered sleeps: sleep_i ~ U(0, cap_i). Pass a
        seeded ``random.Random`` for a deterministic schedule (tests,
        replay); the caps bound the caller's loop via :meth:`allows`."""
        uniform = (rng or random).uniform
        i = 0
        while True:
            yield uniform(0.0, self.backoff_cap(i))
            i += 1

    def allows(self, attempt: int, elapsed_s: float) -> bool:
        """May attempt number ``attempt`` (1-based) start after
        ``elapsed_s`` seconds since the first try?"""
        if self.max_attempts > 0 and attempt > self.max_attempts:
            return False
        if self.total_budget_s > 0 and elapsed_s >= self.total_budget_s:
            return False
        return True

    @classmethod
    def for_dial(cls) -> "RetryPolicy":
        return cls(
            initial_backoff_s=config.rpc_dial_initial_backoff_s,
            max_backoff_s=config.rpc_dial_max_backoff_s,
            multiplier=config.rpc_backoff_multiplier,
            total_budget_s=config.rpc_dial_total_s,
        )

    @classmethod
    def for_calls(cls) -> "RetryPolicy":
        return cls(
            initial_backoff_s=config.rpc_retry_initial_backoff_s,
            max_backoff_s=config.rpc_retry_max_backoff_s,
            multiplier=config.rpc_backoff_multiplier,
            total_budget_s=config.rpc_reconnect_timeout_s,
        )


def _new_unpacker():
    """Streaming frame decoder: the native C decoder when loaded (same
    feed()/iterate/tell() surface, byte-identical results), else msgpack's.
    One per connection, plus a fresh one at every blob-mode switch."""
    if _NATIVE_WIRE is not None:
        return _NATIVE_WIRE.Decoder()
    return msgpack.Unpacker(
        raw=False, strict_map_key=False, max_buffer_size=_MAX_FRAME
    )


class _RpcProtocol(asyncio.Protocol):
    """Transport glue: buffers writes per loop tick, streams reads through a
    msgpack Unpacker, and forwards complete messages to the Connection."""

    def __init__(self, conn: "Connection"):
        self._conn = conn
        self._unpacker = _new_unpacker()
        self.transport: Optional[asyncio.Transport] = None
        self._paused = False
        self._drain_waiters: list = []
        # Blob receive mode: while _blob_remaining > 0 inbound bytes bypass
        # the Unpacker and stream into _blob_sink. _fed counts bytes fed to
        # the CURRENT Unpacker so the unconsumed tail (bytes after a blob
        # control frame) can be recovered via unpacker.tell().
        self._fed = 0
        self._blob_msg: Optional[list] = None
        self._blob_sink = None
        self._blob_external = False
        self._blob_remaining = 0

    def connection_made(self, transport) -> None:
        self.transport = transport
        if self._conn._closed:
            # Torn down before its transport existed (its server stopped
            # while accepting it): nothing closed the socket then, and its
            # peer would wait forever on replies that are never sent.
            transport.close()

    def connection_lost(self, exc) -> None:
        for w in self._drain_waiters:
            if not w.done():
                w.set_result(None)
        self._drain_waiters.clear()
        self._conn._teardown()

    def pause_writing(self) -> None:
        self._paused = True

    def resume_writing(self) -> None:
        self._paused = False
        for w in self._drain_waiters:
            if not w.done():
                w.set_result(None)
        self._drain_waiters.clear()

    def data_received(self, data: bytes) -> None:
        _TEL_BYTES_IN.inc(len(data))
        view = memoryview(data)
        conn = self._conn
        # Replies produced while we dispatch this chunk (sync handlers
        # answering inline) are flushed once at the end of the read instead
        # of via a call_soon per reply: same coalescing, one less loop
        # callback per request on the server hot path.
        conn._in_read = True
        try:
            self._feed(view)
        finally:
            conn._in_read = False
            if conn._out and not conn._flush_scheduled and not conn._closed:
                conn._flush()

    def _feed(self, view) -> None:
        try:
            while True:
                if self._blob_remaining > 0:
                    n = view.nbytes
                    if n <= self._blob_remaining:
                        self._blob_sink.write(view)
                        self._blob_remaining -= n
                        if self._blob_remaining == 0:
                            self._finish_blob()
                        return
                    self._blob_sink.write(view[: self._blob_remaining])
                    view = view[self._blob_remaining :]
                    self._blob_remaining = 0
                    self._finish_blob()
                if not view.nbytes:
                    return
                self._unpacker.feed(view)
                self._fed += view.nbytes
                switched = False
                for msg in self._unpacker:
                    if (
                        isinstance(msg, (list, tuple))
                        and len(msg) >= 5
                        and (msg[1] == _KIND_BLOB or msg[1] == _KIND_BLOB_REP)
                    ):
                        # The bytes after this control frame are the raw blob
                        # (and whatever follows it), NOT msgpack: recover the
                        # unconsumed tail of the current chunk, discard the
                        # Unpacker (its buffer holds those same bytes), and
                        # switch to blob mode.
                        tail = self._fed - self._unpacker.tell()
                        self._unpacker = _new_unpacker()
                        self._fed = 0
                        self._begin_blob(list(msg))
                        view = view[view.nbytes - tail :]
                        switched = True
                        break
                    self._conn._on_message(msg)
                if not switched:
                    return
        except Exception:
            logger.exception("rpc stream corrupted; dropping connection")
            if self.transport is not None:
                self.transport.close()

    def _begin_blob(self, msg: list) -> None:
        size = msg[4]
        if not isinstance(size, int) or size < 0 or size > _MAX_FRAME:
            raise RpcError(f"invalid blob length {size!r}")
        _TEL_FRAMES_IN[msg[1]].inc()
        sink, external = self._conn._select_blob_sink(msg, size)
        if size == 0:
            self._conn._on_blob_complete(msg, sink, external)
            return
        self._blob_msg = msg
        self._blob_sink = sink
        self._blob_external = external
        self._blob_remaining = size

    def _finish_blob(self) -> None:
        msg, sink, external = self._blob_msg, self._blob_sink, self._blob_external
        self._blob_msg = None
        self._blob_sink = None
        self._conn._on_blob_complete(msg, sink, external)


class Connection:
    """One end of a duplex RPC link. Both sides can issue requests and pushes."""

    def __init__(
        self,
        handlers: Dict[str, Callable[..., Awaitable[Any]]],
        on_close: Optional[Callable[["Connection"], None]] = None,
        sync_handlers: Optional[Dict[str, Callable]] = None,
        blob_factories: Optional[Dict[str, Callable]] = None,
        dispatch_observer: Optional[Callable[[str, float], None]] = None,
    ):
        self._handlers = handlers
        # Optional ``(method, seconds)`` callback fired after each async
        # handler dispatch — the GCS attaches its service-latency histogram
        # here (telemetry.py). None (the default) costs one branch.
        self._dispatch_observer = dispatch_observer
        # Blob sink factories: ``factory(conn, payload, size) -> sink|None``
        # invoked inline from the read path when a kind-4 control frame for
        # that method arrives; None declines (the blob is drained and
        # discarded). Shared dict from the owning Server (register_blob).
        self._blob_factories = blob_factories if blob_factories is not None else {}
        # Per-call blob-reply sinks (call_into), keyed by msgid.
        self._blob_reply_sinks: Dict[int, Any] = {}
        # Sync fast-path handlers: ``fn(conn, msgid, payload)`` invoked inline
        # from data_received — no asyncio task per message. The handler must
        # not block; it replies later via ``reply_nowait``. Used for the task
        # execution hot path (reference analog: the C++ server's inlined
        # HandleRequest dispatch before posting to the io_context).
        self._sync_handlers = sync_handlers if sync_handlers is not None else {}
        self._on_close = on_close
        self._msgid = itertools.count(1)
        self._pending: Dict[int, asyncio.Future] = {}
        # Inline reply callbacks (call_cb): msgid -> cb(reply, error).
        self._cb_pending: Dict[int, Callable] = {}
        self._closed = False
        self._loop = asyncio.get_running_loop()
        self._protocol = _RpcProtocol(self)
        self._out: list = []
        self._flush_scheduled = False
        # True while data_received is dispatching inbound frames on this
        # connection: replies queued during the read are flushed at its end
        # (no call_soon per reply).
        self._in_read = False
        # Lease-batch coalescing (call_batched_nowait): entries queued for
        # the next flush tick. Each entry is [msgid, method, payload,
        # absolute_deadline|None, [trace_id, span_id]|None]; per-entry
        # msgids keep dedup tokens, cancellation, and chaos faults
        # operating per-lease inside the coalesced frame.
        self._batch_entries: list = []
        self._batch_scheduled = False
        # Arbitrary per-connection state daemons can attach (e.g. worker id).
        self.context: Dict[str, Any] = {}
        # The logical (host, port) this connection was dialed to; set by
        # connect(). Stays meaningful when the transport is a Unix socket.
        self.remote_addr: Optional[Tuple[str, int]] = None

    @property
    def peername(self) -> Optional[Tuple[str, int]]:
        if self.remote_addr is not None:
            return self.remote_addr
        try:
            name = self._protocol.transport.get_extra_info("peername")
        except Exception:
            return None
        if isinstance(name, tuple) and len(name) >= 2:
            return (name[0], name[1])
        return None

    # -- write path ----------------------------------------------------------

    def _pack_frame(self, msg) -> list:
        """Pack one frame into its wire buffers. For a request with a
        deadline, the absolute loop.time() instant held in-memory is stamped
        into the relative TTL that goes on the wire — at pack time, not call
        time, so a frame a chaos schedule delays ships with its budget
        already shrunk and the receiver's reconstructed deadline stays
        honest. A blob frame packs as its control message (payload slot 4
        rewritten to the byte length) followed by the raw buffers; blob
        frames never carry trace context (slot 4 is the byte length and the
        data plane is instrumented at its managers instead)."""
        kind = msg[1]
        if kind == _KIND_BLOB or kind == _KIND_BLOB_REP:
            buffers = _blob_buffers(msg[4])
            total = sum(b.nbytes for b in buffers)
            out = [_packb([msg[0], kind, msg[2], msg[3], total])]
            out.extend(buffers)
            _TEL_FRAMES_OUT[kind].inc()
            _TEL_BYTES_OUT[kind].inc(len(out[0]) + total)
            return out
        method = msg[2]
        if kind == _KIND_PUSH and method == "LeaseBatch":
            # Per-entry deadlines are absolute loop instants in memory;
            # stamp each into a relative TTL at pack time on a copy — the
            # same honesty rule as the frame-level slot, so a batch a chaos
            # schedule delays ships with every entry's budget already
            # shrunk (the in-memory frame keeps absolute instants and a
            # re-send re-stamps them).
            now = self._loop.time()
            entries = [
                [e[0], e[1], e[2], None if e[3] is None else e[3] - now, e[4]]
                for e in msg[3]["entries"]
            ]
            msg = [msg[0], kind, method, {"entries": entries}]
        elif len(msg) > 4 and msg[4] is not None:
            # Rebuild in place so a trailing trace-context slot survives.
            msg = list(msg)
            msg[4] = msg[4] - self._loop.time()
        payload = msg[3]
        if type(payload) is PackedPayload:
            # Splice pre-packed payload bytes into the frame: fixarray
            # header + per-slot packs around the raw value. The grant
            # fan-out path pays one skeleton pack for N replies.
            parts = [_FIXARRAY[len(msg)], _packb(msg[0]), _packb(kind),
                     _packb(method), payload.raw]
            for extra in msg[4:]:
                parts.append(_packb(extra))
            packed = b"".join(parts)
        else:
            packed = None
            nm = _NATIVE_METHODS
            if method in (nm if nm is not None else _native_methods()):
                if _NATIVE_WIRE is not None:
                    try:
                        packed = _NATIVE_WIRE.pack_frame(msg)
                        _TEL_NATIVE_PACK.inc()
                    except Exception:
                        packed = None
                if packed is None:
                    _TEL_FALLBACK_PACK.inc()
            if packed is None:
                packed = _packb(msg)
        _TEL_FRAMES_OUT[kind].inc()
        _TEL_BYTES_OUT[kind].inc(len(packed))
        return [packed]

    def _send_nowait(self, msg) -> None:
        if self._closed:
            raise ConnectionLost("connection closed")
        blob = msg[1] == _KIND_BLOB or msg[1] == _KIND_BLOB_REP
        if _send_interceptor is not None:
            if blob:
                # Materialize before offering: a dropped/delayed/duplicated
                # blob frame must be one atomic unit with a stable copy of
                # the data, not a view into live (reusable) arena memory.
                msg = [msg[0], msg[1], msg[2], msg[3], _blob_bytes(msg[4])]
            if _send_interceptor(self, msg):
                return  # consumed by fault injection (dropped/held/delayed)
        self._out.extend(self._pack_frame(msg))
        if blob:
            # Blob buffers may be live arena views the caller only pins for
            # the duration of this call: hand them to the transport NOW (an
            # unwritable socket copies them into asyncio's own buffer).
            self._flush()
        elif not self._flush_scheduled and not self._in_read:
            self._flush_scheduled = True
            self._loop.call_soon(self._flush)

    def _send_direct(self, msg) -> None:
        """Enqueue a frame bypassing the interceptor: the delivery half of a
        delayed/duplicated/reordered fault. No-op on a closed connection (a
        delay timer may outlive the link)."""
        if self._closed:
            return
        self._out.extend(self._pack_frame(msg))
        if msg[1] == _KIND_BLOB or msg[1] == _KIND_BLOB_REP:
            self._flush()
        elif not self._flush_scheduled and not self._in_read:
            self._flush_scheduled = True
            self._loop.call_soon(self._flush)

    def _flush(self) -> None:
        self._flush_scheduled = False
        if self._closed or not self._out:
            self._out.clear()
            return
        out = self._out
        self._out = []
        transport = self._protocol.transport
        if len(out) == 1:
            transport.write(out[0])
            return
        # Join adjacent small frames into one write (the control-plane hot
        # path: one syscall per loop tick); large blob memoryviews are
        # written individually so they reach the socket with no join copy.
        pending: list = []
        for item in out:
            if isinstance(item, memoryview) and item.nbytes >= _WRITE_JOIN_MAX:
                if pending:
                    transport.write(
                        pending[0] if len(pending) == 1 else b"".join(pending)
                    )
                    pending.clear()
                transport.write(item)
            else:
                pending.append(item)
        if pending:
            transport.write(pending[0] if len(pending) == 1 else b"".join(pending))

    async def drain(self) -> None:
        """Wait until the transport's write buffer is below the high-water
        mark. Bulk senders (object transfer) call this between chunks."""
        self._flush()
        if self._protocol._paused and not self._closed:
            w = self._loop.create_future()
            self._protocol._drain_waiters.append(w)
            await w
            if self._closed:
                raise ConnectionLost("connection closed")

    # -- request/reply -------------------------------------------------------

    def call_nowait(
        self, method: str, payload: Any = None, deadline: Optional[float] = None
    ) -> asyncio.Future:
        """Issue a request; returns the reply future. ``deadline`` is an
        absolute loop.time() instant carried to the server as a TTL; the
        caller still owns its own wait. Loop thread only."""
        msgid = next(self._msgid)
        fut = self._loop.create_future()
        fut.rpc_msgid = msgid
        self._pending[msgid] = fut
        frame = [msgid, _KIND_REQ, method, payload]
        tctx = _trace_ctx.get()
        if deadline is not None or tctx is not None:
            frame.append(deadline)
        if tctx is not None:
            frame.append([tctx[0], tctx[1]])
        try:
            self._send_nowait(frame)
        except ConnectionLost:
            self._pending.pop(msgid, None)
            raise
        return fut

    def call_cb(self, method: str, payload: Any, cb: Callable[[Any, Optional[str]], None]) -> None:
        """Issue a request whose reply invokes ``cb(reply, error)`` INLINE
        from the read path — no Future, no call_soon hop. The per-message
        saving (~5us) matters on >10k-msgs/s pipelines (task dispatch).
        ``cb`` runs on the loop thread and must not raise; on connection
        loss every outstanding callback fires with error='connection lost'.
        Loop thread only."""
        msgid = next(self._msgid)
        self._cb_pending[msgid] = cb
        frame = [msgid, _KIND_REQ, method, payload]
        tctx = _trace_ctx.get()
        if tctx is not None:
            frame.append(None)
            frame.append([tctx[0], tctx[1]])
        try:
            self._send_nowait(frame)
        except ConnectionLost:
            self._cb_pending.pop(msgid, None)
            raise

    def _effective_deadline(self, timeout: Optional[float]) -> Optional[float]:
        """Fold the explicit timeout with the ambient handler deadline: a
        call made while serving a deadlined request never outlives its
        caller, whatever timeout it asked for locally."""
        ambient = _ambient_deadline.get()
        local = None if timeout is None else self._loop.time() + timeout
        if ambient is None:
            return local
        if local is None:
            return ambient
        return min(ambient, local)

    async def call(self, method: str, payload: Any = None, timeout: Optional[float] = None):
        """Issue a request and await the reply. The effective budget —
        ``timeout`` clamped by the ambient handler deadline — rides the
        frame as a TTL so every downstream hop sees it shrink."""
        deadline = self._effective_deadline(timeout)
        fut = self.call_nowait(method, payload, deadline=deadline)
        return await self._await_reply(fut, deadline)

    async def _await_reply(self, fut: asyncio.Future, deadline: Optional[float]):
        """Await a reply future under an absolute deadline. The timeout is
        a loop timer (mark-then-cancel), NOT asyncio.wait_for: wait_for
        wraps every call in an extra waiter task, which at lease rates is
        the single largest source of event-loop churn — a timer costs one
        heap entry and nothing more on the (common) in-time reply."""
        if deadline is None:
            try:
                return await fut
            finally:
                if fut.cancelled():
                    self._pending.pop(fut.rpc_msgid, None)
        timer = self._loop.call_at(deadline, _cancel_for_timeout, fut)
        try:
            return await fut
        except asyncio.CancelledError:
            if getattr(fut, "rpc_timed_out", False):
                raise asyncio.TimeoutError() from None
            raise
        finally:
            timer.cancel()
            # On timeout or caller cancellation the reply will never be
            # consumed; drop the entry so the pending table doesn't leak.
            if fut.cancelled():
                self._pending.pop(fut.rpc_msgid, None)

    # -- batched lease frames ------------------------------------------------

    def call_batched_nowait(
        self, method: str, payload: Any = None, deadline: Optional[float] = None
    ) -> asyncio.Future:
        """Like ``call_nowait``, but the request coalesces with every other
        batched call issued on this connection in the same event-loop tick
        into one ``LeaseBatch`` frame (one pack + one write for N lease
        ops). Entries keep their own msgid, deadline, and trace context, so
        dedup/cancellation/chaos semantics are per-lease; the receiving
        rpc layer re-injects each entry through normal request dispatch.
        Until the flush tick runs the entry can be withdrawn with
        ``try_cancel_batched`` (a cancel for a frame that never went out
        must not reach the wire). Loop thread only."""
        if self._closed:
            raise ConnectionLost("connection closed")
        msgid = next(self._msgid)
        fut = self._loop.create_future()
        fut.rpc_msgid = msgid
        self._pending[msgid] = fut
        tctx = _trace_ctx.get()
        self._batch_entries.append(
            [msgid, method, payload, deadline,
             None if tctx is None else [tctx[0], tctx[1]]]
        )
        if not self._batch_scheduled:
            self._batch_scheduled = True
            self._loop.call_soon(self._flush_batch)
        return fut

    async def call_batched(
        self, method: str, payload: Any = None, timeout: Optional[float] = None
    ):
        """Batched counterpart of ``call``: enqueue into this tick's lease
        batch and await the per-entry reply."""
        deadline = self._effective_deadline(timeout)
        fut = self.call_batched_nowait(method, payload, deadline=deadline)
        return await self._await_reply(fut, deadline)

    def try_cancel_batched(self, msgid: int) -> bool:
        """Withdraw a batched request that has NOT been flushed yet.
        Returns True when the entry was still queued locally: it is removed
        from the pending batch and its future is cancelled, and the caller
        must NOT send a wire cancel (the request never existed remotely).
        False means the batch already went out — cancel over the wire as
        usual. Loop thread only."""
        entries = self._batch_entries
        for i, entry in enumerate(entries):
            if entry[0] == msgid:
                del entries[i]
                fut = self._pending.pop(msgid, None)
                if fut is not None and not fut.done():
                    fut.cancel()
                return True
        return False

    def _flush_batch(self) -> None:
        self._batch_scheduled = False
        entries = self._batch_entries
        if not entries or self._closed:
            # Everything was withdrawn pre-flush, or the link died
            # (teardown already failed the pending futures).
            return
        self._batch_entries = []
        _TEL_BATCH_SIZE.observe(len(entries))
        try:
            if len(entries) == 1:
                # Singleton: a plain request frame is cheaper than a
                # 1-entry batch and semantically identical.
                mid, method, payload, deadline, tctx = entries[0]
                frame = [mid, _KIND_REQ, method, payload]
                if deadline is not None or tctx is not None:
                    frame.append(deadline)
                if tctx is not None:
                    frame.append(tctx)
                self._send_nowait(frame)
            else:
                self._send_nowait(
                    [0, _KIND_PUSH, "LeaseBatch", {"entries": entries}]
                )
        except ConnectionLost:
            pass  # teardown already failed every pending future

    @property
    def write_paused(self) -> bool:
        """True while the transport has backpressured writes (high-water
        mark hit). Broadcast fan-out uses this to decide between an inline
        write and a backpressure-aware drain task."""
        return self._protocol._paused

    def push_nowait(self, method: str, payload: Any = None) -> None:
        """One-way message; no reply expected. Loop thread only."""
        self._send_nowait([0, _KIND_PUSH, method, payload])

    def push_packed_nowait(self, packed: bytes) -> None:
        """Write a frame pre-packed by ``pack_push`` — the broadcast fan-out
        hot path: the publisher packs once and hands every subscriber the
        same bytes instead of paying one msgpack encode per subscriber.
        Loop thread only."""
        if self._closed:
            raise ConnectionLost("connection closed")
        _TEL_FRAMES_OUT[_KIND_PUSH].inc()
        _TEL_BYTES_OUT[_KIND_PUSH].inc(len(packed))
        self._out.append(packed)
        if not self._flush_scheduled and not self._in_read:
            self._flush_scheduled = True
            self._loop.call_soon(self._flush)

    def push_packed_now(self, packed: bytes) -> None:
        """``push_packed_nowait`` + immediate transport write. Broadcast
        fan-out sends exactly one frame per subscriber per round — there is
        nothing to coalesce, so the per-connection flush callback is pure
        overhead (N loop callbacks per round at N subscribers)."""
        if self._closed:
            raise ConnectionLost("connection closed")
        _TEL_FRAMES_OUT[_KIND_PUSH].inc()
        _TEL_BYTES_OUT[_KIND_PUSH].inc(len(packed))
        self._out.append(packed)
        self._flush()

    async def push(self, method: str, payload: Any = None) -> None:
        self._send_nowait([0, _KIND_PUSH, method, payload])

    # -- blob sidecar frames -------------------------------------------------

    def blob_push_nowait(self, method: str, payload: Any, blob) -> None:
        """One-way blob frame: msgpack control message + raw sidecar bytes.
        ``blob`` is bytes/memoryview or a list of them; the buffers are
        handed to the transport before this returns (scatter-gather, no pack
        copy), so live arena views are safe to pass. Loop thread only."""
        self._send_nowait([0, _KIND_BLOB, method, payload, blob])

    async def call_with_blob(
        self, method: str, payload: Any, blob, timeout: Optional[float] = None
    ):
        """Issue a request whose bulk data rides as a blob sidecar instead
        of inside the msgpack payload; awaits the reply like ``call``. The
        receiver's sink factory (or the default buffer, delivered to the
        handler as ``payload["data"]``) consumes the bytes."""
        msgid = next(self._msgid)
        fut = self._loop.create_future()
        fut.rpc_msgid = msgid
        self._pending[msgid] = fut
        try:
            self._send_nowait([msgid, _KIND_BLOB, method, payload, blob])
        except ConnectionLost:
            self._pending.pop(msgid, None)
            raise
        try:
            if timeout is None:
                return await fut
            return await asyncio.wait_for(fut, timeout)
        finally:
            if fut.cancelled():
                self._pending.pop(msgid, None)

    async def call_into(
        self, method: str, payload: Any, sink, timeout: Optional[float] = None
    ):
        """Issue a request whose reply may carry a blob sidecar streamed
        into ``sink`` (``write(view)`` per chunk, ``done(ok)`` at the end).
        Returns the reply's meta payload once the blob has fully landed.
        An error reply or a plain reply resolves without touching the
        sink."""
        deadline = self._effective_deadline(timeout)
        fut = self.call_nowait(method, payload, deadline=deadline)
        msgid = fut.rpc_msgid
        self._blob_reply_sinks[msgid] = sink
        try:
            if deadline is None:
                return await fut
            return await asyncio.wait_for(
                fut, max(0.0, deadline - self._loop.time())
            )
        finally:
            self._blob_reply_sinks.pop(msgid, None)
            if fut.cancelled():
                self._pending.pop(msgid, None)

    # -- read path -----------------------------------------------------------

    def reply_nowait(self, msgid: int, method: str, payload: Any) -> None:
        """Send a reply for a request handled by a sync handler."""
        try:
            self._send_nowait([msgid, _KIND_REP, method, payload])
        except ConnectionLost:
            pass

    def reply_error_nowait(self, msgid: int, method: str, err: str) -> None:
        try:
            self._send_nowait([msgid, _KIND_ERR, method, err])
        except ConnectionLost:
            pass

    def _select_blob_sink(self, msg: list, size: int):
        """Pick the sink for an inbound blob; returns (sink, external).
        ``external`` sinks (factory- or call_into-registered) own delivery;
        the default BufferSink's contents are instead injected into the
        payload as ``data`` and dispatched like a normal message."""
        msgid, kind, method, payload = msg[0], msg[1], msg[2], msg[3]
        if kind == _KIND_BLOB_REP:
            sink = self._blob_reply_sinks.pop(msgid, None)
            if sink is not None:
                return sink, True
            return BufferSink(size), False
        factory = self._blob_factories.get(method)
        if factory is not None:
            try:
                sink = factory(self, payload, size)
            except Exception:
                logger.exception("blob sink factory for %s failed", method)
                sink = None
            if sink is not None:
                return sink, True
            return _NullSink(), True  # declined: drain and discard
        return BufferSink(size), False

    def _on_blob_complete(self, msg: list, sink, external: bool) -> None:
        """A blob fully landed: finish the sink, then deliver the control
        message (resolve the pending call for a blob reply; dispatch the
        handler for a blob push/request)."""
        msgid, kind, method, payload = msg[0], msg[1], msg[2], msg[3]
        try:
            sink.done(True)
        except Exception:
            logger.exception("blob sink completion for %s failed", method)
        if kind == _KIND_BLOB_REP:
            if not external and isinstance(payload, dict):
                payload["data"] = sink.value()
            cb = self._cb_pending.pop(msgid, None)
            if cb is not None:
                try:
                    cb(payload, None)
                except Exception:
                    logger.exception("inline reply callback failed")
                return
            fut = self._pending.pop(msgid, None)
            if fut is not None and not fut.done():
                fut.set_result(payload)
            return
        if external:
            # The sink consumed the data plane; only a request (msgid != 0)
            # still needs its handler to produce a reply.
            if msgid:
                spawn(self._dispatch(msgid, method, payload))
            return
        if isinstance(payload, dict):
            payload["data"] = sink.value()
        spawn(self._dispatch(msgid or None, method, payload))

    def _on_message(self, msg) -> None:
        msgid, kind, method, payload = msg[0], msg[1], msg[2], msg[3]
        _TEL_FRAMES_IN[kind].inc()
        if kind == _KIND_REQ:
            deadline = None
            if len(msg) > 4 and msg[4] is not None:
                ttl = msg[4]
                if ttl <= 0:
                    # Shed stale work: the caller has already given up.
                    deadline_stats.shed += 1
                    _TEL_DL_SHED.inc()
                    telemetry.record_event(
                        "rpc", "deadline_shed", method=method, late_s=-ttl
                    )
                    self.reply_error_nowait(
                        msgid,
                        method,
                        f"DeadlineExceeded: {method} arrived "
                        f"{-ttl:.3f}s past its deadline (shed)",
                    )
                    return
                deadline = self._loop.time() + ttl
            tctx = None
            if len(msg) > 5 and msg[5] is not None:
                tctx = (msg[5][0], msg[5][1])
            sync_h = self._sync_handlers.get(method)
            if sync_h is not None:
                # Set the ambient deadline (and trace context) around the
                # inline handler so any coroutine it spawn()s inherits both.
                token = _ambient_deadline.set(deadline)
                ttoken = _trace_ctx.set(tctx)
                try:
                    sync_h(self, msgid, payload)
                except Exception as e:
                    self.reply_error_nowait(
                        msgid, method, f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
                    )
                finally:
                    _trace_ctx.reset(ttoken)
                    _ambient_deadline.reset(token)
                return
            spawn(self._dispatch(msgid, method, payload, deadline, tctx))
        elif kind == _KIND_PUSH:
            if method == "LeaseBatch":
                # Unbundle: re-inject every entry as its own request frame
                # through this same dispatch path, so per-entry TTL shed,
                # sync fast-path handlers, dedup ledgers, and trace context
                # all behave exactly as for unbatched frames. The N replies
                # coalesce back into one write on the next flush tick.
                for e in payload["entries"]:
                    self._on_message([e[0], _KIND_REQ, e[1], e[2], e[3], e[4]])
                return
            sync_h = self._sync_handlers.get(method)
            if sync_h is not None:
                # Push fast path: no task per broadcast delivery. The
                # handler gets msgid=None (pushes have no reply).
                try:
                    sync_h(self, None, payload)
                except Exception:
                    logger.exception("sync push handler %s failed", method)
                return
            spawn(self._dispatch(None, method, payload))
        else:
            cb = self._cb_pending.pop(msgid, None)
            if cb is not None:
                try:
                    if kind == _KIND_REP:
                        cb(payload, None)
                    else:
                        cb(None, payload)
                except Exception:
                    logger.exception("inline reply callback failed")
                return
            fut = self._pending.pop(msgid, None)
            if fut is not None and not fut.done():
                if kind == _KIND_REP:
                    fut.set_result(payload)
                else:
                    fut.set_exception(_typed_error(payload))

    async def _dispatch(
        self,
        msgid,
        method: str,
        payload,
        deadline: Optional[float] = None,
        trace_ctx: Optional[tuple] = None,
    ) -> None:
        handler = self._handlers.get(method)
        # Each dispatch runs in its own task (own context copy), so setting
        # the ambient deadline (and trace context) here scopes them to this
        # handler and every call it makes downstream.
        _ambient_deadline.set(deadline)
        _trace_ctx.set(trace_ctx)
        obs = self._dispatch_observer
        t0 = self._loop.time() if obs is not None else 0.0
        try:
            if handler is None:
                raise RpcError(f"no handler for method {method!r}")
            if deadline is None:
                result = await handler(self, payload)
            else:
                result = await self._run_deadlined(handler, method, payload, deadline)
        except Exception as e:
            if obs is not None:
                obs(method, self._loop.time() - t0)
            # Any handler failure — including ConnectionLost from a dial the
            # handler made to a third party — must produce an error reply, or
            # the caller waits out its full timeout.
            if msgid is not None:
                err = f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
                try:
                    self._send_nowait([msgid, _KIND_ERR, method, err])
                except ConnectionLost:
                    pass  # our own link died; caller learns via teardown
            else:
                logger.exception("push handler %s failed", method)
            return
        if obs is not None:
            obs(method, self._loop.time() - t0)
        if msgid is not None:
            try:
                if isinstance(result, Blob):
                    # Blob reply: no awaits between the handler returning its
                    # (possibly arena-backed) views and the transport write
                    # inside _send_nowait, so the span cannot be recycled
                    # under the send.
                    self._send_nowait(
                        [msgid, _KIND_BLOB_REP, method, result.payload, result.blob]
                    )
                else:
                    self._send_nowait([msgid, _KIND_REP, method, result])
            except ConnectionLost:
                pass

    async def _run_deadlined(self, handler, method: str, payload, deadline: float):
        """Run a handler under its wire deadline: shed if already expired,
        cancel at the deadline (the caller gave up at the same instant, so
        the result would be discarded anyway), and record handlers whose
        finish — or cancellation unwind — runs more than the grace period
        late (the no-call-outlives-deadline invariant's raw data)."""
        remaining = deadline - self._loop.time()
        if remaining <= 0:
            deadline_stats.shed += 1
            _TEL_DL_SHED.inc()
            telemetry.record_event(
                "rpc", "deadline_shed", method=method, late_s=-remaining
            )
            raise DeadlineExceeded(
                f"{method} shed before dispatch: deadline expired "
                f"{-remaining:.3f}s ago"
            )
        try:
            result = await asyncio.wait_for(handler(self, payload), remaining)
        except asyncio.TimeoutError:
            deadline_stats.enforced += 1
            _TEL_DL_ENFORCED.inc()
            telemetry.record_event(
                "rpc", "deadline_enforced", method=method, budget_s=remaining
            )
            raise DeadlineExceeded(
                f"{method} handler cancelled at its deadline "
                f"({remaining:.3f}s budget on arrival)"
            ) from None
        finally:
            late = self._loop.time() - deadline
            if late > config.rpc_deadline_grace_s:
                deadline_stats.overruns.append((method, late))
                _TEL_DL_OVERRUNS.inc()
                telemetry.record_event(
                    "rpc", "deadline_overrun", method=method, late_s=late
                )
            elif late <= 0:
                deadline_stats.met += 1
                _TEL_DL_MET.inc()
        return result

    # -- lifecycle -----------------------------------------------------------

    def _teardown(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._out.clear()
        self._batch_entries.clear()
        # Fail the mid-stream blob (the sink may hold a partially-written
        # arena span: done(False) lets it abort/quarantine) and any sinks
        # still waiting for a blob reply.
        proto = self._protocol
        sink = proto._blob_sink
        if sink is not None:
            proto._blob_sink = None
            proto._blob_msg = None
            proto._blob_remaining = 0
            try:
                sink.done(False)
            except Exception:
                logger.exception("blob sink teardown failed")
        if self._blob_reply_sinks:
            sinks, self._blob_reply_sinks = self._blob_reply_sinks, {}
            for s in sinks.values():
                try:
                    s.done(False)
                except Exception:
                    logger.exception("blob reply sink teardown failed")
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(ConnectionLost("connection closed"))
        self._pending.clear()
        if self._cb_pending:
            cbs, self._cb_pending = self._cb_pending, {}
            for cb in cbs.values():
                try:
                    cb(None, _CONNECTION_LOST)
                except Exception:
                    logger.exception("inline reply callback failed at teardown")
        try:
            if self._protocol.transport is not None:
                self._protocol.transport.close()
        except Exception:
            pass
        if self._on_close is not None:
            try:
                self._on_close(self)
            except Exception:
                logger.exception("on_close callback failed")

    async def close(self) -> None:
        self._teardown()

    @property
    def closed(self) -> bool:
        return self._closed


class Server:
    """RPC server: accepts connections, dispatches to registered handlers.

    Handlers are ``async def handler(conn, payload) -> reply``.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._host = host
        self._port = port
        self._handlers: Dict[str, Callable] = {}
        self._sync_handlers: Dict[str, Callable] = {}
        self._blob_factories: Dict[str, Callable] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self.connections: set = set()
        self._stopping = False
        self._on_disconnect: Optional[Callable[[Connection], None]] = None
        # Per-dispatch ``(method, seconds)`` hook, copied onto every
        # accepted connection (service-latency telemetry; see Connection).
        self.dispatch_observer: Optional[Callable[[str, float], None]] = None

    def handler(self, name: str):
        def deco(fn):
            self._handlers[name] = fn
            return fn

        return deco

    def register(self, name: str, fn: Callable) -> None:
        self._handlers[name] = fn

    def register_sync(self, name: str, fn: Callable) -> None:
        """Register a sync fast-path handler ``fn(conn, msgid, payload)``."""
        self._sync_handlers[name] = fn

    def register_blob(self, name: str, factory: Callable) -> None:
        """Register a blob sink factory ``factory(conn, payload, size) ->
        sink | None`` for inbound kind-4 frames of this method. The factory
        runs inline from the read path; returning None drains and discards
        the blob. The sink's ``write(view)`` is called per streamed chunk
        (the view is transient — copy it) and ``done(ok)`` once on full
        arrival (ok=True) or connection teardown (ok=False)."""
        self._blob_factories[name] = factory

    def on_disconnect(self, fn: Callable[[Connection], None]) -> None:
        self._on_disconnect = fn

    def _make_protocol(self) -> _RpcProtocol:
        conn = Connection(
            self._handlers,
            on_close=self._conn_closed,
            sync_handlers=self._sync_handlers,
            blob_factories=self._blob_factories,
            dispatch_observer=self.dispatch_observer,
        )
        if self._stopping:
            # Accepted while stop() closes the listeners: close it as soon
            # as its transport exists (connection_made), or it outlives the
            # server unanswered.
            conn._teardown()
        else:
            self.connections.add(conn)
        return conn._protocol

    async def start(self) -> Tuple[str, int]:
        loop = asyncio.get_running_loop()
        self._stopping = False
        self._server = await loop.create_server(
            self._make_protocol, self._host, self._port
        )
        sock = self._server.sockets[0]
        self._host, self._port = sock.getsockname()[:2]
        # Same-host peers dial the Unix socket instead of TCP loopback
        # (~40% less kernel CPU per frame on the chatty control plane); the
        # path is derived from the TCP port, so the advertised (host, port)
        # address stays the only address anyone needs to know.
        try:
            path = _uds_path(self._port)
            if os.path.exists(path):
                os.unlink(path)
            self._uds_server = await loop.create_unix_server(self._make_protocol, path)
            self._uds_path = path
        except Exception:  # pragma: no cover - platform without UDS
            self._uds_server = None
            self._uds_path = None
        return self._host, self._port

    @property
    def address(self) -> Tuple[str, int]:
        return self._host, self._port

    def _conn_closed(self, conn: Connection) -> None:
        self.connections.discard(conn)
        if self._on_disconnect is not None:
            self._on_disconnect(conn)

    async def stop(self) -> None:
        self._stopping = True
        if self._server is not None:
            self._server.close()
        if getattr(self, "_uds_server", None) is not None:
            self._uds_server.close()
            try:
                os.unlink(self._uds_path)
            except OSError:
                pass
        # Close live connections before wait_closed(): since py3.12.1
        # wait_closed blocks until every client transport is gone.
        for conn in list(self.connections):
            await conn.close()
        if self._server is not None:
            try:
                await asyncio.wait_for(self._server.wait_closed(), timeout=5)
            except asyncio.TimeoutError:
                pass


async def connect(
    host: str,
    port: int,
    handlers: Optional[Dict[str, Callable]] = None,
    retry: Optional[int] = None,
    retry_interval: Optional[float] = None,
    sync_handlers: Optional[Dict[str, Callable]] = None,
    policy: Optional[RetryPolicy] = None,
    blob_factories: Optional[Dict[str, Callable]] = None,
) -> Connection:
    """Dial a server, retrying with jittered exponential backoff while it
    boots. Returns a duplex Connection.

    By default the dial schedule comes from :meth:`RetryPolicy.for_dial`
    (config knobs ``rpc_dial_*``). Legacy ``retry``/``retry_interval``
    arguments are mapped onto an equivalent policy — ``retry`` caps the
    attempt count and ``retry * retry_interval`` caps the total wait — so
    existing call sites keep their expected patience.
    """
    loop = asyncio.get_running_loop()
    if policy is None:
        if retry is None and retry_interval is None:
            policy = RetryPolicy.for_dial()
        else:
            n = 30 if retry is None else max(1, retry)
            interval = 0.1 if retry_interval is None else retry_interval
            policy = RetryPolicy(
                initial_backoff_s=interval,
                max_backoff_s=interval * 8,
                multiplier=config.rpc_backoff_multiplier,
                max_attempts=n,
                total_budget_s=n * interval,
            )
    last_err: Optional[Exception] = None
    uds = _uds_path(port) if host in _LOOPBACK else None
    backoffs = policy.backoffs()
    start = loop.time()
    attempt = 0
    while True:
        attempt += 1
        try:
            # NB: keep the caller's dict object (even if currently empty) so
            # handlers registered later are visible on this connection.
            conn = Connection(
                handlers if handlers is not None else {},
                sync_handlers=sync_handlers,
                blob_factories=blob_factories,
            )
            conn.remote_addr = (host, port)
            if uds is not None and os.path.exists(uds):
                try:
                    await loop.create_unix_connection(lambda: conn._protocol, uds)
                    return conn
                except (ConnectionRefusedError, OSError):
                    pass  # stale socket file; fall through to TCP
            await loop.create_connection(lambda: conn._protocol, host, port)
            return conn
        except (ConnectionRefusedError, OSError) as e:
            last_err = e
        delay = next(backoffs)
        if not policy.allows(attempt + 1, (loop.time() - start) + delay):
            break
        await asyncio.sleep(delay)
    raise ConnectionLost(
        f"could not connect to {host}:{port} "
        f"after {attempt} attempts: {last_err}"
    )


class RetryableConnection:
    """A Connection wrapper that survives the link: transparent re-dial on
    ``ConnectionLost``/timeout, with in-flight calls queued during the
    reconnect window and drained against the fresh link — the reference
    runtime's retryable gRPC client (``retryable_grpc_client.h``, and the
    GCS client's failover call queue) in miniature.

    Retry *safety* is per method, declared in ``wire.SCHEMAS``:

    - ``"safe"`` — idempotent; retried freely.
    - ``"dedup"`` — retried only when the payload carries the schema's
      msgid-stable dedup token (e.g. ``lease_id``), which the server uses
      to mirror the original outcome instead of re-applying.
    - ``"none"`` — never retried; the first failure surfaces.

    Methods missing from the registry use ``default_retry`` (constructor
    argument; "safe" fits channels whose handlers are keyed upserts/reads
    by construction, like the GCS control plane).

    The wrapper owns reconnection, not call-level deadlines: each attempt
    inherits the caller's ``timeout`` folded with the ambient handler
    deadline, and the overall retry loop gives up when that budget — or the
    policy's — runs out.

    ``resolver`` makes re-dial target-aware: an async callable returning
    the *current* ``(host, port)`` of the service (or None to keep the last
    known address). When set, every reconnect re-resolves before dialing
    and the address is passed to ``dial(addr)`` — how clients follow a GCS
    leader across failover instead of hammering the dead primary.
    """

    def __init__(
        self,
        dial: Callable[[], Awaitable[Connection]],
        conn: Optional[Connection] = None,
        policy: Optional[RetryPolicy] = None,
        default_retry: str = "none",
        attempt_timeout_s: Optional[float] = None,
        on_reconnect: Optional[Callable[[Connection], Awaitable[None]]] = None,
        name: str = "rpc",
        rng: Optional[random.Random] = None,
        resolver: Optional[
            Callable[[], Awaitable[Optional[Tuple[str, int]]]]
        ] = None,
    ):
        self._dial = dial
        self._resolver = resolver
        self.conn = conn
        self._policy = policy or RetryPolicy.for_calls()
        self._default_retry = default_retry
        # Per-attempt cap so a request whose reply was dropped doesn't pin
        # the whole budget. 0/None disables it (required for channels that
        # carry long-polls, e.g. CreateActor wait_alive).
        if attempt_timeout_s is None:
            attempt_timeout_s = config.rpc_default_timeout_s
        self._attempt_timeout_s = attempt_timeout_s or None
        self._on_reconnect = on_reconnect
        self._name = name
        self._rng = rng or random.Random()
        self._lock: Optional[asyncio.Lock] = None  # lazy: loop-bound
        self._closed = False
        # Legacy per-channel dict kept for direct readers (tests, repr);
        # the cluster-visible copies are the telemetry cells below.
        self.stats = {"redials": 0, "retries": 0, "queued": 0}  # telemetry: allow-adhoc-stats
        self._tel_redials = telemetry.counter(
            "rpc", "redials", "reconnects of a retryable channel"
        ).cell(channel=name)
        self._tel_retries = telemetry.counter(
            "rpc", "retries", "calls transparently re-issued after a failure"
        ).cell(channel=name)
        self._tel_queued = telemetry.counter(
            "rpc", "retry_queued", "calls that waited out a reconnect"
        ).cell(channel=name)

    @property
    def closed(self) -> bool:
        return self._closed

    def _retry_mode(self, method: str, payload: Any) -> str:
        """"safe" if this (method, payload) may be re-sent, else "none"."""
        from ray_tpu_torch._private import wire  # lazy: avoid import cycle

        mode, dedup_key = wire.retry_class(method, self._default_retry)
        if mode == wire.RETRY_DEDUP:
            token = payload.get(dedup_key) if isinstance(payload, dict) else None
            return wire.RETRY_SAFE if token is not None else wire.RETRY_NONE
        return mode

    async def _ensure_connected(self) -> Connection:
        """Current live connection, (re)dialing under a lock if needed.
        Sets ``self.conn`` *before* firing ``on_reconnect`` so re-entrant
        calls made from the callback hit the fast path instead of
        deadlocking on the lock."""
        conn = self.conn
        if conn is not None and not conn.closed:
            return conn
        if self._closed:
            raise ConnectionLost(f"{self._name}: client closed")
        if self._lock is None:
            self._lock = asyncio.Lock()
        queued = self._lock.locked()
        if queued:
            self.stats["queued"] += 1
            self._tel_queued.inc()
        async with self._lock:
            conn = self.conn
            if conn is not None and not conn.closed:
                return conn  # another waiter already reconnected
            if self._closed:
                raise ConnectionLost(f"{self._name}: client closed")
            if self._resolver is not None:
                addr = None
                try:
                    addr = await self._resolver()
                except Exception:
                    logger.debug("%s: address resolver failed; using last "
                                 "known address", self._name, exc_info=True)
                conn = await self._dial(addr)
            else:
                conn = await self._dial()
            self.conn = conn
            self.stats["redials"] += 1
            self._tel_redials.inc()
            telemetry.record_event("rpc", "redial", channel=self._name)
            if self._on_reconnect is not None:
                await self._on_reconnect(conn)
            return conn

    async def call(
        self, method: str, payload: Any = None, timeout: Optional[float] = None
    ):
        """Issue a request, retrying per the method's wire retry class.

        The overall budget is ``timeout`` folded with the ambient handler
        deadline and the policy's total budget; backoffs are clamped to it.
        Non-retryable failures — and retryable ones once the budget is
        spent — propagate to the caller.
        """
        loop = asyncio.get_running_loop()
        ambient = _ambient_deadline.get()
        overall: Optional[float] = None
        if timeout is not None:
            overall = loop.time() + timeout
        if ambient is not None:
            overall = ambient if overall is None else min(overall, ambient)
        start = loop.time()
        backoffs = self._policy.backoffs(self._rng)
        attempt = 0
        while True:
            attempt += 1
            try:
                conn = await self._ensure_connected()
                attempt_timeout = self._attempt_timeout_s
                if overall is not None:
                    remaining = overall - loop.time()
                    if remaining <= 0:
                        raise DeadlineExceeded(
                            f"{self._name}: {method} budget exhausted "
                            f"before attempt {attempt}"
                        )
                    if attempt_timeout is None or attempt_timeout > remaining:
                        attempt_timeout = remaining
                return await conn.call(method, payload, timeout=attempt_timeout)
            except (ConnectionLost, asyncio.TimeoutError, StaleLeaderError) as e:
                if isinstance(e, StaleLeaderError):
                    # The peer lost leadership: the write was rejected, not
                    # applied. Drop the link so the next attempt re-resolves
                    # (and re-dials) the current leader. Without a resolver
                    # this still lands on the restarted/promoted address.
                    if self.conn is conn and not conn.closed:
                        self.conn = None
                        spawn(conn.close())
                if self._closed:
                    raise
                if self._retry_mode(method, payload) != "safe":
                    raise
                delay = next(backoffs)
                now = loop.time()
                if not self._policy.allows(attempt + 1, (now - start) + delay):
                    raise
                if overall is not None:
                    remaining = overall - now
                    if remaining <= delay:
                        raise
                self.stats["retries"] += 1
                self._tel_retries.inc()
                telemetry.record_event(
                    "rpc", "retry", channel=self._name, method=method
                )
                logger.debug(
                    "%s: retrying %s after %s (attempt %d, sleeping %.3fs)",
                    self._name, method, type(e).__name__, attempt, delay,
                )
                await asyncio.sleep(delay)

    async def close(self) -> None:
        """Terminal: no further re-dials; in-flight retry loops surface
        their pending error instead of reconnecting."""
        self._closed = True
        if self.conn is not None:
            await self.conn.close()
