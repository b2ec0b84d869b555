"""The reference's tests/test_blob_frames.py on the port, case for case after the
rename (ray_tpu -> ray_tpu_torch, num_tpus -> num_gpus, the conftest fixtures
-> ray_tpu_torch.testing's). No case differs.

Blob sidecar frames (the zero-copy data plane, rpc.py kinds 4/5):
framing boundaries under adversarial chunking, sink selection and delivery,
interleaving with ordinary control frames, mid-blob connection loss, and
chaos-interceptor atomicity (a blob frame drops/delays/dups as ONE unit
with its data materialized)."""

import asyncio

import msgpack
import pytest

from ray_tpu_torch._private import rpc
from ray_tpu_torch.chaos import interceptors
from ray_tpu_torch.chaos.schedule import FaultSchedule, FaultSpec

_packb = msgpack.Packer(use_bin_type=True, autoreset=True).pack


class _RecordingSink:
    """Sink that records every write and the final done(ok) verdict."""

    def __init__(self):
        self.chunks = []
        self.oks = []

    def write(self, view):
        self.chunks.append(bytes(view))  # views are transient: copy

    def done(self, ok):
        self.oks.append(ok)

    def data(self):
        return b"".join(self.chunks)


async def _start_pair(server_handlers=None, blob_factories=None):
    """A Server with the given handlers/factories plus a dialed client."""
    server = rpc.Server("127.0.0.1", 0)
    for name, fn in (server_handlers or {}).items():
        server.register(name, fn)
    for name, factory in (blob_factories or {}).items():
        server.register_blob(name, factory)
    host, port = await server.start()
    client = await rpc.connect(host, port)
    return server, client


# ------------------------------------------------- byte-level framing


def _feed_sizes(total):
    # Adversarial chunkings: byte-by-byte, tiny, and near-boundary splits.
    yield [1] * total
    yield [7] * (total // 7) + [total % 7]
    yield [total - 1, 1]
    yield [total]


def test_blob_frame_survives_any_chunking():
    """A blob control frame + sidecar + trailing ordinary frame must decode
    identically no matter how the byte stream is sliced: the protocol's
    unpacker-tail recovery and blob-mode switch cannot depend on frames
    arriving whole."""

    async def go():
        blob = bytes(range(256)) * 13  # 3328 bytes, non-repeating-ish
        wire_bytes = (
            _packb([0, 3, "Before", {"seq": 1}])
            + _packb([0, 4, "Blobbed", {"oid": "o1"}, len(blob)])
            + blob
            + _packb([0, 3, "After", {"seq": 2}])
        )
        for sizes in _feed_sizes(len(wire_bytes)):
            got = {"pushes": [], "sink": _RecordingSink()}

            async def push(conn, p, got=got):
                got["pushes"].append(p)

            conn = rpc.Connection(
                {"Before": push, "After": push},
                blob_factories={
                    "Blobbed": lambda c, p, size, got=got: got["sink"]
                },
            )
            pos = 0
            for n in sizes:
                conn._protocol.data_received(wire_bytes[pos : pos + n])
                pos += n
            for _ in range(4):
                await asyncio.sleep(0)  # run the spawned push dispatches
            assert got["sink"].data() == blob, sizes
            assert got["sink"].oks == [True]
            assert [p["seq"] for p in got["pushes"]] == [1, 2], sizes

    asyncio.run(go())


def test_back_to_back_blobs_one_chunk():
    """Two blob frames delivered in a single data_received call: the tail
    recovery after the first blob must hand the second control frame (and
    its sidecar) back through the framing loop."""

    async def go():
        a, b = b"A" * 1000, b"B" * 2000
        sinks = []

        def factory(conn, p, size):
            sinks.append(_RecordingSink())
            return sinks[-1]

        conn = rpc.Connection({}, blob_factories={"Chunk": factory})
        conn._protocol.data_received(
            _packb([0, 4, "Chunk", {"i": 0}, len(a)])
            + a
            + _packb([0, 4, "Chunk", {"i": 1}, len(b)])
            + b
        )
        assert [s.data() for s in sinks] == [a, b]
        assert all(s.oks == [True] for s in sinks)

    asyncio.run(go())


def test_zero_length_blob_completes_inline():
    async def go():
        sink = _RecordingSink()
        conn = rpc.Connection(
            {}, blob_factories={"Empty": lambda c, p, size: sink}
        )
        conn._protocol.data_received(
            _packb([0, 4, "Empty", {"oid": "z"}, 0])
            + _packb([0, 4, "Empty", {"oid": "z2"}, 0])
        )
        assert sink.data() == b"" and sink.oks == [True, True]

    asyncio.run(go())


def test_oversized_blob_length_drops_connection():
    """A corrupt/hostile length field must kill the link, not allocate."""

    async def go():
        closed = []
        conn = rpc.Connection({}, on_close=lambda c: closed.append(True))

        class _T:
            def close(self):
                conn._teardown()

            def get_extra_info(self, *_):
                return None

        conn._protocol.transport = _T()
        conn._protocol.data_received(
            _packb([0, 4, "Huge", {}, rpc._MAX_FRAME + 1])
        )
        assert closed == [True]

    asyncio.run(go())


# ------------------------------------------------- end-to-end over sockets


def test_blob_push_streams_into_factory_sink():
    async def go():
        landed = asyncio.Event()
        sink = _RecordingSink()
        seen = {}

        def factory(conn, payload, size):
            seen["payload"], seen["size"] = payload, size
            return sink

        real_done = sink.done

        def done(ok):
            real_done(ok)
            landed.set()

        sink.done = done
        server, client = await _start_pair(blob_factories={"Push": factory})
        try:
            blob = memoryview(bytearray(b"\xab" * (256 * 1024)))
            client.blob_push_nowait("Push", {"oid": "x", "offset": 0}, blob)
            await asyncio.wait_for(landed.wait(), 5)
            assert seen["payload"] == {"oid": "x", "offset": 0}
            assert seen["size"] == blob.nbytes
            assert sink.data() == bytes(blob)
        finally:
            await client.close()
            await server.stop()

    asyncio.run(go())


def test_call_with_blob_default_sink_injects_data():
    """No factory registered: the blob lands in a BufferSink and reaches the
    ordinary handler as payload['data']; the reply round-trips."""

    async def go():
        async def put(conn, p):
            return {"n": len(p["data"]), "meta": p["meta"]}

        server, client = await _start_pair(server_handlers={"CPut": put})
        try:
            blob = b"z" * 123_457
            reply = await asyncio.wait_for(
                client.call_with_blob("CPut", {"meta": 7}, blob), 5
            )
            assert reply == {"n": len(blob), "meta": 7}
        finally:
            await client.close()
            await server.stop()

    asyncio.run(go())


def test_call_into_span_sink_receives_blob_reply():
    async def go():
        payload = bytes(range(256)) * 4096  # 1 MiB

        async def fetch(conn, p):
            lo, hi = p["lo"], p["hi"]
            return rpc.Blob({"size": hi - lo}, memoryview(payload)[lo:hi])

        server, client = await _start_pair(server_handlers={"Fetch": fetch})
        try:
            dest = memoryview(bytearray(len(payload)))
            sink = rpc.SpanSink(dest, pos=4096)
            meta = await asyncio.wait_for(
                client.call_into(
                    "Fetch", {"lo": 0, "hi": 65536}, sink, timeout=5
                ),
                10,
            )
            assert meta == {"size": 65536}
            assert sink.written == 65536
            assert bytes(dest[4096 : 4096 + 65536]) == payload[:65536]
        finally:
            await client.close()
            await server.stop()

    asyncio.run(go())


def test_multi_buffer_blob_concatenates():
    async def go():
        async def put(conn, p):
            return {"data": bytes(p["data"])}

        server, client = await _start_pair(server_handlers={"Put": put})
        try:
            parts = [b"a" * 10, memoryview(b"b" * 20), bytearray(b"c" * 30)]
            reply = await asyncio.wait_for(
                client.call_with_blob("Put", {}, parts), 5
            )
            assert reply["data"] == b"a" * 10 + b"b" * 20 + b"c" * 30
        finally:
            await client.close()
            await server.stop()

    asyncio.run(go())


def test_declined_factory_drains_and_stream_stays_framed():
    """A factory returning None discards the blob; the very next request on
    the same connection must still parse (the stream stayed framed)."""

    async def go():
        async def ping(conn, p):
            return {"pong": True}

        server, client = await _start_pair(
            server_handlers={"Ping": ping},
            blob_factories={"Unwanted": lambda c, p, size: None},
        )
        try:
            client.blob_push_nowait("Unwanted", {}, b"x" * 50_000)
            reply = await asyncio.wait_for(client.call("Ping", {}), 5)
            assert reply == {"pong": True}
        finally:
            await client.close()
            await server.stop()

    asyncio.run(go())


def test_blob_interleaves_with_pipelined_calls():
    """Blob frames and ordinary request/reply traffic share one connection;
    ordering per direction is preserved and nothing corrupts."""

    async def go():
        order = []

        async def mark(conn, p):
            order.append(("call", p["i"]))
            return p["i"]

        async def putb(conn, p):
            order.append(("blob", len(p["data"])))
            return len(p["data"])

        server, client = await _start_pair(
            server_handlers={"Mark": mark, "PutB": putb}
        )
        try:
            results = await asyncio.wait_for(
                asyncio.gather(
                    client.call("Mark", {"i": 0}),
                    client.call_with_blob("PutB", {}, b"q" * 70_000),
                    client.call("Mark", {"i": 1}),
                    client.call_with_blob("PutB", {}, b"r" * 10),
                    client.call("Mark", {"i": 2}),
                ),
                10,
            )
            assert results == [0, 70_000, 1, 10, 2]
            assert order == [
                ("call", 0),
                ("blob", 70_000),
                ("call", 1),
                ("blob", 10),
                ("call", 2),
            ]
        finally:
            await client.close()
            await server.stop()

    asyncio.run(go())


def test_connection_loss_mid_blob_fails_sink():
    """Teardown with a half-received blob: the sink must see done(False) so
    an arena span being filled can be aborted/quarantined."""

    async def go():
        sink = _RecordingSink()
        started = asyncio.Event()
        real_write = sink.write

        def write(view):
            real_write(view)
            started.set()

        sink.write = write
        server, client = await _start_pair(
            blob_factories={"Part": lambda c, p, size: sink}
        )
        try:
            total = 64 * 1024 * 1024  # far more than one socket buffer
            # Half-frame by hand: control message promises `total` bytes but
            # the client only ever writes a fragment, then dies.
            client._protocol.transport.write(
                _packb([0, 4, "Part", {"oid": "p"}, total]) + b"x" * 4096
            )
            await asyncio.wait_for(started.wait(), 5)
            await client.close()
            for _ in range(100):
                if sink.oks:
                    break
                await asyncio.sleep(0.02)
            assert sink.oks == [False]
            assert len(sink.data()) < total
        finally:
            await server.stop()

    asyncio.run(go())


def test_call_with_blob_fails_fast_on_connection_loss():
    async def go():
        server, client = await _start_pair()
        try:
            fut = asyncio.ensure_future(
                client.call_with_blob("Never", {}, b"x" * 1024)
            )
            await asyncio.sleep(0)
            await client.close()
            with pytest.raises(rpc.RpcError):
                await asyncio.wait_for(fut, 5)
        finally:
            await server.stop()

    asyncio.run(go())


# ------------------------------------------------- chaos x blob atomicity


def _install(spec, seed=0):
    return interceptors.install(FaultSchedule(seed, [spec]))


def test_chaos_sees_blob_frame_as_one_materialized_unit():
    """The interceptor must be offered [msgid, kind, method, payload, BYTES]
    — a stable copy, not a live arena view — so drop/delay/dup act on the
    whole frame (control + data) atomically."""

    async def go():
        offered = []

        def interceptor(conn, msg):
            offered.append(msg)
            return True  # drop

        rpc.set_send_interceptor(interceptor)
        try:
            server, client = await _start_pair()
            try:
                arena = bytearray(b"\x11" * 2048)
                client.blob_push_nowait(
                    "PushChunk", {"oid": "o"}, memoryview(arena)
                )
                (msg,) = offered
                assert msg[1] == rpc._KIND_BLOB
                assert isinstance(msg[4], bytes)  # materialized, not a view
                arena[:] = b"\x99" * 2048  # arena reuse must not corrupt it
                assert msg[4] == b"\x11" * 2048
            finally:
                await client.close()
                await server.stop()
        finally:
            rpc.set_send_interceptor(None)

    asyncio.run(go())


def test_chaos_dropped_then_redelivered_blob_arrives_intact():
    """Drop a blob push via the chaos interceptor, then redeliver the
    captured frame with _send_direct (the delay/dup delivery path): the
    receiver must get the full blob exactly once."""

    async def go():
        held = []

        def interceptor(conn, msg):
            if msg[1] == rpc._KIND_BLOB:
                held.append((conn, msg))
                return True
            return False

        landed = asyncio.Event()
        sink = _RecordingSink()
        real_done = sink.done

        def done(ok):
            real_done(ok)
            landed.set()

        sink.done = done
        rpc.set_send_interceptor(interceptor)
        try:
            server, client = await _start_pair(
                blob_factories={"PushChunk": lambda c, p, size: sink}
            )
            try:
                blob = b"\x42" * 100_000
                client.blob_push_nowait("PushChunk", {"oid": "o"}, blob)
                assert not sink.chunks  # consumed by the fault
                (conn, msg), = held
                conn._send_direct(msg)  # the delayed delivery half
                await asyncio.wait_for(landed.wait(), 5)
                assert sink.data() == blob and sink.oks == [True]
            finally:
                await client.close()
                await server.stop()
        finally:
            rpc.set_send_interceptor(None)

    asyncio.run(go())


def test_chaos_interceptor_classifies_blob_frames():
    """Frame-class matching for the new kinds: a kind-4 with msgid 0 is a
    push, with a msgid it is a request; kind-5 is a reply."""
    chaos = interceptors.ChaosInterceptor(
        FaultSchedule(
            0, [FaultSpec("d", "drop", "PushChunk", frame="push", p=1.0)]
        )
    )

    class _C:
        sent = []

        def _send_direct(self, m):
            self.sent.append(m)

    # push-classed blob: dropped.
    assert chaos(_C(), [0, rpc._KIND_BLOB, "PushChunk", {}, b"x"]) is True
    # request-classed blob (msgid != 0): not a "push", flows.
    assert chaos(_C(), [9, rpc._KIND_BLOB, "PushChunk", {}, b"x"]) is False
    # blob replies class as replies.
    rep = interceptors.ChaosInterceptor(
        FaultSchedule(
            0, [FaultSpec("d", "drop", "FetchChunk", frame="reply", p=1.0)]
        )
    )
    assert rep(_C(), [3, rpc._KIND_BLOB_REP, "FetchChunk", {}, b"x"]) is True


def test_chaos_dup_of_blob_push_is_idempotent_for_arena_sink():
    """Duplicate a PushChunk blob: both copies carry the same offset, so an
    arena sink just writes the same bytes twice — content converges."""

    async def go():
        arena = bytearray(8192)
        dones = []

        class _ArenaSink:
            def __init__(self, off):
                self.off = off

            def write(self, view):
                n = view.nbytes
                arena[self.off : self.off + n] = view
                self.off += n

            def done(self, ok):
                dones.append(ok)

        chaos = _install(
            FaultSpec("2x", "dup", "PushChunk", frame="push", p=1.0)
        )
        try:
            server, client = await _start_pair(
                blob_factories={
                    "PushChunk": lambda c, p, size: _ArenaSink(p["offset"])
                }
            )
            try:
                blob = bytes(range(256)) * 16  # 4096 bytes
                client.blob_push_nowait(
                    "PushChunk", {"oid": "o", "offset": 512}, blob
                )
                for _ in range(100):
                    if len(dones) >= 2:
                        break
                    await asyncio.sleep(0.02)
                assert dones == [True, True]  # original + duplicate
                assert bytes(arena[512 : 512 + len(blob)]) == blob
                assert chaos.log.count("2x") == 1
            finally:
                await client.close()
                await server.stop()
        finally:
            interceptors.uninstall()

    asyncio.run(go())
