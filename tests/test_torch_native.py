"""The port's native extensions (ray_tpu_torch._native, built from
_native/csrc/ at first import), on the CPU: tests/test_fastpath_native.py
(the direct-call channel, the wire codec against the port's pure-Python
packer byte for byte, the fallbacks) and tests/test_store_core.py (both
store engines) run on the port's build; the libraries loaded are the ones
built from the copies of src/ (test_torch_runtime.py holds the copies to
src/ after the rename), a changed source is rebuilt under a new hash, a
failed build raises ImportError with the compiler's output, the runtime
takes the native path in the driver and in its workers, and a task whose
arguments carry out-of-band buffers goes through the native channel."""

import os
import select
import shutil
import sys
import time

import msgpack
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import _native
from ray_tpu_torch._native import _fastpath as fp
from ray_tpu_torch._private import rpc
from ray_tpu_torch._private import store_core as sc
from ray_tpu_torch.testing import torch_cluster  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- tests/test_fastpath_native.py on the port ------------------------------


def _drain_until(n, timeout=10.0):
    out = []
    deadline = time.time() + timeout
    nfd = fp.notify_fd()
    while len(out) < n and time.time() < deadline:
        select.select([nfd], [], [], 0.5)
        out.extend(fp.drain())
    return out


@pytest.fixture
def server():
    calls = []

    def cb(tid, fid, name, blob):
        calls.append((tid, fid, name, blob))
        if fid == b"boom":
            return (1, b"ERRPAYLOAD")
        if fid == b"nofn":
            return (4, b"")
        if fid == b"big":
            return (6, b"PLASMA_DESC")
        return (0, b"R:" + blob)

    sid, port = fp.serve("127.0.0.1", 0, cb)
    yield port, calls
    fp.stop_server(sid)


def test_round_trip_statuses(server):
    """Every reply status survives the 10+status wire encoding."""
    port, calls = server
    ch = fp.client_connect("127.0.0.1", port)
    assert ch > 0
    fp.submit(ch, b"t-ok", b"f1", b"n", b"payload")
    fp.submit(ch, b"t-err", b"boom", b"n", b"x")
    fp.submit(ch, b"t-nofn", b"nofn", b"n", b"x")
    fp.submit(ch, b"t-big", b"big", b"n", b"x")
    got = {tid: (status, payload) for tid, status, payload in _drain_until(4)}
    assert got[b"t-ok"] == (0, b"R:payload")
    assert got[b"t-err"] == (1, b"ERRPAYLOAD")
    assert got[b"t-nofn"] == (4, b"")
    assert got[b"t-big"] == (6, b"PLASMA_DESC")
    assert [c[0] for c in calls] == [b"t-ok", b"t-err", b"t-nofn", b"t-big"]
    fp.client_close(ch)


def test_large_args_round_trip(server):
    """Multi-megabyte args cross the frame reader's 64KB recv buffer."""
    port, _calls = server
    ch = fp.client_connect("127.0.0.1", port)
    blob = os.urandom(3 * 1024 * 1024)
    fp.submit(ch, b"t-large", b"f", b"n", blob)
    ((tid, status, payload),) = _drain_until(1, timeout=30)
    assert tid == b"t-large" and status == 0
    assert payload == b"R:" + blob
    fp.client_close(ch)


def test_channel_loss_no_tid_vanishes(server):
    """The driver-side invariant its retry machinery depends on: every
    submitted tid produces EXACTLY ONE completion — finished work arrives
    as status 0/1, anything cut off by the connection dropping arrives as
    status 2 (lost). Nothing is silently dropped."""
    def slow_cb(tid, fid, name, blob):
        time.sleep(1.0)
        return (0, b"late")

    sid, port = fp.serve("127.0.0.1", 0, slow_cb)
    ch = fp.client_connect("127.0.0.1", port)
    fp.submit(ch, b"t-cut-1", b"f", b"n", b"x")
    fp.submit(ch, b"t-cut-2", b"f", b"n", b"x")
    time.sleep(0.2)
    fp.stop_server(sid)  # server torn down with work in flight
    got = _drain_until(2, timeout=15)
    assert sorted(tid for tid, _s, _p in got) == [b"t-cut-1", b"t-cut-2"]
    assert all(status in (0, 2) for _t, status, _p in got), got
    fp.client_close(ch)


def test_submit_to_closed_channel_returns_false(server):
    port, _calls = server
    ch = fp.client_connect("127.0.0.1", port)
    fp.client_close(ch)
    assert fp.submit(ch, b"t", b"f", b"n", b"x") is False


def test_connect_failure_returns_negative():
    assert fp.client_connect("127.0.0.1", 1) < 0


# ---------------------------------------------------- wire codec parity

# The port's pure-Python packer: the fallback the native codec must match
# byte for byte.
_PACKB = rpc._packb
_FUZZ_ROUNDS = 500


def _lease_id(rng):
    return "".join(rng.choices("0123456789abcdef", k=24))


def _resources(rng):
    names = ["CPU", "TPU", "memory", "node:10.0.0.%d" % rng.randrange(256),
             "custom/res-%d" % rng.randrange(8)]
    return {
        rng.choice(names): rng.choice([1, 0.5, 4.0, rng.random() * 64])
        for _ in range(rng.randrange(0, 4))
    }


def _payload_for(method, rng):
    """Schema-shaped randomized payloads (field lists mirror
    wire.NATIVE_WIRE_SCHEMAS; the drift lint keeps the two in sync)."""
    if method == "RequestWorkerLease":
        return {
            "lease_id": _lease_id(rng),
            "resources": _resources(rng),
            "pg_id": rng.choice([None, _lease_id(rng)]),
            "bundle_index": rng.choice([-1, 0, rng.randrange(64)]),
            "strategy": rng.choice(
                [None, {"spread": True}, {"node_affinity": {"node_id": _lease_id(rng), "soft": rng.random() < 0.5}}]
            ),
            "spilled_from": rng.random() < 0.3,
            "locality": rng.choice(
                [None, {"10.0.0.%d:%d" % (rng.randrange(256), rng.randrange(1024, 65536)): rng.random() * 8}]
            ),
            "job_id": rng.choice([None, "job-%04d" % rng.randrange(10000)]),
        }
    if method == "ReturnWorker":
        return {"lease_id": _lease_id(rng), "dirty": rng.random() < 0.5}
    if method == "CancelWorkerLease":
        return {"lease_id": _lease_id(rng)}
    if method == "LeaseBatch":
        inner = ["RequestWorkerLease", "ReturnWorker", "CancelWorkerLease"]
        return {
            "entries": [
                [
                    rng.randrange(1, 1 << 30),
                    m,
                    _payload_for(m, rng),
                    rng.choice([None, rng.random() * 30]),
                    rng.choice([None, [_lease_id(rng), _lease_id(rng)[:16]]]),
                ]
                for m in (rng.choice(inner) for _ in range(rng.randrange(1, 9)))
            ]
        }
    if method == "PubBatch":
        return {
            "items": [
                [
                    rng.choice(["NODE", "ACTOR", "WORKER", "health"]),
                    rng.choice(
                        [
                            {"node_id": _lease_id(rng), "state": rng.choice(["ALIVE", "DEAD"])},
                            {"actor_id": _lease_id(rng), "addr": ["10.0.0.1", rng.randrange(65536)]},
                            b"\x00binary blob\xff" * rng.randrange(1, 4),
                        ]
                    ),
                    rng.randrange(1, 1 << 40),
                ]
                for _ in range(rng.randrange(1, 9))
            ]
        }
    raise AssertionError(method)


def _frame_variants(method, payload, rng):
    """The frame shapes rpc._pack_frame actually emits: bare request, with
    TTL slot, and with TTL + trace-context slot (PR 4 / PR 13 survive
    byte-for-byte)."""
    msgid = rng.randrange(1, 1 << 31)
    kind = 3 if method in ("LeaseBatch", "PubBatch") else 0
    yield [msgid, kind, method, payload]
    yield [msgid, kind, method, payload, rng.random() * 30]
    yield [msgid, kind, method, payload, rng.random() * 30,
           [_lease_id(rng), _lease_id(rng)[:16]]]


def _norm(v):
    if isinstance(v, (list, tuple)):
        return [_norm(x) for x in v]
    if isinstance(v, dict):
        return {k: _norm(val) for k, val in v.items()}
    return v


@pytest.mark.parametrize(
    "method",
    ["RequestWorkerLease", "ReturnWorker", "CancelWorkerLease", "LeaseBatch", "PubBatch"],
)
def test_native_pack_parity_fuzz(method):
    """Per native schema: randomized frames pack byte-identically to the
    Python packer, Python-unpack the native bytes losslessly, and
    native-unpack the Python bytes losslessly — both directions of the
    fallback boundary are interchangeable on the wire."""
    import random

    rng = random.Random(hash(method) & 0xFFFF)
    for _ in range(_FUZZ_ROUNDS):
        payload = _payload_for(method, rng)
        for frame in _frame_variants(method, payload, rng):
            native = fp.pack_frame(frame)
            pure = _PACKB(frame)
            assert native == pure, f"{method}: byte divergence"
            # native-pack -> Python-unpack
            back = msgpack.unpackb(native, raw=False, strict_map_key=False)
            assert back == _norm(frame)
            # Python-pack -> native-unpack
            dec = fp.Decoder()
            dec.feed(pure)
            got = list(dec)
            assert got == [_norm(frame)]
            assert dec.tell() == len(pure)


def test_native_decoder_incremental_and_tell():
    """Chunked feeds: frames split at arbitrary byte boundaries decode
    exactly once each, and tell() counts total consumed bytes (the blob-
    mode switch in rpc.data_received depends on that)."""
    import random

    rng = random.Random(99)
    frames = []
    for _ in range(200):
        m = rng.choice(["RequestWorkerLease", "ReturnWorker", "LeaseBatch"])
        frames.append(next(_frame_variants(m, _payload_for(m, rng), rng)))
    stream = b"".join(_PACKB(f) for f in frames)
    dec = fp.Decoder()
    got = []
    i = 0
    while i < len(stream):
        n = rng.randrange(1, 4096)
        dec.feed(stream[i : i + n])
        i += n
        got.extend(dec)
    assert got == [_norm(f) for f in frames]
    assert dec.tell() == len(stream)


def test_native_decoder_rejects_malformed_bytes():
    """Ext/reserved leaders are not part of the wire protocol: the decoder
    must raise (the rpc layer drops the connection) instead of guessing."""
    for bad in (b"\xc1", b"\xc7\x01\x05x", b"\xd4\x05x", b"\xc8\x00\x01\x05x"):
        dec = fp.Decoder()
        dec.feed(bad)
        with pytest.raises(Exception):
            list(dec)


def test_packed_payload_grant_reply_byte_identity():
    """The pre-packed grant skeleton (raylet._grant_reply) must splice into
    frames byte-identically to packing the equivalent plain-dict reply —
    the wire format is unchanged, only who pays the encode."""
    import asyncio

    from ray_tpu_torch._private import rpc as _rpc

    mapping = {
        "granted": True,
        "worker_id": "w-00042",
        "worker_addr": ["10.0.0.7", 45123],
        "lease_id": "a1b2c3d4e5f60718293a4b5c",
        "fp_port": 7011,
    }
    packed = _rpc.PackedPayload(mapping, _rpc._packb(mapping))

    async def go():
        server = _rpc.Server("127.0.0.1", 0)
        addr = await server.start()
        conn = await _rpc.connect(*addr)
        try:
            flats = []
            for frame_payload in (mapping, packed):
                bufs = conn._pack_frame([771, 1, "RequestWorkerLease", frame_payload])
                flats.append(b"".join(bytes(b) for b in bufs))
        finally:
            await conn.close()
            await server.stop()
        return flats

    plain, spliced = asyncio.run(go())
    assert spliced == plain
    assert msgpack.unpackb(plain, raw=False, strict_map_key=False) == [
        771, 1, "RequestWorkerLease", mapping,
    ]


def test_python_fallback_when_native_masked():
    """With the compiled module masked (import error) the rpc layer must
    boot on the pure-Python packer and complete a lease-shaped round trip;
    native is an accelerator, never a dependency."""
    import subprocess

    code = r"""
import asyncio, sys

class _Mask:
    def find_spec(self, name, path=None, target=None):
        if name == "ray_tpu_torch._native._fastpath":
            raise ImportError("masked for fallback test")

sys.meta_path.insert(0, _Mask())

from ray_tpu_torch._private import rpc

assert rpc._NATIVE_WIRE is None, "mask failed"
assert not rpc.native_wire_active()

async def go():
    server = rpc.Server("127.0.0.1", 0)

    async def lease(conn, p):
        return {"granted": True, "lease_id": p["lease_id"]}

    server.register("RequestWorkerLease", lease)
    addr = await server.start()
    conn = await rpc.connect(*addr)
    try:
        replies = await asyncio.gather(
            *(conn.call_batched("RequestWorkerLease", {"lease_id": "L%d" % i})
              for i in range(8))
        )
        assert [r["lease_id"] for r in replies] == ["L%d" % i for i in range(8)]
    finally:
        await conn.close()
        await server.stop()

asyncio.run(go())
print("FALLBACK_OK")
"""
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, timeout=120,
        cwd=REPO,
    )
    assert out.returncode == 0, out.stderr
    assert "FALLBACK_OK" in out.stdout


def test_env_gate_disables_native_wire():
    """RAY_TPU_NATIVE_WIRE=0 must force the pure-Python path even with the
    extension importable."""
    import subprocess

    code = (
        "from ray_tpu_torch._private import rpc; "
        "assert rpc._NATIVE_WIRE is None; "
        "assert not rpc.native_wire_active(); "
        "print('GATE_OK')"
    )
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, timeout=60,
        env={**os.environ, "RAY_TPU_NATIVE_WIRE": "0"}, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr
    assert "GATE_OK" in out.stdout


# -- tests/test_store_core.py on the port -----------------------------------

ENGINES = [pytest.param(sc.PyStoreCore, id="python"),
           pytest.param(sc.NativeStoreCore, id="native")]


@pytest.fixture(params=ENGINES)
def Store(request):
    return request.param


def test_alloc_free_roundtrip(Store):
    s = Store(1 << 20)
    off_a = s.alloc("a", 1000, True)
    assert off_a >= 0
    off_b = s.alloc("b", 2000, False)
    assert off_b >= off_a + 1000
    assert s.used == 3000
    assert s.num_objects == 2
    s.seal("a")
    assert s.lookup("a") == (off_a, 1000, True, True)
    assert s.contains("a") and not s.contains("b")  # b unsealed
    assert s.free("a") == 1000
    assert s.lookup("a") is None
    assert s.used == 2000


def test_duplicate_alloc_raises(Store):
    s = Store(1 << 16)
    s.alloc("x", 10, True)
    with pytest.raises(KeyError):
        s.alloc("x", 10, True)


def test_capacity_exhaustion_and_reuse(Store):
    s = Store(64 * 10)  # ten 64B-rounded slots
    offs = [s.alloc(f"o{i}", 64, False) for i in range(10)]
    assert all(o >= 0 for o in offs)
    assert s.alloc("overflow", 64, False) == -1
    s.free("o5")
    off = s.alloc("overflow", 64, False)
    assert off == offs[5]  # best-fit reuses the freed slot


def test_coalescing(Store):
    s = Store(64 * 8)
    for i in range(8):
        s.alloc(f"o{i}", 64, False)
    # Free three adjacent slots -> one coalesced span fits a 3-slot object.
    for i in (2, 3, 4):
        s.free(f"o{i}")
    off = s.alloc("big", 64 * 3, False)
    assert off >= 0
    frag, largest, spans = s.fragmentation()
    assert largest == 0 and s.used == s.capacity


def test_lru_eviction_order_and_pinning(Store):
    s = Store(1 << 20)
    for i in range(5):
        s.alloc(f"o{i}", 100, False)
        s.seal(f"o{i}")
    s.pin("o0")
    s.touch("o1")  # o1 becomes most-recent
    victims = s.evict(250, 0)
    # o0 pinned, o1 freshly touched -> oldest unpinned are o2, o3, o4...
    assert victims[:2] == ["o2", "o3"]
    assert "o0" not in victims and "o1" not in victims


def test_evict_skips_unsealed(Store):
    s = Store(1 << 16)
    s.alloc("unsealed", 100, False)
    s.alloc("sealed", 100, False)
    s.seal("sealed")
    victims = s.evict(10_000, 0)
    assert victims == ["sealed"]
    assert s.lookup("unsealed") is not None


def test_arena_store_end_to_end(torch_cluster):  # noqa: F811
    """Large objects round-trip through the node arena zero-copy."""
    import ray_tpu_torch
    from ray_tpu_torch._private import worker as worker_mod

    arr = np.random.rand(512, 512)  # 2 MB -> plasma path
    ref = ray_tpu_torch.put(arr)
    out = ray_tpu_torch.get(ref)
    np.testing.assert_array_equal(arr, out)

    # The raylet's store core accounts for it.
    raylet = worker_mod.global_worker.node.raylet
    assert raylet.store.num_objects >= 1
    assert raylet.store_used >= arr.nbytes

    # Worker-side round trip too (task returns large value).
    @ray_tpu_torch.remote
    def make():
        return np.ones((256, 256))

    np.testing.assert_array_equal(ray_tpu_torch.get(make.remote()), np.ones((256, 256)))


def test_delete_quarantine(torch_cluster):  # noqa: F811
    """Deleted objects vanish from the directory immediately but their arena
    bytes are not recycled within the grace window (zero-copy view safety)."""
    import ray_tpu_torch
    from ray_tpu_torch._private import worker as worker_mod

    arr = np.arange(300_000, dtype=np.float64)  # 2.4MB -> arena
    ref = ray_tpu_torch.put(arr)
    view = ray_tpu_torch.get(ref)  # zero-copy view into the arena
    raylet = worker_mod.global_worker.node.raylet

    # Drop the ref -> owner ref count hits zero -> delete path.
    del ref
    import gc, time as _t

    gc.collect()
    deadline = _t.monotonic() + 10
    while _t.monotonic() < deadline and not raylet.condemned:
        _t.sleep(0.2)
    assert raylet.condemned, "deleted object was not quarantined"
    # The view must still read the original bytes (span not recycled).
    np.testing.assert_array_equal(view[:100], np.arange(100, dtype=np.float64))


# -- the build ----------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(_native.EXTENSIONS))
def test_loaded_library_is_built_from_the_copied_source(name):
    """Each module the runtime imports is the library built from its source
    in _native/csrc/ with the current flags (the hash names both)."""
    mod = sys.modules[f"ray_tpu_torch._native.{name}"]
    assert os.path.samefile(mod.__file__, _native.library_path(name))
    assert os.path.dirname(mod.__file__) == str(_native.BUILD_DIR)


def test_build_is_a_release_build_with_setup_py_flags():
    """The libraries build with setup.py's flags and the -DNDEBUG that
    setuptools adds for the JAX package's build (a release build: without
    it the interpreter's headers keep their asserts)."""
    flags = _native._flags("_shm")
    assert {"-O2", "-std=c++17", "-DNDEBUG", "-shared", "-fPIC", "-lrt"} <= set(flags)
    assert "-lrt" not in _native._flags("_fastpath")


def test_changed_source_is_rebuilt_under_a_new_hash(tmp_path):
    """An edited source gets a new library beside the old one; the old
    name is never reused for the new text."""
    csrc, build_dir = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    shutil.copy(_native.CSRC / "store_core.cc", csrc / "store_core.cc")
    first = _native.build("_store", csrc, build_dir)
    assert first == _native.library_path("_store", csrc, build_dir)
    stamp = first.stat().st_mtime_ns
    assert _native.build("_store", csrc, build_dir) == first  # cached
    assert first.stat().st_mtime_ns == stamp
    with open(csrc / "store_core.cc", "a") as f:
        f.write("\n// edited\n")
    second = _native.build("_store", csrc, build_dir)
    assert second != first and second.exists() and first.exists()
    assert sorted(p.name for p in build_dir.glob("*.so")) == sorted([first.name, second.name])


def test_failed_build_raises_import_error_with_the_compiler_output(tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "store_core.cc").write_text("#include <Python.h>\nint broken( {\n")
    with pytest.raises(ImportError, match=r"(?s)cannot build ray_tpu_torch\._native\._store.*error"):
        _native.build("_store", csrc, tmp_path / "build")
    assert not list((tmp_path / "build").glob("*.so"))


@pytest.mark.timeout(120)
def test_runtime_takes_the_native_path_in_the_driver_and_its_workers(torch_cluster,  # noqa: F811
                                                                     monkeypatch):
    """The codec, the store core and the shm segments are native in the
    driver and in a worker; a task whose args carry out-of-band buffers (an
    array and a tensor over 512 bytes: the args are a bytearray) goes
    through the native channel and returns the right sum."""
    from ray_tpu_torch._private import core_worker

    def native_state():
        from ray_tpu_torch._private import rpc, shm, store_core

        return rpc.native_wire_active(), store_core.NATIVE, shm.NATIVE

    assert native_state() == (True, True, True)
    assert core_worker._fp_mod() is fp

    @ray_tpu_torch.remote
    def state():
        return native_state()

    @ray_tpu_torch.remote
    def total(a, t):
        return float(a.sum()) + float(t.sum())

    assert ray_tpu_torch.get(state.remote(), timeout=60) == (True, True, True)
    submitted = []
    native_submit = fp.submit

    def counted(ch, tid, fid, name, blob):
        submitted.append(type(blob).__name__)
        return native_submit(ch, tid, fid, name, blob)

    monkeypatch.setattr(fp, "submit", counted)
    a, t = np.arange(1024, dtype=np.float64), torch.ones(256, dtype=torch.float32)
    for _ in range(4):
        assert ray_tpu_torch.get(total.remote(a, t), timeout=60) == float(a.sum()) + 256.0
    assert submitted and set(submitted) == {"bytes"}, submitted
