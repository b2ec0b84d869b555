"""The reference's spilling and fault-tolerance suites on the port:
tests/test_spilling.py (spill and restore, create backpressure, the memory
monitor), tests/test_reconstruction.py (lineage reconstruction of lost
returns), tests/test_gcs_ft.py (a GCS restarted or crashed with a torn WAL)
and tests/test_remote_storage.py (s3:// spilling and checkpoints on the
local mock S3 server) run on ray_tpu_torch's runtime, case for case after
the rename. The reference's JaxTrainer checkpoint case is a CPU
TorchTrainer here."""

import os
import sys
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.testing import torch_shutdown_only  # noqa: F401
from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy

sys.path.insert(0, os.path.dirname(__file__))
from mock_s3_server import MockS3Server  # noqa: E402


# ----------------------------------------------------------------------
# test_spilling.py

ARENA = 64 * 1024 * 1024  # store minimum
OBJ = 8 * 1024 * 1024  # 8 MB payloads


@pytest.fixture
def small_store():
    info = ray_tpu_torch.init(num_cpus=2, num_gpus=0, object_store_memory=ARENA)
    yield info
    ray_tpu_torch.shutdown()


def test_put_2x_capacity_and_get_all_back(small_store):
    """Fill the arena twice over; cold objects spill to disk and restore on
    get with their contents intact."""
    n = 2 * ARENA // OBJ  # 16 objects of 8 MB = 128 MB through a 64 MB arena
    refs = []
    for i in range(n):
        arr = np.full(OBJ // 8, i, dtype=np.float64)
        refs.append(ray_tpu_torch.put(arr))
    for i, ref in enumerate(refs):
        out = ray_tpu_torch.get(ref, timeout=60)
        assert out[0] == i and out[-1] == i and out.shape == (OBJ // 8,)


def test_task_outputs_spill(small_store):
    """Task returns exceeding capacity spill; all remain gettable."""

    @ray_tpu_torch.remote
    def produce(i):
        return np.full(OBJ // 8, i, dtype=np.float64)

    refs = [produce.remote(i) for i in range(12)]  # 96 MB of returns
    for i, ref in enumerate(refs):
        assert ray_tpu_torch.get(ref, timeout=120)[0] == i


def test_spill_stats_visible(small_store):
    # Hold the refs: unreferenced puts are freed promptly and would never
    # pressure the store into spilling.
    refs = [ray_tpu_torch.put(np.full(OBJ // 8, i, dtype=np.float64)) for i in range(12)]
    stats = [
        s
        for s in ray_tpu_torch._private.worker.global_worker.run_async(
            _node_stats(), timeout=30
        )
    ]
    assert any(s.get("spilled_objects", 0) > 0 for s in stats)


async def _node_stats():
    from ray_tpu_torch._private import worker as worker_mod

    core = worker_mod.global_worker.core
    reply = await core.raylet_conn.call("GetNodeStats", {})
    return [reply]


def test_spill_io_off_event_loop(torch_shutdown_only, monkeypatch):
    """A slow spill backend must not stall the raylet event loop: control
    RPCs (Ping) stay fast while multi-object spills are in flight
    (reference: async IO workers, local_object_manager.cc)."""
    import json
    import threading
    import time

    from ray_tpu_torch._private import external_storage as es
    from ray_tpu_torch._private import worker as worker_mod

    class SlowFS(es.FileSystemStorage):
        def spill(self, oid, data):
            time.sleep(0.5)  # simulate slow storage media
            return super().spill(oid, data)

    es.register_storage_backend(
        "slowfs",
        lambda params: SlowFS(
            params.get("directory_path", "/tmp/ray_tpu_torch_slowfs_test")
        ),
    )
    monkeypatch.setenv(
        "RAY_TPU_OBJECT_SPILLING_CONFIG", json.dumps({"type": "slowfs"})
    )
    ray_tpu_torch.init(num_cpus=2, num_gpus=0, object_store_memory=ARENA)

    refs = []
    done = threading.Event()

    def putter():
        # 2x arena capacity: forces spills of the cold half, each write
        # paying the 0.5s media penalty on the IO pool.
        for i in range(16):
            refs.append(ray_tpu_torch.put(np.full(OBJ // 8, i, dtype=np.float64)))
        done.set()

    t = threading.Thread(target=putter, daemon=True)
    t.start()

    async def _ping():
        core = worker_mod.global_worker.core
        return await core.raylet_conn.call("Ping", {})

    worst = 0.0
    while not done.is_set():
        t0 = time.monotonic()
        worker_mod.global_worker.run_async(_ping(), timeout=30)
        worst = max(worst, time.monotonic() - t0)
        time.sleep(0.02)
    t.join(timeout=120)
    assert done.is_set()
    # Inline spill writes would stall pings for ~0.5s each; off-loop IO
    # keeps the loop turning.
    assert worst < 0.3, f"event loop stalled {worst:.3f}s during spills"
    for i, ref in enumerate(refs):
        assert ray_tpu_torch.get(ref, timeout=120)[0] == i


def test_pluggable_remote_spill_backend(torch_shutdown_only, monkeypatch):
    """Spilling routes through a registered non-filesystem backend (the
    remote-storage hook, reference external_storage.py smart_open path)."""
    import json

    from ray_tpu_torch._private import external_storage as es

    blobs = {}

    class MemStorage(es.ExternalStorage):
        def spill(self, oid, data):
            blobs[oid] = bytes(data)
            return "mem://" + oid

        def restore(self, uri, dest):
            data = blobs[uri[len("mem://") :]]
            dest[: len(data)] = data
            return len(data)

        def delete(self, uri):
            blobs.pop(uri[len("mem://") :], None)

        def destroy(self):
            blobs.clear()

    es.register_storage_backend("memtest", lambda params: MemStorage())
    monkeypatch.setenv(
        "RAY_TPU_OBJECT_SPILLING_CONFIG", json.dumps({"type": "memtest"})
    )
    ray_tpu_torch.init(num_cpus=2, num_gpus=0, object_store_memory=ARENA)
    n = 2 * ARENA // OBJ
    refs = [ray_tpu_torch.put(np.full(OBJ // 8, i, dtype=np.float64)) for i in range(n)]
    # Wait until some spill writes land in the fake remote store.
    import time

    deadline = time.monotonic() + 30
    while not blobs and time.monotonic() < deadline:
        time.sleep(0.1)
    assert blobs, "no objects were spilled through the registered backend"
    for i, ref in enumerate(refs):
        assert ray_tpu_torch.get(ref, timeout=60)[0] == i


def _spill_files(spill_dir):
    import glob

    return [
        f
        for f in glob.glob(os.path.join(spill_dir, "**"), recursive=True)
        if os.path.isfile(f) and not f.endswith(".tmp")
    ]


def test_spill_file_deleted_on_free(torch_shutdown_only, monkeypatch, tmp_path):
    """Regression for the spill-file leak: freeing a spilled object must
    delete its backing file from external storage, not just the spilled[]
    table entry (reference: local_object_manager.cc spilled-object deletion
    on ref release)."""
    import gc
    import json
    import time

    spill_dir = str(tmp_path / "spill")
    monkeypatch.setenv(
        "RAY_TPU_OBJECT_SPILLING_CONFIG",
        json.dumps(
            {"type": "filesystem", "params": {"directory_path": spill_dir}}
        ),
    )
    ray_tpu_torch.init(num_cpus=2, num_gpus=0, object_store_memory=ARENA)
    n = 2 * ARENA // OBJ
    refs = [ray_tpu_torch.put(np.full(OBJ // 8, i, dtype=np.float64)) for i in range(n)]
    deadline = time.monotonic() + 30
    while not _spill_files(spill_dir) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert _spill_files(spill_dir), "pressure never spilled anything"
    # Drop the only refs: the owner's free must reach the raylet and the
    # raylet must unlink every spilled file, not only forget the URI.
    del refs
    gc.collect()
    deadline = time.monotonic() + 30
    while _spill_files(spill_dir) and time.monotonic() < deadline:
        time.sleep(0.2)
    leaked = _spill_files(spill_dir)
    assert not leaked, f"freed objects leaked spill files: {leaked}"


def test_spill_files_deleted_on_shutdown(torch_shutdown_only, monkeypatch, tmp_path):
    """Session teardown deletes every still-spilled object's backing file
    (per-entry delete runs before the IO pool shuts down; destroy() then
    removes the session subtree)."""
    import json
    import time

    spill_dir = str(tmp_path / "spill")
    monkeypatch.setenv(
        "RAY_TPU_OBJECT_SPILLING_CONFIG",
        json.dumps(
            {"type": "filesystem", "params": {"directory_path": spill_dir}}
        ),
    )
    ray_tpu_torch.init(num_cpus=2, num_gpus=0, object_store_memory=ARENA)
    n = 2 * ARENA // OBJ
    refs = [ray_tpu_torch.put(np.full(OBJ // 8, i, dtype=np.float64)) for i in range(n)]
    deadline = time.monotonic() + 30
    while not _spill_files(spill_dir) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert _spill_files(spill_dir), "pressure never spilled anything"
    assert refs  # keep the refs live until shutdown
    ray_tpu_torch.shutdown()
    leaked = _spill_files(spill_dir)
    assert not leaked, f"shutdown leaked spill files: {leaked}"


def test_pinned_object_never_spills(small_store):
    """A pinned object survives pressure that spills everything else, and
    spilling it explicitly is rejected."""
    import time

    from ray_tpu_torch._private import worker as worker_mod

    pin_ref = ray_tpu_torch.put(np.full(OBJ // 8, 7.0, dtype=np.float64))

    async def _pin(oid):
        core = worker_mod.global_worker.core
        return await core.plasma.pin(oid)

    assert worker_mod.global_worker.run_async(_pin(pin_ref.hex()), timeout=30)

    refs = [ray_tpu_torch.put(np.full(OBJ // 8, i, dtype=np.float64)) for i in range(12)]

    async def _probe(oid):
        core = worker_mod.global_worker.core
        spill = await core.plasma.spill([oid])
        contains = await core.plasma.contains([oid])
        return spill, contains[oid]

    deadline = time.monotonic() + 30
    spilled_any = False
    while time.monotonic() < deadline and not spilled_any:
        stats = worker_mod.global_worker.run_async(_node_stats(), timeout=30)
        spilled_any = any(s.get("spilled_objects", 0) > 0 for s in stats)
        time.sleep(0.1)
    assert spilled_any, "pressure never spilled anything"
    spill_reply, in_arena = worker_mod.global_worker.run_async(
        _probe(pin_ref.hex()), timeout=30
    )
    assert pin_ref.hex() in spill_reply["rejected"]
    assert in_arena
    assert ray_tpu_torch.get(pin_ref, timeout=60)[0] == 7.0
    assert ray_tpu_torch.get(refs[0], timeout=60)[0] == 0.0


def test_memory_monitor_kills_runaway_actor(torch_shutdown_only, monkeypatch):
    """With no task workers leased, an actor worker is eligible (reference:
    group-by-owner policy kills actors as last resort — a runaway actor must
    not OOM the node while the monitor only watches tasks)."""
    monkeypatch.setenv("RAY_TPU_MEMORY_USAGE_THRESHOLD", "0.0")
    monkeypatch.setenv("RAY_TPU_MEMORY_MONITOR_INTERVAL_S", "0.2")
    ray_tpu_torch.init(num_cpus=2, num_gpus=0)

    @ray_tpu_torch.remote(max_restarts=0)
    class Hog:
        def spin(self):
            import time

            time.sleep(60)
            return 1

    hog = Hog.remote()
    # Specifically the actor-death surface — a plain GetTimeoutError would
    # mean the monitor never selected the actor worker.
    from ray_tpu_torch._private.common import ActorDiedError, ActorUnavailableError

    with pytest.raises((ActorDiedError, ActorUnavailableError)):
        ray_tpu_torch.get(hog.spin.remote(), timeout=120)


def test_memory_monitor_kills_newest_task(torch_shutdown_only, monkeypatch):
    """With the threshold forced to 0, the monitor kills the newest leased
    task worker; a non-retriable task surfaces WorkerCrashedError."""
    monkeypatch.setenv("RAY_TPU_MEMORY_USAGE_THRESHOLD", "0.0")
    monkeypatch.setenv("RAY_TPU_MEMORY_MONITOR_INTERVAL_S", "0.2")
    ray_tpu_torch.init(num_cpus=2, num_gpus=0)

    @ray_tpu_torch.remote(max_retries=0)
    def hog():
        import time

        time.sleep(30)
        return 1

    with pytest.raises(ray_tpu_torch.RayTpuError):
        ray_tpu_torch.get(hog.remote(), timeout=60)


# ----------------------------------------------------------------------
# test_reconstruction.py

# Above max_direct_call_object_size so returns land in plasma on the
# producing node (inline returns live in the owner and cannot be lost).
SIZE = (600, 600)  # ~2.9 MB float64


@pytest.fixture
def cluster_with_victim():
    cluster = Cluster(head_node_args={"num_cpus": 1, "num_gpus": 0})
    cluster.add_node(num_cpus=2, resources={"victim": 2})
    cluster.connect()
    yield cluster
    cluster.shutdown()


def _victim_node_id():
    for n in ray_tpu_torch.nodes():
        if n["state"] == "ALIVE" and "victim" in {
            k.split(":")[0] for k in n["total"]
        }:
            return n["node_id"]
    raise AssertionError("victim node not found")


def test_reconstruct_lost_object(cluster_with_victim):
    """Kill the node holding a task's plasma return; get() still succeeds."""
    cluster = cluster_with_victim

    @ray_tpu_torch.remote(num_cpus=1, resources={"victim": 1}, max_retries=3)
    def produce():
        return np.ones(SIZE)

    ref = produce.remote()
    # Materialize once so the object exists on the victim node.
    assert float(ray_tpu_torch.get(ref, timeout=60).sum()) == 360000.0

    cluster.remove_node(cluster.raylets[_victim_node_id()])
    # Replacement node so the re-executed task has somewhere to run.
    cluster.add_node(num_cpus=2, resources={"victim": 2})
    time.sleep(0.5)

    value = ray_tpu_torch.get(ref, timeout=120)
    assert float(value.sum()) == 360000.0


def test_reconstruct_chain(cluster_with_victim):
    """Loss of an intermediate object recovers recursively through its deps."""
    cluster = cluster_with_victim

    @ray_tpu_torch.remote(num_cpus=1, resources={"victim": 1}, max_retries=3)
    def base():
        return np.ones(SIZE)

    @ray_tpu_torch.remote(num_cpus=1, resources={"victim": 1}, max_retries=3)
    def double(x):
        return x * 2

    b = base.remote()
    d = double.remote(b)
    assert float(ray_tpu_torch.get(d, timeout=60).sum()) == 720000.0

    cluster.remove_node(cluster.raylets[_victim_node_id()])
    cluster.add_node(num_cpus=2, resources={"victim": 2})
    time.sleep(0.5)

    # Both b's and d's primary copies died; getting d must re-run base then
    # double (the worker resolving double's arg triggers owner-side recovery
    # of b).
    value = ray_tpu_torch.get(d, timeout=120)
    assert float(value.sum()) == 720000.0


def test_borrower_triggers_owner_recovery(cluster_with_victim):
    """A consumer task on another node hits the lost copy and asks the owner
    to reconstruct (RecoverObject RPC path)."""
    cluster = cluster_with_victim

    @ray_tpu_torch.remote(num_cpus=1, resources={"victim": 1}, max_retries=3)
    def produce():
        return np.ones(SIZE)

    ref = produce.remote()
    assert float(ray_tpu_torch.get(ref, timeout=60).sum()) == 360000.0

    cluster.remove_node(cluster.raylets[_victim_node_id()])
    cluster.add_node(num_cpus=2, resources={"victim": 2})
    time.sleep(0.5)

    @ray_tpu_torch.remote(num_cpus=1, resources={"victim": 1})
    def consume(x):
        return float(x.sum())

    assert ray_tpu_torch.get(consume.remote(ref), timeout=120) == 360000.0


def test_put_objects_are_not_reconstructable(cluster_with_victim):
    """ray.put objects have no lineage; loss is a terminal ObjectLostError
    (reference semantics)."""
    cluster = cluster_with_victim

    # Put via a task running ON the victim node so the primary copy is there
    # but ownership stays with that worker... simpler: put from the driver
    # always lands on the head node which we cannot kill. Instead assert the
    # error path directly: lost + no lineage raises.
    @ray_tpu_torch.remote(num_cpus=1, resources={"victim": 1})
    def put_and_return_ref():
        return ray_tpu_torch.put(np.ones(SIZE))

    inner_ref = ray_tpu_torch.get(put_and_return_ref.remote(), timeout=60)
    cluster.remove_node(cluster.raylets[_victim_node_id()])
    time.sleep(0.5)
    with pytest.raises(ray_tpu_torch.RayTpuError):
        ray_tpu_torch.get(inner_ref, timeout=30)


def test_lineage_pruned_raises_typed_error(monkeypatch):
    """With lineage_bytes_limit squeezed to near zero, older producing specs
    are LRU-pruned; losing such an object raises
    ObjectReconstructionFailedError (typed: a tuning problem, not an
    unreconstructable-by-design object)."""
    from ray_tpu_torch._private.common import config

    monkeypatch.setenv("RAY_TPU_LINEAGE_BYTES_LIMIT", "1")
    config.refresh()
    cluster = Cluster(head_node_args={"num_cpus": 1, "num_gpus": 0})
    try:
        cluster.add_node(num_cpus=2, resources={"victim": 2})
        cluster.connect()

        @ray_tpu_torch.remote(num_cpus=1, resources={"victim": 1}, max_retries=3)
        def produce(i):
            return np.full(SIZE, float(i))

        first = produce.remote(1)
        ready, _ = ray_tpu_torch.wait([first], num_returns=1, timeout=60)
        assert ready
        # A second spilling-sized return prunes first's lineage (the cap
        # keeps only the newest entry).
        second = produce.remote(2)
        ready, _ = ray_tpu_torch.wait([second], num_returns=1, timeout=60)
        assert ready

        cluster.remove_node(cluster.raylets[_victim_node_id()])
        cluster.add_node(num_cpus=2, resources={"victim": 2})
        time.sleep(0.5)

        with pytest.raises(ray_tpu_torch.ObjectReconstructionFailedError):
            ray_tpu_torch.get(first, timeout=60)
    finally:
        cluster.shutdown()
        monkeypatch.delenv("RAY_TPU_LINEAGE_BYTES_LIMIT")
        config.refresh()


def test_node_death_triggers_eager_reconstruction(cluster_with_victim):
    """The owner's node-death subscription recomputes lost primaries without
    waiting for a get: after the victim dies, the owned marker re-points at
    a live raylet on its own."""
    from ray_tpu_torch._private import worker as worker_mod

    cluster = cluster_with_victim

    @ray_tpu_torch.remote(num_cpus=1, resources={"victim": 1}, max_retries=3)
    def produce():
        return np.ones(SIZE)

    ref = produce.remote()
    ready, _ = ray_tpu_torch.wait([ref], num_returns=1, timeout=60)
    assert ready
    core = worker_mod.global_worker.core
    dead_addr = core.memory_store.get(ref.hex()).plasma_addr
    assert dead_addr is not None

    cluster.remove_node(cluster.raylets[_victim_node_id()])
    cluster.add_node(num_cpus=2, resources={"victim": 2})

    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        entry = core.memory_store.get(ref.hex())
        if entry is not None and entry.plasma_addr != dead_addr:
            break
        time.sleep(0.2)
    entry = core.memory_store.get(ref.hex())
    assert entry is not None and entry.plasma_addr != dead_addr, (
        "node-death pubsub did not trigger eager reconstruction"
    )
    assert float(ray_tpu_torch.get(ref, timeout=60).sum()) == 360000.0


def test_torn_spill_file_reconstructs_via_lineage(torch_shutdown_only, monkeypatch):
    """A spilled copy whose backing file is torn is a *lost* copy, not a
    transient error: restore fails with the typed integrity error, the
    raylet drops the entry, and the owner's lineage re-runs the producer —
    the consumer still sees correct bytes."""
    import json

    from ray_tpu_torch._private import external_storage as es

    torn = {"count": 0}

    class TornFS(es.FileSystemStorage):
        def restore(self, uri, dest):
            if torn["count"] == 0:
                torn["count"] += 1
                raise es.SpillIntegrityError(uri, len(dest), len(dest) // 2)
            return super().restore(uri, dest)

    es.register_storage_backend(
        "tornfs",
        lambda params: TornFS(
            params.get("directory_path", "/tmp/ray_tpu_torch_tornfs_test")
        ),
    )
    monkeypatch.setenv(
        "RAY_TPU_OBJECT_SPILLING_CONFIG", json.dumps({"type": "tornfs"})
    )
    arena = 64 * 1024 * 1024
    ray_tpu_torch.init(num_cpus=2, num_gpus=0, object_store_memory=arena)

    @ray_tpu_torch.remote(max_retries=3)
    def produce(i):
        return np.full((1024, 1024), float(i))  # 8 MB each

    refs = [produce.remote(i) for i in range(12)]  # 96 MB through 64 MB
    ready, _ = ray_tpu_torch.wait(refs, num_returns=len(refs), timeout=120)
    assert len(ready) == len(refs)
    # Every value comes back right even though one restore hit a torn file
    # (that object's spilled copy was dropped and its producer re-ran).
    for i, ref in enumerate(refs):
        out = ray_tpu_torch.get(ref, timeout=120)
        assert out[0, 0] == float(i) and out[-1, -1] == float(i)


def test_reconstruct_actor_task_return(cluster_with_victim):
    """Actor-task returns with max_task_retries>0 are reconstructable by
    resubmitting through the restarted actor (reference:
    task_manager.cc actor-task resubmission)."""
    cluster = cluster_with_victim

    @ray_tpu_torch.remote
    class Producer:
        def produce(self):
            return np.ones(SIZE)

    a = Producer.options(
        max_restarts=3,
        max_task_retries=3,
        num_cpus=1,
        resources={"victim": 1},
    ).remote()
    ref = a.produce.remote()
    # Materialize WITHOUT fetching (a driver-side get would leave a local
    # copy that survives the node kill and masks reconstruction).
    ready, _ = ray_tpu_torch.wait([ref], num_returns=1, timeout=60)
    assert ready

    cluster.remove_node(cluster.raylets[_victim_node_id()])
    cluster.add_node(num_cpus=2, resources={"victim": 2})
    time.sleep(0.5)

    # The primary copy died with the node AND the actor did too; recovery
    # waits for the restarted incarnation and re-runs the method.
    value = ray_tpu_torch.get(ref, timeout=120)
    assert float(value.sum()) == 360000.0


def test_actor_task_not_reconstructable_without_retries(cluster_with_victim):
    """max_task_retries=0 actor returns keep the old behavior: loss is a
    terminal ObjectLostError."""
    cluster = cluster_with_victim

    @ray_tpu_torch.remote
    class Producer:
        def produce(self):
            return np.ones(SIZE)

    a = Producer.options(
        max_restarts=3, num_cpus=1, resources={"victim": 1}
    ).remote()
    ref = a.produce.remote()
    ready, _ = ray_tpu_torch.wait([ref], num_returns=1, timeout=60)
    assert ready

    cluster.remove_node(cluster.raylets[_victim_node_id()])
    cluster.add_node(num_cpus=2, resources={"victim": 2})
    time.sleep(0.5)

    with pytest.raises(ray_tpu_torch.RayTpuError):
        ray_tpu_torch.get(ref, timeout=60)


# ----------------------------------------------------------------------
# test_gcs_ft.py

@pytest.fixture
def ray_small(torch_shutdown_only):
    ray_tpu_torch.init(num_cpus=2, num_gpus=0)
    yield


def _restart_gcs():
    w = worker_mod.global_worker
    node = w.node

    async def cycle():
        await node.kill_gcs()
        await node.restart_gcs()

    w.run_async(cycle(), timeout=30)


def _crash_gcs(torn_tail=True):
    """Hard-crash cycle: no store checkpoint/fsync on the way down, plus a
    half-written record torn onto the WAL tail (power-loss shape)."""
    w = worker_mod.global_worker
    node = w.node

    async def cycle():
        await node.crash_gcs(torn_tail=torn_tail)
        await node.restart_gcs()

    w.run_async(cycle(), timeout=30)


def test_gcs_restart_cluster_resumes(ray_small):
    @ray_tpu_torch.remote
    def f(x):
        return x + 1

    assert ray_tpu_torch.get(f.remote(1)) == 2
    _restart_gcs()
    # Raylet re-registers via its reconnecting GCS client; new work proceeds
    # (first call may ride the reconnect backoff).
    deadline = time.monotonic() + 20
    while True:
        try:
            assert ray_tpu_torch.get(f.remote(41), timeout=30) == 42
            break
        except Exception:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.5)


def test_gcs_restart_detached_actor_survives(ray_small):
    @ray_tpu_torch.remote
    class Keeper:
        def __init__(self):
            self.v = 0

        def incr(self):
            self.v += 1
            return self.v

    k = Keeper.options(name="durable", lifetime="detached").remote()
    assert ray_tpu_torch.get(k.incr.remote()) == 1

    _restart_gcs()

    # Named lookup hits the restarted GCS's reloaded actor table; the actor
    # process itself never died, so its state is intact.
    deadline = time.monotonic() + 20
    while True:
        try:
            k2 = ray_tpu_torch.get_actor("durable")
            assert ray_tpu_torch.get(k2.incr.remote(), timeout=30) == 2
            break
        except Exception:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.5)


def test_gcs_restart_kv_survives(ray_small):
    w = worker_mod.global_worker
    core = w.core
    w.run_async(core.gcs.kv_put("persist_me", b"value", ns="test"))
    _restart_gcs()
    deadline = time.monotonic() + 20
    while True:
        try:
            assert w.run_async(core.gcs.kv_get("persist_me", ns="test"), timeout=30) == b"value"
            break
        except Exception:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.5)


def test_gcs_crash_torn_wal_detached_actor_survives(ray_small):
    """Crash (not stop) the GCS with a torn WAL tail mid-session: recovery
    truncates the torn frame and every acknowledged record — the detached
    actor's ALIVE entry, its name registration — survives."""

    @ray_tpu_torch.remote
    class Keeper:
        def __init__(self):
            self.v = 0

        def incr(self):
            self.v += 1
            return self.v

    k = Keeper.options(name="crashproof", lifetime="detached").remote()
    assert ray_tpu_torch.get(k.incr.remote()) == 1

    _crash_gcs(torn_tail=True)

    deadline = time.monotonic() + 20
    while True:
        try:
            k2 = ray_tpu_torch.get_actor("crashproof")
            assert ray_tpu_torch.get(k2.incr.remote(), timeout=30) == 2
            break
        except Exception:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.5)


def test_gcs_crash_torn_wal_kv_survives(ray_small):
    w = worker_mod.global_worker
    core = w.core
    w.run_async(core.gcs.kv_put("crash_me", b"value", ns="test"))
    _crash_gcs(torn_tail=True)
    deadline = time.monotonic() + 20
    while True:
        try:
            assert (
                w.run_async(core.gcs.kv_get("crash_me", ns="test"), timeout=30)
                == b"value"
            )
            break
        except Exception:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.5)


def test_gcs_restart_actor_restart_still_works(ray_small):
    """After a GCS restart, the actor-restart FSM (now running on reloaded
    state) still restarts a killed actor."""

    @ray_tpu_torch.remote
    class Flaky:
        def pid(self):
            import os

            return os.getpid()

    a = Flaky.options(max_restarts=2).remote()
    pid1 = ray_tpu_torch.get(a.pid.remote())
    _restart_gcs()
    time.sleep(2.0)  # let the raylet re-register
    import os
    import signal

    os.kill(pid1, signal.SIGKILL)
    deadline = time.monotonic() + 30
    while True:
        try:
            pid2 = ray_tpu_torch.get(a.pid.remote(), timeout=30)
            assert pid2 != pid1
            break
        except ray_tpu_torch.RayTpuError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.5)


# ----------------------------------------------------------------------
# test_remote_storage.py

@pytest.fixture
def mock_s3(monkeypatch):
    with MockS3Server() as srv:
        monkeypatch.setenv("AWS_ENDPOINT_URL", srv.endpoint)
        monkeypatch.setenv("AWS_ACCESS_KEY_ID", "mock")
        monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "mock")
        monkeypatch.setenv("AWS_DEFAULT_REGION", "us-east-1")
        srv.create_bucket("bucket")
        yield srv


def test_spill_to_s3_roundtrip(mock_s3, monkeypatch, torch_shutdown_only):
    """Objects spilled under memory pressure land in the S3 bucket and
    restore with contents intact."""
    monkeypatch.setenv(
        "RAY_TPU_OBJECT_SPILLING_CONFIG",
        '{"type": "uri", "params": {"uri": "s3://bucket/spill"}}',
    )
    arena = 64 * 1024 * 1024
    obj = 8 * 1024 * 1024
    ray_tpu_torch.init(num_cpus=2, num_gpus=0, object_store_memory=arena)
    n = 2 * arena // obj  # 2x the arena forces spilling
    refs = []
    for i in range(n):
        refs.append(ray_tpu_torch.put(np.full(obj // 8, i, dtype=np.float64)))
    # Something actually went to the bucket.
    with mock_s3.state.lock:
        spilled_keys = [
            k for k in mock_s3.state.buckets["bucket"] if k.startswith("spill/")
        ]
    assert spilled_keys, "no objects were spilled to s3://bucket/spill"
    # Everything restores intact (cold objects pull back from S3).
    for i, ref in enumerate(refs):
        out = ray_tpu_torch.get(ref, timeout=120)
        assert out[0] == i and out[-1] == i and out.shape == (obj // 8,)


def test_checkpoint_to_s3_and_resume(mock_s3, torch_shutdown_only, tmp_path):
    """A CPU TorchTrainer persists checkpoints to an s3:// storage path; a
    second run resumes from the S3 checkpoint."""
    import json

    from ray_tpu_torch import train
    from ray_tpu_torch.air import RunConfig, ScalingConfig
    from ray_tpu_torch.train import Checkpoint
    from ray_tpu_torch.train.torch import TorchTrainer

    ray_tpu_torch.init(num_cpus=4, num_gpus=0)

    def train_fn(config):
        import json as _json
        import os as _os
        import tempfile

        start = 0
        ckpt = train.get_checkpoint()
        if ckpt:
            with ckpt.as_directory() as d:
                start = _json.load(
                    open(_os.path.join(d, "state.json"))
                )["step"] + 1
        for i in range(start, start + 2):
            with tempfile.TemporaryDirectory() as d:
                _json.dump(
                    {"step": i}, open(_os.path.join(d, "state.json"), "w")
                )
                train.report(
                    {"step": i}, checkpoint=Checkpoint.from_directory(d)
                )

    r1 = TorchTrainer(
        train_fn,
        scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
        run_config=RunConfig(name="s3run", storage_path="s3://bucket/results"),
    ).fit()
    assert r1.error is None
    assert r1.checkpoint is not None
    assert r1.checkpoint.path.startswith("s3://bucket/results/s3run")
    # The files are really in the bucket.
    with mock_s3.state.lock:
        keys = [
            k for k in mock_s3.state.buckets["bucket"]
            if k.startswith("results/s3run") and k.endswith("state.json")
        ]
    assert keys, "checkpoint files not found in the mock bucket"
    # Materialize from S3 and read back.
    with r1.checkpoint.as_directory() as d:
        assert json.load(open(os.path.join(d, "state.json")))["step"] == 1

    # Resume: steps continue from the persisted S3 checkpoint.
    r2 = TorchTrainer(
        train_fn,
        scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
        run_config=RunConfig(name="s3run2", storage_path="s3://bucket/results"),
        resume_from_checkpoint=r1.checkpoint,
    ).fit()
    assert r2.error is None
    assert [m["step"] for m in r2.metrics_history] == [2, 3]


def test_uri_storage_s3_spill_restore_delete_roundtrip(mock_s3):
    """Direct UriStorage coverage against the mock S3 server: spill writes
    one namespaced key, restore returns identical bytes, delete removes the
    key, destroy clears the namespace."""
    from ray_tpu_torch._private.external_storage import UriStorage

    store = UriStorage("s3://bucket/direct", namespace="nodeB")
    payload = np.arange(4096, dtype=np.int64).tobytes()
    uri = store.spill("oidX", memoryview(payload))
    assert uri.startswith("uri://bucket/direct/nodeB/oidX-")
    with mock_s3.state.lock:
        keys = [
            k
            for k in mock_s3.state.buckets["bucket"]
            # skip the create_dir placeholder, present only on mock/NFS-like
            # stores where prefixes are materialized
            if k.startswith("direct/nodeB/") and not k.endswith("/")
        ]
    assert len(keys) == 1
    dest = bytearray(len(payload))
    assert store.restore(uri, memoryview(dest)) == len(payload)
    assert bytes(dest) == payload
    store.delete(uri)
    with mock_s3.state.lock:
        assert not [
            k
            for k in mock_s3.state.buckets["bucket"]
            if k.startswith("direct/nodeB/") and not k.endswith("/")
        ]
    store.destroy()


def test_uri_storage_torn_spill_raises_typed_error(mock_s3):
    """Partial-write crash injection: truncate the stored object behind the
    backend's back (a torn upload a crash made visible). Restore must raise
    SpillIntegrityError — never hand back a short/garbage buffer."""
    from ray_tpu_torch._private.external_storage import SpillIntegrityError, UriStorage

    store = UriStorage("s3://bucket/torn")
    payload = np.arange(8192, dtype=np.int64).tobytes()
    uri = store.spill("oidT", memoryview(payload))
    key = uri[len("uri://bucket/") :]
    with mock_s3.state.lock:
        data = mock_s3.state.buckets["bucket"][key]
        mock_s3.state.buckets["bucket"][key] = data[: len(data) // 2]
    dest = bytearray(len(payload))
    with pytest.raises(SpillIntegrityError) as ei:
        store.restore(uri, memoryview(dest))
    assert ei.value.expected == len(payload)
    assert ei.value.actual < len(payload)
    # The typed error is what the raylet keys its copy-lost handling on; a
    # generic short read would instead seal trailing garbage into the arena.
    assert "torn" in str(ei.value)


def test_uri_storage_local_file_scheme(tmp_path):
    """The same uri backend covers plain filesystem URIs (NFS-style)."""
    from ray_tpu_torch._private.external_storage import UriStorage

    store = UriStorage(f"file://{tmp_path}/spill", namespace="nodeA")
    payload = np.arange(1000, dtype=np.int64).tobytes()
    uri = store.spill("oid1", memoryview(payload))
    dest = bytearray(len(payload))
    n = store.restore(uri, memoryview(dest))
    assert n == len(payload) and bytes(dest) == payload
    store.delete(uri)
    dest2 = bytearray(len(payload))
    with pytest.raises(Exception):
        store.restore(uri, memoryview(dest2))
    store.destroy()
