"""Control-plane microbenchmarks (port of the reference's
python/ray/_private/ray_perf.py:93-288 suite set).

Run: python -m ray_tpu_torch._private.ray_perf [--json PATH] [--device cpu | --device-only]

Suites: trivial task throughput (sync + pipelined), actor call throughput
(1:1 sync, 1:1 async batch, n:n), put/get small objects. Each prints a
line; with --json, a summary dict is written for the driver/CI.

The benches run on the CPU and the host, and give the reference's keys.
On a card (the default, ``--device cuda``) two more suites run the same
paths on device tensors and add their own keys: an NCCL group at world 1
against the store group on cuda:0 (``collective_allreduce_nccl_cuda_*``)
and a compiled DAG's device edge between two GPU actors, which goes by
CUDA IPC (``dag_channel_cuda_ipc_per_s``). ``--device cpu`` runs only the
reference's key set, ``--device-only`` only the device suites.
"""

from __future__ import annotations

import asyncio
import json
import time
from typing import Dict, Optional

import ray_tpu_torch


def timeit(name: str, fn, multiplier: int = 1) -> float:
    # Warmup, then 3 timed trials (reference ray_perf style).
    fn()
    best = 0.0
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        dt = time.perf_counter() - t0
        rate = multiplier / dt
        best = max(best, rate)
    print(f"{name}: {best:.1f} /s")
    return best


def _bench_release_batched() -> float:
    """Rate of plasma hold drops through the debounced release() batch:
    one cycle takes holds on N objects (one ObjGet), queues N release()
    calls, and awaits the single coalesced ObjRelease flush."""
    import numpy as np

    from ray_tpu_torch._private import worker as worker_mod

    n = 200
    payload = np.zeros(256 * 1024, dtype=np.uint8)  # plasma-sized
    refs = [ray_tpu_torch.put(payload) for _ in range(n)]
    oids = [r.hex() for r in refs]
    w = worker_mod.global_worker
    plasma = w.core.plasma

    async def _cycle():
        found, _ = await plasma.get(oids)
        del found
        for oid in oids:
            plasma.release(oid)
        await asyncio.sleep(0)  # run the call_soon flush
        task = plasma._release_task
        if task is not None:
            await task

    rate = timeit(
        "batched release (200 holds)", lambda: w.run_async(_cycle(), 60), n
    )
    del refs
    return rate


def _bench_sched() -> Dict[str, float]:
    """Scheduler throughput on the simulated cluster: N raylets (real lease
    scheduler, loopback RPC, in-process stub workers — sim_cluster.py) with
    10k 1-CPU lease/release cycles driven through the core_worker spillback
    protocol at bounded concurrency. Runs after shutdown(): the sim owns
    its own loop and config env."""
    import os

    from ray_tpu_torch._private.sim_cluster import SimCluster, SimLeaseClient

    nodes = int(os.environ.get("RAY_TPU_SCHED_BENCH_NODES", "500"))
    tasks = int(os.environ.get("RAY_TPU_SCHED_BENCH_TASKS", "10000"))
    concurrency = int(os.environ.get("RAY_TPU_SCHED_BENCH_CONCURRENCY", "64"))
    cluster = SimCluster(nodes).start()
    client = SimLeaseClient(cluster)

    async def schedule_all(n: int) -> None:
        sem = asyncio.Semaphore(concurrency)
        entries = [tuple(r.addr) for r in cluster.raylets.values()]

        async def one(i: int) -> None:
            async with sem:
                await client.lease_cycle(
                    {"CPU": 1.0}, entry_addr=entries[i % len(entries)]
                )

        await asyncio.gather(*(one(i) for i in range(n)))

    try:
        cluster.run(schedule_all(min(tasks, 500)), timeout=120)  # warmup
        t0 = time.perf_counter()
        cluster.run(schedule_all(tasks), timeout=600)
        dt = time.perf_counter() - t0
    finally:
        cluster.run(client.close(), timeout=30)
        cluster.shutdown()
    rate = tasks / dt
    wall_10k = dt * (10_000 / tasks)
    print(f"sched leases ({nodes} sim nodes): {rate:.1f} /s")
    print(f"time to schedule 10k tasks: {wall_10k:.2f} s")
    return {
        "leases_per_s": rate,
        "time_to_schedule_10k_tasks_s": wall_10k,
    }


def _bench_gcs_persist(
    replicated: bool = False, followers: Optional[int] = None
) -> float:
    """Write-through rate of the persistent store under group commit: each
    cycle issues N keyed puts inside one event-loop context and then runs
    the per-tick flush — one os.write + one fsync for the whole batch, the
    shape every GCS control-plane mutation pays (docs/fault_tolerance.md
    "Durability contract"). With ``replicated=True`` the same workload runs
    through ReplicatedStoreClient; ``followers=1`` pins the historical
    wait-for-all 2-member shape (every flush fsyncs primary AND the single
    follower before ack), while the default 2-follower group acks at the
    majority (2 of 3) with the laggard catching up off the commit path —
    the HA deployment's quorum write path."""
    import os
    import shutil
    import tempfile

    from ray_tpu_torch._private.gcs_store import (
        ReplicatedStoreClient,
        WalStoreClient,
        follower_paths,
    )

    d = tempfile.mkdtemp(prefix="perf_wal_")
    if replicated:
        path = os.path.join(d, "gcs.wal")
        fols = follower_paths(path, followers) if followers else None
        store = ReplicatedStoreClient(path, followers=fols, term=1)
        label = (
            f"gcs persist puts (replicated, {followers} follower)"
            if followers
            else f"gcs persist puts (quorum {store.quorum} of "
            f"{len(store._members)})"
        )
    else:
        store = WalStoreClient(os.path.join(d, "gcs.wal"))
        label = "gcs persist puts (wal group commit)"
    n = 2000
    payload = b"v" * 256
    seq = [0]

    def cycle():
        base = seq[0]
        seq[0] += n

        async def burst():
            # Keyed overwrites: the table stays bounded, the log grows and
            # periodically compacts — the steady-state GCS write pattern.
            for i in range(n):
                store.put("kv", f"k{(base + i) % 512}", payload)
            store.flush()

        asyncio.run(burst())

    try:
        rate = timeit(label, cycle, n)
    finally:
        store.close()
        shutil.rmtree(d, ignore_errors=True)
    return rate


def _bench_gcs_failover() -> float:
    """Time to a converged control-plane view after whole-machine GCS loss:
    a SimCluster in HA mode (replicated store + warm standby) loses the
    primary GCS process AND its log member; the clock runs from the kill
    until the promoted leader's node view reports every raylet ALIVE again
    (promotion + leader-file flip + the full reconnect/re-report wave)."""
    import os
    import shutil
    import tempfile

    from ray_tpu_torch._private import rpc
    from ray_tpu_torch._private.common import config
    from ray_tpu_torch._private.sim_cluster import SimCluster

    nodes = int(os.environ.get("RAY_TPU_FAILOVER_BENCH_NODES", "100"))
    d = tempfile.mkdtemp(prefix="perf_failover_")
    cluster = SimCluster(
        nodes,
        persist_path=os.path.join(d, "gcs.wal"),
        ha=True,
        env={
            "RAY_TPU_GCS_LEADER_LEASE_S": "1.0",
            "RAY_TPU_GCS_STANDBY_POLL_S": "0.05",
        },
    ).start()
    try:
        t0 = time.perf_counter()
        assert cluster.run(cluster.kill_gcs_host_async(), timeout=120)

        async def converged() -> None:
            conn = await rpc.connect(*cluster.gcs_addr)
            try:
                while True:
                    reply = await conn.call(
                        "GetAllNodes", timeout=config.rpc_reconnect_timeout_s
                    )
                    alive = sum(
                        1 for nd in reply["nodes"] if nd["state"] == "ALIVE"
                    )
                    if alive >= nodes:
                        return
                    await asyncio.sleep(0.1)
            finally:
                await conn.close()

        cluster.run(converged(), timeout=300)
        dt = time.perf_counter() - t0
    finally:
        cluster.shutdown()
        shutil.rmtree(d, ignore_errors=True)
    print(f"gcs failover -> converged view ({nodes} sim nodes): {dt:.2f} s")
    return dt


def _bench_pubsub_fanout() -> float:
    """Publisher fan-out with 1000 subscribers on one channel: each cycle
    publishes a burst in one loop tick and waits until every subscriber's
    drain task has pushed its PubBatch frames (packed once per chunk,
    written to every transport). Measures deliveries (message x
    subscriber) per second through the publisher machinery; transports are
    no-op sinks so the number isolates the control-plane fan-out cost a
    registration wave pays."""
    from ray_tpu_torch._private.pubsub import Publisher

    n_subs = 1000
    burst = 32

    class _Sink:
        # A writable transport: the publisher writes inline through
        # push_packed_now (ray_tpu's sink lacks both, and its bench raises
        # AttributeError in Publisher.flush).
        closed = False
        peername = "bench"
        write_paused = False

        def push_packed_now(self, data):
            pass

        def push_packed_nowait(self, data):
            pass

        def push_nowait(self, kind, payload):
            pass

        async def drain(self):
            pass

    pub = Publisher()
    for _ in range(n_subs):
        pub.subscribe("bench", _Sink())

    def cycle():
        async def one_tick():
            for i in range(burst):
                pub.publish("bench", {"i": i})
            await asyncio.sleep(0)  # run the scheduled flush
            while any(
                s.queued_msgs
                for subs in pub.channels.values()
                for s in subs.values()
            ):
                await asyncio.sleep(0)

        asyncio.run(one_tick())

    rate = timeit(
        "pubsub fan-out (1000 subscribers)", cycle, burst * n_subs
    )
    assert pub.total_dropped == 0, pub.total_dropped
    return rate


def _bench_telemetry_overhead() -> float:
    """Nanoseconds per hot-path telemetry record (one bound counter inc +
    one histogram observe) — the price every instrumented site pays. Gated
    with a ceiling: a regression here (a lock on the record path, an
    allocation per event) taxes every RPC frame and object operation."""
    from ray_tpu_torch._private import telemetry

    c = telemetry.counter("perf", "overhead_probe", "overhead bench").default
    h = telemetry.histogram(
        "perf", "overhead_probe_s", "overhead bench",
        buckets=telemetry.LATENCY_BUCKETS_S,
    ).default
    n = 200_000
    for _ in range(10_000):  # warmup
        c.inc()
        h.observe(0.001)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n):
            c.inc()
            h.observe(0.001)
        dt = time.perf_counter() - t0
        best = min(best, dt / n * 1e9)
    print(f"telemetry record overhead: {best:.0f} ns")
    return best


def _bench_trace_span_record() -> float:
    """Nanoseconds per runtime span record with tracing enabled and an
    active trace context — the price every instrumented hop (lease, arg
    fetch, object get/put, serve admission) pays on a sampled request.
    Gated with a ceiling: a regression here (id generation doing syscalls,
    lock contention on the buffer) taxes every traced hop. The disabled
    path is covered implicitly by the existing floors: with tracing off,
    instrumented sites reduce to one ContextVar.get() returning None."""
    from ray_tpu_torch._private import rpc
    from ray_tpu_torch.util import tracing

    prev = tracing.config.trace_sample_rate
    tracing.config.trace_sample_rate = 1.0
    tok = rpc._trace_ctx.set(("deadbeefdeadbeef", "cafebabecafebabe"))
    try:
        n = 200_000
        for _ in range(10_000):  # warmup
            tracing.record_span("perf.probe", "perf", 0.0, 0.001, oid="x")
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(n):
                tracing.record_span("perf.probe", "perf", 0.0, 0.001, oid="x")
            dt = time.perf_counter() - t0
            best = min(best, dt / n * 1e9)
    finally:
        rpc._trace_ctx.reset(tok)
        tracing.config.trace_sample_rate = prev
        tracing.reset()
    print(f"trace span record overhead: {best:.0f} ns")
    return best


def _bench_ingest() -> float:
    """Rows/s through the streaming ingest fast path: a fused read->map
    stage per block (metadata rides the refs), pipelined block fetch, and
    the zero-copy cursor batcher — i.e. execute -> iter_batches end to end
    on the driver (docs/perf.md "Ingest pipeline")."""
    import numpy as np

    import ray_tpu_torch.data as rd

    n_blocks, rows_per_block, batch = 16, 4096, 256
    total = n_blocks * rows_per_block

    def synth(b):
        b["x"] = b["id"].astype(np.float64) * 2.0
        return b

    ds = rd.range(total, parallelism=n_blocks).map_batches(synth)

    def cycle():
        seen = 0
        for out in ds.iter_batches(
            batch_size=batch, batch_format="numpy", prefetch_batches=2
        ):
            seen += len(out["x"])
        assert seen == total, seen

    return timeit("ingest rows (execute->iter_batches)", cycle, total)


def _bench_transfer_16mb() -> float:
    """Two-node 16MB object transfers (PushChunk blob sidecar): each cycle
    produces fresh objects on node A and consumes them on node B, so every
    get crosses the wire."""
    import numpy as np

    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy

    store = 512 * 1024 * 1024
    cluster = Cluster(head_node_args={"num_cpus": 1, "num_gpus": 0})
    cluster.add_node(num_cpus=2, object_store_memory=store)
    cluster.add_node(num_cpus=2, object_store_memory=store)
    cluster.connect()
    try:

        @ray_tpu_torch.remote(num_cpus=2)
        def produce(i):
            return np.full(16 * 1024 * 1024 // 8, float(i))

        @ray_tpu_torch.remote(num_cpus=2)
        def consume(x):
            return float(x[0])

        nodes = [
            n for n in ray_tpu_torch.nodes() if n["total"].get("CPU", 0) >= 20000
        ]
        n1, n2 = nodes[0]["node_id"], nodes[1]["node_id"]
        k = 3
        seq = [0]

        def cycle():
            base = seq[0]
            seq[0] += k
            refs = [
                produce.options(
                    scheduling_strategy=NodeAffinitySchedulingStrategy(n1)
                ).remote(base + i)
                for i in range(k)
            ]
            outs = [
                consume.options(
                    scheduling_strategy=NodeAffinitySchedulingStrategy(n2)
                ).remote(r)
                for r in refs
            ]
            ray_tpu_torch.get(outs, timeout=120)

        return timeit("16MB cross-node transfer", cycle, k)
    finally:
        cluster.shutdown()


def _bench_spill() -> Dict[str, float]:
    """Object plane under memory pressure (docs/perf.md "Spilling"): a
    working set 4x the arena pushed through put + get, so the pressure loop
    spills the cold tail on the way in and the gets pay restores on the way
    out; then the same oversubscription driven through the data pipeline
    (execute -> iter_batches), counted in rows/s. Runs after shutdown():
    both phases boot their own small-arena session with filesystem
    spilling."""
    import os
    import shutil
    import tempfile

    import numpy as np

    spill_dir = tempfile.mkdtemp(prefix="ray_tpu_torch_perf_spill_")
    saved = os.environ.get("RAY_TPU_OBJECT_SPILLING_CONFIG")
    os.environ["RAY_TPU_OBJECT_SPILLING_CONFIG"] = json.dumps(
        {"type": "filesystem", "params": {"directory_path": spill_dir}}
    )
    arena = 64 * 1024 * 1024
    obj = 8 * 1024 * 1024
    n = 4 * arena // obj  # 32 objects: working set 4x the arena
    results: Dict[str, float] = {}
    try:
        ray_tpu_torch.init(num_cpus=2, num_gpus=0, object_store_memory=arena)

        def cycle():
            refs = [
                ray_tpu_torch.put(np.full(obj, i % 251, dtype=np.uint8))
                for i in range(n)
            ]
            for i, ref in enumerate(refs):
                out = ray_tpu_torch.get(ref, timeout=120)
                assert out[0] == i % 251
                del out  # drop the zero-copy hold so the copy stays evictable

        mb = 2 * n * obj // (1024 * 1024)  # bytes spilled in + restored out
        results["spill_restore_mb_per_s"] = timeit(
            f"spill+restore round trip ({n * obj >> 20}MB through "
            f"{arena >> 20}MB arena)",
            cycle,
            mb,
        )
        ray_tpu_torch.shutdown()

        # Same oversubscription end to end through the data pipeline: blocks
        # totaling 4x the arena must stream execute -> iter_batches with
        # zero errors while cold blocks spill and restore under the hood.
        ray_tpu_torch.init(num_cpus=2, num_gpus=0, object_store_memory=arena)
        import ray_tpu_torch.data as rd

        n_blocks = 16
        rows_per_block = (4 * arena) // n_blocks // 1024  # 1 KB rows
        total = n_blocks * rows_per_block

        def widen(b):
            out = dict(b)
            out["payload"] = np.zeros((len(b["id"]), 1024), dtype=np.uint8)
            return out

        ds = rd.range(total, parallelism=n_blocks).map_batches(widen)

        def data_cycle():
            seen = 0
            for out in ds.iter_batches(
                batch_size=4096, batch_format="numpy", prefetch_batches=2
            ):
                seen += len(out["payload"])
            assert seen == total, seen

        results["oversubscribed_put_rows_per_s"] = timeit(
            "oversubscribed ingest rows (4x arena, execute->iter_batches)",
            data_cycle,
            total,
        )
        ray_tpu_torch.shutdown()
    finally:
        if saved is None:
            os.environ.pop("RAY_TPU_OBJECT_SPILLING_CONFIG", None)
        else:
            os.environ["RAY_TPU_OBJECT_SPILLING_CONFIG"] = saved
        shutil.rmtree(spill_dir, ignore_errors=True)
    return results


def _gloo_allreduce_rank(world: int, mb: int):
    """One rank of the gloo allreduce bench (run_in_processes calls it in
    each of `world` processes joined in one gloo group): rank r's `mb` MiB
    of float(r + 1) summed by MeshCollectives. Rank 0 returns its best rate
    and the reduced tensor; the other ranks return nothing and print
    nothing."""
    import contextlib
    import io

    import torch
    import torch.distributed as dist

    from ray_tpu_torch.util.collective.collective import SUM
    from ray_tpu_torch.util.collective.mesh_ops import MeshCollectives

    rank = dist.get_rank()
    part = torch.full((mb * 1024 * 1024 // 4,), float(rank + 1), dtype=torch.float32)
    eng = MeshCollectives(dist.group.WORLD, torch.device("cpu"), "perf")
    out = {}

    def mesh_cycle():
        out["reduced"] = eng.allreduce(part, SUM)

    quiet = contextlib.nullcontext() if rank == 0 else contextlib.redirect_stdout(io.StringIO())
    with quiet:
        rate = timeit(f"collective allreduce {mb}MiB (gloo, {world} processes)", mesh_cycle)
    return (rate, out["reduced"].numpy()) if rank == 0 else None


def _gloo_allreduce(world: int = 8, mb: int = 16):
    """-> (allreduces/s, reduced array) of MeshCollectives on `world` gloo
    processes, each contributing `mb` MiB."""
    from ray_tpu_torch.testing import run_in_processes

    return run_in_processes(_gloo_allreduce_rank, world, world, mb, timeout=600)


def _store_allreduce(world: int = 8, mb: int = 16):
    """-> (allreduces/s, reduced array) of the store backend's rendezvous
    actor on the same parts: every rank's contribution crosses the object
    store into the actor and the reduced result crosses back out, once per
    rank. Boots (and shuts down) its own session."""
    import numpy as np

    import ray_tpu_torch
    from ray_tpu_torch.util.collective.collective import SUM, _store_actor_cls

    parts = [
        np.full((mb * 1024 * 1024 // 4,), float(r + 1), dtype=np.float32)
        for r in range(world)
    ]
    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    try:
        # max_concurrency: in production every rank is a distinct caller so
        # contribute() coroutines interleave; here one driver plays all 8
        # ranks, and per-caller ordering would serialize the rendezvous.
        store = _store_actor_cls().options(max_concurrency=world).remote(world)
        seq = [0]
        out = {}

        def store_cycle():
            s = seq[0]
            seq[0] += 1
            out["reduced"] = ray_tpu_torch.get(
                [
                    store.contribute.remote(s, r, parts[r], SUM, "allreduce")
                    for r in range(world)
                ],
                timeout=120,
            )[0]

        store_rate = timeit(
            f"collective allreduce {mb}MiB (store actor)", store_cycle
        )
    finally:
        ray_tpu_torch.shutdown()
    return store_rate, out["reduced"]


def _collective_child_main() -> None:
    """Child-process body for the collective allreduce bench: the gloo
    group of 8 processes, then the store actor, at 16 MiB per rank. Runs in
    a fresh interpreter, as the JAX package's does, so the ranks it spawns and the
    session it boots start from a clean process. Prints one JSON dict on
    the last stdout line (docs/collectives.md "Benchmarks & gating").
    """
    mb = 16
    mesh_rate, _ = _gloo_allreduce(8, mb)
    mesh_mb_per_s = mb * mesh_rate
    store_rate, _ = _store_allreduce(8, mb)
    store_mb_per_s = mb * store_rate

    print(
        json.dumps(
            {
                "collective_allreduce_mb_per_s": mesh_mb_per_s,
                "collective_allreduce_store_mb_per_s": store_mb_per_s,
                "collective_allreduce_speedup_x": mesh_mb_per_s
                / max(store_mb_per_s, 1e-9),
            }
        )
    )


def _bench_collective_allreduce() -> Dict[str, float]:
    """Process-group vs store-actor allreduce at 16 MiB per rank, world=8,
    the group on gloo across 8 processes. The acceptance bar — group >= 2x
    store — is gated as `collective_allreduce_speedup_x` in
    benchmarks/perf_floors.json."""
    import os
    import subprocess
    import sys

    env = dict(os.environ)
    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch._private.ray_perf", "--collective-child"],
        env=env,
        capture_output=True,
        text=True,
        timeout=600,
    )
    if out.returncode != 0:
        raise RuntimeError(
            f"collective bench child failed:\n{out.stdout}\n{out.stderr}"
        )
    line = out.stdout.strip().splitlines()[-1]
    results: Dict[str, float] = json.loads(line)
    for k, v in results.items():
        print(f"{k}: {v:.1f}")
    return results


def _bench_dag_channel() -> float:
    """Compiled-DAG executes/s through a ~1 MiB actor->actor tensor-channel
    edge: producer writes a torch tensor into the shm tensor channel,
    consumer reduces it — the steady-state cost of a compiled pipeline
    hop."""
    import torch

    from ray_tpu_torch import dag

    @ray_tpu_torch.remote
    class Producer:
        def make(self, seed):
            return torch.full((512, 512), float(seed), dtype=torch.float32)

    @ray_tpu_torch.remote
    class Consumer:
        def total(self, x):
            return float(x[0, 0])

    p, c = Producer.remote(), Consumer.remote()
    with dag.InputNode() as inp:
        graph = c.total.bind(p.make.bind(inp).with_tensor_transport("tensor"))
    compiled = graph.experimental_compile()
    try:
        assert compiled.execute(3).get() == 3.0  # warm the channel

        n = 50
        seq = [10]

        def cycle():
            base = seq[0]
            seq[0] += n
            for i in range(n):
                assert compiled.execute(base + i).get() == float(base + i)

        return timeit("compiled DAG 1MiB tensor-channel hop", cycle, n)
    finally:
        compiled.teardown()
        for a in (p, c):
            ray_tpu_torch.kill(a)


def result_keys(path: str) -> set:
    """The keys a ray_perf module's main() reports, read from its source
    (`path`) without running it: every ``results["..."]`` it sets, and the
    keys of the dicts that _bench_sched returns and the collective child
    prints whole. The device suites' keys (CUDA_KEYS) are left out."""
    import ast

    with open(path) as f:
        tree = ast.parse(f.read())
    keys = set()
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef) or fn.name == "_bench_cuda":
            continue
        for node in ast.walk(fn):
            if (isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name)
                    and node.value.id == "results" and isinstance(node.ctx, ast.Store)):
                keys.add(node.slice.value)
            elif fn.name in ("_bench_sched", "_collective_child_main"):
                whole = None
                if isinstance(node, ast.Return):
                    whole = node.value
                elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dumps"
                      and node.args):
                    whole = node.args[0]
                if isinstance(whole, ast.Dict):
                    keys.update(k.value for k in whole.keys if isinstance(k, ast.Constant))
    return keys


# -- device suites (on a card) ------------------------------------------------

_CUDA_MB = 16  # per-rank allreduce payload, as the gloo and store benches
CUDA_KEYS = (
    "collective_allreduce_nccl_cuda_mb_per_s",
    "collective_allreduce_store_cuda_mb_per_s",
    "collective_allreduce_nccl_cuda_speedup_x",
    "dag_channel_cuda_ipc_per_s",
)


class _CudaRank:
    """A GPU actor of the device suites: the collective groups at world 1
    on its card, and one end of a compiled DAG's device edge."""

    def allreduce_rates(self, mb: int) -> Dict[str, float]:
        """Allreduces/s of an NCCL group and a store group, each of world 1,
        on this actor's card, `mb` MiB of f32; raises unless the two
        results are bitwise equal."""
        import torch

        from ray_tpu_torch.util import collective as col

        dev = torch.device("cuda", torch.cuda.current_device())
        x = torch.randn(mb * 1024 * 1024 // 4, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
        rates = {}
        for backend in ("nccl", "store"):
            group = f"perf_{backend}"
            col.init_collective_group(1, 0, backend=backend, group_name=group)

            def cycle():
                col.allreduce(x, group)
                torch.cuda.synchronize()

            rates[backend] = timeit(f"collective allreduce {mb}MiB cuda ({backend}, world 1)",
                                    cycle)
        same = torch.equal(col.allreduce(x, "perf_nccl").cpu(),
                           torch.as_tensor(col.allreduce(x, "perf_store")).cpu())
        for backend in ("nccl", "store"):
            col.destroy_collective_group(f"perf_{backend}")
        if not same:
            raise RuntimeError("the NCCL group's allreduce differs from the store group's")
        return rates

    def join(self, group: str, rank: int) -> None:
        from ray_tpu_torch.util import collective as col

        col.init_collective_group(2, rank, backend="gloo", group_name=group)

    def make(self, seed):
        import torch

        return torch.full((512, 512), float(seed), dtype=torch.float32, device="cuda")

    def total(self, x):
        if x.device.type != "cuda":
            raise RuntimeError(f"the device edge delivered a {x.device.type} tensor")
        return float(x[0, 0])


def _bench_dag_cuda_ipc(producer, consumer) -> float:
    """Compiled-DAG executes/s through a ~1 MiB device edge between two GPU
    actors on one card (a 2-rank gloo group joins them; the tensor crosses
    by CUDA IPC, not through the host)."""
    from ray_tpu_torch import dag

    group = "perf_dag"
    ray_tpu_torch.get([producer.join.remote(group, 0), consumer.join.remote(group, 1)],
                      timeout=120)
    with dag.InputNode() as inp:
        made = producer.make.bind(inp).with_tensor_transport(
            "device", group_name=group, src=0, dst=1)
        graph = consumer.total.bind(made)
    compiled = graph.experimental_compile()
    try:
        assert compiled.execute(3).get() == 3.0  # warm the channel

        n = 50
        seq = [10]

        def cycle():
            base = seq[0]
            seq[0] += n
            for i in range(n):
                assert compiled.execute(base + i).get() == float(base + i)

        return timeit("compiled DAG 1MiB CUDA IPC device edge", cycle, n)
    finally:
        compiled.teardown()


def _bench_cuda() -> Dict[str, float]:
    """The device suites, in two GPU actors (GPU 0.5 each) on one card."""
    results: Dict[str, float] = {}
    ray_tpu_torch.init(num_cpus=4, num_gpus=1)
    try:
        rank = ray_tpu_torch.remote(num_gpus=0.5, max_concurrency=4)(_CudaRank)
        producer, consumer = rank.remote(), rank.remote()
        rates = ray_tpu_torch.get(producer.allreduce_rates.remote(_CUDA_MB), timeout=600)
        nccl, store = _CUDA_MB * rates["nccl"], _CUDA_MB * rates["store"]
        values = (nccl, store, nccl / max(store, 1e-9),
                  _bench_dag_cuda_ipc(producer, consumer))
        results.update(zip(CUDA_KEYS, values))
        for a in (producer, consumer):
            ray_tpu_torch.kill(a)
    finally:
        ray_tpu_torch.shutdown()
    for k in CUDA_KEYS[:3]:
        print(f"{k}: {results[k]:.1f}")
    return results


def device_main(json_path: str = "") -> Dict[str, float]:
    """The device suites alone (CUDA_KEYS), written to `json_path` as main
    writes its results."""
    results = _bench_cuda()
    if json_path:
        with open(json_path, "w") as f:
            json.dump(results, f, indent=2)
    return results


def main(json_path: str = "", device: str = "cuda") -> Dict[str, float]:
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError(
                "ray_perf runs its device suites on a CUDA card; pass "
                "device='cpu' (--device cpu) for the host benches alone"
            )
    results: Dict[str, float] = {}
    ray_tpu_torch.init(num_cpus=8, num_gpus=0)

    @ray_tpu_torch.remote
    def trivial():
        return b"ok"

    # Separate sync and async actor classes (reference ray_perf.py does the
    # same): an actor with any coroutine method is an asyncio actor, whose
    # calls all run on the event loop rather than the dedicated exec thread.
    @ray_tpu_torch.remote
    class Counter:
        def small(self):
            return b"ok"

    @ray_tpu_torch.remote
    class AsyncCounter:
        async def asmall(self):
            return b"ok"

    # Warm the worker pool so spawn cost is not measured.
    ray_tpu_torch.get([trivial.remote() for _ in range(16)])

    N = 1000
    results["tasks_sync_per_s"] = timeit(
        "single client tasks sync",
        lambda: [ray_tpu_torch.get(trivial.remote()) for _ in range(100)],
        100,
    )
    results["tasks_async_per_s"] = timeit(
        "single client tasks async (pipelined)",
        lambda: ray_tpu_torch.get([trivial.remote() for _ in range(N)]),
        N,
    )

    actor = Counter.remote()
    ray_tpu_torch.get(actor.small.remote())
    results["actor_calls_sync_per_s"] = timeit(
        "1:1 actor calls sync",
        lambda: [ray_tpu_torch.get(actor.small.remote()) for _ in range(100)],
        100,
    )
    results["actor_calls_async_per_s"] = timeit(
        "1:1 actor calls async (pipelined)",
        lambda: ray_tpu_torch.get([actor.small.remote() for _ in range(N)]),
        N,
    )

    ray_tpu_torch.kill(actor)
    async_actor = AsyncCounter.options(max_concurrency=64).remote()
    ray_tpu_torch.get(async_actor.asmall.remote())
    results["async_actor_calls_per_s"] = timeit(
        "1:1 async actor calls (pipelined)",
        lambda: ray_tpu_torch.get([async_actor.asmall.remote() for _ in range(N)]),
        N,
    )

    ray_tpu_torch.kill(async_actor)
    n_actors = 4
    actors = [Counter.remote() for _ in range(n_actors)]
    ray_tpu_torch.get([a.small.remote() for a in actors])
    results["nn_actor_calls_per_s"] = timeit(
        "n:n actor calls (4 actors, pipelined)",
        lambda: ray_tpu_torch.get(
            [a.small.remote() for _ in range(N // n_actors) for a in actors]
        ),
        N,
    )

    for a in actors:
        ray_tpu_torch.kill(a)
    small = b"x" * 1024
    results["put_small_per_s"] = timeit(
        "1KB put", lambda: [ray_tpu_torch.put(small) for _ in range(500)], 500
    )
    ref = ray_tpu_torch.put(small)
    results["get_small_per_s"] = timeit(
        "1KB get", lambda: [ray_tpu_torch.get(ref) for _ in range(500)], 500
    )

    import numpy as np

    big = np.zeros(16 * 1024 * 1024 // 8)  # 16 MB
    results["put_16mb_per_s"] = timeit(
        "16MB put (shm)", lambda: [ray_tpu_torch.put(big) for _ in range(20)], 20
    )
    bref = ray_tpu_torch.put(big)
    results["get_16mb_per_s"] = timeit(
        "16MB get (zero-copy)", lambda: [ray_tpu_torch.get(bref) for _ in range(50)], 50
    )

    big64 = np.zeros(64 * 1024 * 1024 // 8)  # 64 MB
    results["put_64mb_per_s"] = timeit(
        "64MB put (shm)", lambda: [ray_tpu_torch.put(big64) for _ in range(5)], 5
    )
    del big64

    results["release_batched_per_s"] = _bench_release_batched()
    results["ingest_rows_per_s"] = _bench_ingest()
    results["dag_channel_tensor_per_s"] = _bench_dag_channel()

    ray_tpu_torch.shutdown()

    results["transfer_16mb_per_s"] = _bench_transfer_16mb()
    results.update(_bench_spill())
    results.update(_bench_collective_allreduce())
    results.update(_bench_sched())
    results["gcs_persist_puts_per_s"] = _bench_gcs_persist()
    results["gcs_persist_puts_per_s_replicated"] = _bench_gcs_persist(
        replicated=True, followers=1
    )
    results["gcs_persist_puts_per_s_quorum"] = _bench_gcs_persist(
        replicated=True
    )
    results["gcs_failover_converge_s"] = _bench_gcs_failover()
    results["pubsub_fanout_per_s"] = _bench_pubsub_fanout()
    results["telemetry_overhead_ns"] = _bench_telemetry_overhead()
    results["trace_span_record_ns"] = _bench_trace_span_record()
    if device == "cuda":
        results.update(_bench_cuda())
    if json_path:
        with open(json_path, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--json", default="")
    parser.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default="cuda",
        help="cuda (the default) adds the device suites; cpu runs the "
        "host benches alone",
    )
    parser.add_argument(
        "--device-only",
        action="store_true",
        help="run the device suites alone (needs a card); with --device "
        "cpu in another process, the keys of one --device cuda run",
    )
    parser.add_argument(
        "--collective-child",
        action="store_true",
        help="internal: run the collective allreduce bench body "
        "(fresh process for the gloo ranks and the store session)",
    )
    args = parser.parse_args()
    if args.collective_child:
        _collective_child_main()
    elif args.device_only:
        device_main(args.json)
    else:
        main(args.json, args.device)
