"""Multi-node clusters on the port (ray_tpu_torch.cluster_utils), on the
CPU: the cases of tests/test_cluster.py (spillback, cross-node objects,
push-manager broadcast, placement groups, node affinity, node death) and
tests/test_node_labels.py (label expressions, hard and soft label
placement of tasks and actors) on the port's Cluster; then GPU nodes:
add_node(num_gpus=1) leases "GPU" where the reference's add_node(num_tpus=1)
leases "TPU" (both packages, each in a process of its own), a node without a
count advertises the GPUs it detects, and a GPU task lands on the GPU node
of a cluster whose head has none."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.util.placement_group import (
    placement_group,
    placement_group_table,
    remove_placement_group,
)
from ray_tpu_torch.util.scheduling_strategies import (
    DoesNotExist,
    Exists,
    In,
    NodeAffinitySchedulingStrategy,
    NodeLabelSchedulingStrategy,
    NotIn,
    PlacementGroupSchedulingStrategy,
    match_label_expr,
    node_matches_labels,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cluster_3():
    cluster = Cluster(head_node_args={"num_cpus": 1, "num_gpus": 0})
    cluster.add_node(num_cpus=2)
    cluster.add_node(num_cpus=2)
    cluster.connect()
    yield cluster
    cluster.shutdown()


def test_cluster_sees_all_nodes(cluster_3):
    nodes = ray_tpu_torch.nodes()
    assert len([n for n in nodes if n["state"] == "ALIVE"]) == 3
    assert ray_tpu_torch.cluster_resources()["CPU"] == 5.0


def test_spillback_scheduling(cluster_3):
    """Head has 1 CPU; 2-CPU tasks must spill to the bigger nodes."""

    @ray_tpu_torch.remote(num_cpus=2)
    def where():
        import os

        return os.environ["RAY_TPU_NODE_ID"]

    node_ids = ray_tpu_torch.get([where.remote() for _ in range(4)])
    # The 1-CPU head can never host a 2-CPU task: all must have spilled to
    # the 2-CPU nodes.
    from ray_tpu_torch._private.common import ResourceSet

    small_nodes = {
        n["node_id"] for n in ray_tpu_torch.nodes()
        if ResourceSet.from_units(n["total"]).to_dict().get("CPU", 0) < 2
    }
    assert small_nodes and not (small_nodes & set(node_ids))


def test_cross_node_object_transfer(cluster_3):
    @ray_tpu_torch.remote(num_cpus=2)
    def produce():
        return np.ones((600, 600))  # ~2.9 MB: plasma on producing node

    @ray_tpu_torch.remote(num_cpus=2)
    def consume(x):
        return float(x.sum())

    # Force different nodes via node affinity.
    nodes = [n for n in ray_tpu_torch.nodes() if n["total"].get("CPU", 0) >= 20000]
    n1, n2 = nodes[0]["node_id"], nodes[1]["node_id"]
    ref = produce.options(
        scheduling_strategy=NodeAffinitySchedulingStrategy(n1)
    ).remote()
    out = consume.options(
        scheduling_strategy=NodeAffinitySchedulingStrategy(n2)
    ).remote(ref)
    assert ray_tpu_torch.get(out, timeout=60) == 360000.0


def test_broadcast_uses_push_manager(cluster_3):
    """One object consumed on every other node: transfers go through the
    source's push manager (bounded one-way chunk fan-out, reference
    push_manager.h) rather than per-chunk request/reply pulls."""
    from ray_tpu_torch._private.common import config

    @ray_tpu_torch.remote(num_cpus=2)
    def consume(x):
        return float(x[0] + x[-1])

    data = np.arange(3 * 1024 * 1024, dtype=np.float64)  # 24 MB -> 3 chunks
    ref = ray_tpu_torch.put(data)  # lands in the head node's store
    nodes = [n for n in ray_tpu_torch.nodes() if n["total"].get("CPU", 0) >= 20000]
    assert len(nodes) >= 2
    outs = [
        consume.options(
            scheduling_strategy=NodeAffinitySchedulingStrategy(n["node_id"])
        ).remote(ref)
        for n in nodes
        for _ in range(2)
    ]
    expected = float(data[0] + data[-1])
    assert all(v == expected for v in ray_tpu_torch.get(outs, timeout=120))
    stats = cluster_3.head_node.raylet.push_manager.stats
    assert stats["pushes_completed"] >= 2, stats
    assert stats["chunks_sent"] >= 2 * 3, stats
    assert stats["peak_inflight_chunks"] <= config.push_manager_max_chunks, stats


def test_placement_group_spread(cluster_3):
    pg = placement_group([{"CPU": 1}, {"CPU": 1}], strategy="STRICT_SPREAD")
    assert pg.ready(timeout=30)

    @ray_tpu_torch.remote(num_cpus=1)
    def where():
        import os

        return os.environ["RAY_TPU_NODE_ID"]

    a = where.options(
        scheduling_strategy=PlacementGroupSchedulingStrategy(pg, 0)
    ).remote()
    b = where.options(
        scheduling_strategy=PlacementGroupSchedulingStrategy(pg, 1)
    ).remote()
    na, nb = ray_tpu_torch.get([a, b], timeout=60)
    assert na != nb  # strict spread -> distinct nodes
    remove_placement_group(pg)


def test_placement_group_infeasible_times_out(cluster_3):
    pg = placement_group([{"CPU": 50}], strategy="PACK")
    assert pg.ready(timeout=2) is False


def test_placement_group_table(cluster_3):
    pg = placement_group([{"CPU": 1}], strategy="PACK")
    assert pg.ready(timeout=30)
    table = placement_group_table()
    states = {t["pg_id"]: t["state"] for t in table}
    assert states[pg.id_hex] == "CREATED"


def test_actor_on_specific_node(cluster_3):
    nodes = [n for n in ray_tpu_torch.nodes() if n["total"].get("CPU", 0) >= 20000]
    target = nodes[0]["node_id"]

    @ray_tpu_torch.remote(num_cpus=1)
    class A:
        def where(self):
            import os

            return os.environ["RAY_TPU_NODE_ID"]

    a = A.options(
        scheduling_strategy=NodeAffinitySchedulingStrategy(target)
    ).remote()
    assert ray_tpu_torch.get(a.where.remote(), timeout=60) == target


def test_node_death_kills_actors(cluster_3):
    cluster = cluster_3
    extra = cluster.add_node(num_cpus=1, resources={"special": 1})

    @ray_tpu_torch.remote(num_cpus=1, resources={"special": 1})
    class Pinned:
        def ping(self):
            return "pong"

    a = Pinned.remote()
    assert ray_tpu_torch.get(a.ping.remote(), timeout=60) == "pong"
    cluster.remove_node(extra)
    time.sleep(1.0)
    with pytest.raises((ray_tpu_torch.ActorDiedError, ray_tpu_torch.ActorUnavailableError, ray_tpu_torch.RayTpuError)):
        ray_tpu_torch.get(a.ping.remote(), timeout=15)


def test_label_expression_semantics():
    labels = {"region": "us-west", "tier": "gold"}
    assert match_label_expr(In("us-west").to_wire(), labels, "region")
    assert not match_label_expr(In("eu").to_wire(), labels, "region")
    assert match_label_expr(NotIn("eu").to_wire(), labels, "region")
    # Missing label satisfies NotIn, fails In/Exists, passes DoesNotExist.
    assert match_label_expr(NotIn("x").to_wire(), labels, "absent")
    assert not match_label_expr(In("x").to_wire(), labels, "absent")
    assert match_label_expr(Exists().to_wire(), labels, "tier")
    assert not match_label_expr(Exists().to_wire(), labels, "absent")
    assert match_label_expr(DoesNotExist().to_wire(), labels, "absent")
    # Plain string sugar == In(value).
    wire = NodeLabelSchedulingStrategy(hard={"region": "us-west"}).to_wire()
    assert wire["labels"]["hard"]["region"] == {"op": "in", "values": ["us-west"]}
    assert node_matches_labels(wire["labels"]["hard"], labels)


@pytest.fixture
def label_cluster():
    cluster = Cluster(
        initialize_head=True, head_node_args={"num_cpus": 1}
    )
    cluster.add_node(num_cpus=2, labels={"accel": "tpu", "gen": "v5e"})
    cluster.add_node(num_cpus=2, labels={"accel": "gpu"})
    ray_tpu_torch.init(address=cluster.address)
    yield cluster
    ray_tpu_torch.shutdown()
    cluster.shutdown()


def test_task_hard_label_affinity(label_cluster):
    @ray_tpu_torch.remote(num_cpus=1)
    def where():
        import os

        return os.environ["RAY_TPU_NODE_ID"]

    tpu_node = {
        n["node_id"]: n.get("labels") or {}
        for n in ray_tpu_torch.nodes()
    }
    tpu_ids = [k for k, v in tpu_node.items() if v.get("accel") == "tpu"]
    gpu_ids = [k for k, v in tpu_node.items() if v.get("accel") == "gpu"]
    assert len(tpu_ids) == 1 and len(gpu_ids) == 1

    strat = NodeLabelSchedulingStrategy(hard={"accel": In("tpu")})
    got = ray_tpu_torch.get(
        [
            where.options(scheduling_strategy=strat).remote()
            for _ in range(4)
        ]
    )
    assert set(got) == {tpu_ids[0]}

    # Anti-affinity: NOT the tpu node.
    strat = NodeLabelSchedulingStrategy(hard={"accel": NotIn("tpu")})
    got = ray_tpu_torch.get(
        [where.options(scheduling_strategy=strat).remote() for _ in range(4)]
    )
    assert tpu_ids[0] not in set(got)


def test_task_unsatisfiable_hard_labels(label_cluster):
    @ray_tpu_torch.remote(num_cpus=1)
    def f():
        return 1

    strat = NodeLabelSchedulingStrategy(hard={"accel": In("nonexistent")})
    with pytest.raises(Exception):
        ray_tpu_torch.get(f.options(scheduling_strategy=strat).remote(), timeout=30)


def test_soft_labels_prefer_but_fall_back(label_cluster):
    @ray_tpu_torch.remote(num_cpus=1)
    def where():
        import os

        return os.environ["RAY_TPU_NODE_ID"]

    nodes = {n["node_id"]: n.get("labels") or {} for n in ray_tpu_torch.nodes()}
    v5e = [k for k, v in nodes.items() if v.get("gen") == "v5e"]
    # Soft preference for gen=v5e lands there...
    strat = NodeLabelSchedulingStrategy(
        hard={"accel": Exists()}, soft={"gen": In("v5e")}
    )
    got = ray_tpu_torch.get(where.options(scheduling_strategy=strat).remote())
    assert got == v5e[0]
    # ...but a soft-only miss still schedules somewhere.
    strat = NodeLabelSchedulingStrategy(soft={"gen": In("not-a-gen")})
    assert ray_tpu_torch.get(where.options(scheduling_strategy=strat).remote()) in nodes


def test_actor_label_placement(label_cluster):
    @ray_tpu_torch.remote(num_cpus=1)
    class Pinned:
        def where(self):
            import os

            return os.environ["RAY_TPU_NODE_ID"]

    nodes = {n["node_id"]: n.get("labels") or {} for n in ray_tpu_torch.nodes()}
    gpu = [k for k, v in nodes.items() if v.get("accel") == "gpu"]
    a = Pinned.options(
        scheduling_strategy=NodeLabelSchedulingStrategy(
            hard={"accel": In("gpu")}
        )
    ).remote()
    assert ray_tpu_torch.get(a.where.remote()) == gpu[0]
    ray_tpu_torch.kill(a)


# -- GPU nodes -----------------------------------------------------------------

# A head without accelerators and one node with one, on {pkg}; a task that
# asks for the accelerator reports where it ran. Prints each node's totals.
LEASE_SCRIPT = r'''
import json, os, sys
sys.path.insert(0, {repo!r})
import {pkg} as rt
from {pkg}._private.common import ResourceSet
from {pkg}.cluster_utils import Cluster

cluster = Cluster(head_node_args={{"num_cpus": 1, "{opt}": 0}})
acc = cluster.add_node(num_cpus=1, {opt}=1)
cluster.connect()

@rt.remote({opt}=1)
def where():
    return os.environ["RAY_TPU_NODE_ID"]

def plain(res):  # without the node:<id> resource each node has
    return {{k: v for k, v in res.items() if not k.startswith("node:")}}

placed = rt.get([where.remote() for _ in range(3)], timeout=60)
totals = {{n["node_id"]: plain(ResourceSet.from_units(n["total"]).to_dict()) for n in rt.nodes()}}
out = {{"placed_on_acc_node": all(p == acc.node_id for p in placed),
       "acc_node": totals[acc.node_id],
       "other_nodes": [t for nid, t in totals.items() if nid != acc.node_id],
       "cluster": plain(rt.cluster_resources())}}
cluster.shutdown()
print("RESULT " + json.dumps(out))
'''


def _leases(tmp_path) -> dict:
    """Both packages' runs of LEASE_SCRIPT, side by side."""
    procs = {pkg: subprocess.Popen(
        [sys.executable, "-c", LEASE_SCRIPT.format(repo=REPO, pkg=pkg, opt=opt)], cwd=tmp_path,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pkg, opt in (("ray_tpu", "num_tpus"), ("ray_tpu_torch", "num_gpus"))}
    got = {}
    for pkg, proc in procs.items():
        out, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err[-4000:]
        line = [x for x in out.splitlines() if x.startswith("RESULT ")]
        assert line, (out[-2000:], err[-2000:])
        got[pkg] = json.loads(line[-1][len("RESULT "):])
    return got


@pytest.mark.timeout(150)
def test_gpu_node_leases_gpu_as_reference_tpu_node_leases_tpu(tmp_path):
    got = _leases(tmp_path)
    ref, port = got["ray_tpu"], got["ray_tpu_torch"]
    assert ref["placed_on_acc_node"] and port["placed_on_acc_node"]
    assert ref["acc_node"] == {"CPU": 1.0, "TPU": 1.0}
    assert port["acc_node"] == {"CPU": 1.0, "GPU": 1.0}
    for key in ("other_nodes", "cluster"):
        assert json.loads(json.dumps(ref[key]).replace('"TPU"', '"GPU"')) == port[key], key


@pytest.mark.timeout(60)
def test_node_without_a_count_advertises_detected_gpus(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1")
    cluster = Cluster(head_node_args={"num_cpus": 1, "num_gpus": 0})
    try:
        detected = cluster.add_node(num_cpus=1)
        counted = cluster.add_node(num_cpus=1, num_gpus=1)
        none = cluster.add_node(num_cpus=1, num_gpus=0)
        cluster.connect()
        from ray_tpu_torch._private.common import ResourceSet

        totals = {n["node_id"]: {k: v for k, v in ResourceSet.from_units(n["total"]).to_dict()
                                 .items() if not k.startswith("node:")}
                  for n in ray_tpu_torch.nodes()}
        assert totals[detected.node_id] == {"CPU": 1.0, "GPU": 2.0}
        assert totals[counted.node_id] == {"CPU": 1.0, "GPU": 1.0}
        assert totals[none.node_id] == {"CPU": 1.0}
        assert totals[cluster.head_node.raylet.node_id].get("GPU", 0) == 0
    finally:
        cluster.shutdown()


@pytest.mark.timeout(90)
def test_gpu_task_lands_on_the_gpu_node():
    """Phase 14a's placement on the CPU: the head has no GPU, one added node
    has one; a num_gpus=1 task and actor run there, never on the head."""
    cluster = Cluster(head_node_args={"num_cpus": 2, "num_gpus": 0})
    try:
        gpu_node = cluster.add_node(num_cpus=2, num_gpus=1)
        cluster.connect()

        @ray_tpu_torch.remote(num_gpus=1)
        def where():
            return os.environ["RAY_TPU_NODE_ID"]

        @ray_tpu_torch.remote(num_gpus=1)
        class OnGpu:
            def where(self):
                return os.environ["RAY_TPU_NODE_ID"]

        assert set(ray_tpu_torch.get([where.remote() for _ in range(4)], timeout=60)) == \
            {gpu_node.node_id}
        a = OnGpu.remote()
        assert ray_tpu_torch.get(a.where.remote(), timeout=60) == gpu_node.node_id
        ray_tpu_torch.kill(a)
    finally:
        cluster.shutdown()


@pytest.mark.timeout(90)
def test_shutdown_says_farewell_while_the_gcs_answers():
    """Cluster.shutdown closes its driver (JobFinished, the task-event flush)
    before it stops the daemons: it stopped them first, and each call then
    redialed the stopped GCS until its window ended (5 s for JobFinished, 30 s
    for a flush). Held at 4.5 s, below the first of those windows."""
    from ray_tpu_torch._private import worker as worker_mod

    cluster = Cluster(head_node_args={"num_cpus": 1, "num_gpus": 0})
    cluster.add_node(num_cpus=1, resources={"victim": 1})
    cluster.connect()

    @ray_tpu_torch.remote(resources={"victim": 1})
    def one():
        return 1

    assert ray_tpu_torch.get(one.remote(), timeout=60) == 1
    core = worker_mod.global_worker.core
    start = time.monotonic()
    cluster.shutdown()
    took = time.monotonic() - start
    assert core.closed and not worker_mod.global_worker.connected
    assert took < 4.5, f"shutdown took {took:.2f} s"


@pytest.mark.timeout(90)
def test_a_closed_driver_rebuilds_nothing_while_its_cluster_stops():
    """Stopping a Cluster removes its nodes, and the GCS announces each
    removal. A driver that has closed must not start lineage reconstruction
    of its answers for them: it did, and each such task failed against the
    stopping daemons, attempt after attempt, as the cluster went down."""
    from ray_tpu_torch._private import worker as worker_mod

    cluster = Cluster(head_node_args={"num_cpus": 1, "num_gpus": 0})
    cluster.add_node(num_cpus=1, resources={"victim": 1})
    cluster.connect()

    @ray_tpu_torch.remote(resources={"victim": 1}, max_retries=3)
    def produce():
        return np.ones(200_000)  # 1.6 MB: a plasma return on the victim node

    ref = produce.remote()
    assert float(ray_tpu_torch.get(ref, timeout=60).sum()) == 200_000.0
    core = worker_mod.global_worker.core
    rebuilt = []

    async def record(oid):
        rebuilt.append(oid)

    core._recover_lost_primary = record
    cluster.shutdown()
    assert rebuilt == []
    del ref
