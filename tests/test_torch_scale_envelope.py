"""The scalability envelope of tests/test_scale.py on the port: its seven
cases on real multi-process clusters, case for case after the rename
(`ray_tpu` -> `ray_tpu_torch`, `num_tpus` -> `num_gpus`, the conftest's
`shutdown_only` -> `torch_shutdown_only`; the `RAY_TPU_*` variables keep
their names, which ray_tpu_torch/_private/common.py reads). The same
sizes, the same `scale` mark, the same per-case timeouts and the same
`big_cluster` fixture: 10,000 and 100,000 queued tasks, 200 and 1,000
actors, 50 and 200 placement groups on one 256-CPU node, and one 256 MB
object broadcast to tasks pinned on 8 raylets. A file of its own, so
that under the suite's `--dist loadfile` these cases run on a worker
beside tests/test_torch_scale.py's simulated-cluster cases.

    python -m pytest -m scale tests/test_torch_scale_envelope.py -q
"""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.testing import torch_shutdown_only  # noqa: F401

pytestmark = pytest.mark.scale


@pytest.fixture
def big_cluster(torch_shutdown_only, monkeypatch):  # noqa: F811
    monkeypatch.setenv("RAY_TPU_MAX_WORKERS_PER_NODE", "300")
    monkeypatch.setenv("RAY_TPU_ACTOR_RESOLVE_TIMEOUT_S", "800")
    ray_tpu_torch.init(num_cpus=256, num_gpus=0)
    yield


@pytest.mark.timeout(900)
def test_10k_queued_tasks(big_cluster):
    """10,000 tasks queued at once all complete (reference bar: 1M queued on
    one m4.16xlarge; scaled to CI)."""

    @ray_tpu_torch.remote(num_cpus=8)  # bound worker-process count to ~32
    def tick(i):
        return i

    refs = [tick.remote(i) for i in range(10_000)]
    out = ray_tpu_torch.get(refs, timeout=600)
    assert out == list(range(10_000))


@pytest.mark.timeout(900)
def test_200_actors(big_cluster):
    """200 concurrent actors all answer (reference bar: 40k cluster-wide)."""

    @ray_tpu_torch.remote(num_cpus=0.5)
    class Cell:
        def __init__(self, i):
            self.i = i

        def who(self):
            return self.i

    actors = [Cell.remote(i) for i in range(200)]
    out = ray_tpu_torch.get([a.who.remote() for a in actors], timeout=600)
    assert out == list(range(200))
    for a in actors:
        ray_tpu_torch.kill(a)


@pytest.mark.timeout(900)
def test_50_placement_groups(big_cluster):
    """50 simultaneous placement groups become ready and host work
    (reference bar: 1k+ cluster-wide)."""
    from ray_tpu_torch.util.placement_group import placement_group, remove_placement_group
    from ray_tpu_torch.util.scheduling_strategies import PlacementGroupSchedulingStrategy

    @ray_tpu_torch.remote(num_cpus=1)
    def inside():
        return 1

    pgs = [placement_group([{"CPU": 1}]) for _ in range(50)]
    for pg in pgs:
        assert pg.wait(timeout=120)
    refs = [
        inside.options(
            scheduling_strategy=PlacementGroupSchedulingStrategy(placement_group=pg)
        ).remote()
        for pg in pgs
    ]
    assert sum(ray_tpu_torch.get(refs, timeout=600)) == 50
    for pg in pgs:
        remove_placement_group(pg)


@pytest.mark.timeout(1800)
def test_100k_queued_tasks(big_cluster):
    """100,000 tasks queued at once all complete (reference bar: 1M queued
    on one m4.16xlarge — this is the 10% point on a 1-core CI host)."""

    @ray_tpu_torch.remote(num_cpus=8)  # bound worker-process count to ~32
    def tick(i):
        return i

    t0 = time.perf_counter()
    refs = [tick.remote(i) for i in range(100_000)]
    t_submit = time.perf_counter() - t0
    out = ray_tpu_torch.get(refs, timeout=1500)
    t_total = time.perf_counter() - t0
    assert out == list(range(100_000))
    print(
        f"\n100k queued tasks: submit {100_000 / t_submit:.0f}/s, "
        f"end-to-end {100_000 / t_total:.0f}/s"
    )


@pytest.mark.timeout(1800)
def test_1000_actors(big_cluster):
    """1,000 concurrent actors all answer (reference bar: 40k across a
    64-host cluster). Worker-process spawn is the expected wall on one
    host; the print records where the control plane saturates."""

    @ray_tpu_torch.remote(num_cpus=0.25)
    class Cell:
        def __init__(self, i):
            self.i = i

        def who(self):
            return self.i

    t0 = time.perf_counter()
    actors = [Cell.remote(i) for i in range(1000)]
    out = ray_tpu_torch.get([a.who.remote() for a in actors], timeout=1500)
    dt = time.perf_counter() - t0
    assert out == list(range(1000))
    print(f"\n1000 actors alive+answering in {dt:.0f}s ({1000 / dt:.1f}/s)")
    for a in actors:
        ray_tpu_torch.kill(a)


@pytest.mark.timeout(1800)
def test_200_placement_groups(big_cluster):
    """200 simultaneous placement groups become ready and host work
    (reference bar: 1k+ cluster-wide)."""
    from ray_tpu_torch.util.placement_group import (
        placement_group,
        remove_placement_group,
    )
    from ray_tpu_torch.util.scheduling_strategies import (
        PlacementGroupSchedulingStrategy,
    )

    @ray_tpu_torch.remote(num_cpus=1)
    def inside():
        return 1

    t0 = time.perf_counter()
    pgs = [placement_group([{"CPU": 1}]) for _ in range(200)]
    for pg in pgs:
        assert pg.wait(timeout=600)
    t_ready = time.perf_counter() - t0
    refs = [
        inside.options(
            scheduling_strategy=PlacementGroupSchedulingStrategy(
                placement_group=pg
            )
        ).remote()
        for pg in pgs
    ]
    assert sum(ray_tpu_torch.get(refs, timeout=900)) == 200
    print(f"\n200 PGs ready in {t_ready:.1f}s")
    for pg in pgs:
        remove_placement_group(pg)


@pytest.mark.timeout(1800)
def test_256mb_broadcast_to_8_nodes(torch_shutdown_only):  # noqa: F811
    """One 256 MB object broadcast to tasks pinned on 8 raylets — the
    PushManager fan-out pattern (reference bar: 1 GiB to 50+ nodes)."""
    import numpy as np

    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy

    cluster = Cluster()
    head = cluster.add_node(num_cpus=2, object_store_memory=600 * 1024 * 1024)
    ray_tpu_torch.init(address=cluster.address)
    nodes = [head] + [
        cluster.add_node(
            num_cpus=2, object_store_memory=600 * 1024 * 1024
        )
        for _ in range(7)
    ]

    @ray_tpu_torch.remote(num_cpus=1)
    def digest(arr):
        return int(arr[0]), int(arr[-1]), arr.nbytes

    payload = np.arange(256 * 1024 * 1024 // 8, dtype=np.float64)
    ref = ray_tpu_torch.put(payload)
    t0 = time.perf_counter()
    refs = [
        digest.options(
            scheduling_strategy=NodeAffinitySchedulingStrategy(
                node_id=n.node_id, soft=False
            )
        ).remote(ref)
        for n in nodes
    ]
    out = ray_tpu_torch.get(refs, timeout=900)
    dt = time.perf_counter() - t0
    assert all(o == (0, len(payload) - 1, payload.nbytes) for o in out)
    total_gb = 256 / 1024 * len(nodes)
    print(
        f"\n256MB broadcast to {len(nodes)} nodes in {dt:.1f}s "
        f"({total_gb / dt:.2f} GB/s aggregate)"
    )
    cluster.shutdown()
