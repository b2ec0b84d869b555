"""The port's runtime yardstick (ray_tpu_torch._private.ray_perf) on the
CPU: its main reports the reference's keys, read from both modules'
source so that neither runs whole; the gloo group of 8 processes reduces
to the store actor's value bitwise; the cheap benches give rates above 0;
the entry point runs on the card unless asked for the CPU."""

import os

import numpy as np
import pytest

from ray_tpu_torch._private import ray_perf
from ray_tpu_torch.testing import torch_cluster  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_main_reports_the_reference_keys():
    port = ray_perf.result_keys(os.path.join(REPO, "ray_tpu_torch", "_private", "ray_perf.py"))
    ref = ray_perf.result_keys(os.path.join(REPO, "ray_tpu", "_private", "ray_perf.py"))
    assert port == ref
    assert len(ref) == 29
    assert {"tasks_sync_per_s", "leases_per_s", "collective_allreduce_speedup_x",
            "dag_channel_tensor_per_s", "trace_span_record_ns"} <= ref
    assert not set(ray_perf.CUDA_KEYS) & ref
    assert all("cuda" in k for k in ray_perf.CUDA_KEYS)


@pytest.mark.timeout(180)
def test_gloo_allreduce_equals_the_store_actor_bitwise():
    """MeshCollectives on 8 gloo processes and the store backend's actor
    reduce the bench's parts (rank r holds r + 1) to the same array."""
    gloo_rate, gloo = ray_perf._gloo_allreduce(8, 1)
    store_rate, store = ray_perf._store_allreduce(8, 1)
    assert gloo_rate > 0 and store_rate > 0
    assert gloo.dtype == store.dtype == np.float32 and gloo.shape == store.shape
    assert gloo.tobytes() == store.tobytes()
    assert float(gloo[0]) == sum(range(1, 9))


@pytest.mark.parametrize("bench", [
    "_bench_pubsub_fanout", "_bench_telemetry_overhead", "_bench_trace_span_record",
    "_bench_gcs_persist"])
def test_cheap_benches_give_values_above_zero(bench):
    assert getattr(ray_perf, bench)() > 0


@pytest.mark.timeout(120)
def test_dag_channel_moves_a_torch_tensor(torch_cluster):  # noqa: F811
    assert ray_perf._bench_dag_channel() > 0


def test_main_runs_on_the_card_unless_asked_for_the_cpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="--device cpu"):
        ray_perf.main(device="cuda")
    with pytest.raises(ValueError):
        ray_perf.main(device="tpu")
