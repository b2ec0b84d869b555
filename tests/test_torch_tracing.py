"""The reference's tests/test_tracing.py on the port, case for case after the
rename (ray_tpu -> ray_tpu_torch, num_tpus -> num_gpus, the conftest fixtures
-> ray_tpu_torch.testing's). No case differs.

Task tracing spans with context propagation (reference:
python/ray/util/tracing/tracing_helper.py — spans injected into TaskSpec,
parent-child linkage across submit/execute boundaries)."""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.testing import torch_shutdown_only  # noqa: F401
from ray_tpu_torch.util.state import api as state_api


@pytest.fixture
def traced_cluster(monkeypatch, torch_shutdown_only):
    monkeypatch.setenv("RAY_TPU_TASK_TRACE_SPANS", "1")
    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield


def _spans_by_kind(spans):
    return (
        {s["task_id"]: s for s in spans if s["kind"] == "submit"},
        {s["task_id"]: s for s in spans if s["kind"] == "execute"},
    )


def _wait_spans(min_count, trace_id=None, timeout=20):
    deadline = time.time() + timeout
    while time.time() < deadline:
        spans = state_api.list_spans(trace_id)
        if len(spans) >= min_count:
            return spans
        time.sleep(0.25)
    raise AssertionError(
        f"expected >={min_count} spans, got {state_api.list_spans(trace_id)}"
    )


def test_parent_child_spans_across_task_chain(traced_cluster):
    """Driver submits `outer`, which submits `inner`: all four spans share
    one trace id and link parent->child across the process boundaries."""

    @ray_tpu_torch.remote
    def inner(x):
        return x + 1

    @ray_tpu_torch.remote
    def outer(x):
        return ray_tpu_torch.get(inner.remote(x)) * 10

    assert ray_tpu_torch.get(outer.remote(1)) == 20
    spans = _wait_spans(4)
    submits, executes = _spans_by_kind(spans)
    # Identify the tasks by name.
    outer_exec = next(s for s in executes.values() if s["name"] == "outer")
    inner_exec = next(s for s in executes.values() if s["name"] == "inner")
    outer_sub = submits[outer_exec["task_id"]]
    inner_sub = submits[inner_exec["task_id"]]

    # One trace end to end.
    tid = outer_sub["trace_id"]
    assert tid and all(
        s["trace_id"] == tid
        for s in (outer_exec, inner_sub, inner_exec)
    )
    # Driver-side submit of `outer` is the root.
    assert outer_sub["parent_span_id"] is None
    # execute(outer) is a child of submit(outer).
    assert outer_exec["parent_span_id"] == outer_sub["span_id"]
    # submit(inner) happened INSIDE execute(outer) on the worker.
    assert inner_sub["parent_span_id"] == outer_exec["span_id"]
    # execute(inner) is a child of submit(inner).
    assert inner_exec["parent_span_id"] == inner_sub["span_id"]
    # Execute spans carry durations.
    assert inner_exec["duration"] >= 0.0


def test_actor_method_spans(traced_cluster):
    @ray_tpu_torch.remote
    class A:
        def work(self, x):
            return x * 2

    a = A.remote()
    assert ray_tpu_torch.get(a.work.remote(3)) == 6
    spans = _wait_spans(2)
    submits, executes = _spans_by_kind(spans)
    ex = next(s for s in executes.values() if s["name"] == "work")
    sub = submits[ex["task_id"]]
    assert ex["parent_span_id"] == sub["span_id"]
    assert ex["trace_id"] == sub["trace_id"]


def test_spans_in_timeline(traced_cluster):
    @ray_tpu_torch.remote
    def f():
        return 1

    ray_tpu_torch.get(f.remote())
    _wait_spans(2)
    events = state_api.timeline()
    span_events = [e for e in events if e["cat"] == "span"]
    assert span_events, "timeline must export span events"
    ev = span_events[0]
    assert ev["args"]["trace_id"] and ev["args"]["span_id"]


def test_tracing_disabled_by_default(torch_shutdown_only):
    ray_tpu_torch.init(num_cpus=2, num_gpus=0)

    @ray_tpu_torch.remote
    def f():
        return 1

    ray_tpu_torch.get(f.remote())
    time.sleep(1.0)
    assert state_api.list_spans() == []


# ----------------------------------------------------------- runtime spans


def _wait_until(pred, timeout=25):
    deadline = time.time() + timeout
    spans = []
    while time.time() < deadline:
        spans = state_api.list_spans()
        if pred(spans):
            return spans
        time.sleep(0.25)
    raise AssertionError(
        f"condition not met; have {sorted({(s['name'], s['kind']) for s in spans})}"
    )


def _assert_connected(trace):
    """Every span in the trace reaches a root through parent links that
    stay inside the trace (roots are spans whose parent is unrecorded)."""
    ids = {s["span_id"]: s for s in trace if s.get("span_id")}
    for s in trace:
        hops, cur = 0, s
        while cur.get("parent_span_id") in ids:
            cur = ids[cur["parent_span_id"]]
            hops += 1
            assert hops < len(trace) + 1, "parent cycle"


def test_task_trace_includes_lease_lifecycle(traced_cluster):
    """One task chain yields ONE connected trace spanning >= 3 processes
    with the raylet's lease lifecycle (request->queue->grant), the arg
    fetch, and the execute spans all parented into it."""

    @ray_tpu_torch.remote
    def inner(x):
        return x + 1

    @ray_tpu_torch.remote
    def outer(x):
        return ray_tpu_torch.get(inner.remote(x)) * 10

    assert ray_tpu_torch.get(outer.remote(1)) == 20
    spans = _wait_until(
        lambda ss: {"lease", "execute", "arg_fetch"}
        <= {s["kind"] for s in ss}
    )
    traces = {s["trace_id"] for s in spans}
    assert len(traces) == 1, f"expected one trace, got {traces}"
    names = {s["name"] for s in spans}
    assert {"raylet.lease", "lease.queue", "lease.grant"} <= names, names
    _assert_connected(spans)
    # Driver, raylet/GCS, and at least one worker reported into the trace.
    assert len({s.get("worker_id") for s in spans}) >= 3, spans


def test_serve_request_single_connected_trace(monkeypatch, torch_shutdown_only):
    """A cross-process serve request produces ONE connected trace: the
    router's request root, admission, per-item batch-queue wait, batched
    execution, and the replica-side actor-method execute span."""
    monkeypatch.setenv("RAY_TPU_TASK_TRACE_SPANS", "1")
    from ray_tpu_torch import serve

    ray_tpu_torch.init(num_cpus=8, num_gpus=0)
    try:

        @serve.deployment(
            num_replicas=1,
            max_ongoing_requests=16,
            max_batch_size=4,
            batch_wait_timeout_s=0.05,
        )
        class Tripler:
            async def __call__(self, batch):
                return [b * 3 for b in batch]

        handle = serve.run(Tripler.bind(), route_prefix=None)
        responses = [handle.remote(i) for i in range(4)]
        assert [r.result(timeout_s=30) for r in responses] == [0, 3, 6, 9]

        spans = _wait_until(
            lambda ss: {"serve.admission", "serve.batch_wait", "serve.batch_execute"}
            <= {s["name"] for s in ss}
        )
        roots = [s for s in spans if s["name"].startswith("serve.request::")]
        assert roots, f"no serve root span: {[s['name'] for s in spans]}"
        tid = roots[0]["trace_id"]
        trace = [s for s in spans if s["trace_id"] == tid]
        names = {s["name"] for s in trace}
        assert {"serve.admission", "serve.batch_wait"} <= names, names
        kinds = {s["kind"] for s in trace}
        assert "execute" in kinds, kinds  # replica-side method execution
        _assert_connected(trace)
        # Router (driver) and the replica worker both reported in.
        assert len({s.get("worker_id") for s in trace}) >= 2, trace
    finally:
        serve.shutdown()


def test_sampling_deterministic(monkeypatch):
    """Sampling is a pure function of (key, rate): every process agrees,
    repeated calls agree, and the sampled fraction tracks the rate."""
    from ray_tpu_torch.util import tracing

    monkeypatch.setattr(tracing.config, "task_trace_spans", False)
    monkeypatch.setattr(tracing.config, "trace_sample_rate", 0.3)
    keys = [f"task-{i:05d}" for i in range(2000)]
    first = [tracing._sample(k) for k in keys]
    assert first == [tracing._sample(k) for k in keys]
    frac = sum(first) / len(first)
    assert 0.2 < frac < 0.4, frac
    monkeypatch.setattr(tracing.config, "trace_sample_rate", 1.0)
    assert all(tracing._sample(k) for k in keys)
    monkeypatch.setattr(tracing.config, "trace_sample_rate", 0.0)
    assert not any(tracing._sample(k) for k in keys)


def test_sampled_mode_traces_end_to_end(monkeypatch, torch_shutdown_only):
    """trace_sample_rate=1.0 without task_trace_spans: sampled always-on
    mode still assembles complete traces."""
    monkeypatch.setenv("RAY_TPU_TRACE_SAMPLE_RATE", "1.0")
    ray_tpu_torch.init(num_cpus=2, num_gpus=0)

    @ray_tpu_torch.remote
    def f(x):
        return x + 1

    assert ray_tpu_torch.get(f.remote(1)) == 2
    spans = _wait_spans(2)
    assert {s["kind"] for s in spans} >= {"submit", "execute"}
    assert len({s["trace_id"] for s in spans}) == 1


def test_worker_exit_flushes_spans(monkeypatch, torch_shutdown_only):
    """Runtime spans buffered in a worker survive its managed exit: with
    the periodic flusher disabled, handle_exit's final ReportSpans is the
    only delivery path."""
    monkeypatch.setenv("RAY_TPU_TELEMETRY_FLUSH_INTERVAL_S", "0")
    monkeypatch.setenv("RAY_TPU_TASK_TRACE_SPANS", "1")
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch.util import tracing

    tracing.reset_flusher_for_test()
    tracing.reset()
    ray_tpu_torch.init(num_cpus=2, num_gpus=0)

    @ray_tpu_torch.remote
    def leak_span():
        from ray_tpu_torch.util import tracing as t

        t.record_span("test.exit_span", "test", time.time(), 0.001)
        return 1

    assert ray_tpu_torch.get(leak_span.remote()) == 1

    w = worker_mod.global_worker
    node = w.node

    async def _exit_workers():
        for wk in list(node.raylet.workers.values()):
            if wk.conn is not None and not wk.conn.closed:
                try:
                    await wk.conn.call("Exit", {}, timeout=10)
                except Exception:
                    pass

    w.run_async(_exit_workers(), timeout=30)
    spans = state_api.list_spans()
    assert any(s["name"] == "test.exit_span" for s in spans), [
        s["name"] for s in spans
    ]


def test_list_spans_gcs_side_filtering(traced_cluster):
    """trace_id filtering and the limit happen in the GCS handler, and the
    result only contains the requested trace."""

    @ray_tpu_torch.remote
    def f(x):
        return x

    assert ray_tpu_torch.get(f.remote(1)) == 1
    assert ray_tpu_torch.get(f.remote(2)) == 2
    spans = _wait_spans(4)
    traces = sorted({s["trace_id"] for s in spans})
    assert len(traces) == 2, traces
    only = state_api.list_spans(trace_id=traces[0])
    assert only and all(s["trace_id"] == traces[0] for s in only)
    assert len(state_api.list_spans(limit=1)) == 1


def test_critical_path_names_dominant(traced_cluster):
    @ray_tpu_torch.remote
    def slow():
        time.sleep(0.3)
        return 1

    @ray_tpu_torch.remote
    def outer():
        return ray_tpu_torch.get(slow.remote())

    assert ray_tpu_torch.get(outer.remote()) == 1
    _wait_spans(4)
    cp = state_api.critical_path()
    assert cp["trace_id"] and cp["total_s"] > 0
    assert cp["path"], cp
    names = [seg["name"] for seg in cp["path"]]
    assert cp["dominant"] in names
    # The chain bottoms out in the sleeping task, so it (or its executor
    # span) dominates self time.
    assert cp["segments"][0]["self_s"] >= 0.2, cp["segments"]


def test_wire_schemas_declare_trace():
    """Every wire schema takes a position on trace propagation, and the
    lint rule catches one that doesn't."""
    from ray_tpu_torch._private import wire
    from ray_tpu_torch.devtools import rpc_check

    assert rpc_check._check_trace_declared() == []
    undeclared = dict(wire.SCHEMAS)
    undeclared["BogusMethod"] = wire.WireSchema(
        frozenset(), frozenset(), wire.RETRY_SAFE, None, None, None
    )
    try:
        wire.SCHEMAS = undeclared
        findings = rpc_check._check_trace_declared()
        assert any(
            f.rule == "wire-trace-undeclared" and "BogusMethod" in f.message
            for f in findings
        ), findings
    finally:
        original = dict(undeclared)
        original.pop("BogusMethod")
        wire.SCHEMAS = original
