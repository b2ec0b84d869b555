"""The reference's tests/test_telemetry.py on the port, case for case after
the rename (ray_tpu -> ray_tpu_torch, num_tpus -> num_gpus, the conftest
fixtures -> ray_tpu_torch.testing's). The rename reaches the strings that
name the package too: the port renders its series as ray_tpu_torch_*, so
the rendered names the cases look for are ray_tpu_torch_t7rend_*,
ray_tpu_torch_rpc_deadline_* and ray_tpu_torch_<component>_*. The
environment variables keep their RAY_TPU_* names, which the port reads. No
case differs otherwise.

Runtime telemetry plane: snapshot-and-reset flush semantics, the GCS
aggregate + Prometheus rendering, flush-on-exit from worker subprocesses,
the merged dashboard /metrics export, the chaos flight-recorder dump, and
the telemetry-unregistered-stat lint rule."""

import json
import time
import urllib.request

import pytest

from ray_tpu_torch._private import telemetry
from ray_tpu_torch.testing import torch_shutdown_only  # noqa: F401

# The registry is process-global and other tests leave series behind
# (rpc frame counters, raylet gauges, ...). Every test here uses a unique
# component namespace and asserts on its own families only.


def _series(payload, comp, name):
    """The wire entry for (comp, name) in a flush payload, or None."""
    if payload is None:
        return None
    for m in payload["metrics"]:
        if m["c"] == comp and m["n"] == name:
            return m
    return None


# ------------------------------------------------------- flush semantics


def test_counter_flush_is_exactly_once():
    fam = telemetry.counter("t7flush", "reqs", "test counter")
    fam.cell(k="a").inc(2)
    fam.cell(k="b").inc(3)

    p1 = telemetry.flush_delta("src", "node1")
    m = _series(p1, "t7flush", "reqs")
    assert m is not None and m["k"] == "counter"
    assert sum(v for _, v in m["s"]) == 5.0

    # Drained: the same family contributes nothing to the next flush.
    p2 = telemetry.flush_delta("src", "node1")
    assert _series(p2, "t7flush", "reqs") is None

    # New increments after the flush land in the next delta, undoubled.
    fam.cell(k="a").inc()
    p3 = telemetry.flush_delta("src", "node1")
    m3 = _series(p3, "t7flush", "reqs")
    assert sum(v for _, v in m3["s"]) == 1.0


def test_gauge_reports_and_keeps():
    g = telemetry.gauge("t7flush", "depth", "test gauge").default
    g.set(7.0)
    for _ in range(2):  # gauges survive flushes: last value, every time
        p = telemetry.flush_delta("src", "node1")
        m = _series(p, "t7flush", "depth")
        assert m is not None and m["s"][0][1] == 7.0


def test_histogram_buckets_and_reset():
    h = telemetry.histogram(
        "t7flush", "lat_s", "test histogram", buckets=(0.1, 1.0)
    ).default
    for v in (0.05, 0.5, 5.0):
        h.observe(v)

    p = telemetry.flush_delta("src", "node1")
    m = _series(p, "t7flush", "lat_s")
    assert m["b"] == [0.1, 1.0]
    _, val = m["s"][0]
    assert val["counts"] == [1, 1, 1]  # one per bucket + one overflow
    assert val["total"] == 3 and abs(val["sum"] - 5.55) < 1e-9

    # Histograms drain like counters.
    assert _series(telemetry.flush_delta("s", "n"), "t7flush", "lat_s") is None


def test_restore_delta_roundtrips_an_undelivered_flush():
    fam = telemetry.counter("t7restore", "sent", "test")
    fam.cell(ch="x").inc(4)
    h = telemetry.histogram("t7restore", "d_s", "test", buckets=(1.0,)).default
    h.observe(0.5)
    telemetry.record_event("t7restore", "probe", n=1)

    p = telemetry.flush_delta("src", "node1")
    assert p is not None and p.get("events")
    telemetry.restore_delta(p)  # the send failed; fold it back

    p2 = telemetry.flush_delta("src", "node1")
    for name in ("sent", "d_s"):
        assert _series(p2, "t7restore", name) == _series(p, "t7restore", name)
    assert p2["events"] == p["events"]


def test_flight_recorder_drain_and_flush_payload():
    telemetry.flight().clear()
    telemetry.record_event("t7ring", "one", a=1)
    telemetry.record_event("t7ring", "two", b=2)
    assert len(telemetry.flight()) == 2

    p = telemetry.flush_delta("src", "node1")
    evs = [e for e in p["events"] if e[1] == "t7ring"]
    assert [e[2] for e in evs] == ["one", "two"]
    assert len(telemetry.flight()) == 0  # drained with the flush


# --------------------------------------------- aggregate + Prometheus text


def _payload(node, metrics):
    return {"source": node, "node": node, "metrics": metrics}


def test_ingest_and_render_runtime_prometheus():
    agg = telemetry.new_aggregate()
    ctr = {
        "c": "t7rend", "n": "reqs", "k": "counter", "h": "test reqs",
        "b": None, "s": [['{"dep": "x"}', 3.0]],
    }
    gau = {
        "c": "t7rend", "n": "depth", "k": "gauge", "h": "", "b": None,
        "s": [["{}", 9.0]],
    }
    hist = {
        "c": "t7rend", "n": "lat_s", "k": "histogram", "h": "", "b": [0.1, 1.0],
        "s": [["{}", {"counts": [1, 1, 1], "sum": 5.55, "total": 3}]],
    }
    telemetry.ingest(agg, _payload("n1", [ctr, gau, hist]), now=1000.0)
    telemetry.ingest(agg, _payload("n2", [ctr]), now=1000.0)
    telemetry.ingest(agg, _payload("n1", [ctr]), now=1000.0)  # delta folds

    wds = {"met": 5, "shed": 1, "enforced": 2, "overruns": [["w", "m", 1.0]]}
    text = telemetry.render_runtime_prometheus(
        agg, worker_deadline_stats=wds, now=1010.0, stale_after_s=30.0
    )
    # Counter: deltas accumulate per (node, labels); name gets _total.
    assert '# TYPE ray_tpu_torch_t7rend_reqs_total counter' in text
    assert '# HELP ray_tpu_torch_t7rend_reqs_total test reqs' in text
    assert 'ray_tpu_torch_t7rend_reqs_total{dep="x",node="n1"} 6.0' in text
    assert 'ray_tpu_torch_t7rend_reqs_total{dep="x",node="n2"} 3.0' in text
    # Gauge: last value with its node label.
    assert 'ray_tpu_torch_t7rend_depth{node="n1"} 9.0' in text
    # Histogram: cumulative buckets, +Inf, sum/count.
    assert 'ray_tpu_torch_t7rend_lat_s_bucket{node="n1",le="0.1"} 1' in text
    assert 'ray_tpu_torch_t7rend_lat_s_bucket{node="n1",le="+Inf"} 3' in text
    assert 'ray_tpu_torch_t7rend_lat_s_count{node="n1"} 3' in text
    # worker_deadline_stats appears as the deadline families under the
    # dedicated aggregate pseudo-node.
    assert 'ray_tpu_torch_rpc_deadline_met_total{node="_worker_aggregate"} 5.0' in text
    assert (
        'ray_tpu_torch_rpc_deadline_overruns_total{node="_worker_aggregate"} 1.0'
        in text
    )

    # A gauge whose source stopped flushing ages out; counters do not.
    stale = telemetry.render_runtime_prometheus(
        agg, now=1000.0 + 120.0, stale_after_s=30.0
    )
    assert 'ray_tpu_torch_t7rend_depth{node="n1"}' not in stale
    assert 'ray_tpu_torch_t7rend_reqs_total{dep="x",node="n1"} 6.0' in stale


def test_merged_timeline_orders_and_dumps_jsonl(tmp_path):
    a = [(3.0, "raylet", "lease_granted", {"lease": "l1"})]
    b = [
        (1.0, "object", "sealed", {"oid": "o1"}),
        (2.0, "rpc", "retry", {"channel": "gcs"}),
    ]
    timeline = telemetry.merged_timeline(a, b)
    assert [e["ts"] for e in timeline] == [1.0, 2.0, 3.0]
    assert timeline[0] == {"ts": 1.0, "component": "object", "event": "sealed",
                           "oid": "o1"}

    path = tmp_path / "flight.jsonl"
    assert telemetry.dump_timeline(str(path), a, b) == 3
    lines = [json.loads(l) for l in path.read_text().splitlines()]
    assert [e["event"] for e in lines] == ["sealed", "retry", "lease_granted"]


# ------------------------------------------------------------- lint rule


def test_telemetry_lint_flags_adhoc_stats_and_honors_waiver(tmp_path):
    from ray_tpu_torch.devtools import telemetry_lint

    pkg = tmp_path / "_private"
    pkg.mkdir()
    bad = pkg / "mod.py"
    bad.write_text(
        "class C:\n"
        "    def __init__(self):\n"
        "        self.stats = {'a': 0}\n"
        "        self.push_stats = {'b': 0}  # telemetry: allow-adhoc-stats\n"
        "        # telemetry: allow-adhoc-stats\n"
        "        self.pull_stats = {'c': 0}\n"
        "        self.status = {'not': 'stats'}\n"
    )
    findings = telemetry_lint.lint_file(str(bad))
    assert len(findings) == 1 and findings[0].line == 3
    assert findings[0].rule == "telemetry-unregistered-stat"

    # Outside a _private package the rule does not apply.
    ok = tmp_path / "mod.py"
    ok.write_text("stats = {'a': 0}\n")
    assert telemetry_lint.lint_file(str(ok)) == []


# --------------------------------------------------------- cluster e2e


def test_worker_exit_flushes_telemetry_to_gcs(torch_shutdown_only, monkeypatch):
    """Counters recorded inside a worker subprocess survive its managed
    exit: handle_exit's bounded final ReportTelemetry reaches the GCS
    aggregate even with periodic flushing disabled."""
    # Periodic flush off everywhere: delivery below can only be the
    # worker's flush-on-exit.
    monkeypatch.setenv("RAY_TPU_TELEMETRY_FLUSH_INTERVAL_S", "0")
    import ray_tpu_torch
    from ray_tpu_torch._private import worker as worker_mod

    telemetry.reset_flusher_for_test()
    ray_tpu_torch.init(num_cpus=2, num_gpus=0)

    @ray_tpu_torch.remote
    def bump():
        from ray_tpu_torch._private import telemetry as t

        t.counter("t7exit", "worker_bump", "test").cell(tag="x").inc(3)
        t.record_event("t7exit", "bumped", tag="x")
        return 1

    assert ray_tpu_torch.get(bump.remote()) == 1

    w = worker_mod.global_worker
    node = w.node
    gcs = node.gcs_server
    assert gcs is not None

    async def _exit_workers():
        # Graceful Exit: the reply only comes back after handle_exit has
        # awaited its final ReportTelemetry, so this is race-free.
        for wk in list(node.raylet.workers.values()):
            if wk.conn is not None and not wk.conn.closed:
                try:
                    await wk.conn.call("Exit", {}, timeout=10)
                except Exception:
                    pass

    w.run_async(_exit_workers(), timeout=30)

    tbl = gcs.telemetry["counters"].get("t7exit.worker_bump", {})
    assert sum(tbl.values()) == 3.0, gcs.telemetry["counters"].keys()
    assert any(
        comp == "t7exit" and ev == "bumped"
        for _, comp, ev, _f in gcs.flight_events
    )


def test_dashboard_metrics_merges_app_and_runtime_series(torch_shutdown_only):
    """/metrics serves the app-metric export plus runtime series from all
    five instrumented components, including the deadline-stats family."""
    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch.dashboard.dashboard import Dashboard
    from ray_tpu_torch.util import metrics as app_metrics

    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    try:
        # Object + rpc + raylet + gcs traffic (past the 100 KiB inline
        # threshold so the put goes through the shm store client).
        ref = ray_tpu_torch.put(b"x" * (1 << 20))
        assert len(ray_tpu_torch.get(ref)) == 1 << 20

        @ray_tpu_torch.remote
        def f():
            return 1

        assert ray_tpu_torch.get(f.remote()) == 1

        # Serve traffic (the handle router records per-deployment series).
        @serve.deployment
        class Doubler:
            def __call__(self, x):
                return x * 2

        handle = serve.run(Doubler.bind(), route_prefix=None)
        assert handle.remote(21).result(timeout_s=30) == 42

        # An application metric, flushed to the GCS KV snapshot store.
        app_metrics.Counter("t7_app_requests", "app-side test counter").inc(5)
        app_metrics._flush_once()

        # Deterministic runtime flush: in-process cluster -> one shared
        # registry; a single explicit report carries every component.
        w = worker_mod.global_worker
        w.run_async(
            telemetry.flush_once(w.core.gcs.call, "driver", "drivernode"),
            timeout=10,
        )

        gcs_addr = w.node.gcs_addr
        dash = Dashboard(gcs_addr, port=0)
        host, port = w.run_async(dash.start())
        try:
            body = urllib.request.urlopen(
                f"http://{host}:{port}/metrics", timeout=10
            ).read().decode()
        finally:
            w.run_async(dash.stop())

        # App-metric pipeline present, bookkeeping stamp not rendered.
        assert "t7_app_requests" in body
        assert not any(l.startswith("_ts") for l in body.splitlines())
        # Runtime series from every instrumented component.
        for comp in ("rpc", "raylet", "object", "gcs", "serve"):
            assert f"ray_tpu_torch_{comp}_" in body, f"missing {comp} series"
        # The deadline family, including the GCS worker aggregate.
        assert "ray_tpu_torch_rpc_deadline_met_total" in body
        assert 'node="_worker_aggregate"' in body
    finally:
        serve.shutdown()


def test_chaos_violation_dumps_flight_timeline(torch_shutdown_only, tmp_path,
                                               monkeypatch):
    """A failing chaos seed writes flight_<scenario>_<seed>.jsonl next to
    the corpus: a non-empty, time-ordered merged timeline."""
    from ray_tpu_torch.chaos import invariants
    from ray_tpu_torch.chaos.runner import SCENARIOS, run_scenario

    async def forced_violation(cluster):
        return ["forced: flight-dump test"]

    monkeypatch.setattr(invariants, "check", forced_violation)

    corpus = tmp_path / "chaos_corpus.jsonl"
    results = run_scenario(SCENARIOS["rpc_delay"], seeds=[0], corpus=str(corpus))
    assert [r.ok for r in results] == [False]

    dump = tmp_path / "flight_rpc_delay_0.jsonl"
    assert dump.exists(), list(tmp_path.iterdir())
    events = [json.loads(l) for l in dump.read_text().splitlines()]
    assert events, "flight dump must not be empty"
    ts = [e["ts"] for e in events]
    assert ts == sorted(ts)
    for e in events:
        assert {"ts", "component", "event"} <= set(e)
    # The workload's lifecycle edges made it into the timeline.
    assert any(e["component"] in ("raylet", "object", "gcs") for e in events)
