"""ray_tpu_torch.loadgen: closed- and open-loop load harness for Serve.

Drives the in-process Router directly (no HTTP hop), so it measures the
serving stack — admission control, batching, routing, deadline enforcement —
rather than an HTTP client's connection pool. Two generators:

- **closed loop**: N concurrent issuers, each sending its next request only
  after the previous one completes. Measures sustainable throughput and the
  latency distribution at that throughput (classic closed-loop bias: it
  cannot overload the system, so it calibrates capacity).
- **open loop**: requests arrive on a fixed schedule regardless of
  completions (Poisson-free constant rate; see "Open Versus Closed" NSDI'06
  for why this is the one that exposes overload behavior). Run at a multiple
  of the closed-loop rate to verify the overload story: excess load must
  come back as *typed sheds* (DeploymentOverloadedError) or deadline cuts —
  never as admitted requests silently overrunning their deadline.

Results serialize to the same flat JSON shape as ray_perf, so
benchmarks/perf_gate.py gates serve_rps / serve_p99_ms alongside the core
runtime metrics.
"""

from __future__ import annotations

import asyncio
import json
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private import rpc, telemetry
from ray_tpu_torch._private.common import config
from ray_tpu_torch.serve._private.common import DeploymentOverloadedError

__all__ = [
    "PhaseResult",
    "closed_loop",
    "open_loop",
    "percentile",
    "run_smoke",
    "to_gate_json",
]


def percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted list (no numpy dep)."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


class PhaseResult:
    """Outcome counters + latency samples for one load phase.

    Every issued request lands in exactly one bucket:

    - ``ok``            completed within its deadline (goodput)
    - ``shed_queue_full`` / ``shed_deadline``  typed admission sheds
    - ``deadline_cut``  admitted, then cut at the wire deadline (typed
                        DeadlineExceeded / TimeoutError — enforced, not lost)
    - ``overruns``      admitted and returned SUCCESS after the deadline —
                        the invariant violation the harness exists to catch
    - ``errors``        anything else
    """

    def __init__(self, name: str):
        self.name = name
        self.issued = 0
        self.ok = 0
        self.shed_queue_full = 0
        self.shed_deadline = 0
        self.deadline_cut = 0
        self.overruns = 0
        self.errors = 0
        self.error_samples: List[str] = []
        self.latencies_ms: List[float] = []
        self.duration_s = 0.0

    @property
    def shed(self) -> int:
        return self.shed_queue_full + self.shed_deadline

    def summary(self) -> Dict[str, Any]:
        lat = sorted(self.latencies_ms)
        dur = max(self.duration_s, 1e-9)
        return {
            "issued": self.issued,
            "ok": self.ok,
            "rps": self.ok / dur,
            "offered_rps": self.issued / dur,
            "goodput_rps": self.ok / dur,
            "p50_ms": percentile(lat, 0.50),
            "p99_ms": percentile(lat, 0.99),
            "p999_ms": percentile(lat, 0.999),
            "shed_queue_full": self.shed_queue_full,
            "shed_deadline": self.shed_deadline,
            "deadline_cut": self.deadline_cut,
            "overruns": self.overruns,
            "errors": self.errors,
            "error_samples": list(self.error_samples),
            "duration_s": self.duration_s,
        }


async def _issue_one(
    router,
    deployment_id_str: str,
    payload: Any,
    timeout_s: float,
    res: PhaseResult,
) -> None:
    loop = asyncio.get_running_loop()
    t0 = loop.time()
    deadline = t0 + timeout_s
    res.issued += 1
    try:
        await router.assign_request(
            deployment_id_str,
            {"call_method": "__call__", "request_id": "", "multiplexed_model_id": ""},
            (payload,),
            {},
            timeout_s=timeout_s,
        )
        now = loop.time()
        if now > deadline + config.rpc_deadline_grace_s:
            # Success delivered past deadline + grace: the enforcement chain
            # (router wait_for, replica-side TTL) failed to cut it.
            res.overruns += 1
        else:
            res.ok += 1
            res.latencies_ms.append((now - t0) * 1000.0)
    except DeploymentOverloadedError as e:
        if e.reason == "queue_full":
            res.shed_queue_full += 1
        else:
            res.shed_deadline += 1
    except (rpc.DeadlineExceeded, TimeoutError, asyncio.TimeoutError):
        res.deadline_cut += 1
    except Exception as e:  # noqa: BLE001 - loadgen must survive any failure
        res.errors += 1
        if len(res.error_samples) < 5:
            res.error_samples.append(f"{type(e).__name__}: {e}")


async def closed_loop(
    router,
    deployment_id_str: str,
    *,
    concurrency: int,
    duration_s: float,
    timeout_s: float,
    payload: Any = 0,
) -> PhaseResult:
    """N issuers, each one-request-at-a-time, for duration_s."""
    loop = asyncio.get_running_loop()
    res = PhaseResult("closed")
    start = loop.time()
    end = start + duration_s

    async def issuer() -> None:
        while loop.time() < end:
            await _issue_one(router, deployment_id_str, payload, timeout_s, res)

    await asyncio.gather(*(issuer() for _ in range(concurrency)))
    res.duration_s = loop.time() - start
    return res


async def open_loop(
    router,
    deployment_id_str: str,
    *,
    rps: float,
    duration_s: float,
    timeout_s: float,
    payload: Any = 0,
) -> PhaseResult:
    """Constant-rate arrivals for duration_s, independent of completions.

    Arrivals are batched per scheduler tick (all requests whose arrival time
    has passed fire together), so the generator sustains tens of thousands
    of rps without a per-request sleep.
    """
    loop = asyncio.get_running_loop()
    res = PhaseResult("open")
    spacing = 1.0 / max(rps, 1e-9)
    start = loop.time()
    end = start + duration_s
    tasks: List[asyncio.Task] = []
    fired = 0
    while True:
        now = loop.time()
        if now >= end:
            break
        due = int((now - start) / spacing) + 1
        while fired < due:
            tasks.append(
                rpc.spawn(
                    _issue_one(router, deployment_id_str, payload, timeout_s, res)
                )
            )
            fired += 1
        await asyncio.sleep(max(spacing, 0.0005))
    if tasks:
        await asyncio.gather(*tasks, return_exceptions=True)
    res.duration_s = loop.time() - start
    return res


def to_gate_json(closed: PhaseResult, open_: PhaseResult) -> Dict[str, Any]:
    """Flatten both phases into the perf-gate results shape. Closed-loop
    supplies throughput + latency percentiles (measured un-overloaded);
    open-loop supplies goodput + shed counts under overload."""
    c, o = closed.summary(), open_.summary()
    return {
        "serve_rps": c["rps"],
        "serve_p50_ms": c["p50_ms"],
        "serve_p99_ms": c["p99_ms"],
        "serve_p999_ms": c["p999_ms"],
        "serve_goodput_rps": o["goodput_rps"],
        "serve_offered_rps": o["offered_rps"],
        "serve_shed": open_.shed,
        "serve_deadline_cut": o["deadline_cut"],
        "serve_overruns": c["overruns"] + o["overruns"],
        "serve_errors": c["errors"] + o["errors"],
        "phases": {"closed": c, "open": o},
    }


def run_smoke(
    json_path: Optional[str] = None,
    *,
    closed_concurrency: int = 16,
    closed_duration_s: float = 2.0,
    open_duration_s: float = 2.0,
    overload_factor: float = 5.0,
    timeout_s: float = 1.0,
    num_replicas: int = 2,
    max_batch_size: int = 4,
    verbose: bool = True,
) -> Dict[str, Any]:
    """Self-contained smoke run: start a local cluster + Serve (HTTP off),
    deploy a batched echo, run closed-loop to calibrate, then open-loop at
    overload_factor x the calibrated rate. Returns the gate JSON dict."""
    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch.serve import handle as handle_mod

    owns_cluster = not ray_tpu_torch.is_initialized()
    if owns_cluster:
        ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    serve.start(http_options={"enabled": False})

    @serve.deployment(
        num_replicas=num_replicas,
        max_ongoing_requests=8,
        max_queued_requests=64,
        max_batch_size=max_batch_size,
        batch_wait_timeout_s=0.002,
    )
    class Echo:
        async def __call__(self, batch):
            # Batched calling convention: list in, same-length list out.
            await asyncio.sleep(0.001)
            return batch

    serve.run(Echo.bind(), route_prefix=None)
    dep = "default#Echo"

    async def _phases():
        router = await handle_mod._get_router()
        closed = await closed_loop(
            router,
            dep,
            concurrency=closed_concurrency,
            duration_s=closed_duration_s,
            timeout_s=timeout_s,
        )
        calibrated = closed.ok / max(closed.duration_s, 1e-9)
        opened = await open_loop(
            router,
            dep,
            rps=max(200.0, calibrated * overload_factor),
            duration_s=open_duration_s,
            timeout_s=timeout_s,
        )
        return closed, opened, router.stats().get(dep, {})

    w = worker_mod.global_worker
    try:
        closed, opened, router_stats = w.run_async(
            _phases(), timeout=closed_duration_s + open_duration_s + 60
        )
        # Runtime-telemetry snapshot (non-destructive) while the cluster is
        # still up: the serve/rpc/object counters the run just exercised.
        tel_snapshot = telemetry.peek("loadgen", "loadgen")
    finally:
        try:
            serve.shutdown()
        finally:
            if owns_cluster:
                ray_tpu_torch.shutdown()

    out = to_gate_json(closed, opened)
    out["router"] = router_stats
    out["telemetry"] = tel_snapshot
    if json_path:
        with open(json_path, "w") as f:
            json.dump(out, f, indent=2)
    if verbose:
        c, o = out["phases"]["closed"], out["phases"]["open"]
        print(
            f"closed : {c['rps']:8.1f} rps  "
            f"p50 {c['p50_ms']:6.1f}ms  p99 {c['p99_ms']:6.1f}ms  "
            f"p999 {c['p999_ms']:6.1f}ms  ({c['issued']} issued)"
        )
        print(
            f"open   : {o['offered_rps']:8.1f} offered rps -> "
            f"{o['goodput_rps']:8.1f} goodput rps  "
            f"shed {out['serve_shed']}  cut {o['deadline_cut']}  "
            f"overruns {out['serve_overruns']}  errors {out['serve_errors']}"
        )
    return out
