"""Application metrics API: Counter / Gauge / Histogram.

Analog of python/ray/util/metrics (backed by the reference's OpenCensus C++
pipeline, src/ray/stats/metric.h): metrics recorded anywhere in the cluster
are aggregated in the GCS KV by (name, labels) and exported in Prometheus
text format by the dashboard's /metrics endpoint (the reference's
MetricsAgent role, python/ray/_private/metrics_agent.py:483).
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

METRICS_NS = "_metrics"
_FLUSH_INTERVAL_S = 2.0

_registry_lock = threading.Lock()
_registry: List["Metric"] = []
_flusher_started = False


def _labels_key(labels: Dict[str, str]) -> str:
    return json.dumps(sorted(labels.items()))


class Metric:
    kind = "untyped"

    def __init__(
        self,
        name: str,
        description: str = "",
        tag_keys: Optional[Sequence[str]] = None,
    ):
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys or ())
        self._default_tags: Dict[str, str] = {}
        self._values: Dict[str, float] = {}
        self._lock = threading.Lock()
        with _registry_lock:
            _registry.append(self)
        _ensure_flusher()

    def set_default_tags(self, tags: Dict[str, str]) -> "Metric":
        self._default_tags = dict(tags)
        return self

    def _resolve_tags(self, tags: Optional[Dict[str, str]]) -> Dict[str, str]:
        merged = dict(self._default_tags)
        if tags:
            merged.update(tags)
        extra = set(merged) - set(self.tag_keys)
        if extra:
            raise ValueError(f"undeclared tag keys {extra} for metric {self.name}")
        return merged

    def _snapshot(self) -> List[Tuple[str, float]]:
        with self._lock:
            return list(self._values.items())


class Counter(Metric):
    kind = "counter"

    def inc(self, value: float = 1.0, tags: Optional[Dict[str, str]] = None) -> None:
        if value < 0:
            raise ValueError("counters only increase")
        key = _labels_key(self._resolve_tags(tags))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value


class Gauge(Metric):
    kind = "gauge"

    def set(self, value: float, tags: Optional[Dict[str, str]] = None) -> None:
        key = _labels_key(self._resolve_tags(tags))
        with self._lock:
            self._values[key] = float(value)


class Histogram(Metric):
    kind = "histogram"

    def __init__(
        self,
        name: str,
        description: str = "",
        boundaries: Optional[Sequence[float]] = None,
        tag_keys: Optional[Sequence[str]] = None,
    ):
        super().__init__(name, description, tag_keys)
        self.boundaries = list(boundaries or [0.01, 0.1, 1, 10, 100])
        self._counts: Dict[str, List[int]] = {}
        self._sums: Dict[str, float] = {}
        self._totals: Dict[str, int] = {}

    def observe(self, value: float, tags: Optional[Dict[str, str]] = None) -> None:
        key = _labels_key(self._resolve_tags(tags))
        with self._lock:
            counts = self._counts.setdefault(key, [0] * (len(self.boundaries) + 1))
            for i, b in enumerate(self.boundaries):
                if value <= b:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1

    def _snapshot_hist(self):
        with self._lock:
            return (
                {k: list(v) for k, v in self._counts.items()},
                dict(self._sums),
                dict(self._totals),
            )


def _collect_local() -> Dict[str, dict]:
    """Serialize this process's metric state for the GCS."""
    out: Dict[str, dict] = {}
    with _registry_lock:
        metrics = list(_registry)
    for m in metrics:
        entry = out.setdefault(
            m.name,
            {"kind": m.kind, "description": m.description, "series": {}},
        )
        if isinstance(m, Histogram):
            counts, sums, totals = m._snapshot_hist()
            entry["boundaries"] = m.boundaries
            for key in counts:
                entry["series"][key] = {
                    "counts": counts[key],
                    "sum": sums[key],
                    "total": totals[key],
                }
        else:
            for key, v in m._snapshot():
                entry["series"][key] = v
    return out


def _flush_once() -> None:
    from ray_tpu_torch._private import worker as worker_mod

    w = worker_mod.global_worker
    if not w.connected:
        return
    core = w.core
    payload = _collect_local()
    if not payload:
        return
    # Stamped so the dashboard can age out snapshots from dead workers
    # (a worker that stops flushing must not serve its last values forever).
    payload["_ts"] = time.time()
    key = f"{core.worker_id}"

    async def _push():
        await core.gcs.kv_put(key, json.dumps(payload).encode(), ns=METRICS_NS)

    try:
        w.run_async(_push(), timeout=5)
    except Exception:
        pass


def _ensure_flusher() -> None:
    global _flusher_started
    with _registry_lock:
        if _flusher_started:
            return
        _flusher_started = True

    def loop():
        while True:
            time.sleep(_FLUSH_INTERVAL_S)
            _flush_once()

    threading.Thread(target=loop, name="ray_tpu_torch_metrics_flush", daemon=True).start()


# -- export (dashboard side) ---------------------------------------------------


def render_prometheus(per_worker: Dict[str, dict]) -> str:
    """Merge per-worker snapshots into Prometheus text exposition format."""
    merged: Dict[str, dict] = {}
    for snapshot in per_worker.values():
        for name, entry in snapshot.items():
            if name.startswith("_"):  # bookkeeping keys ("_ts"), not metrics
                continue
            dst = merged.setdefault(
                name,
                {
                    "kind": entry["kind"],
                    "description": entry.get("description", ""),
                    "boundaries": entry.get("boundaries"),
                    "series": {},
                },
            )
            for key, v in entry["series"].items():
                if entry["kind"] == "histogram":
                    cur = dst["series"].setdefault(
                        key,
                        {"counts": [0] * (len(entry["boundaries"]) + 1), "sum": 0.0, "total": 0},
                    )
                    cur["counts"] = [
                        a + b for a, b in zip(cur["counts"], v["counts"])
                    ]
                    cur["sum"] += v["sum"]
                    cur["total"] += v["total"]
                elif entry["kind"] == "counter":
                    dst["series"][key] = dst["series"].get(key, 0.0) + v
                else:
                    dst["series"][key] = v  # gauge: last writer wins

    lines: List[str] = []
    for name, entry in sorted(merged.items()):
        pname = name.replace(".", "_").replace("-", "_")
        if entry["description"]:
            lines.append(f"# HELP {pname} {entry['description']}")
        lines.append(f"# TYPE {pname} {entry['kind']}")
        for key, v in entry["series"].items():
            labels = dict(json.loads(key))
            label_str = ",".join(f'{k}="{val}"' for k, val in sorted(labels.items()))
            braces = f"{{{label_str}}}" if label_str else ""
            if entry["kind"] == "histogram":
                cum = 0
                for bound, c in zip(entry["boundaries"], v["counts"]):
                    cum += c
                    lb = label_str + ("," if label_str else "") + f'le="{bound}"'
                    lines.append(f"{pname}_bucket{{{lb}}} {cum}")
                cum += v["counts"][-1]
                lb = label_str + ("," if label_str else "") + 'le="+Inf"'
                lines.append(f"{pname}_bucket{{{lb}}} {cum}")
                lines.append(f"{pname}_sum{braces} {v['sum']}")
                lines.append(f"{pname}_count{braces} {v['total']}")
            else:
                lines.append(f"{pname}{braces} {v}")
    return "\n".join(lines) + "\n"
