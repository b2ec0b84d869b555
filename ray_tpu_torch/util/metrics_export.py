"""Prometheus file-based service discovery + generated Grafana dashboards
(reference: python/ray/_private/metrics_agent.py:595
PrometheusServiceDiscoveryWriter and dashboard/modules/metrics/ — the
grafana_*_dashboard generators + file-SD output a stock Prometheus config
consumes via:

    scrape_configs:
      - job_name: ray_tpu_torch
        file_sd_configs:
          - files: ['/tmp/ray_tpu_torch/prom_metrics_service_discovery.json']
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional

DEFAULT_SD_FILENAME = "prom_metrics_service_discovery.json"


class PrometheusServiceDiscoveryWriter:
    """Periodically writes the cluster's metrics endpoints in Prometheus
    <file_sd_config> format: a JSON list of {"targets": [...], "labels":
    {...}} groups. Writes are atomic (tmp + rename) so Prometheus never
    reads a torn file."""

    def __init__(
        self,
        get_targets: Callable[[], List[str]],
        out_dir: str,
        filename: str = DEFAULT_SD_FILENAME,
        labels: Optional[Dict[str, str]] = None,
        interval_s: float = 5.0,
    ):
        self._get_targets = get_targets
        self.path = os.path.join(out_dir, filename)
        self.labels = {"job": "ray_tpu_torch", **(labels or {})}
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def write_once(self) -> str:
        targets = sorted(set(self._get_targets()))
        payload = [{"labels": self.labels, "targets": targets}]
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, self.path)
        return self.path

    def start(self) -> None:
        if self._thread is not None:
            return

        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.write_once()
                except Exception:
                    pass

        self.write_once()
        self._thread = threading.Thread(
            target=loop, daemon=True, name="prom-file-sd"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None


# -- Grafana ---------------------------------------------------------------

# Core panels generated for every cluster (reference:
# dashboard/modules/metrics/dashboards/default_dashboard_panels.py).
_DEFAULT_PANELS = [
    ("Scheduler Tasks", "ray_tpu_torch_tasks_total", "rate(ray_tpu_torch_tasks_total[1m])"),
    ("Live Actors", "ray_tpu_torch_actors", "ray_tpu_torch_actors"),
    ("Object Store Used Bytes", "ray_tpu_torch_object_store_used_bytes",
     "ray_tpu_torch_object_store_used_bytes"),
    ("Pending Worker Leases", "ray_tpu_torch_pending_leases",
     "ray_tpu_torch_pending_leases"),
    ("Node Count", "ray_tpu_torch_nodes", "ray_tpu_torch_nodes"),
]


def generate_grafana_dashboard(
    extra_metrics: Optional[List[str]] = None, title: str = "Ray TPU Core"
) -> dict:
    """A stock-importable Grafana dashboard JSON covering the core metrics
    plus any caller-registered metric names (each becomes a graph panel
    querying Prometheus for the metric)."""
    panels = []
    specs = list(_DEFAULT_PANELS) + [
        (name, name, name) for name in (extra_metrics or [])
    ]
    for i, (ptitle, _metric, expr) in enumerate(specs):
        panels.append(
            {
                "id": i + 1,
                "title": ptitle,
                "type": "timeseries",
                "datasource": {"type": "prometheus", "uid": "${datasource}"},
                "targets": [{"expr": expr, "refId": "A"}],
                "gridPos": {"h": 8, "w": 12, "x": 12 * (i % 2), "y": 8 * (i // 2)},
            }
        )
    return {
        "title": title,
        "uid": "ray-tpu-core",
        "schemaVersion": 39,
        "refresh": "10s",
        "time": {"from": "now-1h", "to": "now"},
        "templating": {
            "list": [
                {
                    "name": "datasource",
                    "type": "datasource",
                    "query": "prometheus",
                }
            ]
        },
        "panels": panels,
    }


def write_grafana_dashboards(out_dir: str, extra_metrics=None) -> str:
    """Write the generated dashboard JSON where a Grafana provisioning
    config can pick it up (reference: metrics head writes
    grafana/dashboards/*.json under the session dir)."""
    path = os.path.join(out_dir, "grafana", "dashboards")
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, "ray_tpu_torch_core_dashboard.json")
    with open(out, "w") as f:
        json.dump(generate_grafana_dashboard(extra_metrics), f, indent=2)
    return out
