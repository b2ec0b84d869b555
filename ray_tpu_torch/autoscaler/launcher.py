"""Cluster launcher: a YAML -> a running cluster (reference:
python/ray/scripts/scripts.py `ray up`/`ray down` at :1279/:1355 driving
autoscaler/_private/commands.py, schema python/ray/autoscaler/ray-schema.json).

The launcher turns a declarative cluster config into provider calls plus a
head bootstrap, then hands steady-state scaling to the Autoscaler:

    cluster_name: demo
    max_workers: 8
    idle_timeout_minutes: 5
    provider:
      type: fake | gce            # gce: + project_id / zone / runner opts
    head_node_type: head
    available_node_types:
      head:
        resources: {CPU: 4}
        min_workers: 0
        max_workers: 0
      worker:
        resources: {CPU: 4}
        min_workers: 2
        max_workers: 8

Provider `fake` boots everything in-process (cluster_utils raylets — the
reference's fake_multi_node provider pattern), which is also how the e2e
test exercises up/submit/scale/down without a cloud. Provider `gce` drives
GCEGPUNodeProvider (gcloud GPU-VM lifecycle with an injectable runner) and
bootstraps the head over `gcloud ... ssh --command "ray-tpu-torch start --head"`.
A node type's `resources` may hold `GPU`, a per-host count.
"""

from __future__ import annotations

import json
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ray_tpu_torch.autoscaler.autoscaler import Autoscaler, AutoscalerConfig
from ray_tpu_torch.autoscaler.node_provider import (
    FakeNodeProvider,
    GCEGPUNodeProvider,
)

logger = logging.getLogger(__name__)

# The port's own state directory: the two packages never read each other's
# cluster state.
_STATE_DIR = os.path.expanduser("~/.ray_tpu_torch")


class ClusterConfigError(ValueError):
    pass


@dataclass
class ClusterConfig:
    """Validated cluster YAML (reference schema: ray-schema.json)."""

    cluster_name: str
    provider: Dict[str, Any]
    head_node_type: str
    available_node_types: Dict[str, Dict[str, Any]]
    max_workers: int = 8
    idle_timeout_minutes: float = 5.0
    raw: Dict[str, Any] = field(default_factory=dict)

    REQUIRED = ("cluster_name", "provider", "head_node_type", "available_node_types")

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ClusterConfig":
        for key in cls.REQUIRED:
            if key not in d:
                raise ClusterConfigError(f"cluster config missing '{key}'")
        if not isinstance(d["available_node_types"], dict) or not d[
            "available_node_types"
        ]:
            raise ClusterConfigError("available_node_types must be a non-empty map")
        if d["head_node_type"] not in d["available_node_types"]:
            raise ClusterConfigError(
                f"head_node_type {d['head_node_type']!r} not in available_node_types"
            )
        ptype = (d.get("provider") or {}).get("type")
        if ptype not in ("fake", "gce"):
            raise ClusterConfigError(
                f"provider.type must be 'fake' or 'gce', got {ptype!r}"
            )
        for name, spec in d["available_node_types"].items():
            if "resources" not in spec:
                raise ClusterConfigError(f"node type {name!r} missing resources")
            if int(spec.get("min_workers", 0)) > int(
                spec.get("max_workers", d.get("max_workers", 8))
            ):
                raise ClusterConfigError(
                    f"node type {name!r}: min_workers > max_workers"
                )
        return cls(
            cluster_name=str(d["cluster_name"]),
            provider=dict(d["provider"]),
            head_node_type=str(d["head_node_type"]),
            available_node_types={
                k: dict(v) for k, v in d["available_node_types"].items()
            },
            max_workers=int(d.get("max_workers", 8)),
            idle_timeout_minutes=float(d.get("idle_timeout_minutes", 5.0)),
            raw=dict(d),
        )

    @classmethod
    def from_yaml(cls, path: str) -> "ClusterConfig":
        import yaml

        with open(path) as f:
            d = yaml.safe_load(f)
        if not isinstance(d, dict):
            raise ClusterConfigError(f"{path} is not a YAML mapping")
        return cls.from_dict(d)

    def worker_types(self) -> Dict[str, Dict[str, Any]]:
        return {
            k: v
            for k, v in self.available_node_types.items()
            if k != self.head_node_type
        }


def _state_path(name: str) -> str:
    return os.path.join(_STATE_DIR, f"cluster-{name}.json")


class ClusterLauncher:
    """up/down/submit for one cluster config.

    For provider 'fake' the head and workers are in-process raylets; for
    'gce' nodes are GPU VMs and bootstrap runs through the provider's
    injectable command runner (tests inject a fake gcloud).
    """

    def __init__(self, config: ClusterConfig, runner=None):
        self.config = config
        self._runner = runner  # gce: injectable gcloud runner
        self.provider = None
        self.autoscaler: Optional[Autoscaler] = None
        self.head_address: Optional[str] = None
        self._fake_cluster = None
        self._head_pid: Optional[str] = None
        self._worker_pids: List[str] = []

    # -- up ------------------------------------------------------------------

    def up(self) -> str:
        """Boot head + min_workers; returns the head address."""
        cfg = self.config
        self._make_provider()
        self._bootstrap_head()
        # Initial workers: honor per-type min_workers at launch (the
        # autoscaler keeps them there afterwards).
        for ntype, spec in cfg.worker_types().items():
            for _ in range(int(spec.get("min_workers", 0))):
                self._worker_pids.append(self.provider.create_node(ntype))
        self._wait_ready()
        self.autoscaler = Autoscaler(
            self.provider,
            AutoscalerConfig(
                idle_timeout_s=cfg.idle_timeout_minutes * 60.0,
            ),
        )
        # Adopt the launch-time workers so idle-timeout/min-worker
        # accounting sees them.
        for pid in self._worker_pids:
            self._adopt(pid)
        self._write_state()
        logger.info(
            "cluster %s up: head=%s workers=%d",
            cfg.cluster_name, self.head_address, len(self._worker_pids),
        )
        return self.head_address

    def _adopt(self, pid: str) -> None:
        from ray_tpu_torch.autoscaler.autoscaler import _NodeTracker

        ntype = self._pid_type(pid)
        self.autoscaler._tracked[pid] = _NodeTracker(
            provider_node_id=pid, node_type=ntype
        )

    def _pid_type(self, pid: str) -> str:
        # Fake pids embed the type; gce names embed it too (raytpu-<type>-).
        for ntype in self.config.available_node_types:
            if f"-{ntype}-" in pid or pid.startswith(f"fake-{ntype}"):
                return ntype
        return next(iter(self.config.worker_types()), self.config.head_node_type)

    def _make_provider(self) -> None:
        cfg = self.config
        ptype = cfg.provider["type"]
        node_types = cfg.available_node_types
        if ptype == "fake":
            import ray_tpu_torch
            from ray_tpu_torch.cluster_utils import Cluster

            head_res = dict(node_types[cfg.head_node_type]["resources"])
            self._fake_cluster = Cluster(
                initialize_head=True,
                head_node_args={
                    "num_cpus": head_res.pop("CPU", 1.0),
                    "num_gpus": head_res.pop("GPU", 0.0),
                    "resources": head_res,
                },
            )
            self.provider = FakeNodeProvider(
                self._fake_cluster, node_types=node_types
            )
        else:
            kwargs = {
                k: v
                for k, v in cfg.provider.items()
                if k in ("project", "zone", "machine_type", "accelerator_type",
                         "image_family", "image_project")
            }
            self.provider = GCEGPUNodeProvider(
                node_types=node_types, runner=self._runner, **kwargs
            )

    def _bootstrap_head(self) -> None:
        cfg = self.config
        if cfg.provider["type"] == "fake":
            host, port = self._fake_cluster.gcs_addr
            self.head_address = f"{host}:{port}"
            return
        # GCE: create the head VM, then start the head daemon over ssh
        # (reference: ray up's "head_start_ray_commands" over ssh).
        self._head_pid = self.provider.create_node(cfg.head_node_type)
        deadline = time.monotonic() + float(
            cfg.provider.get("head_ready_timeout_s", 600)
        )
        while self.provider.node_state(self._head_pid) != "READY":
            self.provider.poll()
            if self.provider.node_state(self._head_pid) == "FAILED":
                raise RuntimeError("head node failed to provision")
            if time.monotonic() > deadline:
                raise TimeoutError("head node not READY before timeout")
            time.sleep(cfg.provider.get("poll_interval_s", 2.0))
        self.provider.run_on_node(
            self._head_pid,
            cfg.provider.get(
                "head_start_command", "ray-tpu-torch start --head --port 6379"
            ),
        )
        self.head_address = f"{self._head_pid}:6379"

    def _wait_ready(self, timeout: float = 600.0) -> None:
        """Wait until every launched worker is usable (fake: immediate;
        gce: REQUESTED/PROVISIONING -> READY via poll)."""
        if self.config.provider["type"] == "fake":
            return
        deadline = time.monotonic() + timeout
        while True:
            self.provider.poll()
            states = [self.provider.node_state(p) for p in self._worker_pids]
            if all(s == "READY" for s in states):
                return
            if time.monotonic() > deadline:
                raise TimeoutError(f"workers not READY: {states}")
            time.sleep(self.config.provider.get("poll_interval_s", 2.0))

    # -- steady state --------------------------------------------------------

    def update(self) -> Dict[str, int]:
        """One autoscaler round (callers loop this; the CLI runs it in a
        monitor loop). The autoscaler reads the cluster's state through a
        driver: this process attaches to the head as one if it is not
        connected yet (`up --monitor` is a process of its own)."""
        assert self.autoscaler is not None, "cluster is not up"
        import ray_tpu_torch

        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(address=self.head_address)
        return self.autoscaler.update()

    # -- submit --------------------------------------------------------------

    def submit(self, entrypoint: str, wait: bool = True, timeout: float = 300.0):
        """Submit a job entrypoint to the running cluster's job manager."""
        from ray_tpu_torch.job import JobSubmissionClient

        client = JobSubmissionClient(self.head_address)
        sid = client.submit_job(entrypoint=entrypoint)
        if not wait:
            return sid, None
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            info = client.get_job_info(sid)
            if info.status in ("SUCCEEDED", "FAILED", "STOPPED"):
                return sid, info
            time.sleep(0.2)
        raise TimeoutError(f"job {sid} did not finish within {timeout}s")

    # -- down ----------------------------------------------------------------

    def down(self) -> None:
        cfg = self.config
        for pid in list(self.provider.non_terminated_nodes()):
            try:
                self.provider.terminate_node(pid)
            except Exception:
                logger.exception("terminate of %s failed", pid)
        if self._head_pid is not None:
            try:
                self.provider.terminate_node(self._head_pid)
            except Exception:
                logger.exception("terminate of head failed")
        if self._fake_cluster is not None:
            self._fake_cluster.shutdown()
            self._fake_cluster = None
        try:
            os.unlink(_state_path(cfg.cluster_name))
        except OSError:
            pass
        logger.info("cluster %s down", cfg.cluster_name)

    # -- state file ----------------------------------------------------------

    def _write_state(self) -> None:
        os.makedirs(_STATE_DIR, exist_ok=True)
        with open(_state_path(self.config.cluster_name), "w") as f:
            json.dump(
                {
                    "cluster_name": self.config.cluster_name,
                    "head_address": self.head_address,
                    "provider_type": self.config.provider["type"],
                    "worker_pids": self._worker_pids,
                },
                f,
            )


def read_cluster_state(name: str) -> Optional[dict]:
    try:
        with open(_state_path(name)) as f:
            return json.load(f)
    except OSError:
        return None
