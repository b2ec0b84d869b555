"""Node providers: pluggable node lifecycle backends.

Analog of python/ray/autoscaler/node_provider.py and the cloud
implementations under python/ray/autoscaler/_private/: a provider knows how
to create/terminate/list nodes of configured node types.
"""

from __future__ import annotations

import logging
import uuid
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)


class NodeProvider:
    """Interface (reference: node_provider.py NodeProvider)."""

    def __init__(self, node_types: Optional[Dict[str, dict]] = None):
        # node_types: name -> {"resources": {...}, "min_workers", "max_workers"}
        self.node_types = node_types or {
            "worker": {"resources": {"CPU": 2.0}, "min_workers": 0, "max_workers": 4}
        }

    def create_node(self, node_type: str) -> str:
        raise NotImplementedError

    def terminate_node(self, provider_node_id: str) -> None:
        raise NotImplementedError

    def non_terminated_nodes(self) -> List[str]:
        raise NotImplementedError


class FakeNodeProvider(NodeProvider):
    """Adds/removes in-process raylets on the running cluster — the
    reference's fake_multi_node provider (autoscaler tests run against it in
    CI rather than a cloud)."""

    def __init__(self, cluster, node_types: Optional[Dict[str, dict]] = None):
        super().__init__(node_types)
        self.cluster = cluster  # ray_tpu_torch.cluster_utils.Cluster
        self._nodes: Dict[str, Any] = {}

    def create_node(self, node_type: str) -> str:
        spec = self.node_types[node_type]
        res = dict(spec["resources"])
        # The GPU count is explicit: add_node without one advertises the
        # cards this host has, so a CPU-only type must say 0.
        node = self.cluster.add_node(
            num_cpus=res.pop("CPU", 1.0),
            num_gpus=res.pop("GPU", 0.0),
            resources=res,
        )
        pid = f"fake-{node_type}-{uuid.uuid4().hex[:6]}"
        self._nodes[pid] = node
        logger.info("fake provider launched %s (%s)", pid, spec["resources"])
        return pid

    def terminate_node(self, provider_node_id: str) -> None:
        node = self._nodes.pop(provider_node_id, None)
        if node is not None:
            self.cluster.remove_node(node)
            logger.info("fake provider terminated %s", provider_node_id)

    def non_terminated_nodes(self) -> List[str]:
        return list(self._nodes)

    def raylet_node_id(self, provider_node_id: str) -> Optional[str]:
        node = self._nodes.get(provider_node_id)
        return getattr(node, "node_id", None) if node is not None else None


# GCE VM node lifecycle states (reference: the GCP API's node states,
# gcp/node_provider.py _get_node status handling).
REQUESTED = "REQUESTED"  # create issued, no describe yet
PROVISIONING = "PROVISIONING"  # GCE reports PROVISIONING/STAGING
READY = "READY"
TERMINATING = "TERMINATING"  # delete issued, awaiting disappearance
FAILED = "FAILED"  # create exhausted retries / node vanished / stopped

# GCE instance status -> provider state. STOPPING/TERMINATED (GCE's word
# for a stopped VM, preempted ones included) mean the node is lost.
_GCE_STATES = {
    "RUNNING": READY,
    "PROVISIONING": PROVISIONING,
    "STAGING": PROVISIONING,
    "": PROVISIONING,
    "STOPPING": FAILED,
    "TERMINATED": FAILED,
    "SUSPENDING": FAILED,
    "SUSPENDED": FAILED,
}


def _error_text(e: Exception) -> str:
    """Lower-cased message of a runner failure, including the gcloud output
    that CalledProcessError keeps in .output/.stderr rather than str(e)."""
    parts = [str(e)]
    for attr in ("output", "stderr"):
        v = getattr(e, attr, None)
        if isinstance(v, bytes):
            v = v.decode("utf-8", "replace")
        if v:
            parts.append(str(v))
    return " ".join(parts).lower()


class NodeCreateError(RuntimeError):
    pass


class GCEGPUNodeProvider(NodeProvider):
    """GPU-VM provider with a real node state machine (reference:
    autoscaler/_private/gcp/node_provider.py): creates are issued async and
    retried on failure; poll() advances nodes through REQUESTED ->
    PROVISIONING -> READY by describing them, and confirms TERMINATING
    nodes actually disappeared. A node type may set its own
    ``machine_type`` and ``accelerator`` ({"type", "count"}); an ``a3-*``
    or ``a2-*`` machine type carries its GPUs, so no accelerator flag is
    passed for it. Command execution is injectable (runner(argv) ->
    stdout, raising on nonzero exit) so tests drive the lifecycle through a
    fake gcloud that models delays and failures."""

    def __init__(
        self,
        project: str,
        zone: str,
        machine_type: str = "a3-highgpu-1g",
        accelerator_type: str = "nvidia-h100-80gb",
        image_family: str = "common-cu124-debian-11",
        image_project: str = "deeplearning-platform-release",
        node_types: Optional[Dict[str, dict]] = None,
        runner=None,
        create_retries: int = 3,
    ):
        super().__init__(node_types)
        self.project = project
        self.zone = zone
        self.machine_type = machine_type
        self.accelerator_type = accelerator_type
        self.image_family = image_family
        self.image_project = image_project
        self._runner = runner or self._default_runner
        self.create_retries = create_retries
        # name -> {"state", "node_type", "create_attempts"}
        self._nodes: Dict[str, Dict[str, Any]] = {}

    @staticmethod
    def _default_runner(cmd: List[str]) -> str:
        import subprocess

        return subprocess.check_output(cmd, text=True)

    # -- gcloud argv ---------------------------------------------------------

    def _scope(self) -> List[str]:
        return [f"--project={self.project}", f"--zone={self.zone}"]

    def _machine_flags(self, node_type: str) -> List[str]:
        """--machine-type, plus --accelerator for a general-purpose machine
        type given GPUs (count from the type's GPU resource)."""
        spec = self.node_types.get(node_type, {})
        machine = spec.get("machine_type", self.machine_type)
        flags = [f"--machine-type={machine}"]
        gpus = int(spec.get("resources", {}).get("GPU", 0))
        accel = dict(spec.get("accelerator") or {})
        if gpus and not machine.startswith(("a3-", "a2-")):
            flags.append(
                f"--accelerator=type={accel.get('type', self.accelerator_type)},"
                f"count={int(accel.get('count', gpus))}"
            )
            # GPU VMs cannot live-migrate.
            flags.append("--maintenance-policy=TERMINATE")
        return flags

    def _create_cmd(self, name: str, node_type: str) -> List[str]:
        return [
            "gcloud", "compute", "instances", "create", name,
            *self._scope(),
            *self._machine_flags(node_type),
            f"--image-family={self.image_family}",
            f"--image-project={self.image_project}",
            "--async",
        ]

    def _delete_cmd(self, name: str) -> List[str]:
        return [
            "gcloud", "compute", "instances", "delete", name,
            *self._scope(), "--quiet",
        ]

    def _describe_cmd(self, name: str) -> List[str]:
        return [
            "gcloud", "compute", "instances", "describe", name,
            *self._scope(), "--format=json",
        ]

    def discover_nodes(self) -> List[str]:
        """Adopt raytpu-* VMs that exist in GCE but aren't tracked here
        (a fresh process running `down`, or crash recovery). Returns the
        adopted names."""
        out = self._runner(
            [
                "gcloud", "compute", "instances", "list",
                f"--project={self.project}",
                f"--filter=name~^raytpu- AND zone:{self.zone}",
                "--format=value(name)",
            ]
        )
        adopted = []
        for name in out.split():
            name = name.strip()
            if name and name not in self._nodes:
                self._nodes[name] = {
                    "state": READY,
                    "node_type": "unknown",
                    "create_attempts": 0,
                    "describe_misses": 0,
                }
                adopted.append(name)
        return adopted

    def run_on_node(self, name: str, command: str) -> str:
        """Run a shell command on a VM over gcloud ssh (the launcher's head
        bootstrap path; reference: ray up's ssh command runner)."""
        return self._runner(
            [
                "gcloud", "compute", "ssh", name,
                *self._scope(), "--command", command,
            ]
        )

    # -- lifecycle -----------------------------------------------------------

    def create_node(self, node_type: str) -> str:
        """Issue an async create; retries transient gcloud failures with the
        same name so a half-created node is adopted, not duplicated."""
        name = f"raytpu-{node_type}-{uuid.uuid4().hex[:8]}"
        attempts = 0
        last_err: Optional[Exception] = None
        while attempts < self.create_retries:
            attempts += 1
            try:
                self._runner(self._create_cmd(name, node_type))
                self._nodes[name] = {
                    "state": REQUESTED,
                    "node_type": node_type,
                    "create_attempts": attempts,
                    "describe_misses": 0,
                }
                return name
            except Exception as e:  # subprocess.CalledProcessError and kin
                msg = _error_text(e)
                if "already exists" in msg or "alreadyexists" in msg:
                    # A prior attempt was accepted server-side even though
                    # the client errored: adopt the node instead of burning
                    # retries on a non-transient error.
                    self._nodes[name] = {
                        "state": REQUESTED,
                        "node_type": node_type,
                        "create_attempts": attempts,
                        "describe_misses": 0,
                    }
                    return name
                last_err = e
                logger.warning(
                    "instance create %s attempt %d/%d failed: %r",
                    name, attempts, self.create_retries, e,
                )
        raise NodeCreateError(
            f"instance create {name} failed after {attempts} attempts"
        ) from last_err

    def terminate_node(self, provider_node_id: str) -> bool:
        """Issue a delete. Returns False on a gcloud failure — the node
        stays tracked in its current state so the caller can retry."""
        info = self._nodes.get(provider_node_id)
        if info is None or info["state"] == TERMINATING:
            return True  # already gone / already deleting: retry is a no-op
        try:
            self._runner(self._delete_cmd(provider_node_id))
        except Exception as e:
            logger.warning("instance delete %s failed: %r", provider_node_id, e)
            return False
        info["state"] = TERMINATING
        # Fresh miss budget for the deletion phase: leftover provisioning
        # misses must not let one transient describe failure drop the
        # record of a node that may still exist and bill.
        info["describe_misses"] = 0
        return True

    def poll(self) -> None:
        """Advance the state machine by describing in-flight nodes
        (REQUESTED/PROVISIONING move toward READY; TERMINATING nodes are
        dropped once GCE stops reporting them; vanished or stopped nodes
        fail)."""
        import json

        for name, info in list(self._nodes.items()):
            state = info["state"]
            if state in (READY, FAILED):
                # READY needs no polling; FAILED is terminal (repair or
                # teardown decides its fate — re-describing it every round
                # costs a gcloud call and can flap behind our back).
                continue
            try:
                out = self._runner(self._describe_cmd(name))
                status = str(json.loads(out or "{}").get("status", "")).upper()
            except Exception as e:
                msg = _error_text(e)
                not_found = "not_found" in msg or "not found" in msg
                if state == TERMINATING:
                    # Only a confirmed NOT_FOUND (or repeated misses) drops
                    # the record: a transient gcloud/network failure must
                    # not silently forget a node that may still exist and
                    # bill.
                    info["describe_misses"] = info.get("describe_misses", 0) + 1
                    if not_found or info["describe_misses"] > 3:
                        del self._nodes[name]  # gone, as requested
                    continue
                # --async creates may not be describable immediately;
                # tolerate a few misses before declaring the node lost.
                info["describe_misses"] = info.get("describe_misses", 0) + 1
                if info["describe_misses"] > 3:
                    info["state"] = FAILED
                    logger.warning(
                        "instance %s vanished (describe failed %d times)",
                        name, info["describe_misses"],
                    )
                continue
            info["describe_misses"] = 0
            if state == TERMINATING:
                continue  # still deleting
            if status in _GCE_STATES:
                info["state"] = _GCE_STATES[status]

    def node_state(self, provider_node_id: str) -> Optional[str]:
        info = self._nodes.get(provider_node_id)
        return info["state"] if info else None

    def non_terminated_nodes(self) -> List[str]:
        return [
            n
            for n, info in self._nodes.items()
            if info["state"] not in (TERMINATING, FAILED)
        ]

    def ready_nodes(self) -> List[str]:
        return [
            n for n, info in self._nodes.items() if info["state"] == READY
        ]

    def failed_nodes(self) -> List[str]:
        return [
            n for n, info in self._nodes.items() if info["state"] == FAILED
        ]

    def forget_node(self, provider_node_id: str) -> None:
        """Drop a FAILED node from tracking (after its repair)."""
        self._nodes.pop(provider_node_id, None)
