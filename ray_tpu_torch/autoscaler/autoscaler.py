"""The autoscaling control loop.

Analog of autoscaler/v2/autoscaler.py + _private/autoscaler.py
(StandardAutoscaler) + resource_demand_scheduler.py: demand = pending
worker leases reported by raylets; supply = alive nodes' resources. Scale
up when demand goes unmet past the upscale delay (bin-packing demand onto
the cheapest satisfying node type), scale down nodes idle past the idle
timeout, clamped to per-type min/max workers. GPUs are a per-host count
like any resource: every scaling unit is one host, and a GPU demand is met
by one host of a type with that many GPUs.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)


@dataclass
class AutoscalerConfig:
    upscale_delay_s: float = 1.0
    idle_timeout_s: float = 30.0
    poll_interval_s: float = 1.0
    max_launches_per_round: int = 4


@dataclass
class _NodeTracker:
    """One scaling unit: a single host."""

    provider_node_id: str
    node_type: str
    launched_at: float = field(default_factory=time.monotonic)
    idle_since: Optional[float] = None


class Autoscaler:
    """Drive with repeated update() calls (or run() in a thread). Reads
    cluster state through the connected driver's state APIs."""

    def __init__(
        self,
        provider,
        config: Optional[AutoscalerConfig] = None,
        state_fn=None,
    ):
        self.provider = provider
        self.config = config or AutoscalerConfig()
        # state_fn() -> per-node stats list (GetNodeStats shape). Default
        # reads through the connected driver; the simulated-cluster harness
        # injects its own collector since a SimCluster has no driver.
        self._state_fn = state_fn
        self._tracked: Dict[str, _NodeTracker] = {}
        self._demand_since: Optional[float] = None

    # -- state collection ----------------------------------------------------

    def _cluster_state(self) -> Tuple[int, List[dict]]:
        """-> (total pending leases, per-node stats)."""
        if self._state_fn is not None:
            stats = self._state_fn()
        else:
            from ray_tpu_torch.util.state.api import _each_raylet

            stats = _each_raylet({})
        pending = sum(s.get("pending_leases", 0) for s in stats)
        return pending, stats

    @staticmethod
    def _pending_demands(stats: List[dict]) -> List[Dict[str, int]]:
        demands: List[Dict[str, int]] = []
        for s in stats:
            demands.extend(s.get("pending_demand") or [])
        return demands

    # -- scaling decisions ---------------------------------------------------

    def _reconcile_provider(self) -> int:
        """Advance the provider's node state machine and replace tracked
        nodes that FAILED (a preempted or lost GPU VM is re-created as the
        same type — reference: GCP provider node status handling). Returns
        replacements made."""
        poll = getattr(self.provider, "poll", None)
        if poll is None:
            return 0
        poll()
        failed = set(getattr(self.provider, "failed_nodes", lambda: [])())
        if not failed:
            return 0
        repaired = 0
        forget = getattr(self.provider, "forget_node", lambda _p: None)
        for key, t in list(self._tracked.items()):
            pid = t.provider_node_id
            if pid not in failed:
                continue
            # Create the replacement FIRST: if it fails, the pid stays
            # FAILED and tracked so the next round retries the repair.
            try:
                new_pid = self.provider.create_node(t.node_type)
            except Exception:
                logger.exception(
                    "repair: re-create of %s (%s) failed; will retry",
                    pid, t.node_type,
                )
                continue
            # A FAILED node may still EXIST in GCE (STOPPED/TERMINATED) —
            # delete it so it doesn't bill as an untracked orphan. On
            # success the provider's TERMINATING -> poll path drops the
            # record once GCE confirms; on failure forget it from the
            # provider (it is replaced now) with a loud warning.
            if self.provider.terminate_node(pid) is False:
                forget(pid)
                logger.error(
                    "repair: could not delete failed node %s — it may "
                    "still exist (and bill) in GCE; clean up manually", pid
                )
            del self._tracked[key]
            self._tracked[new_pid] = _NodeTracker(new_pid, t.node_type)
            repaired += 1
            logger.warning("repair: replaced failed node %s with %s", pid, new_pid)
        return repaired

    def update(self) -> Dict[str, int]:
        """One reconcile round; returns {"launched": n, "terminated": m}."""
        self._reconcile_provider()
        pending, stats = self._cluster_state()
        now = time.monotonic()
        launched = terminated = 0

        # Ensure per-type minimums.
        counts: Dict[str, int] = {}
        for t in self._tracked.values():
            counts[t.node_type] = counts.get(t.node_type, 0) + 1
        for node_type, spec in self.provider.node_types.items():
            while counts.get(node_type, 0) < spec.get("min_workers", 0):
                launched += self._launch(node_type)
                counts[node_type] = counts.get(node_type, 0) + 1

        # Upscale on sustained unmet demand.
        if pending > 0:
            if self._demand_since is None:
                self._demand_since = now
            elif now - self._demand_since >= self.config.upscale_delay_s:
                demands = self._pending_demands(stats)
                for i in range(
                    min(self.config.max_launches_per_round, pending)
                ):
                    node_type = self._pick_type(
                        demands[i] if i < len(demands) else None
                    )
                    if node_type is None:
                        # This shape fits no type (or no headroom) — a later
                        # demand may still be satisfiable.
                        continue
                    launched += self._launch(node_type)
                self._demand_since = None
        else:
            self._demand_since = None

        # Downscale idle tracked nodes.
        busy_ids = {
            s["node_id"]
            for s in stats
            if s.get("num_workers", 0) - s.get("num_idle", 0) > 0
            or s.get("pending_leases", 0) > 0
        }
        raylet_of = getattr(self.provider, "raylet_node_id", lambda _p: None)
        for key, t in list(self._tracked.items()):
            raylet_id = raylet_of(t.provider_node_id)
            if raylet_id is not None and raylet_id in busy_ids:
                t.idle_since = None
                continue
            if t.idle_since is None:
                t.idle_since = now
                continue
            spec = self.provider.node_types.get(t.node_type, {})
            if (
                now - t.idle_since >= self.config.idle_timeout_s
                and self._count(t.node_type) > spec.get("min_workers", 0)
            ):
                if self.provider.terminate_node(t.provider_node_id) is False:
                    # Stays tracked (and idle) so the next round retries.
                    logger.warning(
                        "downscale of %s (%s) failed; will retry",
                        t.provider_node_id, t.node_type,
                    )
                else:
                    terminated += 1
                    del self._tracked[key]
        return {"launched": launched, "terminated": terminated}

    def _count(self, node_type: str) -> int:
        return sum(1 for t in self._tracked.values() if t.node_type == node_type)

    def _pick_type(self, demand: Optional[Dict[str, int]] = None) -> Optional[str]:
        """Cheapest node type with headroom that covers the demand shape
        (reference: resource_demand_scheduler bin-packing). With no shape,
        smallest type with headroom; with a shape that provably fits no
        type, None — launching hardware that can never satisfy the demand
        would just churn."""
        from ray_tpu_torch._private.common import RESOURCE_UNIT

        candidates = sorted(
            self.provider.node_types.items(),
            key=lambda kv: sum(kv[1].get("resources", {}).values()),
        )
        fallback = None
        for node_type, spec in candidates:
            if self._count(node_type) >= spec.get("max_workers", 0):
                continue
            if fallback is None:
                fallback = node_type
            if demand and self._covers(spec, demand, RESOURCE_UNIT):
                return node_type
        return None if demand else fallback

    @staticmethod
    def _covers(spec: dict, demand: Dict[str, int], unit: int) -> bool:
        """True when ONE host of this type could grant a lease with this
        demand shape. Every lease is granted by a single raylet, and a GPU
        count is per host like any resource: GPU:8 is covered only by a type
        whose one host has 8 GPUs."""
        have = spec.get("resources", {})
        for r, units in demand.items():
            if r.startswith("node:"):
                continue
            if have.get(r, 0.0) * unit < units:
                return False
        return True

    def _launch(self, node_type: str) -> int:
        """Launch one host of the type. Returns hosts launched (0 when the
        provider's create failed; a later round tries again)."""
        try:
            pid = self.provider.create_node(node_type)
        except Exception:
            logger.exception("launch of %s failed", node_type)
            return 0
        self._tracked[pid] = _NodeTracker(pid, node_type)
        return 1

    # -- loop ----------------------------------------------------------------

    def run(self, stop_event=None) -> None:
        while stop_event is None or not stop_event.is_set():
            try:
                self.update()
            except Exception:
                logger.exception("autoscaler round failed")
            time.sleep(self.config.poll_interval_s)
