"""User-facing Serve config dataclasses.

Analog of python/ray/serve/schema.py + config.py (DeploymentConfig,
AutoscalingConfig, HTTPOptions) — plain dataclasses, no pydantic dependency.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Any, Dict, Optional


@dataclass
class AutoscalingConfig:
    """Queue-length autoscaling (reference: serve/config.py AutoscalingConfig;
    policy in serve/_private/autoscaling_state.py).

    Desired replicas = total ongoing requests / target_ongoing_requests,
    clamped to [min_replicas, max_replicas], smoothed by upscale/downscale
    delays.
    """

    min_replicas: int = 1
    max_replicas: int = 1
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 3.0
    downscale_delay_s: float = 60.0
    metrics_interval_s: float = 0.5
    look_back_period_s: float = 5.0
    # Queue-driven scaling: routers report per-deployment queue depth
    # (requests waiting for a replica slot); the controller smooths the
    # total with this EWMA factor and adds it to ongoing load when sizing
    # the replica set, so sustained queueing scales up even while every
    # replica is saturated at max_ongoing_requests.
    queue_ewma_alpha: float = 0.5
    # Router metrics older than this are dropped from the depth sum
    # (a dead router's last report must not pin the deployment scaled up).
    queue_metric_staleness_s: float = 3.0

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "AutoscalingConfig":
        return cls(**d)


@dataclass
class DeploymentConfig:
    """Per-deployment config (reference: serve/config.py DeploymentConfig)."""

    num_replicas: int = 1
    max_ongoing_requests: int = 16
    # Router-side queue cap: requests waiting for a replica slot beyond this
    # are shed immediately with DeploymentOverloadedError (-1 -> the
    # config.serve_max_queued_requests default).
    max_queued_requests: int = -1
    # Continuous batching (reference: @serve.batch / Orca-style iteration
    # scheduling): >1 makes the replica coalesce concurrent requests to the
    # same method into one user-code call with a list argument. A batch
    # launches when full or batch_wait_timeout_s after its first request,
    # and the next batch forms while in-flight ones execute.
    max_batch_size: int = 1
    batch_wait_timeout_s: float = 0.01
    user_config: Optional[Any] = None
    autoscaling_config: Optional[AutoscalingConfig] = None
    health_check_period_s: float = 2.0
    health_check_timeout_s: float = 30.0
    graceful_shutdown_timeout_s: float = 10.0
    ray_actor_options: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        d = asdict(self)
        if self.autoscaling_config is not None:
            d["autoscaling_config"] = self.autoscaling_config.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DeploymentConfig":
        d = dict(d)
        if d.get("autoscaling_config"):
            d["autoscaling_config"] = AutoscalingConfig.from_dict(
                d["autoscaling_config"]
            )
        return cls(**d)


@dataclass
class HTTPOptions:
    """Proxy config (reference: serve/config.py HTTPOptions + gRPCOptions).

    ``grpc_port`` enables the gRPC ingress alongside HTTP: a generic
    bytes-in/bytes-out service routed by metadata (0 = ephemeral port,
    None = disabled)."""

    host: str = "127.0.0.1"
    port: int = 8000
    grpc_port: Optional[int] = None
    # False skips the proxy actor entirely (handle-only serving — loadgen
    # and the chaos serve suite drive the router directly).
    enabled: bool = True

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)
