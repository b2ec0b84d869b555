"""Shared Serve types: IDs, statuses, request metadata.

Analog of the reference's python/ray/serve/_private/common.py (DeploymentID,
ReplicaID, DeploymentStatus, ApplicationStatus, RequestMetadata).
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, Optional

SERVE_NAMESPACE = "serve"
CONTROLLER_NAME = "SERVE_CONTROLLER"
DEFAULT_APP_NAME = "default"


class DeploymentOverloadedError(Exception):
    """Typed load-shed: the router refused this request at admission.

    ``reason`` is one of:

    - ``"queue_full"`` — the deployment's router queue is at its
      max_queued_requests cap; admitting more would grow memory without
      bound under an open-loop storm.
    - ``"deadline_unreachable"`` — the request's remaining deadline budget
      cannot cover the observed per-replica service estimate, so running it
      would burn a replica slot only to be cut at the wire deadline.

    Callers (proxy, loadgen, chaos) treat this as backpressure, not a bug:
    the HTTP proxy maps it to 503, gRPC to RESOURCE_EXHAUSTED.
    """

    def __init__(self, deployment_id_str: str, reason: str, detail: str = ""):
        self.deployment_id_str = deployment_id_str
        self.reason = reason
        super().__init__(
            f"deployment {deployment_id_str} overloaded ({reason})"
            + (f": {detail}" if detail else "")
        )


@dataclass(frozen=True)
class DeploymentID:
    name: str
    app_name: str = DEFAULT_APP_NAME

    def __str__(self) -> str:
        return f"{self.app_name}#{self.name}"

    @classmethod
    def parse(cls, s: str) -> "DeploymentID":
        app, _, name = s.partition("#")
        return cls(name=name, app_name=app)


@dataclass(frozen=True)
class ReplicaID:
    unique_id: str
    deployment_id: DeploymentID

    @classmethod
    def generate(cls, deployment_id: DeploymentID) -> "ReplicaID":
        return cls(unique_id=uuid.uuid4().hex[:8], deployment_id=deployment_id)

    def to_actor_name(self) -> str:
        d = self.deployment_id
        return f"SERVE_REPLICA::{d.app_name}#{d.name}#{self.unique_id}"


class DeploymentStatus(str, Enum):
    UPDATING = "UPDATING"
    HEALTHY = "HEALTHY"
    UNHEALTHY = "UNHEALTHY"
    UPSCALING = "UPSCALING"
    DOWNSCALING = "DOWNSCALING"
    DELETING = "DELETING"


class ApplicationStatus(str, Enum):
    NOT_STARTED = "NOT_STARTED"
    DEPLOYING = "DEPLOYING"
    RUNNING = "RUNNING"
    DEPLOY_FAILED = "DEPLOY_FAILED"
    DELETING = "DELETING"
    UNHEALTHY = "UNHEALTHY"


class ReplicaState(str, Enum):
    STARTING = "STARTING"
    RUNNING = "RUNNING"
    STOPPING = "STOPPING"


@dataclass
class RequestMetadata:
    """Per-request routing metadata (reference: serve/_private/common.py
    RequestMetadata)."""

    request_id: str = field(default_factory=lambda: uuid.uuid4().hex)
    call_method: str = "__call__"
    route: str = ""
    multiplexed_model_id: str = ""
    is_http_request: bool = False
    http_method: str = "GET"
    headers: Dict[str, str] = field(default_factory=dict)


@dataclass
class DeploymentStatusInfo:
    name: str
    status: DeploymentStatus
    message: str = ""
    replica_states: Dict[str, int] = field(default_factory=dict)


@dataclass
class ApplicationStatusInfo:
    name: str
    status: ApplicationStatus
    message: str = ""
    route_prefix: Optional[str] = None
    deployments: Dict[str, DeploymentStatusInfo] = field(default_factory=dict)


@dataclass
class RunningReplicaInfo:
    """What routers need to know about a live replica."""

    replica_id_str: str
    deployment_id_str: str
    actor_id: str
    max_ongoing_requests: int
    # Router queue cap for the whole deployment (-1 -> the
    # config.serve_max_queued_requests default); rides the replica-set
    # long-poll push so routers learn it without extra RPCs.
    max_queued_requests: int = -1

    def to_dict(self) -> Dict[str, Any]:
        return {
            "replica_id_str": self.replica_id_str,
            "deployment_id_str": self.deployment_id_str,
            "actor_id": self.actor_id,
            "max_ongoing_requests": self.max_ongoing_requests,
            "max_queued_requests": self.max_queued_requests,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RunningReplicaInfo":
        return cls(**d)
