"""FaultTolerantActorManager: fan calls out to a fleet of actors, tolerate
failures.

Analog of rllib/utils/actor_manager.py (used by LearnerGroup at
learner_group.py:178 and EnvRunnerGroup): remote calls go to healthy actors
only; an actor that raises a system error is marked unhealthy and its work
redistributed; `probe_unhealthy` brings restored actors back.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import ray_tpu_torch
from ray_tpu_torch._private.common import (
    ActorDiedError,
    ActorUnavailableError,
    WorkerCrashedError,
)

logger = logging.getLogger(__name__)

_SYSTEM_ERRORS = (ActorDiedError, ActorUnavailableError, WorkerCrashedError)


@dataclass
class CallResult:
    actor_index: int
    ok: bool
    value: Any = None
    error: Optional[Exception] = None

    def get(self):
        if not self.ok:
            raise self.error
        return self.value


class FaultTolerantActorManager:
    def __init__(self, actors: Sequence[Any], *, max_remote_requests_in_flight: int = 2):
        self._actors: List[Any] = list(actors)
        self._healthy: List[bool] = [True] * len(self._actors)
        self.max_in_flight = max_remote_requests_in_flight

    @property
    def actors(self) -> List[Any]:
        return self._actors

    def healthy_actor_ids(self) -> List[int]:
        return [i for i, h in enumerate(self._healthy) if h]

    def num_healthy_actors(self) -> int:
        return sum(self._healthy)

    def set_actor_state(self, idx: int, healthy: bool) -> None:
        self._healthy[idx] = healthy

    def foreach_actor(
        self,
        fn: Callable[[Any], Any],
        *,
        healthy_only: bool = True,
        remote_actor_ids: Optional[Sequence[int]] = None,
        timeout_s: Optional[float] = None,
    ) -> List[CallResult]:
        """fn maps an actor handle to an ObjectRef (e.g. lambda a:
        a.sample.remote()). Blocks for all results; failures mark the actor
        unhealthy instead of raising."""
        ids = (
            list(remote_actor_ids)
            if remote_actor_ids is not None
            else (self.healthy_actor_ids() if healthy_only else range(len(self._actors)))
        )
        refs = []
        for i in ids:
            try:
                refs.append((i, fn(self._actors[i])))
            except Exception as e:
                self._mark(i, e)
                refs.append((i, None))
        results: List[CallResult] = []
        for i, ref in refs:
            if ref is None:
                results.append(
                    CallResult(i, False, error=RuntimeError("submit failed"))
                )
                continue
            try:
                value = ray_tpu_torch.get(ref, timeout=timeout_s)
                results.append(CallResult(i, True, value=value))
            except Exception as e:
                if isinstance(e, _SYSTEM_ERRORS):
                    self._mark(i, e)
                results.append(CallResult(i, False, error=e))
        return results

    def _mark(self, idx: int, err: Exception) -> None:
        if self._healthy[idx]:
            logger.warning("actor %d marked unhealthy: %r", idx, err)
        self._healthy[idx] = False

    def probe_unhealthy_actors(
        self, probe: Optional[Callable[[Any], Any]] = None, timeout_s: float = 5.0
    ) -> List[int]:
        """Ping unhealthy actors; ones that respond are marked healthy again
        (reference: actor_manager.py probe_unhealthy_actors)."""
        restored = []
        probe = probe or (lambda a: a.ping.remote())
        for i, h in enumerate(self._healthy):
            if h:
                continue
            try:
                ray_tpu_torch.get(probe(self._actors[i]), timeout=timeout_s)
                self._healthy[i] = True
                restored.append(i)
            except Exception:
                pass
        return restored

    def replace_actor(self, idx: int, new_actor: Any) -> None:
        self._actors[idx] = new_actor
        self._healthy[idx] = True
