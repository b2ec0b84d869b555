"""ray_tpu_torch.chaos — deterministic seeded fault injection with convergence
invariants.

A seed fully determines a :class:`FaultSchedule` (wire-level drop / delay /
dup / reorder per RPC method pattern) and a :class:`NemesisPlan`
(process-level kill_worker / kill_raylet / restart_gcs). The runner executes
scenario workloads under a schedule, drives the cluster to quiescence, and
asserts the convergence invariants (lease-exactly-once, actors-terminal,
no-orphaned-tasks, store-settled, objects-reconstructable). Failing seeds
land in a JSONL replay corpus; rebuilding the schedule from a recorded seed
reproduces the identical fault sequence.

CLI: ``python -m ray_tpu_torch.chaos --suite smoke --seeds 20``
(see ``--list`` for the scenario catalog, docs/chaos.md for the workflow).
"""

from ray_tpu_torch.chaos.schedule import (
    FaultEvent,
    FaultLog,
    FaultSchedule,
    FaultSpec,
    NemesisPlan,
    stable_u64,
)
from ray_tpu_torch.chaos.interceptors import ChaosInterceptor, install, uninstall
from ray_tpu_torch.chaos.invariants import (
    ConvergenceTimeout,
    Violation,
    check,
    quiesce,
)
from ray_tpu_torch.chaos.nemesis import ACTIONS, Nemesis

__all__ = [
    "ACTIONS",
    "ChaosInterceptor",
    "ConvergenceTimeout",
    "FaultEvent",
    "FaultLog",
    "FaultSchedule",
    "FaultSpec",
    "Nemesis",
    "NemesisPlan",
    "Violation",
    "check",
    "install",
    "quiesce",
    "stable_u64",
    "uninstall",
]
