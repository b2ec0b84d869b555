"""Per-worker train session (reference: python/ray/train/_internal/session.py:110).

The user's train_fn runs on an executor thread inside a TrainWorker actor; the
session is thread-local-ish process state. `report()` persists any checkpoint
directly from the worker (rank-local upload, reference: storage.py:505) and
enqueues a TrainingResult that the driver drains via the actor's `poll()`
method — the actor runs with max_concurrency > 1 so polling and training
overlap (the reference gets the same overlap from its result queue + thread).
"""

from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from ray_tpu_torch.train._checkpoint import Checkpoint, _parse_uri


@dataclass
class TrialInfo:
    name: str = "train"
    experiment_name: str = "train"
    trial_id: str = ""
    storage_path: Optional[str] = None
    trial_dir: Optional[str] = None  # {storage_path}/{experiment}/{trial}


@dataclass
class TrainingResult:
    metrics: Dict[str, Any]
    checkpoint_path: Optional[str] = None
    iteration: int = 0
    world_rank: int = 0


class TrainContext:
    """What `ray_tpu_torch.train.get_context()` returns (reference:
    python/ray/train/context.py)."""

    def __init__(self, session: "_TrainSession"):
        self._s = session

    def get_world_size(self) -> int:
        return self._s.world_size

    def get_world_rank(self) -> int:
        return self._s.world_rank

    def get_local_rank(self) -> int:
        return self._s.local_rank

    def get_local_world_size(self) -> int:
        return self._s.local_world_size

    def get_node_rank(self) -> int:
        return self._s.node_rank

    def get_trial_name(self) -> str:
        return self._s.trial_info.name

    def get_trial_id(self) -> str:
        return self._s.trial_info.trial_id

    def get_experiment_name(self) -> str:
        return self._s.trial_info.experiment_name

    def get_trial_dir(self) -> Optional[str]:
        return self._s.trial_info.trial_dir

    def get_collective_group(self) -> Optional[str]:
        """Name of the collective group spanning the worker gang (the
        trainer's TorchConfig(collective_backend=...); ops on it go through
        ray_tpu_torch.util.collective). None for a gang of one or without one."""
        return self._s.collective_group


@dataclass
class _TrainSession:
    world_rank: int = 0
    world_size: int = 1
    local_rank: int = 0
    local_world_size: int = 1
    node_rank: int = 0
    trial_info: TrialInfo = field(default_factory=TrialInfo)
    latest_checkpoint: Optional[Checkpoint] = None
    dataset_shards: Dict[str, Any] = field(default_factory=dict)
    collective_group: Optional[str] = None
    loop_config: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        self.result_queue: "queue.Queue[TrainingResult]" = queue.Queue()
        self.iteration = 0
        self.finished = threading.Event()
        self.error: Optional[BaseException] = None

    # -- worker-side checkpoint persistence ---------------------------------

    def _persist_checkpoint(self, local_dir: str) -> str:
        """Upload `local_dir` into the trial dir; returns the persisted URI.

        All ranks may report a checkpoint; files land in the same
        checkpoint_{iter} dir (rank-local upload, reference storage.py:505).
        Rank-disambiguation is the caller's job, as in the reference.
        """
        trial_dir = self.trial_info.trial_dir
        if trial_dir is None:
            return os.path.abspath(local_dir)  # no storage: hand back in place
        dest = os.path.join(trial_dir, f"checkpoint_{self.iteration:06d}")
        fs, fs_dest = _parse_uri(dest)
        import pyarrow.fs as pafs

        fs.create_dir(fs_dest, recursive=True)
        pafs.copy_files(
            os.path.abspath(local_dir), fs_dest, destination_filesystem=fs
        )
        return dest

    # -- public session API --------------------------------------------------

    def report(
        self, metrics: Dict[str, Any], checkpoint: Optional[Checkpoint] = None
    ) -> None:
        ckpt_path = None
        if checkpoint is not None:
            ckpt_path = self._persist_checkpoint(checkpoint.fs_path)
            self.latest_checkpoint = Checkpoint(ckpt_path)
        self.result_queue.put(
            TrainingResult(
                metrics=dict(metrics),
                checkpoint_path=ckpt_path,
                iteration=self.iteration,
                world_rank=self.world_rank,
            )
        )
        self.iteration += 1

    def get_checkpoint(self) -> Optional[Checkpoint]:
        return self.latest_checkpoint

    def get_dataset_shard(self, name: str = "train"):
        if name not in self.dataset_shards:
            raise KeyError(
                f"no dataset shard named {name!r}; trainer datasets were "
                f"{sorted(self.dataset_shards)}"
            )
        return self.dataset_shards[name]


_session: Optional[_TrainSession] = None


def _set_session(s: Optional[_TrainSession]) -> None:
    global _session
    _session = s


def _get_session() -> _TrainSession:
    if _session is None:
        raise RuntimeError(
            "train session API used outside a train worker; call this from "
            "inside train_loop_per_worker"
        )
    return _session


# -- module-level API (what `ray_tpu_torch.train` re-exports) ----------------------


def report(metrics: Dict[str, Any], *, checkpoint: Optional[Checkpoint] = None):
    _get_session().report(metrics, checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    return _get_session().get_checkpoint()


def get_context() -> TrainContext:
    return TrainContext(_get_session())


def get_dataset_shard(name: str = "train"):
    return _get_session().get_dataset_shard(name)
