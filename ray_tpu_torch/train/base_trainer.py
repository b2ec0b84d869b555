"""BaseTrainer / DataParallelTrainer (reference: python/ray/train/base_trainer.py
:567 `fit`, train/data_parallel_trainer.py:428 `training_loop`).

`fit()` drives the BackendExecutor directly; under Tune the same `_run_loop`
executes inside a trial actor via `as_trainable()` (the reference couples the
two the same way: base_trainer.py:608 wraps every fit in a single-trial Tuner).
"""

from __future__ import annotations

import os
import shutil
import uuid
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch._private.common import RayTpuError
from ray_tpu_torch.air.config import (
    CheckpointConfig,
    Result,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train._backend_executor import (
    BackendConfig,
    BackendExecutor,
    TrainingFailedError,
)
from ray_tpu_torch.train._checkpoint import Checkpoint, _parse_uri
from ray_tpu_torch.train._session import TrialInfo


class _CheckpointManager:
    """Top-K checkpoint retention (reference:
    train/_internal/checkpoint_manager.py)."""

    def __init__(self, config: CheckpointConfig):
        self.config = config
        self.checkpoints: List[tuple] = []  # (path, metrics)

    def register(self, path: str, metrics: Dict[str, Any]) -> None:
        self.checkpoints.append((path, dict(metrics)))
        k = self.config.num_to_keep
        if k is None or len(self.checkpoints) <= k:
            return
        attr = self.config.checkpoint_score_attribute
        if attr is None:
            drop = self.checkpoints.pop(0)  # FIFO: drop oldest
        else:
            sign = 1 if self.config.checkpoint_score_order == "max" else -1
            worst = min(
                range(len(self.checkpoints) - 1),  # never drop the newest
                key=lambda i: sign
                * float(self.checkpoints[i][1].get(attr, float("-inf") * sign)),
            )
            drop = self.checkpoints.pop(worst)
        self._delete(drop[0])

    @staticmethod
    def _delete(path: str) -> None:
        try:
            fs, fs_path = _parse_uri(path)
            fs.delete_dir(fs_path)
        except Exception:
            shutil.rmtree(path, ignore_errors=True)

    @property
    def latest(self) -> Optional[str]:
        return self.checkpoints[-1][0] if self.checkpoints else None

    def best(self) -> Optional[str]:
        attr = self.config.checkpoint_score_attribute
        if not self.checkpoints:
            return None
        if attr is None:
            return self.checkpoints[-1][0]
        sign = 1 if self.config.checkpoint_score_order == "max" else -1
        return max(
            self.checkpoints,
            key=lambda c: sign * float(c[1].get(attr, float("-inf") * sign)),
        )[0]


def _shard_datasets(
    datasets: Dict[str, Any], num_workers: int
) -> List[Dict[str, Any]]:
    """Split each dataset across ranks: ray_tpu_torch.data Datasets via
    streaming_split (reference: train/_internal/data_config.py), plain
    sequences by strided slicing, everything else replicated."""
    per_rank: List[Dict[str, Any]] = [dict() for _ in range(num_workers)]
    for name, ds in (datasets or {}).items():
        if hasattr(ds, "streaming_split"):
            shards = ds.streaming_split(num_workers)
            for r in range(num_workers):
                per_rank[r][name] = shards[r]
        elif isinstance(ds, (list, tuple)):
            for r in range(num_workers):
                per_rank[r][name] = list(ds[r::num_workers])
        else:
            for r in range(num_workers):
                per_rank[r][name] = ds
    return per_rank


class BaseTrainer:
    """reference: python/ray/train/base_trainer.py BaseTrainer."""

    _default_backend_config: Callable[[], BackendConfig] = BackendConfig

    def __init__(
        self,
        *,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
    ):
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.datasets = datasets or {}
        self.resume_from_checkpoint = resume_from_checkpoint

    def fit(self) -> Result:
        raise NotImplementedError


class DataParallelTrainer(BaseTrainer):
    """reference: python/ray/train/data_parallel_trainer.py."""

    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[Dict[str, Any]] = None,
        backend_config: Optional[BackendConfig] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
        worker_env: Optional[Dict[str, str]] = None,
    ):
        super().__init__(
            scaling_config=scaling_config,
            run_config=run_config,
            datasets=datasets,
            resume_from_checkpoint=resume_from_checkpoint,
        )
        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = train_loop_config or {}
        self.backend_config = backend_config or type(self)._default_backend_config()
        self.worker_env = worker_env

    # -- experiment layout ---------------------------------------------------

    def _make_trial_info(self) -> TrialInfo:
        name = self.run_config.name or f"{type(self).__name__}_{uuid.uuid4().hex[:8]}"
        storage = self.run_config.resolved_storage_path()
        return TrialInfo(
            name=name,
            experiment_name=name,
            trial_id=uuid.uuid4().hex[:12],
            storage_path=storage,
            trial_dir=os.path.join(storage, name),
        )

    # -- the drive loop ------------------------------------------------------

    def _run_loop(
        self,
        trial_info: TrialInfo,
        report_cb: Optional[Callable[[Dict[str, Any], Optional[str]], None]] = None,
    ) -> Result:
        """Run (and re-run on gang failure) until training completes."""
        if trial_info.trial_dir:
            fs, fs_dir = _parse_uri(trial_info.trial_dir)
            fs.create_dir(fs_dir, recursive=True)
        ckpt_manager = _CheckpointManager(self.run_config.checkpoint_config)
        latest_ckpt: Optional[str] = (
            self.resume_from_checkpoint.path if self.resume_from_checkpoint else None
        )
        max_failures = self.run_config.failure_config.max_failures
        history: List[Dict[str, Any]] = []
        attempt = 0
        error: Optional[BaseException] = None

        while True:
            executor = BackendExecutor(
                self.backend_config,
                self.scaling_config,
                trial_info,
                worker_env=self.worker_env,
            )
            try:
                executor.start()
                shards = _shard_datasets(
                    self.datasets, self.scaling_config.num_workers
                )
                executor.start_training(
                    self.train_loop_per_worker,
                    self.train_loop_config,
                    shards,
                    latest_ckpt,
                )
                while True:
                    results = executor.get_next_results()
                    if results is None:
                        break
                    metrics = results[0]["metrics"]
                    ckpt = next(
                        (
                            r["checkpoint_path"]
                            for r in results
                            if r and r["checkpoint_path"]
                        ),
                        None,
                    )
                    if ckpt:
                        latest_ckpt = ckpt
                        ckpt_manager.register(ckpt, metrics)
                    history.append(metrics)
                    if report_cb is not None:
                        report_cb(metrics, ckpt)
                executor.finish_training()
                error = None
                break
            except (TrainingFailedError, RayTpuError) as e:
                error = e
                attempt += 1
                if attempt > max_failures >= 0 and max_failures != -1:
                    break
            finally:
                executor.shutdown()

        best = ckpt_manager.best() or latest_ckpt
        return Result(
            metrics=history[-1] if history else None,
            checkpoint=Checkpoint(best) if best else None,
            path=trial_info.trial_dir,
            error=error,
            metrics_history=history,
        )

    def fit(self) -> Result:
        result = self._run_loop(self._make_trial_info())
        if result.error is not None:
            raise TrainingFailedError(
                f"training failed after retries: {result.error}"
            ) from result.error
        return result

    # -- Tune integration ----------------------------------------------------

    def as_trainable(self):
        """Wrap this trainer as a Tune function-trainable (reference:
        base_trainer.py:819). The returned callable runs the full drive loop
        inside the trial and re-reports every worker report to Tune."""
        trainer = self

        def _trainable(config: Dict[str, Any]):
            import copy

            from ray_tpu_torch import tune
            from ray_tpu_torch.train import _session

            run_loop_config = dict(trainer.train_loop_config)
            run_loop_config.update(config.get("train_loop_config", config))
            t = copy.copy(trainer)
            t.train_loop_config = run_loop_config
            # Nest the inner worker gang's artifacts inside the tune trial's
            # directory (reference: the trainer IS the trial).
            trial_info = copy.copy(_session._get_session().trial_info)

            def cb(metrics, ckpt_path):
                tune.report(
                    metrics,
                    checkpoint=Checkpoint(ckpt_path) if ckpt_path else None,
                    _already_persisted=True,
                )

            result = t._run_loop(trial_info, report_cb=cb)
            if result.error is not None:
                raise result.error

        _trainable.__name__ = f"{type(self).__name__}_trainable"
        return _trainable
