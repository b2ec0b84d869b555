"""Tuner + TuneConfig + ResultGrid (reference: python/ray/tune/tuner.py:44,
tune/result_grid.py)."""

from __future__ import annotations

import os
import uuid
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.air.config import Result, RunConfig
from ray_tpu_torch.train._checkpoint import Checkpoint
from ray_tpu_torch.tune.schedulers import TrialScheduler
from ray_tpu_torch.tune.search import BasicVariantGenerator
from ray_tpu_torch.tune.tune_controller import (
    ERROR,
    Trial,
    TuneController,
    new_trial_id,
)


@dataclass
class TuneConfig:
    """reference: tune/tune_config.py."""

    metric: Optional[str] = None
    mode: str = "max"
    num_samples: int = 1
    max_concurrent_trials: Optional[int] = None
    scheduler: Optional[TrialScheduler] = None
    search_alg: Optional[Any] = None
    seed: Optional[int] = None

    def __post_init__(self):
        if self.mode not in ("max", "min"):
            raise ValueError("mode must be 'max' or 'min'")


class ResultGrid:
    """reference: tune/result_grid.py ResultGrid."""

    def __init__(self, results: List[Result], trials: List[Trial]):
        self._results = results
        self._trials = trials

    def __len__(self):
        return len(self._results)

    def __getitem__(self, i) -> Result:
        return self._results[i]

    @property
    def errors(self):
        return [r.error for r in self._results if r.error is not None]

    @property
    def num_errors(self) -> int:
        return len(self.errors)

    def get_best_result(
        self, metric: Optional[str] = None, mode: Optional[str] = None
    ) -> Result:
        metric = metric or getattr(self, "_default_metric", None)
        mode = mode or getattr(self, "_default_mode", "max")
        if metric is None:
            raise ValueError("metric is required (none set in TuneConfig)")
        sign = 1.0 if mode == "max" else -1.0
        scored = [
            r
            for r in self._results
            if r.metrics is not None and metric in r.metrics
        ]
        if not scored:
            raise RuntimeError(f"no trial reported metric {metric!r}")
        return max(scored, key=lambda r: sign * float(r.metrics[metric]))

    def get_dataframe(self):
        import pandas as pd

        return pd.DataFrame([r.metrics or {} for r in self._results])


def _with_resources_of(trainable) -> Dict[str, float]:
    return getattr(trainable, "_tune_resources", None) or {"CPU": 1.0}


def with_resources(trainable: Callable, resources: Dict[str, float]):
    """reference: tune/trainable/util.py with_resources."""
    if isinstance(trainable, type):
        # Subclass instead of mutating: the same Trainable class may be used
        # with different resources by different Tuners.
        return type(
            trainable.__name__,
            (trainable,),
            {"_tune_resources": dict(resources)},
        )

    def wrapped(config):
        return trainable(config)

    wrapped.__name__ = getattr(trainable, "__name__", "trainable")
    wrapped._tune_resources = dict(resources)
    return wrapped


class Tuner:
    """reference: tune/tuner.py:44; fit() at :344."""

    def __init__(
        self,
        trainable: Callable,
        *,
        param_space: Optional[Dict[str, Any]] = None,
        tune_config: Optional[TuneConfig] = None,
        run_config: Optional[RunConfig] = None,
        _trials: Optional[List[Trial]] = None,
    ):
        from ray_tpu_torch.train.base_trainer import BaseTrainer
        from ray_tpu_torch.tune.trainable import Trainable, class_trainable_to_fn

        if isinstance(trainable, BaseTrainer):
            self._trainer = trainable
            trainable = trainable.as_trainable()
        else:
            self._trainer = None
            if isinstance(trainable, type) and issubclass(trainable, Trainable):
                trainable = class_trainable_to_fn(trainable)
        self.trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or RunConfig()
        self._preloaded_trials = _trials

    def _experiment_layout(self):
        name = self.run_config.name or (
            f"{getattr(self.trainable, '__name__', 'exp')}_{uuid.uuid4().hex[:8]}"
        )
        storage = self.run_config.resolved_storage_path()
        exp_dir = os.path.join(storage, name)
        os.makedirs(exp_dir, exist_ok=True)
        return name, storage, exp_dir

    def fit(self) -> ResultGrid:
        name, storage, exp_dir = self._experiment_layout()
        searcher = None
        if self._preloaded_trials is not None:
            trials = self._preloaded_trials
        else:
            from ray_tpu_torch.tune.suggest import Searcher

            search = self.tune_config.search_alg or BasicVariantGenerator(
                self.tune_config.seed
            )
            if isinstance(search, Searcher):
                # Sequential suggest/observe searcher (TPE etc.): trials are
                # created on demand inside the controller so completed
                # results can steer later suggestions. Cohort schedulers are
                # incompatible with on-demand creation: synchronous
                # HyperBand fixes rung membership up front (late adds join
                # already-closed rungs), and PBT's exploit mutates configs
                # behind the searcher's back, poisoning its model.
                from ray_tpu_torch.tune.schedulers import (
                    HyperBandScheduler,
                    PopulationBasedTraining,
                )

                if isinstance(
                    self.tune_config.scheduler,
                    (HyperBandScheduler, PopulationBasedTraining),
                ):
                    raise ValueError(
                        "search_alg searchers cannot be combined with "
                        "synchronous HyperBand or PBT; use ASHA, median "
                        "stopping, or the default FIFO scheduler"
                    )
                search.set_search_space(self.param_space)
                search.set_metric(self.tune_config.metric, self.tune_config.mode)
                searcher = search
                trials = []
            else:
                configs = search.generate(
                    self.param_space, self.tune_config.num_samples
                )
                trials = [
                    Trial(trial_id=new_trial_id(), config=c) for c in configs
                ]
        scheduler = self.tune_config.scheduler
        if scheduler is not None:
            scheduler.set_metric(self.tune_config.metric, self.tune_config.mode)
        controller = TuneController(
            self.trainable,
            trials,
            experiment_name=name,
            experiment_dir=exp_dir,
            storage_path=storage,
            scheduler=scheduler,
            max_concurrent=self.tune_config.max_concurrent_trials,
            resources_per_trial=_with_resources_of(self.trainable),
            searcher=searcher,
            num_samples=self.tune_config.num_samples,
        )
        controller.metric = self.tune_config.metric
        controller.mode = self.tune_config.mode
        controller.stop_criteria = self.run_config.stop
        controller.run()
        results = [
            Result(
                metrics=t.last_result,
                checkpoint=Checkpoint(t.checkpoint_path)
                if t.checkpoint_path
                else None,
                path=os.path.join(exp_dir, t.trial_id),
                error=RuntimeError(t.error) if t.status == ERROR else None,
                metrics_history=t.history,
            )
            for t in trials
        ]
        grid = ResultGrid(results, trials)
        grid._default_metric = self.tune_config.metric
        grid._default_mode = self.tune_config.mode
        return grid

    @classmethod
    def restore(
        cls,
        path: str,
        trainable: Callable,
        *,
        resume_errored: bool = False,
        tune_config: Optional[TuneConfig] = None,
    ) -> "Tuner":
        """Rebuild a Tuner from an experiment dir; finished trials keep their
        results, unfinished (and optionally errored) ones re-run
        (reference: tuner.py Tuner.restore)."""
        state = TuneController.load_state(path)
        trials = []
        for ts in state["trials"]:
            t = Trial(
                trial_id=ts["trial_id"],
                config=ts["config"],
                history=ts["history"],
                checkpoint_path=ts["checkpoint_path"],
                error=ts["error"],
                early_stopped=ts["early_stopped"],
                status=ts["status"],
            )
            if t.status not in ("TERMINATED",) and not (
                t.status == ERROR and not resume_errored
            ):
                t.status = "PENDING"
            trials.append(t)
        run_config = RunConfig(
            name=os.path.basename(path), storage_path=os.path.dirname(path)
        )
        if tune_config is None and state.get("metric") is not None:
            tune_config = TuneConfig(
                metric=state["metric"], mode=state.get("mode") or "max"
            )
        return cls(
            trainable,
            tune_config=tune_config,
            run_config=run_config,
            _trials=trials,
        )
