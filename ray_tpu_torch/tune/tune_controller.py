"""Trial lifecycle + the controller event loop (reference:
python/ray/tune/execution/tune_controller.py:68).

Each trial runs inside a TrainWorker actor (shared machinery with train:
world-size-1 session, report queue drained by poll). The controller starts
trials as concurrency slots free up, drains results, feeds the scheduler, and
enforces STOP decisions by killing the trial actor.
"""

from __future__ import annotations

import os
import pickle
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch.train._session import TrialInfo
from ray_tpu_torch.tune import schedulers as sched_mod

PENDING, RUNNING, PAUSED, TERMINATED, ERROR = (
    "PENDING", "RUNNING", "PAUSED", "TERMINATED", "ERROR",
)


@dataclass
class Trial:
    trial_id: str
    config: Dict[str, Any]
    status: str = PENDING
    history: List[Dict[str, Any]] = field(default_factory=list)
    checkpoint_path: Optional[str] = None
    error: Optional[str] = None
    early_stopped: bool = False
    num_perturbations: int = 0  # PBT exploit/explore restarts
    actor: Any = None
    run_ref: Any = None

    @property
    def last_result(self) -> Optional[Dict[str, Any]]:
        return self.history[-1] if self.history else None

    def public_state(self) -> Dict[str, Any]:
        return {
            "trial_id": self.trial_id,
            "config": self.config,
            "status": self.status,
            "history": self.history,
            "checkpoint_path": self.checkpoint_path,
            "error": self.error,
            "early_stopped": self.early_stopped,
        }


class TuneController:
    def __init__(
        self,
        trainable: Callable,
        trials: List[Trial],
        *,
        experiment_name: str,
        experiment_dir: str,
        storage_path: str,
        scheduler: Optional[sched_mod.TrialScheduler] = None,
        max_concurrent: Optional[int] = None,
        resources_per_trial: Optional[Dict[str, float]] = None,
        poll_timeout: float = 2.0,
        searcher: Optional[Any] = None,
        num_samples: int = 0,
    ):
        self.trainable_blob = cloudpickle.dumps(trainable)
        self.trials = trials
        # Sequential suggest/observe searcher (reference: tune/search/
        # searcher.py protocol): trials are created on demand via
        # searcher.suggest() as slots free up, and completions feed back
        # through searcher.on_trial_complete so the model adapts.
        self.searcher = searcher
        self.num_samples = num_samples
        self.experiment_name = experiment_name
        self.experiment_dir = experiment_dir
        self.storage_path = storage_path
        self.scheduler = scheduler or sched_mod.FIFOScheduler()
        self.max_concurrent = max_concurrent or len(trials) or 1
        self.resources = resources_per_trial or {"CPU": 1.0}
        self.poll_timeout = poll_timeout
        self.stop_criteria: Optional[Dict[str, Any]] = None
        # PBT's explore step reads donor configs/checkpoints through this.
        by_id = {t.trial_id: t for t in trials}
        if hasattr(self.scheduler, "set_trial_state_reader"):
            self.scheduler.set_trial_state_reader(by_id.get)
        for t in trials:
            self.scheduler.on_trial_add(t.trial_id)

    # -- trial actor management ---------------------------------------------

    def _start_trial(self, trial: Trial) -> None:
        from ray_tpu_torch.train._worker_group import TrainWorker

        cls = ray_tpu_torch.remote(TrainWorker)
        opts: Dict[str, Any] = {"max_concurrency": 4}
        res = dict(self.resources)
        opts["num_cpus"] = res.pop("CPU", 1.0)
        if "GPU" in res:
            opts["num_gpus"] = res.pop("GPU")
        if res:
            opts["resources"] = res
        trial.actor = cls.options(**opts).remote(None)
        trial_dir = os.path.join(self.experiment_dir, trial.trial_id)
        ray_tpu_torch.get(
            trial.actor.setup_session.remote(
                world_rank=0,
                world_size=1,
                local_rank=0,
                local_world_size=1,
                node_rank=0,
                trial_info=TrialInfo(
                    name=trial.trial_id,
                    experiment_name=self.experiment_name,
                    trial_id=trial.trial_id,
                    storage_path=self.storage_path,
                    trial_dir=trial_dir,
                ),
                latest_checkpoint_path=trial.checkpoint_path,
                dataset_shards={},
                loop_config=trial.config,
                collective_group=None,
                # Resumed/exploited trials continue the checkpoint-dir
                # numbering where their history left off, so post-resume
                # checkpoints never overwrite pre-pause directories.
                start_iteration=len(trial.history),
            )
        )
        trial.run_ref = trial.actor.run.remote(self.trainable_blob)
        trial.status = RUNNING

    def _stop_trial(self, trial: Trial, status: str, error: Optional[str] = None):
        trial.status = status
        trial.error = error
        if trial.actor is not None:
            try:
                ray_tpu_torch.kill(trial.actor)
            except Exception:
                pass
            trial.actor = None
        if self.searcher is not None and status in (TERMINATED, ERROR):
            self.searcher.on_trial_complete(
                trial.trial_id, trial.last_result if status == TERMINATED else None
            )

    def _suggest_trials(self) -> None:
        """Top up pending trials from the searcher while sample budget and
        concurrency allow."""
        if self.searcher is None:
            return
        live = [t for t in self.trials if t.status in (RUNNING, PENDING, PAUSED)]
        while (
            len(self.trials) < self.num_samples
            and len(live) < self.max_concurrent
        ):
            tid = new_trial_id()
            config = self.searcher.suggest(tid)
            if config is None:
                break
            trial = Trial(trial_id=tid, config=config)
            self.trials.append(trial)
            self.scheduler.on_trial_add(tid)
            live.append(trial)

    # -- the loop ------------------------------------------------------------

    def _apply_decision(self, trial: Trial, decision) -> bool:
        """Enforce a scheduler decision; True if the trial stopped running."""
        if isinstance(decision, tuple) and decision[0] == sched_mod.EXPLOIT:
            # PBT exploit/explore: adopt the donor's checkpoint + a mutated
            # config and restart the trial in place (history continues).
            _, new_config, donor_ckpt = decision
            trial.config = dict(new_config)
            trial.checkpoint_path = donor_ckpt
            trial.num_perturbations += 1
            self._stop_trial(trial, PENDING)
            return True
        if decision == sched_mod.PAUSE:
            # The trial resumes from its latest reported checkpoint when the
            # scheduler releases it (synchronous rung barrier).
            self._stop_trial(trial, PAUSED)
            return True
        if decision in (sched_mod.STOP, sched_mod.COMPLETE):
            # COMPLETE = budget exhausted (normal end); STOP = killed by the
            # scheduler's selection — only the latter is "early stopped".
            trial.early_stopped = decision == sched_mod.STOP
            self._stop_trial(trial, TERMINATED)
            self.scheduler.on_trial_complete(trial.trial_id, trial.last_result)
            return True
        return False

    def _drain_scheduler_actions(self) -> None:
        if not hasattr(self.scheduler, "pop_actions"):
            return
        by_id = {t.trial_id: t for t in self.trials}
        for trial_id, action in self.scheduler.pop_actions():
            trial = by_id.get(trial_id)
            if trial is None or trial.status in (TERMINATED, ERROR):
                continue
            if action == sched_mod.RESUME:
                if trial.status == PAUSED:
                    trial.status = PENDING
            elif action == sched_mod.STOP:
                trial.early_stopped = True
                self._stop_trial(trial, TERMINATED)
                self.scheduler.on_trial_complete(
                    trial.trial_id, trial.last_result
                )

    def _hit_stop_criteria(self, metrics: Dict[str, Any]) -> bool:
        if not self.stop_criteria:
            return False
        for key, threshold in self.stop_criteria.items():
            val = metrics.get(key)
            if val is None:
                continue
            try:
                if float(val) >= float(threshold):
                    return True
            except (TypeError, ValueError):
                # Non-numeric reported value (e.g. a status string) must not
                # abort the whole experiment from inside the poll loop.
                continue
        return False

    def run(self, result_cb: Optional[Callable[[Trial, Dict], None]] = None):
        while True:
            self._drain_scheduler_actions()
            self._suggest_trials()
            running = [t for t in self.trials if t.status == RUNNING]
            pending = [t for t in self.trials if t.status == PENDING]
            paused = [t for t in self.trials if t.status == PAUSED]
            if not running and not pending:
                if not paused:
                    break
                # Every live trial is paused and the scheduler produced no
                # actions: a dead cohort member can cause this. Resuming
                # everyone beats deadlocking the experiment.
                for t in paused:
                    t.status = PENDING
                continue
            # Fill free slots.
            for t in pending[: max(0, self.max_concurrent - len(running))]:
                self._start_trial(t)
                running.append(t)
            # Drain one poll round across all running trials (each poll
            # batch-drains the trial's whole result queue).
            refs = [
                t.actor.poll.remote(self.poll_timeout, None) for t in running
            ]
            for trial, rep in zip(running, self._safe_get(refs, running)):
                if rep is None:  # actor died
                    self._stop_trial(trial, ERROR, "trial actor died")
                    self.scheduler.on_trial_complete(trial.trial_id, None)
                    continue
                if "results" in rep:
                    for r in rep["results"]:
                        metrics = dict(r["metrics"])
                        metrics.setdefault(
                            "training_iteration", r["iteration"] + 1
                        )
                        metrics.setdefault("trial_id", trial.trial_id)
                        trial.history.append(metrics)
                        if r["checkpoint_path"]:
                            trial.checkpoint_path = r["checkpoint_path"]
                        if result_cb:
                            result_cb(trial, metrics)
                        if self._hit_stop_criteria(metrics):
                            self._stop_trial(trial, TERMINATED)
                            self.scheduler.on_trial_complete(
                                trial.trial_id, trial.last_result
                            )
                            break
                        decision = self.scheduler.on_trial_result(
                            trial.trial_id, metrics
                        )
                        if self._apply_decision(trial, decision):
                            break
                elif rep.get("done"):
                    if rep.get("error"):
                        self._stop_trial(trial, ERROR, rep["error"])
                    else:
                        self._stop_trial(trial, TERMINATED)
                    self.scheduler.on_trial_complete(
                        trial.trial_id, trial.last_result
                    )
            self.save_state()

    def _safe_get(self, refs, trials):
        out = []
        for ref, trial in zip(refs, trials):
            try:
                out.append(ray_tpu_torch.get(ref, timeout=self.poll_timeout + 60))
            except Exception:
                out.append(None)
        return out

    # -- persistence (Tuner.restore) ----------------------------------------

    def save_state(self) -> None:
        state = {
            "experiment_name": self.experiment_name,
            "metric": getattr(self, "metric", None),
            "mode": getattr(self, "mode", None),
            "trials": [t.public_state() for t in self.trials],
        }
        os.makedirs(self.experiment_dir, exist_ok=True)
        tmp = os.path.join(self.experiment_dir, ".experiment_state.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(state, f)
        os.replace(tmp, os.path.join(self.experiment_dir, "experiment_state.pkl"))

    @staticmethod
    def load_state(experiment_dir: str) -> Dict[str, Any]:
        with open(os.path.join(experiment_dir, "experiment_state.pkl"), "rb") as f:
            return pickle.load(f)


def new_trial_id() -> str:
    return uuid.uuid4().hex[:8]
