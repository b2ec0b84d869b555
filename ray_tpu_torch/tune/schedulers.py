"""Trial schedulers (reference: python/ray/tune/schedulers — FIFO,
async_hyperband.py ASHA, median_stopping_rule.py).

Schedulers see every reported result and decide CONTINUE or STOP; the
controller enforces the decision by tearing down the trial actor.
"""

from __future__ import annotations

import collections
from typing import Any, Dict, List, Optional

CONTINUE = "CONTINUE"
STOP = "STOP"


class TrialScheduler:
    def set_metric(self, metric: Optional[str], mode: Optional[str]) -> None:
        if getattr(self, "metric", None) is None:
            self.metric = metric
        if getattr(self, "mode", None) is None:
            self.mode = mode

    def on_trial_add(self, trial_id: str) -> None:
        """Called once per trial before the experiment starts (reference:
        TrialScheduler.on_trial_add) — lets cohort-based schedulers fix
        membership up front instead of discovering trials lazily."""

    def on_trial_result(self, trial_id: str, result: Dict[str, Any]) -> str:
        return CONTINUE

    def on_trial_complete(self, trial_id: str, result: Optional[Dict[str, Any]]) -> None:
        pass


class FIFOScheduler(TrialScheduler):
    """Run every trial to completion."""


class AsyncHyperBandScheduler(TrialScheduler):
    """ASHA (reference: tune/schedulers/async_hyperband.py).

    Rungs at t = grace_period * reduction_factor**k up to max_t. When a trial
    reaches a rung it is compared against the top 1/reduction_factor quantile
    of everything recorded at that rung; below the cutoff → STOP. Async: no
    waiting for a full rung cohort.
    """

    def __init__(
        self,
        metric: Optional[str] = None,
        mode: Optional[str] = None,
        time_attr: str = "training_iteration",
        max_t: int = 100,
        grace_period: int = 1,
        reduction_factor: float = 4,
    ):
        self.metric, self.mode = metric, mode
        self.time_attr = time_attr
        self.max_t, self.grace = max_t, grace_period
        self.rf = reduction_factor
        self.rungs: List[int] = []
        t = grace_period
        while t < max_t:
            self.rungs.append(int(t))
            t *= reduction_factor
        # rung milestone -> recorded metric values of trials that reached it
        self.recorded: Dict[int, Dict[str, float]] = collections.defaultdict(dict)
        self._next_rung: Dict[str, int] = {}  # trial -> index into rungs

    def _sign(self) -> float:
        return 1.0 if (self.mode or "max") == "max" else -1.0

    def on_trial_result(self, trial_id: str, result: Dict[str, Any]) -> str:
        t = result.get(self.time_attr, 0)
        metric = result.get(self.metric)
        if metric is None:
            return CONTINUE
        if t >= self.max_t:
            return STOP
        idx = self._next_rung.setdefault(trial_id, 0)
        decision = CONTINUE
        while idx < len(self.rungs) and t >= self.rungs[idx]:
            milestone = self.rungs[idx]
            rung = self.recorded[milestone]
            rung[trial_id] = self._sign() * float(metric)
            vals = sorted(rung.values(), reverse=True)
            cutoff_n = max(1, int(len(vals) / self.rf))
            cutoff = vals[cutoff_n - 1]
            if rung[trial_id] < cutoff:
                decision = STOP
            idx += 1
        self._next_rung[trial_id] = idx
        return decision


class MedianStoppingRule(TrialScheduler):
    """Stop a trial whose running-average metric falls below the median of
    all trials' averages at the same step (reference:
    tune/schedulers/median_stopping_rule.py)."""

    def __init__(
        self,
        metric: Optional[str] = None,
        mode: Optional[str] = None,
        time_attr: str = "training_iteration",
        grace_period: int = 1,
        min_samples_required: int = 3,
    ):
        self.metric, self.mode = metric, mode
        self.time_attr = time_attr
        self.grace = grace_period
        self.min_samples = min_samples_required
        self._history: Dict[str, List[float]] = collections.defaultdict(list)

    def _sign(self) -> float:
        return 1.0 if (self.mode or "max") == "max" else -1.0

    def on_trial_result(self, trial_id: str, result: Dict[str, Any]) -> str:
        t = result.get(self.time_attr, 0)
        metric = result.get(self.metric)
        if metric is None:
            return CONTINUE
        self._history[trial_id].append(self._sign() * float(metric))
        if t < self.grace or len(self._history) < self.min_samples:
            return CONTINUE
        averages = {
            tid: sum(h) / len(h) for tid, h in self._history.items() if h
        }
        vals = sorted(averages.values())
        median = vals[len(vals) // 2]
        if averages[trial_id] < median:
            return STOP
        return CONTINUE


# Extended decisions (beyond CONTINUE/STOP): tuple decisions carry a payload.
PAUSE = "PAUSE"
EXPLOIT = "EXPLOIT"  # ("EXPLOIT", new_config, donor_checkpoint_path)
RESUME = "RESUME"
COMPLETE = "COMPLETE"  # trial used its full budget: stop WITHOUT early_stopped


class PopulationBasedTraining(TrialScheduler):
    """PBT (reference: tune/schedulers/pbt.py PopulationBasedTraining).

    Every `perturbation_interval` units of `time_attr`, a trial in the
    bottom `quantile_fraction` of the population EXPLOITS a trial from the
    top quantile: it adopts the donor's latest checkpoint and a mutated copy
    of the donor's config (explore step), then continues training in place.
    Requires trainables that report with checkpoints — the fork is a
    checkpoint restore.

    hyperparam_mutations: {key: list | (low, high) tuple | callable}. The
    explore step resamples the key with `resample_probability`, otherwise
    multiplies numeric values by 0.8 or 1.2 (the reference's default
    perturbation factors).
    """

    def __init__(
        self,
        metric: Optional[str] = None,
        mode: Optional[str] = None,
        time_attr: str = "training_iteration",
        perturbation_interval: int = 4,
        hyperparam_mutations: Optional[Dict[str, Any]] = None,
        quantile_fraction: float = 0.25,
        resample_probability: float = 0.25,
        seed: Optional[int] = None,
    ):
        import random

        if not hyperparam_mutations:
            raise ValueError("hyperparam_mutations must be a non-empty dict")
        if not 0.0 < quantile_fraction <= 0.5:
            raise ValueError("quantile_fraction must be in (0, 0.5]")
        self.metric, self.mode = metric, mode
        self.time_attr = time_attr
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations
        self.quantile = quantile_fraction
        self.resample_prob = resample_probability
        self._rng = random.Random(seed)
        self._scores: Dict[str, float] = {}  # trial -> latest signed score
        self._last_perturb: Dict[str, int] = {}
        self._trial_reader = None  # injected by the controller
        self.num_perturbations = 0

    def set_trial_state_reader(self, fn) -> None:
        """Controller injects `fn(trial_id) -> Trial` so explore can read the
        donor's config and checkpoint."""
        self._trial_reader = fn

    def _sign(self) -> float:
        return 1.0 if (self.mode or "max") == "max" else -1.0

    def _quantiles(self):
        ranked = sorted(self._scores.items(), key=lambda kv: kv[1])
        n = max(1, int(len(ranked) * self.quantile))
        if len(ranked) < 2 * n:
            return [], []
        return [t for t, _ in ranked[:n]], [t for t, _ in ranked[-n:]]

    def _explore(self, config: Dict[str, Any]) -> Dict[str, Any]:
        """Mutate a copy of `config`. Spec semantics: list = categorical
        choices (perturb moves to a neighboring choice), (lo, hi) tuple =
        continuous range (perturb multiplies by 0.8/1.2, clamped), callable
        = sampler (always resampled when chosen)."""
        out = dict(config)
        for key, spec in self.mutations.items():
            resample = self._rng.random() < self.resample_prob or key not in out
            if callable(spec):
                if resample:
                    out[key] = spec()
                continue
            if isinstance(spec, list):
                if resample:
                    out[key] = self._rng.choice(spec)
                else:
                    try:
                        i = spec.index(out[key])
                        j = max(0, min(len(spec) - 1,
                                       i + self._rng.choice((-1, 1))))
                        out[key] = spec[j]
                    except ValueError:
                        out[key] = self._rng.choice(spec)
                continue
            if isinstance(spec, tuple) and len(spec) == 2:
                lo, hi = spec
                if resample:
                    val = self._rng.uniform(lo, hi)
                else:
                    val = out[key] * self._rng.choice((0.8, 1.2))
                val = max(lo, min(hi, val))
                out[key] = int(round(val)) if isinstance(
                    out.get(key), int
                ) else val
                continue
            raise ValueError(
                f"unsupported mutation spec for {key!r}: {spec!r}"
            )
        return out

    def on_trial_result(self, trial_id: str, result: Dict[str, Any]):
        t = result.get(self.time_attr, 0)
        metric = result.get(self.metric)
        if metric is None:
            return CONTINUE
        self._scores[trial_id] = self._sign() * float(metric)
        last = self._last_perturb.setdefault(trial_id, 0)
        if t - last < self.interval:
            return CONTINUE
        self._last_perturb[trial_id] = t
        bottom, top = self._quantiles()
        if trial_id not in bottom or not top or self._trial_reader is None:
            return CONTINUE
        donor_id = self._rng.choice(top)
        donor = self._trial_reader(donor_id)
        if donor is None or not donor.checkpoint_path:
            return CONTINUE
        self.num_perturbations += 1
        return (EXPLOIT, self._explore(donor.config), donor.checkpoint_path)

    def on_trial_complete(self, trial_id, result) -> None:
        self._scores.pop(trial_id, None)


class HyperBandScheduler(TrialScheduler):
    """Synchronous successive-halving brackets (reference:
    tune/schedulers/hyperband.py HyperBandScheduler).

    Trials are assigned round-robin to `brackets` cohorts; bracket b's first
    milestone is grace_period * eta**b (classic HyperBand trades more trials
    at small budgets against fewer at large ones). At each milestone the
    WHOLE cohort synchronizes: every live trial pauses on arrival, and when
    the last one arrives the top 1/eta continue (resume from checkpoint) and
    the rest stop. Requires checkpointing trainables for pause/resume.
    """

    def __init__(
        self,
        metric: Optional[str] = None,
        mode: Optional[str] = None,
        time_attr: str = "training_iteration",
        max_t: int = 81,
        grace_period: int = 1,
        reduction_factor: float = 3,
        brackets: int = 1,
    ):
        self.metric, self.mode = metric, mode
        self.time_attr = time_attr
        self.max_t = max_t
        self.grace = grace_period
        self.eta = reduction_factor
        self.n_brackets = max(1, brackets)
        # bracket -> list of milestones
        self.milestones: Dict[int, List[int]] = {}
        for b in range(self.n_brackets):
            ms, t = [], grace_period * reduction_factor**b
            while t < max_t:
                ms.append(int(t))
                t *= reduction_factor
            self.milestones[b] = ms or [int(max_t)]
        self._bracket_of: Dict[str, int] = {}
        self._next_assign = 0
        # (bracket, milestone) -> {trial: signed score}
        self._rung: Dict[tuple, Dict[str, float]] = collections.defaultdict(dict)
        self._rung_idx: Dict[str, int] = {}
        self._live: Dict[int, set] = collections.defaultdict(set)
        self._closed: set = set()  # (bracket, milestone) rungs already halved
        self._actions: List[tuple] = []  # (trial_id, RESUME | STOP)

    def _sign(self) -> float:
        return 1.0 if (self.mode or "max") == "max" else -1.0

    def on_trial_add(self, trial_id: str) -> None:
        self._bracket(trial_id)

    def _bracket(self, trial_id: str) -> int:
        # Membership is normally fixed by on_trial_add before any trial
        # runs; the lazy path only covers schedulers driven outside the
        # controller. Without up-front membership a fast trial could close
        # a rung before slower trials joined the cohort.
        if trial_id not in self._bracket_of:
            b = self._next_assign % self.n_brackets
            self._next_assign += 1
            self._bracket_of[trial_id] = b
            self._live[b].add(trial_id)
        return self._bracket_of[trial_id]

    def _maybe_close_rung(self, b: int, milestone: int) -> None:
        if (b, milestone) in self._closed:
            return  # already halved; a late recheck must not re-emit actions
        rung = self._rung[(b, milestone)]
        live = self._live[b]
        if not live or not (set(rung) >= live):
            return  # cohort not complete yet
        self._closed.add((b, milestone))
        # Rank only members still alive (dead ones cannot resume).
        alive = {tid: v for tid, v in rung.items() if tid in live}
        # Halve over trials that can actually resume: when cohort members
        # died after reporting, keep_n from len(rung) would resume more than
        # 1/eta of the survivors and weaken the selection.
        keep_n = max(1, int(len(alive) / self.eta))
        ranked = sorted(alive.items(), key=lambda kv: -kv[1])
        for i, (tid, _) in enumerate(ranked):
            if i < keep_n:
                self._actions.append((tid, RESUME))
            else:
                self._live[b].discard(tid)
                self._actions.append((tid, STOP))

    def _discard_live(self, trial_id: str) -> None:
        """Remove a trial from its cohort and recheck rungs its departure may
        have completed (a dead/finished member must not block the barrier)."""
        b = self._bracket_of.get(trial_id)
        if b is None or trial_id not in self._live[b]:
            return
        self._live[b].discard(trial_id)
        for m in self.milestones[b]:
            if (b, m) in self._rung:
                self._maybe_close_rung(b, m)

    def on_trial_result(self, trial_id: str, result: Dict[str, Any]):
        t = result.get(self.time_attr, 0)
        metric = result.get(self.metric)
        if metric is None:
            return CONTINUE
        b = self._bracket(trial_id)
        if t >= self.max_t:
            # Full budget used: normal completion, not a halving kill.
            self._discard_live(trial_id)
            return COMPLETE
        ms = self.milestones[b]
        idx = self._rung_idx.setdefault(trial_id, 0)
        if idx >= len(ms) or t < ms[idx]:
            return CONTINUE
        milestone = ms[idx]
        self._rung[(b, milestone)][trial_id] = self._sign() * float(metric)
        self._rung_idx[trial_id] = idx + 1
        self._maybe_close_rung(b, milestone)
        return PAUSE

    def on_trial_complete(self, trial_id, result) -> None:
        self._discard_live(trial_id)

    def pop_actions(self) -> List[tuple]:
        """Controller drains (trial_id, RESUME|STOP) decisions produced when
        a rung cohort completed."""
        out, self._actions = self._actions, []
        return out
