"""Adaptive search algorithms (reference: python/ray/tune/search/ — the
Searcher interface of searcher.py plus the optuna/hyperopt-style adapters).

External bayesopt libraries aren't available in this environment, so the
TPE searcher is implemented natively: the tree-structured Parzen estimator
of Bergstra et al. (the algorithm behind hyperopt/optuna defaults) over the
same Domain leaves tune's random search uses. Sequential protocol:
``suggest(trial_id) -> config`` draws a candidate, ``on_trial_complete``
feeds the observed metric back; after ``n_initial`` random startup trials,
candidates are drawn from a kernel-density model of the GOOD observations
and ranked by the good/bad density ratio.
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.tune.search import (
    Choice,
    Domain,
    GridSearch,
    LogUniform,
    RandInt,
    Uniform,
    _materialize,
    _set_path,
    _walk,
)


class Searcher:
    """Sequential suggest/observe interface (reference: search/searcher.py)."""

    metric: Optional[str] = None
    mode: Optional[str] = None

    def set_metric(self, metric: Optional[str], mode: Optional[str]) -> None:
        if self.metric is None:
            self.metric = metric
        if self.mode is None:
            self.mode = mode

    def set_search_space(self, param_space: Dict) -> None:
        raise NotImplementedError

    def suggest(self, trial_id: str) -> Optional[Dict]:
        raise NotImplementedError

    def on_trial_complete(
        self, trial_id: str, result: Optional[Dict[str, Any]]
    ) -> None:
        pass


class TPESearcher(Searcher):
    """Native tree-structured Parzen estimator.

    Per dimension, observations are split at the gamma-quantile of the
    objective into good/bad sets; `n_candidates` draws from the good set's
    Parzen mixture are ranked by l(x)/g(x) and the best wins. Continuous
    dims use Gaussian kernels (log-space for LogUniform); Choice/RandInt use
    smoothed categorical counts. Grid-search leaves are not supported — use
    the grid generator for those.
    """

    def __init__(
        self,
        metric: Optional[str] = None,
        mode: Optional[str] = None,
        n_initial: int = 8,
        gamma: float = 0.25,
        n_candidates: int = 24,
        seed: Optional[int] = None,
    ):
        self.metric, self.mode = metric, mode
        self.n_initial = n_initial
        self.gamma = gamma
        self.n_candidates = n_candidates
        self._rng = random.Random(seed)
        self._dims: List[Tuple[Tuple, Domain]] = []
        self._space: Optional[Dict] = None
        # trial_id -> {path: value}; observations: (values dict, score)
        self._pending: Dict[str, Dict[Tuple, Any]] = {}
        self._obs: List[Tuple[Dict[Tuple, Any], float]] = []

    # -- space ---------------------------------------------------------------

    def set_search_space(self, param_space: Dict) -> None:
        grids, domains = _walk(param_space, ())
        if grids:
            raise ValueError(
                "TPESearcher does not accept grid_search leaves; use plain "
                "domains (tune.uniform/loguniform/randint/choice)"
            )
        if not domains:
            raise ValueError("param_space has no tunable domains")
        self._space = param_space
        self._dims = domains

    # -- model ---------------------------------------------------------------

    def _split(self):
        sign = 1.0 if (self.mode or "max") == "max" else -1.0
        ranked = sorted(self._obs, key=lambda o: -sign * o[1])
        n_good = max(1, int(math.ceil(len(ranked) * self.gamma)))
        return ranked[:n_good], ranked[n_good:]

    @staticmethod
    def _to_internal(dom: Domain, v: float):
        return math.log(v) if isinstance(dom, LogUniform) else float(v)

    @staticmethod
    def _from_internal(dom: Domain, x: float):
        return math.exp(x) if isinstance(dom, LogUniform) else x

    def _bounds(self, dom: Domain) -> Tuple[float, float]:
        if isinstance(dom, Uniform):
            return dom.low, dom.high
        if isinstance(dom, LogUniform):
            return dom._lo, dom._hi
        if isinstance(dom, RandInt):
            return float(dom.low), float(dom.high - 1)
        raise TypeError(dom)

    def _parzen_sample(self, dom, points: List[float], rng) -> float:
        lo, hi = self._bounds(dom)
        width = (hi - lo) or 1.0
        sigma = max(width / max(len(points), 1), width / 25.0)
        center = rng.choice(points) if points else rng.uniform(lo, hi)
        return min(hi, max(lo, rng.gauss(center, sigma)))

    def _parzen_logpdf(self, dom, points: List[float], x: float) -> float:
        lo, hi = self._bounds(dom)
        width = (hi - lo) or 1.0
        sigma = max(width / max(len(points), 1), width / 25.0)
        if not points:
            return -math.log(width)
        acc = 0.0
        for c in points:
            acc += math.exp(-0.5 * ((x - c) / sigma) ** 2)
        return math.log(acc / (len(points) * sigma * math.sqrt(2 * math.pi)) + 1e-300)

    def _suggest_dim(self, path: Tuple, dom: Domain, good, bad):
        if isinstance(dom, (Choice, RandInt)) and isinstance(dom, Choice):
            cats = dom.categories
            # Smoothed categorical TPE: P(cat|good) / P(cat|bad).
            def counts(obs):
                c = {i: 1.0 for i in range(len(cats))}
                for values, _ in obs:
                    v = values.get(path)
                    for i, cat in enumerate(cats):
                        if cat == v:
                            c[i] += 1.0
                total = sum(c.values())
                return {i: n / total for i, n in c.items()}

            pg, pb = counts(good), counts(bad)
            best = max(
                range(len(cats)),
                key=lambda i: pg[i] / pb[i] + self._rng.random() * 1e-6,
            )
            return cats[best]
        good_pts = [
            self._to_internal(dom, v[path]) for v, _ in good if path in v
        ]
        bad_pts = [
            self._to_internal(dom, v[path]) for v, _ in bad if path in v
        ]
        best_x, best_score = None, -math.inf
        for _ in range(self.n_candidates):
            x = self._parzen_sample(dom, good_pts, self._rng)
            score = self._parzen_logpdf(dom, good_pts, x) - self._parzen_logpdf(
                dom, bad_pts, x
            )
            if score > best_score:
                best_x, best_score = x, score
        val = self._from_internal(dom, best_x)
        if isinstance(dom, RandInt):
            val = int(round(val))
            val = min(dom.high - 1, max(dom.low, val))
        return val

    # -- protocol ------------------------------------------------------------

    def suggest(self, trial_id: str) -> Optional[Dict]:
        if self._space is None:
            raise RuntimeError("set_search_space() was not called")
        values: Dict[Tuple, Any] = {}
        startup = len(self._obs) < self.n_initial
        good, bad = (None, None) if startup else self._split()
        for path, dom in self._dims:
            if startup or not bad:
                values[path] = dom.sample(self._rng)
            else:
                values[path] = self._suggest_dim(path, dom, good, bad)
        self._pending[trial_id] = values
        cfg = _materialize(self._space)
        for path, v in values.items():
            _set_path(cfg, path, v)
        return cfg

    def on_trial_complete(self, trial_id, result) -> None:
        values = self._pending.pop(trial_id, None)
        if values is None or result is None:
            return
        metric = result.get(self.metric) if self.metric else None
        if metric is None:
            return
        self._obs.append((values, float(metric)))
