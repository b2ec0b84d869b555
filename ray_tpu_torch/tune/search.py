"""Search spaces + variant generation (reference: python/ray/tune/search/
sample.py + basic_variant.py BasicVariantGenerator).

Grid axes cross-product; sampled domains draw `num_samples` times; each grid
cross-product is repeated per sample (reference semantics: num_samples
multiplies the grid).
"""

from __future__ import annotations

import itertools
import random
from typing import Any, Callable, Dict, List, Optional, Tuple


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Uniform(Domain):
    def __init__(self, low: float, high: float):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.uniform(self.low, self.high)


class LogUniform(Domain):
    def __init__(self, low: float, high: float):
        import math

        if low <= 0 or high <= 0:
            raise ValueError("loguniform bounds must be positive")
        self._lo, self._hi = math.log(low), math.log(high)

    def sample(self, rng):
        import math

        return math.exp(rng.uniform(self._lo, self._hi))


class RandInt(Domain):
    def __init__(self, low: int, high: int):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.randrange(self.low, self.high)


class Choice(Domain):
    def __init__(self, categories):
        self.categories = list(categories)

    def sample(self, rng):
        return rng.choice(self.categories)


class Function(Domain):
    def __init__(self, fn: Callable[[], Any]):
        self.fn = fn

    def sample(self, rng):
        return self.fn()


class GridSearch:
    def __init__(self, values):
        self.values = list(values)


# -- public constructors (tune.uniform etc.) ---------------------------------


def uniform(low: float, high: float) -> Uniform:
    return Uniform(low, high)


def loguniform(low: float, high: float) -> LogUniform:
    return LogUniform(low, high)


def randint(low: int, high: int) -> RandInt:
    return RandInt(low, high)


def choice(categories) -> Choice:
    return Choice(categories)


def sample_from(fn: Callable[[], Any]) -> Function:
    return Function(fn)


def grid_search(values) -> Dict[str, Any]:
    return {"grid_search": list(values)}


def _walk(space: Any, path: Tuple) -> Tuple[List[Tuple[Tuple, GridSearch]], List[Tuple[Tuple, Domain]]]:
    """Collect (path, GridSearch) and (path, Domain) leaves from a nested
    dict param space."""
    grids: List[Tuple[Tuple, GridSearch]] = []
    domains: List[Tuple[Tuple, Domain]] = []
    if isinstance(space, dict):
        if set(space.keys()) == {"grid_search"}:
            grids.append((path, GridSearch(space["grid_search"])))
            return grids, domains
        for k, v in space.items():
            g, d = _walk(v, path + (k,))
            grids.extend(g)
            domains.extend(d)
    elif isinstance(space, GridSearch):
        grids.append((path, space))
    elif isinstance(space, Domain):
        domains.append((path, space))
    return grids, domains


def _set_path(cfg: Dict, path: Tuple, value: Any) -> None:
    d = cfg
    for k in path[:-1]:
        d = d.setdefault(k, {})
    d[path[-1]] = value


def _materialize(space: Any) -> Dict:
    """Deep-copy the static parts of the space into a plain config dict."""
    if isinstance(space, dict):
        if set(space.keys()) == {"grid_search"}:
            return {}
        return {
            k: _materialize(v) if isinstance(v, dict) else v
            for k, v in space.items()
            if not isinstance(v, (Domain, GridSearch))
            and not (isinstance(v, dict) and set(v.keys()) == {"grid_search"})
        }
    return {}


class BasicVariantGenerator:
    """Grid cross-product × num_samples random draws."""

    def __init__(self, seed: Optional[int] = None):
        self._rng = random.Random(seed)

    def generate(self, param_space: Dict, num_samples: int) -> List[Dict]:
        grids, domains = _walk(param_space, ())
        grid_axes = [
            [(path, v) for v in g.values] for path, g in grids
        ] or [[]]
        configs: List[Dict] = []
        for _ in range(num_samples):
            for combo in itertools.product(*grid_axes) if grids else [()]:
                cfg = _materialize(param_space)
                for path, value in combo:
                    _set_path(cfg, path, value)
                for path, dom in domains:
                    _set_path(cfg, path, dom.sample(self._rng))
                configs.append(cfg)
        return configs
