"""Shared offline-data helpers (reference: rllib/offline/offline_data.py):
materialization and validation used by every offline algorithm (BC, MARWIL,
CQL)."""

from __future__ import annotations

from typing import List

import numpy as np


def materialize_offline(input_) -> List[dict]:
    """Rows from a ray_tpu_torch.data Dataset or any iterable of dicts."""
    rows = input_.take_all() if hasattr(input_, "take_all") else list(input_)
    if not rows:
        raise ValueError("offline dataset is empty")
    return rows


def validate_discrete_actions(acts: np.ndarray, num_actions: int, algo: str) -> np.ndarray:
    """int64 action indices within [0, num_actions); loud errors for
    continuous or out-of-range logged actions (silent truncation would
    train on garbage indices)."""
    if not np.issubdtype(acts.dtype, np.integer):
        if not np.allclose(acts, np.round(acts)):
            raise ValueError(
                f"{algo} requires discrete integer actions; got continuous "
                f"values (dtype {acts.dtype}) — this environment/dataset "
                "combination needs a continuous learner"
            )
        acts = np.round(acts)
    acts = acts.astype(np.int64)
    if acts.min() < 0 or acts.max() >= num_actions:
        raise ValueError(
            f"offline actions outside [0, {num_actions}): "
            f"min={acts.min()}, max={acts.max()} — dataset logged from a "
            "different action space?"
        )
    return acts
