"""LearnerGroup: one local learner, or a gang of learner actors.

Port of ray_tpu/rllib/core/learner_group.py (analog of
rllib/core/learner/learner_group.py:69). Data parallelism as the reference
does it: each learner computes grads on its batch shard, the group's own
process averages the numpy grads and sends the mean to every learner,
which applies it (the reference's RLlib wraps torch DDP instead —
torch_learner.py:354). Learner actors leased GPUs build their learner on
their current card; a learner asked for "cuda" without a GPU lease raises.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional

import cloudpickle
import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.utils.actor_manager import FaultTolerantActorManager

logger = logging.getLogger(__name__)


def _on_cuda(device) -> bool:
    return str(device).startswith("cuda")


class _LearnerActor:
    """Actor shell hosting a Learner (reference: learner actors under
    FaultTolerantActorManager, learner_group.py:178)."""

    def __init__(self, learner_blob: bytes, device: str = "cuda", num_gpus: float = 0.0):
        build = cloudpickle.loads(learner_blob)
        if _on_cuda(device):
            if not num_gpus:
                raise RuntimeError("a learner actor on cuda needs a GPU lease "
                                   "(num_gpus_per_learner > 0)")
            import torch

            device = f"cuda:{torch.cuda.current_device()}"
        self.learner = build(device)

    def ping(self):
        return "pong"

    def get_device(self) -> str:
        return str(self.learner.device)

    def update_from_batch(self, batch):
        return self.learner.update_from_batch(batch)

    def compute_gradients(self, batch):
        return self.learner.compute_gradients(batch)

    def apply_gradients(self, grads):
        self.learner.apply_gradients(grads)

    def get_weights(self):
        return self.learner.get_weights()

    def set_weights(self, weights):
        self.learner.set_weights(weights)

    def get_state(self):
        return self.learner.get_state()

    def set_state(self, state):
        self.learner.set_state(state)


def _mean_tree(trees: List[Any]):
    """Leaf-wise mean of numpy trees of one structure (dicts and lists)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _mean_tree([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_mean_tree(list(xs)) for xs in zip(*trees))
    return sum(trees) / len(trees)


class LearnerGroup:
    def __init__(
        self,
        learner_builder: Callable[[str], Any],
        *,
        num_learners: int = 0,
        num_cpus_per_learner: float = 1.0,
        num_gpus_per_learner: float = 0.0,
        device: str = "cuda",
    ):
        """`learner_builder(device)` builds one learner on `device`."""
        self._builder = learner_builder
        self.num_learners = num_learners
        if num_learners == 0:
            self._local = learner_builder(device)
            self._manager = None
        else:
            if _on_cuda(device) and not num_gpus_per_learner:
                raise ValueError("learner actors on cuda need num_gpus_per_learner > 0 "
                                 "(or learners(device='cpu'))")
            self._local = None
            blob = cloudpickle.dumps(learner_builder)
            cls = ray_tpu_torch.remote(_LearnerActor)
            actors = [
                cls.options(
                    num_cpus=num_cpus_per_learner,
                    num_gpus=num_gpus_per_learner or None,
                    max_restarts=1,
                ).remote(blob, device, num_gpus_per_learner)
                for _ in range(num_learners)
            ]
            self._manager = FaultTolerantActorManager(actors)

    @property
    def is_local(self) -> bool:
        return self._local is not None

    def update_from_batch(
        self, batch: Dict[str, np.ndarray], *, time_major: bool = False
    ) -> Dict[str, float]:
        """One synchronous update. Remote mode: shard batch across healthy
        learners, average grads, apply everywhere (keeps learners in sync).
        time_major=True shards [T, B, ...] arrays along the B axis (IMPALA
        fragments must never be split along time — V-trace scans over T)."""
        if self._local is not None:
            return self._local.update_from_batch(batch)
        ids = self._manager.healthy_actor_ids()
        if not ids:
            raise RuntimeError("no healthy learner actors")
        shards = _shard_batch(batch, len(ids), time_major=time_major)
        refs = [
            (i, self._manager.actors[i].compute_gradients.remote(shard))
            for i, shard in zip(ids, shards)
        ]
        metrics_list = []
        grads_list = []
        for i, ref in refs:
            try:
                grads, metrics = ray_tpu_torch.get(ref)
                grads_list.append(grads)
                metrics_list.append(metrics)
            except Exception as e:
                self._manager.set_actor_state(i, False)
                logger.warning("learner %d failed update: %r", i, e)
        if not grads_list:
            raise RuntimeError("all learner actors failed the update")
        mean_grads = _mean_tree(grads_list)
        self._manager.foreach_actor(
            lambda a: a.apply_gradients.remote(mean_grads)
        )
        out = {
            k: float(np.mean([m[k] for m in metrics_list]))
            for k in metrics_list[0]
        }
        return out

    def get_weights(self):
        if self._local is not None:
            return self._local.get_weights()
        ids = self._manager.healthy_actor_ids()
        return ray_tpu_torch.get(self._manager.actors[ids[0]].get_weights.remote())

    def set_weights(self, weights) -> None:
        if self._local is not None:
            self._local.set_weights(weights)
        else:
            self._manager.foreach_actor(lambda a: a.set_weights.remote(weights))

    def get_state(self):
        if self._local is not None:
            return self._local.get_state()
        ids = self._manager.healthy_actor_ids()
        return ray_tpu_torch.get(self._manager.actors[ids[0]].get_state.remote())

    def set_state(self, state) -> None:
        if self._local is not None:
            self._local.set_state(state)
        else:
            self._manager.foreach_actor(lambda a: a.set_state.remote(state))

    def shutdown(self) -> None:
        if self._manager is not None:
            for a in self._manager.actors:
                try:
                    ray_tpu_torch.kill(a)
                except Exception:
                    pass


def _shard_batch(
    batch: Dict[str, np.ndarray], n: int, *, time_major: bool = False
) -> List[Dict[str, np.ndarray]]:
    if n == 1:
        return [batch]
    if not time_major:
        size = len(next(iter(batch.values())))
        idx = np.array_split(np.arange(size), n)
        return [{k: v[ix] for k, v in batch.items()} for ix in idx]
    # Time-major [T, B, ...]: shard the batch axis (1); per-env vectors like
    # bootstrap_value [B] shard axis 0.
    ref = batch.get("rewards")
    if ref is None:
        ref = next(v for v in batch.values() if np.ndim(v) >= 2)
    B = np.shape(ref)[1]
    idx = np.array_split(np.arange(B), n)
    shards = []
    for ix in idx:
        shard = {}
        for k, v in batch.items():
            v = np.asarray(v)
            if v.ndim >= 2 and v.shape[1] == B:
                shard[k] = v[:, ix]
            elif v.ndim == 1 and v.shape[0] == B:
                shard[k] = v[ix]
            else:
                raise ValueError(
                    f"cannot shard key {k!r} with shape {v.shape} over batch "
                    f"axis of size {B}"
                )
        shards.append(shard)
    return shards
