"""CQL: conservative Q-learning from offline data (discrete CQL(H)).

Port of ray_tpu/rllib/algorithms/cql.py (analog of rllib/algorithms/cql/:
cql.py + cql_learner): standard double-DQN
TD learning on logged transitions plus the conservative regularizer
alpha * (logsumexp_a Q(s, a) - Q(s, a_logged)), which pushes down
out-of-distribution action values so the greedy policy stays inside the
dataset's support — the failure mode of running plain DQN on a fixed
offline buffer. No environment interaction during training; the env only
provides spaces and optional evaluation rollouts.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.utils.offline import materialize_offline, validate_discrete_actions
from ray_tpu_torch.rllib.algorithms.dqn import DQNLearner


class CQLConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=CQL)
        self.lr = 5e-4
        self.train_batch_size = 64
        self.updates_per_iteration = 64
        self.target_network_update_freq_updates = 50  # learner updates
        self.double_q = True
        self.cql_alpha = 1.0  # conservative penalty weight


class CQLLearner(DQNLearner):
    """DQN TD loss + the CQL(H) conservative penalty, one update."""

    def loss_fn(self, module, batch):
        from ray_tpu_torch.rllib.core.rl_module import forward_q

        td_loss, metrics = super().loss_fn(module, batch)
        q_all = forward_q(module, batch["obs"])
        q_data = q_all.gather(-1, batch["actions"][:, None])[:, 0]
        # logsumexp over actions ~= soft-max value of the CURRENT net; its
        # gap to the logged action's value is the OOD overestimation the
        # penalty minimizes.
        cql_gap = torch.mean(torch.logsumexp(q_all, dim=-1) - q_data)
        loss = td_loss + self.cfg["cql_alpha"] * cql_gap
        return loss, {
            **metrics,
            "cql_gap": cql_gap,
            "td_loss": td_loss,
            "total_loss": loss,
        }


class CQL(Algorithm):
    policy_kind = "q"

    def __init__(self, config: AlgorithmConfig):
        if config.offline_input is None:
            raise ValueError(
                "CQL requires offline data: config.offline_data(input_=...)"
            )
        super().__init__(config)
        rows = materialize_offline(config.offline_input)
        n = len(rows)
        self._obs = np.asarray(
            [r["obs"] for r in rows], dtype=np.float32
        ).reshape(n, -1)
        self._acts = validate_discrete_actions(
            np.asarray([r["actions"] for r in rows]), self.num_actions, "CQL"
        )
        self._rewards = np.asarray(
            [float(r.get("rewards", 0.0)) for r in rows], dtype=np.float32
        )
        self._next_obs = np.asarray(
            [r.get("next_obs", r["obs"]) for r in rows], dtype=np.float32
        ).reshape(n, -1)
        self._dones = np.asarray(
            [bool(r.get("dones", False)) for r in rows], dtype=np.float32
        )
        self._rng = np.random.RandomState(config.seed)
        self._updates_since_target_sync = 0

    def _learner_builder(self, obs_dim: int, num_actions: int) -> Callable[[str], Any]:
        from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec

        cfg = self.config
        spec = RLModuleSpec(
            obs_dim=obs_dim,
            num_actions=num_actions,
            hidden=tuple(cfg.model.get("hidden", (64, 64))),
        )
        loss_cfg = {
            "gamma": cfg.gamma,
            "double_q": cfg.double_q,
            "cql_alpha": cfg.cql_alpha,
        }
        lr, grad_clip, seed = cfg.lr, cfg.grad_clip, cfg.seed

        def build(device):
            return CQLLearner(spec, loss_cfg, lr=lr, grad_clip=grad_clip, seed=seed,
                              device=device)

        return build

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        # Target-network state lives in-process (same constraint as DQN).
        learner = self.learner_group._local
        assert learner is not None, "CQL requires num_learners=0 (local learner)"
        metrics: Dict[str, float] = {}
        for _ in range(cfg.updates_per_iteration):
            idx = self._rng.randint(0, len(self._obs), size=cfg.train_batch_size)
            metrics = learner.update_from_batch(
                {
                    "obs": self._obs[idx],
                    "actions": self._acts[idx],
                    "rewards": self._rewards[idx],
                    "next_obs": self._next_obs[idx],
                    "dones": self._dones[idx],
                }
            )
            self._updates_since_target_sync += 1
            if (
                self._updates_since_target_sync
                >= cfg.target_network_update_freq_updates
            ):
                learner.sync_target()
                self._updates_since_target_sync = 0
        self._sync_weights()
        return {
            **{k: float(v) for k, v in metrics.items()},
            "num_offline_rows": len(self._obs),
        }

    def evaluate(self, num_steps: int = 256) -> Dict[str, Any]:
        batches = self.env_runner_group.sample(num_steps, epsilon=0.0)
        return self._episode_metrics(batches)
