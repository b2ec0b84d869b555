"""BC: behavior cloning from offline data.

Port of ray_tpu/rllib/algorithms/bc.py (analog of rllib/algorithms/bc/:
bc.py + the offline-data pipeline,
offline/offline_data.py): supervised imitation of logged (obs, action)
transitions from a ray_tpu_torch.data Dataset — no environment interaction during
training (the env is only used for action/observation spaces and optional
evaluation rollouts).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import Learner
from ray_tpu_torch.rllib.core.rl_module import PiVf, RLModuleSpec, forward_pi_vf
from ray_tpu_torch.rllib.utils.offline import materialize_offline, validate_discrete_actions


class BCConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=BC)
        self.lr = 1e-3
        self.train_batch_size = 256
        self.updates_per_iteration = 32


class BCLearner(Learner):
    def init_module(self, generator):
        return PiVf(self.spec, generator)

    def loss_fn(self, module, batch):
        logits, _ = forward_pi_vf(module, batch["obs"])
        logp = F.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, batch["actions"][:, None])[:, 0]
        loss = torch.mean(nll)
        acc = torch.mean(
            (torch.argmax(logits, dim=-1) == batch["actions"]).to(torch.float32)
        )
        return loss, {"bc_loss": loss, "action_accuracy": acc}


class BC(Algorithm):
    policy_kind = "pi_vf"

    def __init__(self, config: AlgorithmConfig):
        if config.offline_input is None:
            raise ValueError(
                "BC requires offline data: config.offline_data(input_=dataset)"
            )
        super().__init__(config)
        self._rows = materialize_offline(config.offline_input)
        self._obs = np.asarray(
            [r["obs"] for r in self._rows], dtype=np.float32
        ).reshape(len(self._rows), -1)
        self._acts = validate_discrete_actions(
            np.asarray([r["actions"] for r in self._rows]),
            self.num_actions,
            "BC",
        )
        self._rng = np.random.RandomState(config.seed)

    def _learner_builder(self, obs_dim: int, num_actions: int) -> Callable[[str], Any]:
        cfg = self.config
        spec = RLModuleSpec(
            obs_dim=obs_dim,
            num_actions=num_actions,
            hidden=tuple(cfg.model.get("hidden", (64, 64))),
        )
        lr, grad_clip, seed = cfg.lr, cfg.grad_clip, cfg.seed

        def build(device):
            return BCLearner(spec, lr=lr, grad_clip=grad_clip, seed=seed, device=device)

        return build

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        metrics: Dict[str, float] = {}
        for _ in range(cfg.updates_per_iteration):
            idx = self._rng.randint(0, len(self._obs), size=cfg.train_batch_size)
            # Public group API: a plain supervised batch shards across
            # remote learners (grad averaging) or runs locally.
            metrics = self.learner_group.update_from_batch(
                {"obs": self._obs[idx], "actions": self._acts[idx]}
            )
        self._sync_weights()
        return {
            **{k: float(v) for k, v in metrics.items()},
            "num_offline_rows": len(self._rows),
        }

    def evaluate(self, num_steps: int = 256) -> Dict[str, Any]:
        """Greedy evaluation rollout against the configured env."""
        batches = self.env_runner_group.sample(num_steps)
        return self._episode_metrics(batches)
