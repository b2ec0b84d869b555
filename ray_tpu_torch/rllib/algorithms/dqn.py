"""DQN: double-DQN with target network and uniform replay.

Port of ray_tpu/rllib/algorithms/dqn.py (analog of rllib/algorithms/dqn/:
dqn.py, dqn_learner, replay): env runners explore epsilon-greedily into a
replay buffer; the learner does double-DQN TD updates with a Huber loss; the
target net, a detached copy of the parameters, refreshes every
target_network_update_freq env steps.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch
from torch.func import functional_call

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import Learner
from ray_tpu_torch.rllib.core.rl_module import QNet, RLModuleSpec, forward_q
from ray_tpu_torch.rllib.utils.replay_buffer import ReplayBuffer


class DQNConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=DQN)
        self.lr = 5e-4
        self.train_batch_size = 32
        self.replay_buffer_capacity = 50_000
        self.num_steps_sampled_before_learning_starts = 1000
        self.target_network_update_freq = 500  # env steps
        self.epsilon_initial = 1.0
        self.epsilon_final = 0.05
        self.epsilon_timesteps = 10_000
        self.double_q = True
        self.updates_per_iteration = 32
        self.rollout_fragment_length = 4


class DQNLearner(Learner):
    def __init__(self, spec: RLModuleSpec, cfg: Dict[str, Any], **kw):
        self.cfg = cfg
        super().__init__(spec, **kw)
        self.sync_target()

    def init_module(self, generator):
        return QNet(self.spec, generator)

    def loss_fn(self, module, batch):
        q_all = forward_q(module, batch["obs"])
        q = q_all.gather(-1, batch["actions"][:, None])[:, 0]
        with torch.no_grad():
            q_next_target = functional_call(module, batch["_target_params"], (batch["next_obs"],))
            if self.cfg["double_q"]:
                # Online net picks the argmax, target net evaluates it.
                q_next_online = forward_q(module, batch["next_obs"])
                best = torch.argmax(q_next_online, dim=-1)
                q_next = q_next_target.gather(-1, best[:, None])[:, 0]
            else:
                q_next = q_next_target.max(dim=-1).values
            target = batch["rewards"] + self.cfg["gamma"] * (1.0 - batch["dones"]) * q_next
        # Huber loss (reference dqn uses huber by default).
        err = q - target
        huber = torch.where(torch.abs(err) < 1.0, 0.5 * err * err, torch.abs(err) - 0.5)
        loss = torch.mean(huber)
        return loss, {"qf_loss": loss, "q_mean": torch.mean(q)}

    def update_from_batch(self, batch):
        batch = self.to_device(batch)
        batch["_target_params"] = self.target_params
        return self._update(batch)

    def sync_target(self) -> None:
        """The target net: a detached copy of the parameters, by name."""
        self.target_params = {
            n: p.detach().clone() for n, p in self.module.named_parameters()
        }


class DQN(Algorithm):
    policy_kind = "q"

    def __init__(self, config: AlgorithmConfig):
        super().__init__(config)
        self.replay = ReplayBuffer(
            config.replay_buffer_capacity, self.obs_dim, seed=config.seed
        )
        self._steps_since_target_sync = 0

    def _learner_builder(self, obs_dim: int, num_actions: int) -> Callable[[str], Any]:
        cfg = self.config
        spec = RLModuleSpec(
            obs_dim=obs_dim,
            num_actions=num_actions,
            hidden=tuple(cfg.model.get("hidden", (64, 64))),
        )
        loss_cfg = {"gamma": cfg.gamma, "double_q": cfg.double_q}
        lr, grad_clip, seed = cfg.lr, cfg.grad_clip, cfg.seed

        def build(device):
            return DQNLearner(spec, loss_cfg, lr=lr, grad_clip=grad_clip, seed=seed,
                              device=device)

        return build

    @property
    def _epsilon(self) -> float:
        c = self.config
        frac = min(1.0, self._env_steps_total / max(1, c.epsilon_timesteps))
        return c.epsilon_initial + frac * (c.epsilon_final - c.epsilon_initial)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        # DQN's learner is local-only (target-net state lives in-process).
        learner = self.learner_group._local
        assert learner is not None, "DQN requires num_learners=0 (local learner)"

        batches = self.env_runner_group.sample(
            cfg.rollout_fragment_length, epsilon=self._epsilon
        )
        new_steps = sum(b["env_steps"] for b in batches)
        self._env_steps_total += new_steps
        self._steps_since_target_sync += new_steps
        for b in batches:
            self.replay.add_batch(b)

        metrics: Dict[str, float] = {}
        if len(self.replay) >= cfg.num_steps_sampled_before_learning_starts:
            for _ in range(cfg.updates_per_iteration):
                metrics = learner.update_from_batch(
                    self.replay.sample(cfg.train_batch_size)
                )
            if self._steps_since_target_sync >= cfg.target_network_update_freq:
                learner.sync_target()
                self._steps_since_target_sync = 0
            self._sync_weights()
        return {
            **self._episode_metrics(batches),
            **metrics,
            "epsilon": self._epsilon,
            "replay_size": len(self.replay),
        }
