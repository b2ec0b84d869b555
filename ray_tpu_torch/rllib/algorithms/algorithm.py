"""Algorithm: the top-level RL training loop object.

Analog of rllib/algorithms/algorithm.py:210 (training_step:1589): owns an
EnvRunnerGroup and a LearnerGroup, `train()` runs one iteration and returns
a result dict. `as_trainable()` adapts it to the Tune function-trainable
protocol so `Tuner(PPOConfig()...build_algo-less)` works the same way the
reference couples Algorithm to Tune.
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner_group import LearnerGroup
from ray_tpu_torch.rllib.env.env_runner_group import EnvRunnerGroup


class Algorithm:
    # Subclasses set these.
    policy_kind = "pi_vf"
    supports_multi_agent = False

    def __init__(self, config: AlgorithmConfig):
        self.config = config
        self.iteration = 0
        self._env_steps_total = 0
        self._start_time = time.time()
        self._weights_version = 0

        self.multi_agent = bool(config.policies)
        if self.multi_agent and not type(self).supports_multi_agent:
            raise ValueError(
                f"{type(self).__name__} does not implement multi-agent "
                "training; use PPO or drop .multi_agent() from the config"
            )
        extra = None
        runner_cls = None
        if self.multi_agent:
            from ray_tpu_torch.rllib.env.multi_agent_env_runner import (
                MultiAgentEnvRunner,
            )

            runner_cls = MultiAgentEnvRunner
            extra = {
                "policies": list(config.policies),
                "policy_mapping_fn": config.policy_mapping_fn,
            }
        self.env_runner_group = EnvRunnerGroup(
            env=config.env,
            env_config=config.env_config,
            num_env_runners=config.num_env_runners,
            num_envs_per_env_runner=config.num_envs_per_env_runner,
            policy_kind=self.policy_kind,
            module_spec_dict=self._module_spec_dict(),
            seed=config.seed,
            restart_failed=config.restart_failed_env_runners,
            sample_timeout_s=config.sample_timeout_s,
            runner_cls=runner_cls,
            extra_ctor_kwargs=extra,
        )
        if self.multi_agent:
            # {policy_id: (obs_dim, num_actions)} -> one learner group per
            # policy (the reference's MultiRLModule, split by module so
            # policies with different spaces stay independent learners).
            spaces = self.env_runner_group.get_spaces()
            self.policy_spaces = spaces
            self.learner_groups: Dict[str, LearnerGroup] = {
                pid: LearnerGroup(
                    self._learner_builder(od, na),
                    num_learners=config.num_learners,
                    num_cpus_per_learner=config.num_cpus_per_learner,
                    num_gpus_per_learner=config.num_gpus_per_learner,
                    device=config.learner_device or "cuda",
                )
                for pid, (od, na) in spaces.items()
            }
            self.learner_group = None
            self.obs_dim = self.num_actions = None
        else:
            obs_dim, num_actions = self.env_runner_group.get_spaces()
            self.obs_dim, self.num_actions = obs_dim, num_actions
            self.learner_group = LearnerGroup(
                self._learner_builder(obs_dim, num_actions),
                num_learners=config.num_learners,
                num_cpus_per_learner=config.num_cpus_per_learner,
                num_gpus_per_learner=config.num_gpus_per_learner,
                device=config.learner_device or "cuda",
            )
        self._sync_weights()

    # -- subclass hooks ------------------------------------------------------

    def _module_spec_dict(self) -> Dict[str, Any]:
        m = self.config.model
        return {
            "hidden": tuple(m.get("hidden", (64, 64))),
            "vf_share_layers": bool(m.get("vf_share_layers", False)),
        }

    def _learner_builder(self, obs_dim: int, num_actions: int) -> Callable[[str], Any]:
        """A function of the learner's device that builds the learner."""
        raise NotImplementedError

    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    # -- public API ----------------------------------------------------------

    def train(self) -> Dict[str, Any]:
        self.iteration += 1
        t0 = time.time()
        metrics = self.training_step()
        elapsed = time.time() - t0
        result = {
            "training_iteration": self.iteration,
            "time_this_iter_s": elapsed,
            "time_total_s": time.time() - self._start_time,
            "num_env_steps_sampled_lifetime": self._env_steps_total,
            **metrics,
        }
        return result

    def _sync_weights(self) -> None:
        self._weights_version += 1
        if self.multi_agent:
            weights = {
                pid: lg.get_weights() for pid, lg in self.learner_groups.items()
            }
        else:
            weights = self.learner_group.get_weights()
        self.env_runner_group.sync_weights(weights, self._weights_version)

    def _episode_metrics(self, batches: List[Dict[str, Any]]) -> Dict[str, float]:
        stats = []
        for b in batches:
            stats.extend(b.get("episode_stats", []))
        if not stats:
            return {
                "episode_return_mean": float("nan"),
                "episode_len_mean": float("nan"),
            }
        returns = [s[0] for s in stats]
        lens = [s[1] for s in stats]
        return {
            "episode_return_mean": float(np.mean(returns)),
            "episode_return_max": float(np.max(returns)),
            "episode_return_min": float(np.min(returns)),
            "episode_len_mean": float(np.mean(lens)),
        }

    # -- checkpointing (reference: Algorithm.save/restore) -------------------

    def save(self, checkpoint_dir: str) -> str:
        os.makedirs(checkpoint_dir, exist_ok=True)
        path = os.path.join(checkpoint_dir, "algorithm_state.pkl")
        if self.multi_agent:
            learner_state = {
                pid: lg.get_state() for pid, lg in self.learner_groups.items()
            }
        else:
            learner_state = self.learner_group.get_state()
        state = {
            "learner": learner_state,
            "multi_agent": self.multi_agent,
            "iteration": self.iteration,
            "env_steps": self._env_steps_total,
            "config": self.config.to_dict(),
        }
        with open(path, "wb") as f:
            # cloudpickle: multi-agent configs hold callables (env factory,
            # policy_mapping_fn), often lambdas/closures plain pickle rejects.
            import cloudpickle

            cloudpickle.dump(state, f)
        return checkpoint_dir

    def restore(self, checkpoint_dir: str) -> None:
        with open(os.path.join(checkpoint_dir, "algorithm_state.pkl"), "rb") as f:
            state = pickle.load(f)
        if self.multi_agent:
            for pid, lg in self.learner_groups.items():
                lg.set_state(state["learner"][pid])
        else:
            self.learner_group.set_state(state["learner"])
        self.iteration = state["iteration"]
        self._env_steps_total = state["env_steps"]
        self._sync_weights()

    def stop(self) -> None:
        self.env_runner_group.stop()
        if self.multi_agent:
            for lg in self.learner_groups.values():
                lg.shutdown()
        else:
            self.learner_group.shutdown()

    # -- Tune integration ----------------------------------------------------

    @classmethod
    def as_trainable(
        cls, base_config: AlgorithmConfig, *, stop: Optional[Dict[str, Any]] = None
    ) -> Callable[[Dict[str, Any]], None]:
        """Returns a Tune function-trainable: hyperparams from the trial
        config are applied over base_config via .training()."""
        stop = stop or {"training_iteration": 10}

        def trainable(trial_config: Dict[str, Any]) -> None:
            from ray_tpu_torch import train as train_session

            cfg = base_config.copy()
            for k, v in (trial_config or {}).items():
                if hasattr(cfg, k):
                    setattr(cfg, k, v)
            algo = cls(config=cfg)
            try:
                while True:
                    result = algo.train()
                    train_session.report(result)
                    if any(
                        result.get(k) is not None and result[k] >= v
                        for k, v in stop.items()
                    ):
                        break
            finally:
                algo.stop()

        trainable.__name__ = cls.__name__
        return trainable


def gae_advantages(
    rewards: np.ndarray,
    values: np.ndarray,
    terminateds: np.ndarray,
    truncateds: np.ndarray,
    bootstrap_value: np.ndarray,
    gamma: float,
    lam: float,
    boundary_values: Optional[np.ndarray] = None,
):
    """Generalized advantage estimation over time-major [T, N] arrays
    (reference: rllib/evaluation/postprocessing.py compute_gae_for_sample_batch,
    vectorized). Termination zeroes the bootstrap; truncation bootstraps with
    V(final_obs) (`boundary_values`, computed by the env runner) — NOT with
    the next row's value, which belongs to the next episode after autoreset."""
    T, N = rewards.shape
    adv = np.zeros((T, N), dtype=np.float32)
    if boundary_values is None:
        boundary_values = np.zeros((T, N), dtype=np.float32)
    next_value = bootstrap_value.astype(np.float32)
    gae = np.zeros(N, dtype=np.float32)
    for t in range(T - 1, -1, -1):
        nonterminal = 1.0 - terminateds[t].astype(np.float32)
        boundary = np.logical_or(terminateds[t], truncateds[t])
        nv = np.where(truncateds[t], boundary_values[t], next_value)
        delta = rewards[t] + gamma * nv * nonterminal - values[t]
        gae = delta + gamma * lam * nonterminal * np.where(boundary, 0.0, 1.0) * gae
        adv[t] = gae
        next_value = values[t]
    returns = adv + values
    return adv, returns
