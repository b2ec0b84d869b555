"""SingleAgentEnvRunner: actor that collects experience from vector envs.

Port of ray_tpu/rllib/env/env_runner.py (analog of
rllib/env/single_agent_env_runner.py:42, sample:120): lockstep vector env
stepping with torch policy inference on the host's CPU. Returns time-major
[T, num_envs, ...] numpy batches plus episode stats; the learner side turns
these into train batches (GAE / replay) — mirroring the reference's
EnvRunner -> ConnectorV2 -> Learner pipeline.

Runners never touch CUDA: weights reach them as numpy trees. The vector env
is the port's own (`SyncVectorEnv` below, gymnasium's SAME_STEP autoreset);
gymnasium is imported only to make a named env, so a factory env runs
where gymnasium is not installed.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch


class SyncVectorEnv:
    """Sub-envs stepped one after another in lockstep, as
    gymnasium.vector.SyncVectorEnv(..., autoreset_mode=SAME_STEP): step()
    at an episode's end resets that env at once and returns the reset obs,
    with the true last obs in infos["final_obs"] (an object array, None for
    the envs that did not end) and its mask in infos["_final_obs"]. Spaces
    are read duck-typed (`.shape`, `.dtype`), so a sub-env needs no
    gymnasium Space."""

    def __init__(self, env_fns: List[Callable[[], Any]]):
        self.envs = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)
        self.single_observation_space = self.envs[0].observation_space
        self.single_action_space = self.envs[0].action_space
        dtype = getattr(self.single_observation_space, "dtype", None)
        self._obs_dtype = np.float32 if dtype is None else dtype

    def _stack(self, obs) -> np.ndarray:
        return np.stack([np.asarray(o) for o in obs]).astype(self._obs_dtype, copy=False)

    def reset(self, *, seed: Optional[int] = None):
        """Seeds sub-env i with seed + i (None: each keeps its own stream)."""
        seeds = [None] * self.num_envs if seed is None else [seed + i for i in range(self.num_envs)]
        obs = [env.reset(seed=s)[0] for env, s in zip(self.envs, seeds)]
        return self._stack(obs), {}

    def step(self, actions):
        n = self.num_envs
        obs = [None] * n
        rewards = np.zeros(n, dtype=np.float64)
        terminated = np.zeros(n, dtype=np.bool_)
        truncated = np.zeros(n, dtype=np.bool_)
        infos: Dict[str, Any] = {}
        for i, env in enumerate(self.envs):
            obs[i], rewards[i], terminated[i], truncated[i], _ = env.step(actions[i])
            if terminated[i] or truncated[i]:
                if "final_obs" not in infos:
                    infos["final_obs"] = np.full(n, None, dtype=object)
                    infos["_final_obs"] = np.zeros(n, dtype=np.bool_)
                infos["final_obs"][i] = obs[i]
                infos["_final_obs"][i] = True
                obs[i], _ = env.reset()
        return self._stack(obs), rewards, terminated, truncated, infos

    def close(self) -> None:
        for env in self.envs:
            close = getattr(env, "close", None)
            if close is not None:
                close()


def in_runtime_worker() -> bool:
    """Whether this process is a worker of the port's runtime (an actor's
    process) rather than the program that started the cluster."""
    from ray_tpu_torch._private import worker

    return worker.global_worker.mode == "worker"


class SingleAgentEnvRunner:
    """Runs on CPU workers; policy inference is torch on the host."""

    def __init__(
        self,
        env_name_or_factory,
        *,
        num_envs: int = 1,
        policy_kind: str = "pi_vf",  # "pi_vf" (actor-critic), "q" (DQN) or "sac"
        module_spec_dict: Optional[Dict[str, Any]] = None,
        seed: int = 0,
        worker_index: int = 0,
        env_config: Optional[Dict[str, Any]] = None,
    ):
        if in_runtime_worker():
            # One CPU a runner: torch's pool would oversubscribe the node.
            torch.set_num_threads(1)
        cfg = env_config or {}
        if isinstance(env_name_or_factory, str):
            import gymnasium as gym

            name = env_name_or_factory
            fns = [lambda: gym.make(name, **cfg) for _ in range(num_envs)]
        else:
            factory = env_name_or_factory
            fns = [lambda: factory(cfg) for _ in range(num_envs)]
        # SAME_STEP autoreset: step() at episode end returns the reset obs and
        # puts the true terminal obs in infos["final_obs"] — we patch it back
        # into next_obs so value targets see the real final state.
        self.envs = SyncVectorEnv(fns)
        self.num_envs = num_envs
        self.policy_kind = policy_kind
        self.worker_index = worker_index
        self.generator = torch.Generator().manual_seed(seed * 10007 + worker_index)

        from ray_tpu_torch.rllib.core import rl_module as M

        obs_space = self.envs.single_observation_space
        act_space = self.envs.single_action_space
        self.obs_dim = int(np.prod(obs_space.shape))
        if hasattr(act_space, "n"):  # Discrete
            self.num_actions = int(act_space.n)
            self.act_dim = 0
            self.act_low = self.act_high = None
        else:  # Box (continuous, SAC)
            self.num_actions = 0
            self.act_dim = int(np.prod(act_space.shape))
            self.act_low = np.asarray(act_space.low, dtype=np.float32).reshape(-1)
            self.act_high = np.asarray(act_space.high, dtype=np.float32).reshape(-1)
            if not (
                np.all(np.isfinite(self.act_low))
                and np.all(np.isfinite(self.act_high))
                and np.allclose(-self.act_low, self.act_high)
            ):
                raise ValueError(
                    "continuous policies require a bounded symmetric Box "
                    f"action space (got low={self.act_low}, "
                    f"high={self.act_high}); wrap the env with a "
                    "RescaleAction-style wrapper"
                )
        spec_kwargs = dict(module_spec_dict or {})
        spec_kwargs.setdefault("obs_dim", self.obs_dim)
        spec_kwargs.setdefault("num_actions", self.num_actions)
        if self.act_dim:
            spec_kwargs.setdefault("act_dim", self.act_dim)
            spec_kwargs.setdefault("act_limit", float(np.max(np.abs(self.act_high))))
        self.spec = M.RLModuleSpec(**spec_kwargs)
        self.module = M.make_module(policy_kind, self.spec, self.generator)

        self._obs, _ = self.envs.reset(seed=seed * 7919 + worker_index)
        self._episode_returns = np.zeros(num_envs)
        self._episode_lens = np.zeros(num_envs, dtype=np.int64)
        self._completed: collections.deque = collections.deque(maxlen=100)
        self._weights_version = 0

    def ping(self):
        return "pong"

    def process_info(self) -> Dict[str, Any]:
        """Whether this process has made a CUDA context, and which jax or
        ray_tpu modules it holds (none, in the port)."""
        import sys

        forbidden = sorted(m for m in sys.modules
                           if m.split(".")[0] in ("jax", "jaxlib", "optax", "ray_tpu"))
        return {"cuda_initialized": torch.cuda.is_initialized(), "forbidden_modules": forbidden}

    # -- weight sync ---------------------------------------------------------

    def set_weights(self, weights, version: int = 0) -> None:
        from ray_tpu_torch.rllib.core.rl_module import load_tree

        load_tree(self.module, weights)
        self._weights_version = version

    def get_weights_version(self) -> int:
        return self._weights_version

    # -- inference -----------------------------------------------------------

    @torch.no_grad()
    def _policy_step(self, obs: np.ndarray):
        from ray_tpu_torch.rllib.core import rl_module as M

        logits, value = M.forward_pi_vf(self.module, torch.from_numpy(obs))
        actions, logp = M.sample_actions(self.generator, logits)
        return actions.numpy(), logp.numpy(), value.numpy()

    @torch.no_grad()
    def _value(self, obs: np.ndarray) -> np.ndarray:
        from ray_tpu_torch.rllib.core import rl_module as M

        return M.forward_pi_vf(self.module, torch.from_numpy(obs))[1].numpy()

    @torch.no_grad()
    def _greedy(self, obs: np.ndarray) -> np.ndarray:
        from ray_tpu_torch.rllib.core import rl_module as M

        return M.forward_q(self.module, torch.from_numpy(obs)).argmax(dim=-1).numpy()

    @torch.no_grad()
    def _sac_step(self, obs: np.ndarray, deterministic: bool) -> np.ndarray:
        from ray_tpu_torch.rllib.core import rl_module as M

        x, limit = torch.from_numpy(obs), self.spec.act_limit
        if deterministic:  # tanh-mean policy for evaluation rollouts
            return M.sac_pi_deterministic(self.module, x, limit).numpy()
        return M.sac_pi(self.module, x, self.generator, limit)[0].numpy()

    # -- sampling ------------------------------------------------------------

    def sample(
        self,
        num_steps: int,
        *,
        epsilon: float = 0.0,
        random_actions: bool = False,
        deterministic: bool = False,
    ) -> Dict[str, Any]:
        """Collect num_steps steps from every env. Time-major output."""
        T, N = num_steps, self.num_envs
        obs_buf = np.empty((T, N, self.obs_dim), dtype=np.float32)
        if self.act_dim:
            act_buf = np.empty((T, N, self.act_dim), dtype=np.float32)
        else:
            act_buf = np.empty((T, N), dtype=np.int64)
        rew_buf = np.empty((T, N), dtype=np.float32)
        # `done` = terminated only; truncation bootstraps instead of zeroing.
        term_buf = np.empty((T, N), dtype=np.bool_)
        trunc_buf = np.empty((T, N), dtype=np.bool_)
        next_obs_buf = np.empty((T, N, self.obs_dim), dtype=np.float32)
        logp_buf = np.zeros((T, N), dtype=np.float32)
        val_buf = np.zeros((T, N), dtype=np.float32)

        for t in range(T):
            obs_flat = self._obs.reshape(N, -1).astype(np.float32)
            obs_buf[t] = obs_flat
            if self.policy_kind == "pi_vf":
                actions, logp_buf[t], val_buf[t] = self._policy_step(obs_flat)
            elif self.policy_kind == "sac":
                if random_actions:
                    # Warmup: uniform over the Box bounds (reference SAC's
                    # initial exploration steps).
                    actions = np.random.uniform(
                        self.act_low[None, :], self.act_high[None, :],
                        size=(N, self.act_dim),
                    ).astype(np.float32)
                else:
                    actions = self._sac_step(obs_flat, deterministic)
            else:
                if random_actions:
                    actions = np.random.randint(0, self.num_actions, size=N)
                else:
                    greedy = self._greedy(obs_flat)
                    explore = np.random.rand(N) < epsilon
                    randoms = np.random.randint(0, self.num_actions, size=N)
                    actions = np.where(explore, randoms, greedy)
            env_actions = (
                actions.reshape((N,) + tuple(self.envs.single_action_space.shape))
                if self.act_dim
                else actions
            )
            next_obs, rewards, terminated, truncated, infos = self.envs.step(env_actions)
            act_buf[t] = actions
            rew_buf[t] = rewards
            term_buf[t] = terminated
            trunc_buf[t] = truncated
            next_obs_buf[t] = next_obs.reshape(N, -1).astype(np.float32)
            # Patch true terminal observations over the autoreset obs.
            final_obs = infos.get("final_obs")
            if final_obs is not None:
                for i in np.nonzero(np.logical_or(terminated, truncated))[0]:
                    if final_obs[i] is not None:
                        next_obs_buf[t, i] = np.asarray(
                            final_obs[i], dtype=np.float32
                        ).reshape(-1)

            self._episode_returns += rewards
            self._episode_lens += 1
            done = np.logical_or(terminated, truncated)
            for i in np.nonzero(done)[0]:
                self._completed.append(
                    (float(self._episode_returns[i]), int(self._episode_lens[i]))
                )
                self._episode_returns[i] = 0.0
                self._episode_lens[i] = 0
            self._obs = next_obs

        out: Dict[str, Any] = {
            "obs": obs_buf,
            "actions": act_buf,
            "rewards": rew_buf,
            "terminateds": term_buf,
            "truncateds": trunc_buf,
            "next_obs": next_obs_buf,
            "episode_stats": list(self._completed),
            "weights_version": self._weights_version,
            "env_steps": T * N,
        }
        if self.policy_kind == "pi_vf":
            out["logp"] = logp_buf
            out["values"] = val_buf
            # Bootstrap value for the obs after the last step.
            out["bootstrap_value"] = self._value(self._obs.reshape(N, -1).astype(np.float32))
            # V(final_obs) at truncation boundaries, so GAE bootstraps the
            # real terminal state instead of the autoreset obs. Sparse: one
            # batched forward over just the truncated positions.
            boundary_values = np.zeros((T, N), dtype=np.float32)
            ts, is_ = np.nonzero(trunc_buf)
            if len(ts):
                boundary_values[ts, is_] = self._value(next_obs_buf[ts, is_])
            out["boundary_values"] = boundary_values
        return out

    def get_spaces(self) -> Tuple[int, int]:
        return self.obs_dim, self.num_actions

    def get_act_info(self) -> Tuple[int, float]:
        """(act_dim, act_limit) for continuous action spaces (SAC)."""
        limit = float(np.max(np.abs(self.act_high))) if self.act_dim else 0.0
        return self.act_dim, limit

    def stop(self) -> None:
        self.envs.close()
