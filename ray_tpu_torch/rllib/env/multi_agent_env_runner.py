"""MultiAgentEnvRunner: experience collection from a MultiAgentEnv with
per-policy modules (reference: rllib/env/multi_agent_env_runner.py +
core/rl_module/multi_rl_module.py MultiRLModule). Port of
ray_tpu/rllib/env/multi_agent_env_runner.py: inference is torch on the CPU,
as in the single-agent runner; the rest is the reference's logic.

Agents are mapped to policies by policy_mapping_fn; each policy owns its own
pi_vf module and performs ONE batched torch forward per step over all of
its agents (the MultiRLModule idea: group by module, batch the group).
Sample output is a per-policy dict of single-agent-shaped time-major
batches, so the per-policy learner path (GAE, minibatch SGD) is identical
to the single-agent one — agents of a policy occupy the "env" axis.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch


class MultiAgentEnvRunner:
    def __init__(
        self,
        env_factory: Callable[[Dict[str, Any]], Any],
        *,
        policies,
        policy_mapping_fn: Callable[[Any], str],
        module_spec_dict: Optional[Dict[str, Any]] = None,
        seed: int = 0,
        worker_index: int = 0,
        env_config: Optional[Dict[str, Any]] = None,
        num_envs: int = 1,  # env copies stepped in lockstep (vector sampling)
        policy_kind: str = "pi_vf",
    ):
        from ray_tpu_torch.rllib.env.env_runner import in_runtime_worker

        if in_runtime_worker():
            torch.set_num_threads(1)
        if policy_kind != "pi_vf":
            raise ValueError(
                "MultiAgentEnvRunner currently supports actor-critic "
                f"(pi_vf) policies only, got {policy_kind!r}"
            )
        if isinstance(env_factory, str):
            raise ValueError(
                "multi-agent envs are passed as factory callables "
                "(config.environment(env=lambda cfg: MyMultiAgentEnv(cfg)))"
            )
        # Vectorized sampling: num_envs env copies step in lockstep; each
        # policy still performs ONE batched forward per step, over
        # num_envs * n_agents rows (reference: MultiAgentEnvRunner over
        # gymnasium vector envs).
        self.num_envs = max(1, int(num_envs))
        self.envs = [env_factory(env_config or {}) for _ in range(self.num_envs)]
        self.env = self.envs[0]  # spaces/agents template
        self.worker_index = worker_index
        self.generator = torch.Generator().manual_seed(seed * 10007 + worker_index + 17)

        from ray_tpu_torch.rllib.core import rl_module as M

        self.policy_ids = list(policies)
        self.mapping = policy_mapping_fn
        self.agents = list(self.env.agents)
        # Stable per-policy agent grouping (the batch axis of each policy).
        self.agents_of: Dict[str, list] = {pid: [] for pid in self.policy_ids}
        for aid in self.agents:
            pid = self.mapping(aid)
            if pid not in self.agents_of:
                raise ValueError(
                    f"policy_mapping_fn({aid!r}) -> {pid!r} not in {self.policy_ids}"
                )
            self.agents_of[pid].append(aid)

        empty = [p for p, aids in self.agents_of.items() if not aids]
        if empty:
            raise ValueError(
                f"policies {empty} have no agents mapped to them — check "
                "policy_mapping_fn (every configured policy must own at "
                "least one agent)"
            )
        self.specs: Dict[str, Any] = {}
        self.modules: Dict[str, Any] = {}
        for pid, aids in self.agents_of.items():
            if not aids:
                continue
            spaces = [self.env.observation_spaces[a] for a in aids]
            acts = [self.env.action_spaces[a] for a in aids]
            obs_dims = {int(np.prod(s.shape)) for s in spaces}
            n_actions = {int(a.n) for a in acts}
            if len(obs_dims) != 1 or len(n_actions) != 1:
                raise ValueError(
                    f"agents of policy {pid!r} must share obs/action spaces"
                )
            spec_kwargs = dict(module_spec_dict or {})
            spec_kwargs.setdefault("obs_dim", obs_dims.pop())
            spec_kwargs.setdefault("num_actions", n_actions.pop())
            spec = M.RLModuleSpec(**spec_kwargs)
            self.specs[pid] = spec
            self.modules[pid] = M.make_module("pi_vf", spec, self.generator)

        # Per-env state. Per-agent liveness: an individually-terminated
        # agent may drop out of subsequent obs dicts while the episode
        # continues; its slot then replays its last obs with zero reward and
        # terminated=True (the GAE mask zeroes any contribution).
        self._last_obs = []
        self._agent_done = []
        self._episode_return = [0.0] * self.num_envs
        self._episode_len = [0] * self.num_envs
        for e, env in enumerate(self.envs):
            obs, _ = env.reset(seed=seed * 7919 + worker_index * 101 + e)
            self._last_obs.append(dict(obs))
            self._agent_done.append({a: False for a in self.agents})
        self._completed: collections.deque = collections.deque(maxlen=100)
        self._weights_version = 0

    def ping(self):
        return "pong"

    @torch.no_grad()
    def _policy_step(self, pid: str, obs: np.ndarray):
        from ray_tpu_torch.rllib.core import rl_module as M

        logits, value = M.forward_pi_vf(self.modules[pid], torch.from_numpy(obs))
        actions, logp = M.sample_actions(self.generator, logits)
        return actions.numpy(), logp.numpy(), value.numpy()

    @torch.no_grad()
    def _value(self, pid: str, obs: np.ndarray) -> np.ndarray:
        from ray_tpu_torch.rllib.core import rl_module as M

        return M.forward_pi_vf(self.modules[pid], torch.from_numpy(obs))[1].numpy()

    # -- weight sync ---------------------------------------------------------

    def set_weights(self, weights: Dict[str, Any], version: int = 0) -> None:
        from ray_tpu_torch.rllib.core.rl_module import load_tree

        for pid, w in weights.items():
            if pid in self.modules:
                load_tree(self.modules[pid], w)
        self._weights_version = version

    def get_weights_version(self) -> int:
        return self._weights_version

    # -- sampling ------------------------------------------------------------

    def _obs_mat(self, pid: str) -> np.ndarray:
        """[num_envs * n_agents, obs_dim] — env-major, agent-minor rows."""
        return np.stack(
            [
                np.asarray(self._last_obs[e][a], dtype=np.float32).reshape(-1)
                for e in range(self.num_envs)
                for a in self.agents_of[pid]
            ]
        )

    def sample(self, num_steps: int, **_ignored) -> Dict[str, Any]:
        """num_steps lockstep steps of every env copy. Returns
        {"policies": {pid: batch}, ...} where each batch is
        single-agent-shaped: [T, num_envs * n_agents_of_policy, ...] —
        env copies and a policy's agents both ride the batch axis, so the
        per-policy learner path is unchanged."""
        T = num_steps
        E = self.num_envs
        pids = [p for p in self.policy_ids if self.agents_of[p]]
        buf: Dict[str, Dict[str, np.ndarray]] = {}
        for pid in pids:
            n = len(self.agents_of[pid]) * E
            d = self.specs[pid].obs_dim
            buf[pid] = {
                "obs": np.empty((T, n, d), np.float32),
                "actions": np.empty((T, n), np.int64),
                "rewards": np.empty((T, n), np.float32),
                "terminateds": np.empty((T, n), np.bool_),
                "truncateds": np.empty((T, n), np.bool_),
                "next_obs": np.empty((T, n, d), np.float32),
                "logp": np.zeros((T, n), np.float32),
                "values": np.zeros((T, n), np.float32),
                # 0.0 marks padded rows of individually-terminated agents;
                # the PPO loss drops them (GAE alone does NOT zero a padded
                # row's own delta, only its bootstrap).
                "mask": np.ones((T, n), np.float32),
            }

        env_steps = 0
        for t in range(T):
            # One batched forward per policy over ALL envs' agents.
            acts_of: Dict[str, np.ndarray] = {}
            for pid in pids:
                obs_mat = self._obs_mat(pid)
                buf[pid]["obs"][t] = obs_mat
                acts_of[pid], buf[pid]["logp"][t], buf[pid]["values"][t] = (
                    self._policy_step(pid, obs_mat)
                )
                buf[pid]["actions"][t] = acts_of[pid]
            for e in range(E):
                action_dict: Dict[Any, Any] = {}
                for pid in pids:
                    na = len(self.agents_of[pid])
                    for i, aid in enumerate(self.agents_of[pid]):
                        if not self._agent_done[e][aid]:
                            action_dict[aid] = int(acts_of[pid][e * na + i])
                next_obs, rewards, terms, truncs, _infos = self.envs[e].step(
                    action_dict
                )
                env_steps += 1
                all_term = bool(terms.get("__all__", False))
                all_trunc = bool(truncs.get("__all__", False))
                for pid in pids:
                    na = len(self.agents_of[pid])
                    for i, aid in enumerate(self.agents_of[pid]):
                        s = e * na + i
                        done_before = self._agent_done[e][aid]
                        buf[pid]["mask"][t, s] = 0.0 if done_before else 1.0
                        buf[pid]["rewards"][t, s] = (
                            0.0 if done_before else float(rewards.get(aid, 0.0))
                        )
                        buf[pid]["terminateds"][t, s] = bool(
                            done_before or terms.get(aid, all_term)
                        )
                        buf[pid]["truncateds"][t, s] = bool(
                            truncs.get(aid, all_trunc)
                        )
                        buf[pid]["next_obs"][t, s] = np.asarray(
                            next_obs.get(aid, self._last_obs[e][aid]),
                            dtype=np.float32,
                        ).reshape(-1)
                self._episode_return[e] += float(sum(rewards.values()))
                self._episode_len[e] += 1
                if all_term or all_trunc:
                    self._completed.append(
                        (self._episode_return[e], self._episode_len[e])
                    )
                    self._episode_return[e], self._episode_len[e] = 0.0, 0
                    obs, _ = self.envs[e].reset()
                    self._last_obs[e] = dict(obs)
                    self._agent_done[e] = {a: False for a in self.agents}
                else:
                    for aid in self.agents:
                        if aid in next_obs:
                            self._last_obs[e][aid] = next_obs[aid]
                        if terms.get(aid) or truncs.get(aid):
                            self._agent_done[e][aid] = True

        out_policies: Dict[str, Dict[str, Any]] = {}
        for pid in pids:
            b = dict(buf[pid])
            # Bootstrap V(current obs) for the step after the batch end.
            b["bootstrap_value"] = self._value(pid, self._obs_mat(pid))
            # V(next_obs) at truncation boundaries (GAE bootstraps there).
            boundary = np.zeros_like(b["values"])
            ts, is_ = np.nonzero(b["truncateds"] & ~b["terminateds"])
            if len(ts):
                boundary[ts, is_] = self._value(pid, b["next_obs"][ts, is_])
            b["boundary_values"] = boundary
            out_policies[pid] = b
        return {
            "policies": out_policies,
            "episode_stats": list(self._completed),
            "weights_version": self._weights_version,
            "env_steps": env_steps,
        }

    # -- introspection -------------------------------------------------------

    def get_spaces(self) -> Dict[str, Any]:
        return {
            pid: (spec.obs_dim, spec.num_actions)
            for pid, spec in self.specs.items()
        }

    def stop(self) -> None:
        for env in self.envs:
            env.close()
