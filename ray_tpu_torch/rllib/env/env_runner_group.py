"""EnvRunnerGroup: manages local or remote env-runner actors.

Analog of rllib/env/env_runner_group.py:66: creates N SingleAgentEnvRunner
actors under a FaultTolerantActorManager, fans out sample()/set_weights()
calls, and (optionally) replaces runners that die — sampling is stateless
beyond weights, so replacement is cheap (reference: restart_failed_env_runners).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.rllib.env.env_runner import SingleAgentEnvRunner
from ray_tpu_torch.rllib.utils.actor_manager import FaultTolerantActorManager

logger = logging.getLogger(__name__)


class EnvRunnerGroup:
    def __init__(
        self,
        *,
        env,
        env_config: Dict[str, Any],
        num_env_runners: int,
        num_envs_per_env_runner: int,
        policy_kind: str,
        module_spec_dict: Dict[str, Any],
        seed: int,
        restart_failed: bool = True,
        sample_timeout_s: float = 60.0,
        runner_cls=None,
        extra_ctor_kwargs: Optional[Dict[str, Any]] = None,
    ):
        self._runner_cls = runner_cls or SingleAgentEnvRunner
        self._extra_kwargs = dict(extra_ctor_kwargs or {})
        self._ctor_kwargs = dict(
            env=env,
            env_config=env_config,
            num_envs_per_env_runner=num_envs_per_env_runner,
            policy_kind=policy_kind,
            module_spec_dict=module_spec_dict,
            seed=seed,
        )
        self.restart_failed = restart_failed
        self.sample_timeout_s = sample_timeout_s
        self.num_env_runners = num_env_runners
        if num_env_runners == 0:
            self._local = self._make_local(0)
            self._manager = None
        else:
            self._local = None
            actors = [self._make_remote(i) for i in range(num_env_runners)]
            self._manager = FaultTolerantActorManager(actors)

    def _make_local(self, index: int):
        k = self._ctor_kwargs
        return self._runner_cls(
            k["env"],
            num_envs=k["num_envs_per_env_runner"],
            policy_kind=k["policy_kind"],
            module_spec_dict=k["module_spec_dict"],
            seed=k["seed"],
            worker_index=index,
            env_config=k["env_config"],
            **self._extra_kwargs,
        )

    def _make_remote(self, index: int):
        k = self._ctor_kwargs
        cls = ray_tpu_torch.remote(self._runner_cls)
        return cls.options(num_cpus=1).remote(
            k["env"],
            num_envs=k["num_envs_per_env_runner"],
            policy_kind=k["policy_kind"],
            module_spec_dict=k["module_spec_dict"],
            seed=k["seed"],
            worker_index=index,
            env_config=k["env_config"],
            **self._extra_kwargs,
        )

    @property
    def local_env_runner(self) -> Optional[SingleAgentEnvRunner]:
        return self._local

    def get_spaces(self):
        if self._local is not None:
            return self._local.get_spaces()
        ids = self._manager.healthy_actor_ids()
        return ray_tpu_torch.get(self._manager.actors[ids[0]].get_spaces.remote())

    def get_act_info(self):
        """(act_dim, act_limit) for continuous action spaces (SAC)."""
        if self._local is not None:
            return self._local.get_act_info()
        ids = self._manager.healthy_actor_ids()
        return ray_tpu_torch.get(self._manager.actors[ids[0]].get_act_info.remote())

    # -- sampling ------------------------------------------------------------

    def sample(self, num_steps: int, **kw) -> List[Dict[str, Any]]:
        """One sample round from every healthy runner (sync barrier)."""
        if self._local is not None:
            return [self._local.sample(num_steps, **kw)]
        self._heal()
        results = self._manager.foreach_actor(
            lambda a: a.sample.remote(num_steps, **kw),
            timeout_s=self.sample_timeout_s,
        )
        out = [r.value for r in results if r.ok]
        if not out:
            raise RuntimeError(
                "all env runners failed to sample: "
                + "; ".join(repr(r.error) for r in results)
            )
        return out

    def sample_refs(self, num_steps: int, **kw) -> List[Any]:
        """Submit sample() on every healthy runner, return (actor_idx, ref)
        pairs without blocking — the IMPALA async pipeline consumes these."""
        if self._local is not None:
            raise RuntimeError("async sampling requires num_env_runners > 0")
        self._heal()
        return [
            (i, self._manager.actors[i].sample.remote(num_steps, **kw))
            for i in self._manager.healthy_actor_ids()
        ]

    def submit_sample(self, actor_idx: int, num_steps: int, **kw):
        return self._manager.actors[actor_idx].sample.remote(num_steps, **kw)

    # -- weights -------------------------------------------------------------

    def sync_weights(self, weights, version: int = 0) -> None:
        if self._local is not None:
            self._local.set_weights(weights, version)
            return
        self._manager.foreach_actor(
            lambda a: a.set_weights.remote(weights, version)
        )

    # -- fault tolerance -----------------------------------------------------

    def _heal(self) -> None:
        if self._manager is None or not self.restart_failed:
            return
        self._manager.probe_unhealthy_actors()
        for i, healthy in enumerate(self._manager._healthy):
            if not healthy:
                logger.warning("recreating env runner %d", i)
                try:
                    self._manager.replace_actor(i, self._make_remote(i))
                except Exception as e:
                    logger.warning("recreate failed: %r", e)
                    self._manager.set_actor_state(i, False)

    def mark_unhealthy(self, actor_idx: int) -> None:
        self._manager.set_actor_state(actor_idx, False)

    def stop(self) -> None:
        if self._manager is None:
            if self._local is not None:
                self._local.stop()
            return
        for a in self._manager.actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass
