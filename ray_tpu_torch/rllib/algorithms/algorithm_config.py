"""AlgorithmConfig: fluent builder for algorithm hyperparameters.

Analog of rllib/algorithms/algorithm_config.py:117 — the same chained-setter
API (.environment().env_runners().training().learners()), with GPU resource
knobs and the learners' device. `.build_algo()` constructs the Algorithm.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Optional, Tuple, Type, Union


class AlgorithmConfig:
    def __init__(self, algo_class: Optional[Type] = None):
        self.algo_class = algo_class
        # environment()
        self.env: Union[str, Callable, None] = None
        self.env_config: Dict[str, Any] = {}
        # env_runners()
        self.num_env_runners: int = 0
        self.num_envs_per_env_runner: int = 1
        self.rollout_fragment_length: int = 200
        self.sample_timeout_s: float = 60.0
        # training()
        self.lr: float = 5e-4
        self.gamma: float = 0.99
        self.train_batch_size: int = 4000
        self.grad_clip: Optional[float] = 40.0
        self.model: Dict[str, Any] = {"hidden": (64, 64), "vf_share_layers": False}
        # learners()
        self.num_learners: int = 0
        self.num_cpus_per_learner: float = 1.0
        self.num_gpus_per_learner: float = 0.0
        # Where learners run: None means "cuda" (an actor leased GPUs takes
        # its current card); "cpu" only when asked for.
        self.learner_device: Optional[str] = None
        # offline_data()
        self.offline_input = None
        # debugging()
        self.seed: int = 0

        # Multi-agent (reference: AlgorithmConfig.multi_agent): None/empty ->
        # single-agent mode.
        self.policies = None
        self.policy_mapping_fn = None
        # fault_tolerance()
        self.restart_failed_env_runners: bool = True

    # -- chained setters (reference API shape) -------------------------------

    def environment(self, env=None, *, env_config: Optional[dict] = None):
        if env is not None:
            self.env = env
        if env_config is not None:
            self.env_config = dict(env_config)
        return self

    def env_runners(
        self,
        *,
        num_env_runners: Optional[int] = None,
        num_envs_per_env_runner: Optional[int] = None,
        rollout_fragment_length: Optional[int] = None,
        sample_timeout_s: Optional[float] = None,
    ):
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_env_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        if sample_timeout_s is not None:
            self.sample_timeout_s = sample_timeout_s
        return self

    def offline_data(self, *, input_=None):
        """Offline training input (reference: AlgorithmConfig.offline_data):
        a ray_tpu_torch.data Dataset (or list of row dicts) of {obs, actions}
        transitions consumed instead of env rollouts."""
        if input_ is not None:
            self.offline_input = input_
        return self

    def training(self, **kwargs):
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise TypeError(f"unknown training option {k!r}")
            setattr(self, k, v)
        return self

    def learners(
        self,
        *,
        num_learners: Optional[int] = None,
        num_cpus_per_learner: Optional[float] = None,
        num_gpus_per_learner: Optional[float] = None,
        device: Optional[str] = None,
    ):
        if num_learners is not None:
            self.num_learners = num_learners
        if num_cpus_per_learner is not None:
            self.num_cpus_per_learner = num_cpus_per_learner
        if num_gpus_per_learner is not None:
            self.num_gpus_per_learner = num_gpus_per_learner
        if device is not None:
            self.learner_device = device
        return self

    def debugging(self, *, seed: Optional[int] = None):
        if seed is not None:
            self.seed = seed
        return self

    def multi_agent(self, *, policies=None, policy_mapping_fn=None):
        """Declare per-policy modules + the agent->policy mapping
        (reference: AlgorithmConfig.multi_agent)."""
        if policies is not None:
            self.policies = list(policies)
        if policy_mapping_fn is not None:
            self.policy_mapping_fn = policy_mapping_fn
        return self

    def fault_tolerance(self, *, restart_failed_env_runners: Optional[bool] = None):
        if restart_failed_env_runners is not None:
            self.restart_failed_env_runners = restart_failed_env_runners
        return self

    # -- build ---------------------------------------------------------------

    def copy(self) -> "AlgorithmConfig":
        return copy.deepcopy(self)

    def validate(self) -> None:
        if self.env is None:
            raise ValueError("config.environment(env=...) is required")
        if self.policies and self.policy_mapping_fn is None:
            raise ValueError(
                "multi_agent(policies=...) also requires policy_mapping_fn"
            )

    def build_algo(self):
        self.validate()
        if self.algo_class is None:
            raise ValueError("no algo_class bound to this config")
        return self.algo_class(config=self.copy())

    # Back-compat alias (reference has both).
    build = build_algo

    def to_dict(self) -> Dict[str, Any]:
        d = dict(self.__dict__)
        d.pop("algo_class", None)
        return d
