"""ray_tpu_torch.rllib: reinforcement learning on the ray_tpu_torch runtime.

The port of ray_tpu.rllib to PyTorch, with the same architecture as the
reference's RLlib new API stack (rllib/algorithms, rllib/core, rllib/env):
RLModules are small `nn.Module`s, Learners run the loss, backward, global-norm
clip and Adam step on a CUDA card ("cuda" unless the config asks for "cpu"),
env runners are CPU actors whose policy inference is torch on the host, and
multi-learner data parallelism averages numpy gradients in the process
that runs the algorithm.

    from ray_tpu_torch.rllib import PPOConfig

    algo = (
        PPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=2)
        .build_algo()
    )
    while algo.train()["episode_return_mean"] < 200:
        pass

A named env needs gymnasium; an env factory (`environment(env=lambda cfg:
...)`) needs only spaces with `.shape` and `.n` (or `.low`/`.high`).
"""

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.dqn import DQN, DQNConfig
from ray_tpu_torch.rllib.algorithms.impala import (
    APPO,
    APPOConfig,
    IMPALA,
    IMPALAConfig,
)
from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig
from ray_tpu_torch.rllib.env.multi_agent_env import MultiAgentEnv
from ray_tpu_torch.rllib.env.multi_agent_env_runner import MultiAgentEnvRunner
from ray_tpu_torch.rllib.algorithms.bc import BC, BCConfig
from ray_tpu_torch.rllib.algorithms.cql import CQL, CQLConfig
from ray_tpu_torch.rllib.algorithms.marwil import MARWIL, MARWILConfig
from ray_tpu_torch.rllib.algorithms.sac import SAC, SACConfig
from ray_tpu_torch.rllib.core.learner import Learner
from ray_tpu_torch.rllib.core.learner_group import LearnerGroup
from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec
from ray_tpu_torch.rllib.env.env_runner import SingleAgentEnvRunner
from ray_tpu_torch.rllib.env.env_runner_group import EnvRunnerGroup
from ray_tpu_torch.rllib.utils.actor_manager import FaultTolerantActorManager
from ray_tpu_torch.rllib.utils.replay_buffer import ReplayBuffer

__all__ = [
    "Algorithm",
    "AlgorithmConfig",
    "APPO",
    "APPOConfig",
    "BC",
    "BCConfig",
    "CQL",
    "CQLConfig",
    "MARWIL",
    "MARWILConfig",
    "SAC",
    "SACConfig",
    "DQN",
    "DQNConfig",
    "EnvRunnerGroup",
    "FaultTolerantActorManager",
    "IMPALA",
    "IMPALAConfig",
    "Learner",
    "LearnerGroup",
    "MultiAgentEnv",
    "MultiAgentEnvRunner",
    "PPO",
    "PPOConfig",
    "ReplayBuffer",
    "RLModuleSpec",
    "SingleAgentEnvRunner",
]
