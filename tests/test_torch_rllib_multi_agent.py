"""Multi-agent RLlib on the port (ray_tpu_torch.rllib), on the CPU: the
cases of tests/test_rllib_multi_agent.py at their thresholds, with the
learners on device="cpu" and the port's runtime in place of ray_tpu's
(reference: rllib/env/multi_agent_env_runner.py,
core/rl_module/multi_rl_module.py, examples/multi_agent): PPO with two
independent policies on a 2-agent cooperative env must reach a reward
threshold."""

import numpy as np
import pytest
import torch

from ray_tpu_torch.rllib import PPOConfig
from ray_tpu_torch.rllib.env.multi_agent_env_runner import MultiAgentEnvRunner
from ray_tpu_torch.testing import torch_cluster  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def ma_cluster(torch_cluster):  # noqa: F811
    yield


def _env_factory():
    """Factory closure (shipped by value to runner actors)."""

    def make(cfg):
        import gymnasium as gym
        import numpy as np

        from ray_tpu_torch.rllib import MultiAgentEnv

        class ContextMatch(MultiAgentEnv):
            """Each agent sees its own random one-hot context and is paid
            1.0 for picking the hot index. Optimal per-episode return with
            2 agents and 8 steps = 16; random play = 4."""

            def __init__(self, config):
                self.horizon = int(config.get("horizon", 8))
                n = int(config.get("num_agents", 2))
                self._agents = [f"agent_{i}" for i in range(n)]
                self.observation_spaces = {
                    a: gym.spaces.Box(0.0, 1.0, (4,), dtype=np.float32)
                    for a in self._agents
                }
                self.action_spaces = {
                    a: gym.spaces.Discrete(4) for a in self._agents
                }
                self._rng = np.random.default_rng(config.get("seed", 0))
                self._t = 0
                self._ctx = {}

            def _draw(self):
                self._ctx = {}
                obs = {}
                for a in self._agents:
                    hot = int(self._rng.integers(0, 4))
                    vec = np.zeros(4, dtype=np.float32)
                    vec[hot] = 1.0
                    self._ctx[a] = hot
                    obs[a] = vec
                return obs

            def reset(self, *, seed=None):
                self._t = 0
                return self._draw(), {}

            def step(self, action_dict):
                rewards = {
                    a: float(action_dict[a] == self._ctx[a])
                    for a in self._agents
                }
                self._t += 1
                done = self._t >= self.horizon
                obs = self._draw()
                terms = {a: done for a in self._agents}
                terms["__all__"] = done
                truncs = {a: False for a in self._agents}
                truncs["__all__"] = False
                return obs, rewards, terms, truncs, {}

        return ContextMatch(cfg)

    return make


def test_multi_agent_runner_shapes(ma_cluster):
    runner = MultiAgentEnvRunner(
        _env_factory(),
        policies=["p0", "p1"],
        policy_mapping_fn=lambda aid: "p0" if aid == "agent_0" else "p1",
        seed=1,
    )
    out = runner.sample(16)
    assert out["env_steps"] == 16
    assert set(out["policies"]) == {"p0", "p1"}
    for pid in ("p0", "p1"):
        b = out["policies"][pid]
        assert b["obs"].shape == (16, 1, 4)
        assert b["actions"].shape == (16, 1)
        assert b["rewards"].shape == (16, 1)
        assert b["bootstrap_value"].shape == (1,)
    # Episode bookkeeping: horizon 8 -> 2 completed episodes in 16 steps.
    assert len(out["episode_stats"]) == 2
    # Spaces map per policy.
    assert runner.get_spaces() == {"p0": (4, 4), "p1": (4, 4)}
    runner.stop()


def test_multi_agent_ppo_learns(ma_cluster):
    """PPO with two independent policies on the 2-agent context game must
    reach >=13/16 mean episode return (random = 4, optimal = 16)."""
    config = (
        PPOConfig()
        .environment(env=_env_factory(), env_config={"horizon": 8})
        .env_runners(num_env_runners=1)
        .multi_agent(
            policies=["p0", "p1"],
            policy_mapping_fn=lambda aid: "p0" if aid == "agent_0" else "p1",
        )
        .training(
            train_batch_size=512,
            minibatch_size=64,
            num_epochs=6,
            lr=3e-3,
            entropy_coeff=0.003,
        )
        .learners(device="cpu")
        .debugging(seed=5)
    )
    algo = config.build_algo()
    try:
        best = -np.inf
        for _ in range(40):
            result = algo.train()
            ret = result.get("episode_return_mean", float("nan"))
            if np.isfinite(ret):
                best = max(best, ret)
            if best >= 13.0:
                break
        assert best >= 13.0, f"multi-agent PPO failed to learn: best={best}"
        # Both policies actually trained (per-policy metrics present).
        assert any(k.startswith("p0/") for k in result)
        assert any(k.startswith("p1/") for k in result)
    finally:
        algo.stop()


def test_multi_agent_shared_policy(ma_cluster):
    """Many agents can map onto ONE shared policy (parameter sharing)."""
    config = (
        PPOConfig()
        .environment(
            env=_env_factory(), env_config={"horizon": 4, "num_agents": 3}
        )
        .multi_agent(
            policies=["shared"], policy_mapping_fn=lambda aid: "shared"
        )
        .training(train_batch_size=128, minibatch_size=32, num_epochs=2)
        .learners(device="cpu")
    )
    algo = config.build_algo()
    try:
        result = algo.train()
        assert "episode_return_mean" in result
        # 3 agents share one policy: batch axis is 3.
        out = algo.env_runner_group.sample(4)[0]
        assert out["policies"]["shared"]["obs"].shape == (4, 3, 4)
    finally:
        algo.stop()


def test_multi_agent_runner_vectorized_envs(ma_cluster):
    """num_envs=4: one batched forward per policy covers all env copies —
    the batch axis is num_envs * n_agents and throughput scales with env
    count per batched forward (reference: MultiAgentEnvRunner over vector
    envs)."""
    runner = MultiAgentEnvRunner(
        _env_factory(),
        policies=["p0", "p1"],
        policy_mapping_fn=lambda aid: "p0" if aid == "agent_0" else "p1",
        seed=3,
        num_envs=4,
    )
    out = runner.sample(8)
    # 8 lockstep steps x 4 envs = 32 env steps from one sample() call.
    assert out["env_steps"] == 32
    for pid in ("p0", "p1"):
        b = out["policies"][pid]
        assert b["obs"].shape == (8, 4, 4)  # [T, num_envs * 1 agent, obs]
        assert b["actions"].shape == (8, 4)
        assert b["mask"].shape == (8, 4)
        assert b["bootstrap_value"].shape == (4,)
    # Every env copy completed its horizon-8 episode.
    assert len(out["episode_stats"]) == 4
    # Rewards are per-env meaningful: each env's reward depends on its own
    # context, so the 4 env slots are not identical copies.
    rew = out["policies"]["p0"]["rewards"]
    assert rew.shape == (8, 4)
    runner.stop()
