"""RLlib on the port (ray_tpu_torch.rllib), on the CPU: the cases of
tests/test_rllib.py at their thresholds, with every learner on
device="cpu" and the port's runtime in place of ray_tpu's — PPO and DQN
learn CartPole, IMPALA's async pipeline improves, SAC improves on
Pendulum, BC, MARWIL and CQL learn from logged data, the learner group
stays in sync, env runners heal, checkpoints restore. Then what the port
adds: learners default to cuda and never fall back to the CPU, a named env
needs gymnasium while the numpy CartPole does not, and PPO learns the numpy
CartPole with remote runners that never touch CUDA (the card's phase 11b,
on the CPU).

A run of the port need not match the reference's run: the sampling
streams differ (torch generators in place of JAX keys)."""

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.testing import cartpole_env, torch_cluster  # noqa: F401

CPU = {"device": "cpu"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The learners run in this process: one intra-op thread, so the
    suite's other tests keep their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.timeout(300)
def test_ppo_cartpole_learns_local():
    """Reference parity: rllib/tuned_examples/ppo/cartpole-ppo.yaml reward
    threshold run, local mode."""
    from ray_tpu_torch.rllib import PPOConfig

    algo = (
        PPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=0, num_envs_per_env_runner=8)
        .training(
            train_batch_size=2048,
            minibatch_size=256,
            num_epochs=10,
            lr=3e-4,
            entropy_coeff=0.01,
        )
        .learners(**CPU)
        .debugging(seed=42)
        .build_algo()
    )
    best = 0.0
    for _ in range(40):
        result = algo.train()
        ret = result.get("episode_return_mean")
        if ret == ret:  # not NaN
            best = max(best, ret)
        if best >= 150:
            break
    algo.stop()
    assert best >= 150, f"PPO failed to learn CartPole: best={best}"


def test_ppo_distributed_env_runners(torch_cluster):  # noqa: F811
    from ray_tpu_torch.rllib import PPOConfig

    algo = (
        PPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=2, num_envs_per_env_runner=4)
        .training(train_batch_size=1024, minibatch_size=256, num_epochs=6)
        .learners(**CPU)
        .build_algo()
    )
    algo.train()
    r2 = algo.train()
    assert r2["num_env_steps_sampled_lifetime"] >= 2048
    assert "total_loss" in r2
    algo.stop()


@pytest.mark.timeout(300)
def test_dqn_cartpole_improves_local():
    from ray_tpu_torch.rllib import DQNConfig

    algo = (
        DQNConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=0, num_envs_per_env_runner=8,
                     rollout_fragment_length=8)
        .training(
            train_batch_size=64,
            updates_per_iteration=8,
            lr=1e-3,
            num_steps_sampled_before_learning_starts=1000,
            epsilon_timesteps=8000,
            target_network_update_freq=500,
        )
        .learners(**CPU)
        .debugging(seed=7)
        .build_algo()
    )
    best = 0.0
    # Early-exit on success keeps the pass-path fast; the generous budget
    # absorbs the run-to-run variance of epsilon-greedy exploration (the
    # environment's episode stream is not fully determined by the seeds).
    for _ in range(600):
        result = algo.train()
        ret = result.get("episode_return_mean")
        if ret == ret:
            best = max(best, ret)
        if best >= 100:
            break
    algo.stop()
    assert best >= 100, f"DQN failed to improve on CartPole: best={best}"


def test_bc_offline_imitation(torch_cluster):  # noqa: F811
    """BC clones a scripted expert from a ray_tpu_torch.data Dataset: action
    accuracy on the logged policy climbs well above chance (reference:
    rllib/algorithms/bc + offline data pipeline)."""
    import gymnasium as gym

    import ray_tpu_torch.data as rd
    from ray_tpu_torch.rllib import BCConfig

    # Scripted CartPole expert: push toward the pole's lean.
    env = gym.make("CartPole-v1")
    rows = []
    obs, _ = env.reset(seed=0)
    for _ in range(2000):
        action = int(obs[2] + 0.3 * obs[3] > 0)
        rows.append({"obs": obs.astype(np.float32).tolist(), "actions": action})
        obs, _, term, trunc, _ = env.step(action)
        if term or trunc:
            obs, _ = env.reset()
    env.close()

    ds = rd.from_items(rows)
    algo = (
        BCConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=0, num_envs_per_env_runner=2)
        .offline_data(input_=ds)
        .training(train_batch_size=128, updates_per_iteration=16, lr=1e-3)
        .learners(**CPU)
        .debugging(seed=5)
        .build_algo()
    )
    acc = 0.0
    for _ in range(100):
        result = algo.train()
        acc = max(acc, result["action_accuracy"])
        if acc >= 0.95:
            break
    algo.stop()
    assert acc >= 0.93, f"BC never fit the expert: accuracy={acc}"


@pytest.mark.timeout(400)
def test_sac_pendulum_improves_local():
    """SAC on Pendulum-v1 (continuous Box actions): squashed-Gaussian actor,
    twin Q + polyak targets, auto-tuned entropy temperature. Pendulum starts
    near -1500 mean return; crossing -900 demonstrates real learning."""
    from ray_tpu_torch.rllib import SACConfig

    algo = (
        SACConfig()
        .environment("Pendulum-v1")
        .env_runners(num_env_runners=0, num_envs_per_env_runner=8,
                     rollout_fragment_length=8)
        .training(
            train_batch_size=128,
            updates_per_iteration=16,
            lr=1e-3,
            num_steps_sampled_before_learning_starts=1000,
        )
        .learners(**CPU)
        .debugging(seed=3)
        .build_algo()
    )
    best = float("-inf")
    for _ in range(500):
        result = algo.train()
        ret = result.get("episode_return_mean")
        if ret == ret:  # not NaN
            best = max(best, ret)
        if best >= -900:
            break
    algo.stop()
    assert best >= -900, f"SAC failed to improve on Pendulum: best={best}"


@pytest.mark.timeout(300)
def test_impala_async_pipeline(torch_cluster):  # noqa: F811
    from ray_tpu_torch.rllib import IMPALAConfig

    algo = (
        IMPALAConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                     rollout_fragment_length=32)
        .training(batches_per_iteration=8, lr=5e-4)
        .learners(**CPU)
        .build_algo()
    )
    first = None
    best = 0.0
    for _ in range(25):
        result = algo.train()
        ret = result.get("episode_return_mean")
        if ret == ret:
            if first is None:
                first = ret
            best = max(best, ret)
        if best >= 80:
            break
    algo.stop()
    assert first is not None
    assert best > max(first, 40), f"IMPALA did not improve: first={first} best={best}"
    assert result["mean_weight_staleness"] >= 0


def _ppo_group_batch():
    rng = np.random.RandomState(0)
    return {
        "obs": rng.randn(64, 4).astype(np.float32),
        "actions": rng.randint(0, 2, 64),
        "logp_old": -0.7 * np.ones(64, np.float32),
        "advantages": rng.randn(64).astype(np.float32),
        "value_targets": rng.randn(64).astype(np.float32),
        "values_old": np.zeros(64, np.float32),
    }


def _ppo_builder():
    from ray_tpu_torch.rllib import RLModuleSpec
    from ray_tpu_torch.rllib.algorithms.ppo import PPOLearner

    spec = RLModuleSpec(obs_dim=4, num_actions=2)
    loss_cfg = {
        "clip_param": 0.2,
        "vf_clip_param": 10.0,
        "vf_loss_coeff": 0.5,
        "entropy_coeff": 0.0,
    }

    def build(device):
        return PPOLearner(spec, loss_cfg, lr=1e-3, seed=3, device=device)

    return build


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for item in tree for x in _leaves(item)]
    return [np.asarray(tree)]


def test_learner_group_grad_averaging(torch_cluster):  # noqa: F811
    """Two remote learners stay weight-synced via grad averaging, and hold
    what one learner holds after applying the mean of their gradients."""
    from ray_tpu_torch.rllib import LearnerGroup
    from ray_tpu_torch.rllib.core.learner_group import _mean_tree, _shard_batch

    build = _ppo_builder()
    group = LearnerGroup(build, num_learners=2, device="cpu")
    batch = _ppo_group_batch()
    metrics = group.update_from_batch(batch)
    assert "total_loss" in metrics
    # Both learners should hold identical weights after the averaged update.
    w = [ray_tpu_torch.get(a.get_weights.remote()) for a in group._manager.actors]
    flat0, flat1 = _leaves(w[0]), _leaves(w[1])
    for a, b in zip(flat0, flat1):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    assert ray_tpu_torch.get([a.get_device.remote() for a in group._manager.actors]) == ["cpu"] * 2
    group.shutdown()

    # The actors and this process may sum in other orders (their thread
    # counts differ): within 1% of an Adam step at lr 1e-3, as the parity
    # tests hold updates.
    local = build("cpu")
    grads = [local.compute_gradients(shard)[0] for shard in _shard_batch(batch, 2)]
    local.apply_gradients(_mean_tree(grads))
    for a, b in zip(flat0, _leaves(local.get_weights())):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_env_runner_fault_tolerance(torch_cluster):  # noqa: F811
    from ray_tpu_torch.rllib import PPOConfig

    algo = (
        PPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=2, num_envs_per_env_runner=2)
        .training(train_batch_size=256, minibatch_size=64, num_epochs=2)
        .learners(**CPU)
        .build_algo()
    )
    algo.train()
    # Kill one env runner; next train() should heal and still produce a batch.
    victim = algo.env_runner_group._manager.actors[0]
    ray_tpu_torch.kill(victim)
    result = algo.train()
    assert result["num_env_steps_sampled_lifetime"] > 0
    algo.stop()


def test_algorithm_checkpoint_restore(tmp_path):
    from ray_tpu_torch.rllib import PPOConfig

    def make():
        return (
            PPOConfig()
            .environment("CartPole-v1")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=2)
            .training(train_batch_size=256, minibatch_size=64, num_epochs=2)
            .learners(**CPU)
            .build_algo()
        )

    algo = make()
    algo.train()
    algo.train()
    ckpt = algo.save(str(tmp_path / "ckpt"))
    it = algo.iteration
    state = algo.learner_group.get_state()
    algo.stop()

    algo2 = make()
    algo2.restore(ckpt)
    assert algo2.iteration == it
    restored = algo2.learner_group.get_state()
    for a, b in zip(_leaves(restored), _leaves(state)):
        np.testing.assert_array_equal(a, b)
    result = algo2.train()
    assert result["training_iteration"] == it + 1
    algo2.stop()


def _logged_cartpole(n=2000, noise=0.3, seed=0):
    """Offline rows from a decent-but-noisy scripted CartPole policy
    (mixed-quality data, the offline-RL setting): full transitions with
    per-episode reward/done structure."""
    import gymnasium as gym

    rng = np.random.RandomState(seed)
    env = gym.make("CartPole-v1")
    rows = []
    obs, _ = env.reset(seed=seed)
    for _ in range(n):
        expert = int(obs[2] + 0.3 * obs[3] > 0)
        action = expert if rng.rand() > noise else rng.randint(2)
        nxt, rew, term, trunc, _ = env.step(action)
        rows.append(
            {
                "obs": obs.astype(np.float32).tolist(),
                "actions": action,
                "rewards": float(rew),
                "next_obs": nxt.astype(np.float32).tolist(),
                "dones": bool(term or trunc),
            }
        )
        obs = nxt
        if term or trunc:
            obs, _ = env.reset()
    env.close()
    return rows


def test_marwil_beats_bc_weighting(torch_cluster):  # noqa: F811
    """MARWIL's exp(beta*advantage) weighting learns from MIXED-quality
    logs: the learned policy's action accuracy against the expert rule
    exceeds the noisy behavior policy's own consistency (reference:
    rllib/algorithms/marwil learning tests)."""
    import ray_tpu_torch.data as rd
    from ray_tpu_torch.rllib import MARWILConfig
    from ray_tpu_torch.rllib.core.rl_module import forward_pi_vf

    rows = _logged_cartpole(n=3000, noise=0.35, seed=3)

    algo = (
        MARWILConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=0, num_envs_per_env_runner=2)
        .offline_data(input_=rd.from_items(rows))
        .training(train_batch_size=256, updates_per_iteration=24, lr=2e-3)
        .learners(**CPU)
        .debugging(seed=7)
        .build_algo()
    )
    for _ in range(30):
        result = algo.train()
    assert "policy_loss" in result and "vf_loss" in result
    assert result["mean_weight"] > 0.0
    # Greedy accuracy vs the expert rule on held-out states.
    learner = algo.learner_group._local
    test_obs = np.asarray([r["obs"] for r in rows[:500]], dtype=np.float32)
    expert = np.asarray(
        [int(o[2] + 0.3 * o[3] > 0) for o in test_obs], dtype=np.int64
    )
    with torch.no_grad():
        logits, _ = forward_pi_vf(learner.module, torch.from_numpy(test_obs))
    acc = float(np.mean(np.argmax(logits.numpy(), axis=-1) == expert))
    # The behavior policy agrees with the expert only ~65% of the time;
    # advantage weighting must push past it.
    assert acc > 0.75, f"MARWIL greedy accuracy {acc:.2f}"
    algo.stop()


def test_cql_conservative_penalty(torch_cluster):  # noqa: F811
    """CQL learns from the fixed buffer and its conservative gap shrinks;
    the penalty keeps logged-action values above the soft-max OOD value
    (reference: rllib/algorithms/cql learning tests)."""
    import ray_tpu_torch.data as rd
    from ray_tpu_torch.rllib import CQLConfig

    rows = _logged_cartpole(n=2000, noise=0.2, seed=11)

    def train_with(alpha):
        algo = (
            CQLConfig()
            .environment("CartPole-v1")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=2)
            .offline_data(input_=rd.from_items(rows))
            .training(
                train_batch_size=64, updates_per_iteration=32, lr=1e-3,
                cql_alpha=alpha,
            )
            .learners(**CPU)
            .debugging(seed=13)
            .build_algo()
        )
        result = {}
        for _ in range(15):
            result = algo.train()
        algo.stop()
        return result

    conservative = train_with(1.0)
    plain = train_with(0.0)
    assert "td_loss" in conservative and "total_loss" in conservative
    # The penalty's defining property: logged-action Q values sit closer to
    # the soft-max over actions than an unpenalized learner's — OOD actions
    # are pushed DOWN relative to in-distribution ones.
    assert conservative["cql_gap"] < plain["cql_gap"], (
        f"penalty had no conservative effect: alpha=1 gap "
        f"{conservative['cql_gap']:.3f} vs alpha=0 gap {plain['cql_gap']:.3f}"
    )


# -- what the port adds ----------------------------------------------------------


def test_learners_default_to_cuda_and_never_fall_back():
    """A learner built without a device is on cuda, and raises where there
    is no card; a learner group of actors on cuda without a GPU lease
    raises, in the group's process and in the actor."""
    from ray_tpu_torch.rllib import LearnerGroup, PPOConfig
    from ray_tpu_torch.rllib.core.learner_group import _LearnerActor

    build = _ppo_builder()
    if torch.cuda.is_available():
        assert build("cuda").module.pi[0].weight.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build("cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PPOConfig().environment(cartpole_env).build_algo()
    with pytest.raises(ValueError, match="num_gpus_per_learner"):
        LearnerGroup(build, num_learners=1, device="cuda")
    import cloudpickle

    with pytest.raises(RuntimeError, match="GPU lease"):
        _LearnerActor(cloudpickle.dumps(build), "cuda", 0.0)
    assert PPOConfig().learner_device is None  # None means "cuda"


def test_named_env_needs_gymnasium_and_numpy_cartpole_does_not(monkeypatch):
    """Without gymnasium, a named env raises its ImportError (never a
    substitute env), and the numpy CartPole factory still samples."""
    import sys

    from ray_tpu_torch.rllib.env.env_runner import SingleAgentEnvRunner

    monkeypatch.setitem(sys.modules, "gymnasium", None)  # import gymnasium raises
    with pytest.raises(ImportError):
        SingleAgentEnvRunner("CartPole-v1", num_envs=2)
    runner = SingleAgentEnvRunner(cartpole_env, num_envs=2, seed=1)
    out = runner.sample(32)
    assert out["obs"].shape == (32, 2, 4) and out["bootstrap_value"].shape == (2,)
    assert np.isfinite(out["values"]).all()


@pytest.mark.timeout(300)
def test_ppo_learns_numpy_cartpole_with_remote_runners(torch_cluster):  # noqa: F811
    """The card's main path on the CPU: PPO at cartpole-ppo.yaml's settings,
    two runner actors of four numpy CartPoles each, threshold 150 within 40
    iterations; no runner process has made a CUDA context or holds jax or
    ray_tpu."""
    from ray_tpu_torch.rllib import PPOConfig

    algo = (
        PPOConfig()
        .environment(cartpole_env)
        .env_runners(num_env_runners=2, num_envs_per_env_runner=4)
        .training(train_batch_size=2048, minibatch_size=256, num_epochs=10, lr=3e-4,
                  entropy_coeff=0.01)
        .learners(**CPU)
        .debugging(seed=42)
        .build_algo()
    )
    try:
        best = 0.0
        for _ in range(40):
            ret = algo.train()["episode_return_mean"]
            if ret == ret:
                best = max(best, ret)
            if best >= 150:
                break
        assert best >= 150, f"PPO failed to learn the numpy CartPole: best={best}"
        infos = ray_tpu_torch.get([a.process_info.remote()
                                   for a in algo.env_runner_group._manager.actors])
        assert infos == [{"cuda_initialized": False, "forbidden_modules": []}] * 2
    finally:
        algo.stop()
