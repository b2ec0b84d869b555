"""The port's RLlib (ray_tpu_torch.rllib) against the JAX package's on the
CPU: each module's forward on JAX-initialised weights, SAC's sampled action
on the noise JAX draws, GAE, V-trace, every learner's loss, metrics and
gradients against jax.value_and_grad of the reference's loss_fn, three
updates against the reference's optax clip + Adam, and the port's vector
env and numpy CartPole against gymnasium, bitwise.

Tolerances (f32 on both sides; they differ only in summation order):
- forwards, losses and metrics: rtol 1e-6, atol 1e-6 (FWD);
- gradients: rtol 1e-5, atol 1e-6 (GRAD): a gradient sums 64 rows' terms
  in an order of each library's choosing;
- parameters after each of three Adam updates: atol 1e-5 at lr 1e-3
  (UPDATE), 1% of a step: Adam's step is lr * m / (sqrt(v) + eps), and
  where a gradient component is near 0 its rounding moves m / sqrt(v) by
  up to ~1e-3 (measured: 1.6e-6 of a parameter after three steps);
- envs: bitwise.
"""

import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from ray_tpu_torch.convert import rl_module_from_jax, rl_module_to_numpy  # noqa: E402
from ray_tpu_torch.rllib.core import rl_module as M  # noqa: E402
from ray_tpu_torch.testing import CartPole, rl_learner_cases  # noqa: E402

FWD = dict(rtol=1e-6, atol=1e-6)
GRAD = dict(rtol=1e-5, atol=1e-6)
UPDATE = dict(rtol=0.0, atol=1e-5)
LR = 1e-3
# Small widths for the CPU; the card's phase 11 runs the same cases at the
# reference's (64, 64) and SAC's (256, 256).
CASES = rl_learner_cases(seed=0, n=64, T=8, envs=8, hidden=(32, 32), sac_hidden=(32, 32))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _leaves(x, path + (i,))
    else:
        yield path, np.asarray(tree)


def _assert_trees(got, want, tol, what=""):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys(), (what, sorted(got), sorted(want))
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, err_msg=f"{what} {path}", **tol)


def _jax_spec(spec):
    from ray_tpu.rllib.core.rl_module import RLModuleSpec

    return RLModuleSpec(**spec)


def _port_spec(spec):
    return M.RLModuleSpec(**spec)


# -- modules -------------------------------------------------------------------

MODULE_KINDS = {
    "pi_vf": ({"obs_dim": 5, "num_actions": 3, "hidden": (16, 8)}, "init_pi_vf"),
    "pi_vf_shared": ({"obs_dim": 5, "num_actions": 3, "hidden": (16, 8),
                      "vf_share_layers": True}, "init_pi_vf"),
    "q": ({"obs_dim": 5, "num_actions": 3, "hidden": (16, 8)}, "init_q"),
    "sac": ({"obs_dim": 5, "num_actions": 0, "hidden": (16, 8), "act_dim": 2,
             "act_limit": 2.0}, "init_sac"),
}


@pytest.mark.parametrize("name", sorted(MODULE_KINDS))
def test_module_forward_matches_jax(name):
    from ray_tpu.rllib.core import rl_module as J

    spec, init = MODULE_KINDS[name]
    kind = name.replace("_shared", "")
    params = jax.device_get(getattr(J, init)(jax.random.PRNGKey(1), _jax_spec(spec)))
    module = rl_module_from_jax(params, _port_spec(spec), kind, device="cpu")
    _assert_trees(rl_module_to_numpy(module), params, dict(rtol=0, atol=0), "round trip")
    assert M.num_params(module) == J.num_params(params)
    obs = np.random.RandomState(2).randn(7, 5).astype(np.float32)
    x = torch.from_numpy(obs)
    with torch.no_grad():
        if kind == "pi_vf":
            got, want = M.forward_pi_vf(module, x), J.forward_pi_vf(params, obs)
        elif kind == "q":
            got, want = (M.forward_q(module, x),), (J.forward_q(params, obs),)
        else:
            act = np.random.RandomState(3).uniform(-2, 2, (7, 2)).astype(np.float32)
            got = (*M.sac_q(module, x, torch.from_numpy(act)),
                   M.sac_pi_deterministic(module, x, 2.0))
            want = (*J.sac_q(params, obs, act), J.sac_pi_deterministic(params, obs, 2.0))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FWD)


def test_sac_pi_matches_jax_on_its_noise():
    """sac_pi given the Gaussian noise JAX draws from its key: the same
    action and log-probability (with the tanh and act_limit terms)."""
    from ray_tpu.rllib.core import rl_module as J

    spec, _ = MODULE_KINDS["sac"]
    params = jax.device_get(J.init_sac(jax.random.PRNGKey(4), _jax_spec(spec)))
    module = rl_module_from_jax(params, _port_spec(spec), "sac", device="cpu")
    obs = np.random.RandomState(5).randn(9, 5).astype(np.float32)
    key = jax.random.PRNGKey(6)
    act_j, logp_j = J.sac_pi(params, obs, key, 2.0)
    eps = torch.from_numpy(np.asarray(jax.random.normal(key, (9, 2))))
    with torch.no_grad():
        act_p, logp_p = M.sac_pi(module, torch.from_numpy(obs), eps, 2.0)
    np.testing.assert_allclose(act_p.numpy(), np.asarray(act_j), **FWD)
    np.testing.assert_allclose(logp_p.numpy(), np.asarray(logp_j), rtol=1e-6, atol=1e-5)


def test_gae_matches_reference():
    from ray_tpu.rllib.algorithms.algorithm import gae_advantages as ref
    from ray_tpu_torch.rllib.algorithms.algorithm import gae_advantages

    rng = np.random.RandomState(7)
    T, N = 40, 6
    args = (rng.randn(T, N).astype(np.float32), rng.randn(T, N).astype(np.float32),
            rng.rand(T, N) < 0.1, rng.rand(T, N) < 0.05, rng.randn(N).astype(np.float32),
            0.99, 0.95)
    boundary = rng.randn(T, N).astype(np.float32)
    for kw in ({}, {"boundary_values": boundary}):
        for got, want in zip(gae_advantages(*args, **kw), ref(*args, **kw)):
            np.testing.assert_array_equal(got, want)


def test_vtrace_matches_jax_scan():
    from ray_tpu.rllib.algorithms.impala import _vtrace as ref
    from ray_tpu_torch.rllib.algorithms.impala import _vtrace

    rng = np.random.RandomState(8)
    T, B = 20, 5
    arrays = [np.log(rng.uniform(0.1, 0.9, (T, B))), np.log(rng.uniform(0.1, 0.9, (T, B))),
              rng.randn(T, B), rng.randn(T, B), rng.randn(B),
              (rng.rand(T, B) < 0.15).astype(np.float64)]
    arrays = [a.astype(np.float32) for a in arrays]
    for clip_rho, clip_c in ((1.0, 1.0), (0.8, 1.5)):
        want = ref(*map(jnp.asarray, arrays), 0.99, clip_rho, clip_c)
        got = _vtrace(*map(torch.from_numpy, arrays), 0.99, clip_rho, clip_c)
        for g, w in zip(got, want):
            assert not g.requires_grad
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


# -- learners ------------------------------------------------------------------


def _learners(case, grad_clip=40.0):
    """(reference learner, port learner on the CPU) of one case, the port's
    holding the reference's initial weights."""
    args = (case["cfg"],) if case["cfg"] is not None else ()
    ref_cls = getattr(importlib.import_module(f"ray_tpu.rllib.algorithms.{case['module']}"),
                      case["cls"])
    port_cls = getattr(importlib.import_module(
        f"ray_tpu_torch.rllib.algorithms.{case['module']}"), case["cls"])
    ref = ref_cls(_jax_spec(case["spec"]), *args, lr=LR, grad_clip=grad_clip, seed=3)
    port = port_cls(_port_spec(case["spec"]), *args, lr=LR, grad_clip=grad_clip, seed=3,
                    device="cpu")
    port.set_weights(jax.device_get(ref.params))
    return ref, port


def _extras(name, case, ref):
    """The inputs a learner's update adds to the batch, for both sides:
    (reference's, port's). DQN and CQL get a target net and SAC target
    critics (the params moved a little, so target and online differ), SAC
    the noise keys and the noise JAX draws from them, MARWIL the moving
    average of squared advantages."""
    rng = np.random.RandomState(11)
    jx, pt = {}, {}
    params = jax.device_get(ref.params)
    nudge = jax.tree_util.tree_map(
        lambda x: (x + 0.05 * rng.randn(*np.shape(x))).astype(np.float32), params)
    spec = _port_spec(case["spec"])
    if name in ("dqn", "cql", "sac"):
        kind = "q" if name != "sac" else "sac"
        target = rl_module_from_jax(nudge, spec, kind, device="cpu")
        pt["_target_params"] = {n: p.detach() for n, p in target.named_parameters()
                                if kind == "q" or n.startswith(("q1.", "q2."))}
        jx["_target_params"] = nudge if kind == "q" else {"q1": nudge["q1"], "q2": nudge["q2"]}
    if name == "sac":
        n, act_dim = len(case["batch"]["obs"]), case["spec"]["act_dim"]
        for key, seed in (("next", 21), ("pi", 22)):
            k = jax.random.PRNGKey(seed)
            jx[f"_rng_{key}"] = k
            pt[f"_eps_{key}"] = torch.from_numpy(np.asarray(jax.random.normal(k, (n, act_dim))))
    if name == "marwil":
        jx["_ma_sq_adv"] = np.float32(1.7)
        pt["_ma_sq_adv"] = torch.tensor(np.float32(1.7))
    return jx, pt


def _batches(name, case, ref, port):
    jx, pt = _extras(name, case, ref)
    jbatch = {**jax.tree_util.tree_map(jnp.asarray, case["batch"]), **jx}
    pbatch = {**port.to_device(case["batch"]), **pt}
    return jbatch, pbatch


@pytest.mark.parametrize("name", sorted(CASES))
def test_learner_loss_metrics_and_grads_match_jax(name):
    case = CASES[name]
    ref, port = _learners(case)
    jbatch, pbatch = _batches(name, case, ref, port)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(ref.loss_fn, has_aux=True))(
        ref.params, jbatch)
    metrics = {**jax.device_get(metrics), "total_loss": loss,
               "grad_norm": optax.global_norm(grads)}
    got = port._to_host(port._backward(pbatch))
    assert set(metrics) <= set(got), (sorted(metrics), sorted(got))
    for k, v in metrics.items():
        np.testing.assert_allclose(got[k], float(v), err_msg=k, **FWD)
    _assert_trees(rl_module_to_numpy(port.module, grads=True), jax.device_get(grads), GRAD,
                  f"{name} grads")


@pytest.mark.parametrize("clip", ["binding", "not_binding"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_three_updates_match_optax(name, clip):
    """Three updates on one batch: loss, metrics and every parameter after
    each, against the reference learner's jitted update (optax global-norm
    clip, then Adam). The clip is 0.05 (every step's norm is above it: the
    scaling is what is held) or 1e3 (never reached)."""
    case = CASES[name]
    ref, port = _learners(case, grad_clip=0.05 if clip == "binding" else 1e3)
    jbatch, pbatch = _batches(name, case, ref, port)
    for step in range(3):
        ref.params, ref.opt_state, want = ref._jit_update(ref.params, ref.opt_state, jbatch)
        got = port._update(pbatch)
        assert (want["grad_norm"] > 0.05) if clip == "binding" else (want["grad_norm"] < 1e3)
        for k, v in jax.device_get(want).items():
            np.testing.assert_allclose(got[k], float(v), err_msg=f"step {step} {k}", rtol=1e-5,
                                       atol=1e-5)
        _assert_trees(port.get_weights(), jax.device_get(ref.params), UPDATE,
                      f"{name} params after update {step + 1}")
    state = port.get_state()
    assert state["num_updates"] == 3 and state["opt_state"]["step"] == 3.0


@pytest.mark.parametrize("name", ["ppo", "marwil", "dqn"])
def test_update_from_batch_matches_reference(name):
    """The public update_from_batch on numpy, three times (PPO as the main
    path runs it; MARWIL with its host-side moving average; DQN with the
    target net synced to the shared weights on both sides)."""
    case = CASES[name]
    ref, port = _learners(case)
    if name == "dqn":
        ref.sync_target()
        port.sync_target()
    for step in range(3):
        want, got = ref.update_from_batch(case["batch"]), port.update_from_batch(case["batch"])
        assert set(want) == set(got)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                       err_msg=f"step {step} {k}")
    _assert_trees(port.get_weights(), jax.device_get(ref.params), UPDATE, name)
    if name == "marwil":
        np.testing.assert_allclose(port.ma_sq_adv, ref.ma_sq_adv, rtol=1e-6)


def test_learner_state_round_trips_on_another_learner():
    """get_state is numpy; set_state on a fresh learner makes its next
    update equal the first learner's, bitwise."""
    case = CASES["ppo"]
    _, a = _learners(case)
    _, b = _learners(case)
    a.update_from_batch(case["batch"])
    b.set_state(a.get_state())
    _assert_trees(b.get_state(), a.get_state(), dict(rtol=0, atol=0), "state")
    ma, mb = a.update_from_batch(case["batch"]), b.update_from_batch(case["batch"])
    assert ma == mb
    _assert_trees(b.get_weights(), a.get_weights(), dict(rtol=0, atol=0), "after")


def test_sac_actor_gradient_spares_the_critics():
    """The actor loss alone moves pi and not q1/q2 (their params frozen,
    the action still carrying a gradient to pi): its gradients against
    jax.grad of the reference's actor term."""
    case = CASES["sac"]
    ref, port = _learners(case)
    jbatch, pbatch = _batches("sac", case, ref, port)

    grads = jax.grad(lambda p, b: ref.loss_fn(p, b)[1]["actor_loss"])(ref.params, jbatch)
    port.module.zero_grad(set_to_none=True)
    port.loss_fn(port.module, pbatch)[1]["actor_loss"].backward()
    got = [{"w": layer.weight.grad.numpy().T, "b": layer.bias.grad.numpy()}
           for layer in port.module.pi]
    grads = jax.device_get(grads)
    for net in ("q1", "q2"):
        assert all(np.all(np.asarray(layer[k]) == 0) for layer in grads[net] for k in "wb")
        assert all(p.grad is None for n, p in port.module.named_parameters()
                   if n.startswith(net)), net
    assert np.any(np.asarray(grads["pi"][0]["w"]) != 0)
    _assert_trees(got, grads["pi"], GRAD, "actor grads of pi")


# -- envs ----------------------------------------------------------------------


# Per env, the chance of a random action in place of CartPole's scripted
# expert: the first two envs mostly reach the 500-step truncation, the last
# two fall (termination), the last acting at random.
EXPLORE = np.array([0.0, 0.01, 0.5, 1.0])


def _step_both(gym_env, port_env, steps, seed, explore=EXPLORE):
    """Steps both vector envs with the same actions (the expert, or a random
    action with each env's chance in `explore`); asserts every output equal,
    bitwise. Returns (terminations, truncations)."""
    og, _ = gym_env.reset(seed=seed)
    op, _ = port_env.reset(seed=seed)
    np.testing.assert_array_equal(op, og)
    assert op.dtype == og.dtype
    rng = np.random.RandomState(seed)
    ends = np.zeros(2, dtype=np.int64)
    for t in range(steps):
        expert = (og[:, 2] + 0.3 * og[:, 3] > 0).astype(np.int64)
        a = np.where(rng.rand(len(expert)) < explore, rng.randint(0, 2, len(expert)), expert)
        g, p = gym_env.step(a), port_env.step(a)
        for x, y in zip(p[:4], g[:4]):
            np.testing.assert_array_equal(x, y, err_msg=f"step {t}")
            assert x.dtype == y.dtype
        ig, ip = g[4], p[4]
        assert ("final_obs" in ig) == ("final_obs" in ip)
        if "final_obs" in ig:
            np.testing.assert_array_equal(ip["_final_obs"], ig["_final_obs"])
            for i in np.nonzero(ig["_final_obs"])[0]:
                np.testing.assert_array_equal(ip["final_obs"][i], ig["final_obs"][i])
        ends += [g[2].sum(), g[3].sum()]
        og = g[0]
    return ends


def _gym_vector(n):
    gym = pytest.importorskip("gymnasium")
    return gym.vector.SyncVectorEnv([lambda: gym.make("CartPole-v1") for _ in range(n)],
                                    autoreset_mode=gym.vector.AutoresetMode.SAME_STEP)


def test_vector_env_matches_gymnasium_same_step():
    """The port's SyncVectorEnv over gym.make("CartPole-v1") against
    gymnasium's in SAME_STEP mode: obs, rewards, terminations,
    truncations and final_obs, bitwise, over many episode ends of both
    kinds."""
    import gymnasium as gym

    from ray_tpu_torch.rllib.env.env_runner import SyncVectorEnv

    ends = _step_both(_gym_vector(4),
                      SyncVectorEnv([lambda: gym.make("CartPole-v1") for _ in range(4)]),
                      2500, seed=5)
    assert ends[0] >= 20 and ends[1] >= 3, ends


def test_numpy_cartpole_matches_gymnasium():
    """The numpy CartPole-v1 of ray_tpu_torch.testing in the port's vector
    env against gymnasium's CartPole-v1 in its own, bitwise, through
    terminations and 500-step truncations."""
    from ray_tpu_torch.rllib.env.env_runner import SyncVectorEnv

    ends = _step_both(_gym_vector(4), SyncVectorEnv([CartPole for _ in range(4)]),
                      2500, seed=9)
    assert ends[0] >= 20 and ends[1] >= 3, ends


def test_runner_batches_equal_on_named_and_numpy_cartpole():
    """A runner on the named env and one on the numpy CartPole factory,
    same seed: the same batches, bitwise (the env is the only difference)."""
    from ray_tpu_torch.rllib.env.env_runner import SingleAgentEnvRunner
    from ray_tpu_torch.testing import cartpole_env

    named = SingleAgentEnvRunner("CartPole-v1", num_envs=3, seed=4)
    factory = SingleAgentEnvRunner(cartpole_env, num_envs=3, seed=4)
    factory.set_weights(M.tree_of(named.module))
    for _ in range(3):
        a, b = named.sample(64), factory.sample(64)
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a[k] == b[k], k
    assert len(a["episode_stats"]) > 0
