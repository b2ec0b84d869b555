"""Test helpers for the port (counterpart of ray_tpu/testing.py, whose JAX
CPU-mesh helpers have no place here).

Test files import the fixtures they use:

    from ray_tpu_torch.testing import torch_cluster  # noqa: F401

Tests that need a CUDA card carry the `cuda` marker (pyproject.toml) and
decide inside the test whether there is one, never while the module is
imported.

A CPU mesh of n devices is n processes, one device each: `run_in_processes`
runs a function in n spawned gloo processes and returns rank 0's result;
the tests and `ray_tpu_torch.dryrun` share it, and the workers the tests
run through it live here, so the spawned processes import neither jax nor
the test files.

For RLlib: `CartPole` is CartPole-v1 in numpy with the minimal spaces the
env runners read (`Box`, `Discrete`), for machines without gymnasium, and
`rl_learner_cases` the seeded fixed-batch cases of every learner that the
CPU parity tests and the card's phase 11 share.
"""

from __future__ import annotations

import datetime
import math
import queue as queue_lib
import time

import numpy as np
import pytest


@pytest.fixture
def torch_cluster():
    """Fresh single-node port cluster per test: 4 CPUs and the GPUs the
    node has."""
    import ray_tpu_torch

    info = ray_tpu_torch.init(num_cpus=4)
    yield info
    ray_tpu_torch.shutdown()


# ------------------------------------------------------------ gloo processes

def _child(fn, inbox, rank: int, world: int, port: int, results) -> None:
    import traceback

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        args = inbox.get(timeout=120)
        store = dist.TCPStore("127.0.0.1", port, is_master=False,
                              timeout=datetime.timedelta(seconds=120))
        dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, None, out if rank == 0 else None))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, traceback.format_exc(), None))


def run_in_processes(fn, n: int, *args, timeout: float = 300.0):
    """fn(*args) in n spawned processes joined in one gloo process group
    (rank r of n; the rendezvous store listens here, on a port the OS
    picks); returns rank 0's result. Raises with the traceback of the first
    rank that fails, or when the ranks do not finish within `timeout`
    seconds; every process is ended before it returns. `fn` must be
    importable by name (module level)."""
    import multiprocessing

    import torch.distributed as dist

    ctx = multiprocessing.get_context("spawn")
    store = dist.TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False)
    # The arguments go through a queue, whose feeder thread does not block
    # start(): arguments larger than a pipe's buffer, passed to Process,
    # would hold each start() until that child has imported what fn needs.
    inbox, results = ctx.Queue(), ctx.Queue()
    for _ in range(n):
        inbox.put(args)
    procs = [ctx.Process(target=_child, args=(fn, inbox, r, n, store.port, results), daemon=True)
             for r in range(n)]
    for p in procs:
        p.start()
    done = {}
    deadline = time.monotonic() + timeout
    try:
        while len(done) < n:
            try:
                rank, err, out = results.get(timeout=1.0)
            except queue_lib.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"a rank died with exit code {dead[0]}") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{n} ranks did not finish in {timeout} s") from None
                continue
            if err is not None:
                raise RuntimeError(f"rank {rank} of {n} failed:\n{err}")
            done[rank] = out
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        # Arguments no child took stay in the inbox's pipe: do not let the
        # queue's feeder thread hold this process's exit on them.
        inbox.cancel_join_thread()
    return done[0]


# ------------------------------------------------------- workers of the tests

def attention_worker(cases):
    """Each case (fn, axes, q, k, v, g, causal, impl): `fn` ('ring' or
    'ulysses') on a CPU mesh of `axes` from the global numpy inputs, the
    loss sum(out * g) over this rank's block. Returns, per case, the global
    output and the gradients of q, k, v, summed over the ranks (every
    axis of `axes` must split the inputs, so each block has one owner)."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.parallel import make_mesh, shard_of
    from ray_tpu_torch.parallel.ring_attention import ring_attention_sharded
    from ray_tpu_torch.parallel.ulysses import ulysses_attention_sharded

    out = []
    for fn, axes, q, k, v, g, causal, impl in cases:
        mesh = make_mesh(axes, device="cpu")
        leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
        if fn == "ring":
            o = ring_attention_sharded(*leaves, mesh, causal=causal, impl=impl)
            dims = {0: ("data", "fsdp"), 1: ("sequence",), 2: ("tensor",)}
        else:
            o = ulysses_attention_sharded(*leaves, mesh, causal=causal, impl=impl)
            dims = {0: ("data", "fsdp"), 1: ("sequence",)}
        grads = torch.autograd.grad(o, leaves, shard_of(mesh, torch.from_numpy(g), dims))
        whole = torch.zeros(q.shape)
        shard_of(mesh, whole, dims).copy_(o.detach())
        results = [whole, *grads]
        for t in results:
            dist.all_reduce(t)
        out.append([t.numpy() for t in results])
    return out


def sharded_steps_worker(runs, tree, tokens, steps: int, lr: float, wd: float,
                         record_at=(1, 3)):
    """For each (axes, cfg_kwargs) of `runs`: make_train_step on a CPU mesh
    of `axes` from the JAX-shaped param tree `tree` and the global batch
    `tokens` ([B, T+1] numpy), AdamW(lr, weight_decay=wd). Returns per run
    ({parameter name: this rank's shard shape} as placed, and per step
    (loss, grad_norm) and, at the steps in `record_at`, every parameter
    whole)."""
    import torch
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.convert import params_from_jax, params_to_numpy
    from ray_tpu_torch.models import transformer as tr
    from ray_tpu_torch.parallel import make_mesh

    out = []
    for axes, cfg_kwargs in runs:
        cfg = tr.TransformerConfig(**cfg_kwargs)
        mesh = make_mesh(axes, device="cpu")
        init_state, step = tr.make_train_step(
            cfg, optimizer=lambda p: tr.adamw(p, lr=lr, weight_decay=wd), mesh=mesh)
        state = init_state(model=params_from_jax(tree, cfg, device="cpu"))
        shapes = {n: tuple((p.to_local() if isinstance(p, DTensor) else p).shape)
                  for n, p in state["model"].named_parameters()}
        batch = {"tokens": torch.from_numpy(np.asarray(tokens)).long()}
        trace = []
        for i in range(1, steps + 1):
            state, m = step(state, batch)
            params = params_to_numpy(state["model"]) if i in record_at else None
            trace.append((float(m["loss"]), float(m["grad_norm"]), params))
        out.append((shapes, trace))
    return out


def mesh_worker(axes_list, shapes):
    """For each axes of `axes_list`, make_mesh(axes) on the CPU: its dim
    names and sizes, every rank's (mesh coordinate, batch_slice of a global
    [8, 8] arange as a list), and fsdp_sharding_for_leaf's dim for each
    shape of `shapes`."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.parallel import batch_slice, fsdp_sharding_for_leaf, make_mesh

    out = []
    for axes in axes_list:
        mesh = make_mesh(axes, device="cpu")
        block = batch_slice(mesh, torch.arange(64).reshape(8, 8))
        slices = [None] * dist.get_world_size()
        dist.all_gather_object(slices, (mesh.get_coordinate(), block.tolist()))
        out.append({"names": mesh.mesh_dim_names, "shape": tuple(mesh.mesh.shape),
                    "slices": slices,
                    "fsdp_dims": [fsdp_sharding_for_leaf(mesh, torch.empty(s)) for s in shapes]})
    return out


# ------------------------------------------------------------------- RLlib

class Box:
    """The least of a gymnasium Box that the port's env runners read:
    `shape`, `dtype`, `low` and `high`."""

    def __init__(self, low, high, shape=None, dtype=np.float32):
        self.dtype = np.dtype(dtype)
        self.shape = tuple(shape) if shape is not None else np.shape(low)
        self.low = np.broadcast_to(np.asarray(low, self.dtype), self.shape).copy()
        self.high = np.broadcast_to(np.asarray(high, self.dtype), self.shape).copy()


class Discrete:
    """The least of a gymnasium Discrete: `n` actions 0..n-1."""

    def __init__(self, n: int):
        self.n = int(n)
        self.shape = ()
        self.dtype = np.dtype(np.int64)


class CartPole:
    """CartPole-v1 in numpy, for machines without gymnasium: the dynamics
    (Euler), bounds and reward of gymnasium's
    envs/classic_control/cartpole.py, the 500-step truncation of the
    TimeLimit that gym.make("CartPole-v1") adds, and its seeded reset
    (np.random.default_rng(seed).uniform(-0.05, 0.05, 4), the stream kept
    across unseeded resets). The same seeds and actions give gymnasium's
    observations bitwise."""

    max_episode_steps = 500

    def __init__(self, config=None):
        self.gravity = 9.8
        self.masscart = 1.0
        self.masspole = 0.1
        self.total_mass = self.masspole + self.masscart
        self.length = 0.5  # half the pole's length
        self.polemass_length = self.masspole * self.length
        self.force_mag = 10.0
        self.tau = 0.02  # seconds between state updates
        self.theta_threshold_radians = 12 * 2 * math.pi / 360
        self.x_threshold = 2.4
        high = np.array([self.x_threshold * 2, np.inf, self.theta_threshold_radians * 2, np.inf],
                        dtype=np.float32)
        self.observation_space = Box(-high, high, dtype=np.float32)
        self.action_space = Discrete(2)
        self._rng = None
        self.state = None
        self.steps_beyond_terminated = None
        self._elapsed_steps = 0

    def reset(self, *, seed=None, options=None):
        if seed is not None or self._rng is None:
            self._rng = np.random.default_rng(seed)
        self.state = self._rng.uniform(low=-0.05, high=0.05, size=(4,))
        self.steps_beyond_terminated = None
        self._elapsed_steps = 0
        return np.array(self.state, dtype=np.float32), {}

    def step(self, action):
        if int(action) not in (0, 1):
            raise ValueError(f"{action!r} is not an action of CartPole")
        x, x_dot, theta, theta_dot = self.state
        force = self.force_mag if action == 1 else -self.force_mag
        costheta = np.cos(theta)
        sintheta = np.sin(theta)
        temp = (force + self.polemass_length * np.square(theta_dot) * sintheta) / self.total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * np.square(costheta) / self.total_mass))
        xacc = temp - self.polemass_length * thetaacc * costheta / self.total_mass
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc
        self.state = np.array((x, x_dot, theta, theta_dot), dtype=np.float64)

        terminated = bool(x < -self.x_threshold or x > self.x_threshold
                          or theta < -self.theta_threshold_radians
                          or theta > self.theta_threshold_radians)
        if not terminated:
            reward = 1.0
        elif self.steps_beyond_terminated is None:
            self.steps_beyond_terminated = 0  # the pole just fell
            reward = 1.0
        else:
            self.steps_beyond_terminated += 1
            reward = 0.0
        self._elapsed_steps += 1
        truncated = self._elapsed_steps >= self.max_episode_steps
        return np.array(self.state, dtype=np.float32), reward, terminated, truncated, {}

    def close(self) -> None:
        pass


def cartpole_env(config):
    """Env factory for `AlgorithmConfig.environment(env=cartpole_env)`."""
    return CartPole(config)


# The RL learners' fixed-batch cases, shared by the CPU parity tests and the
# card's phase 11: each names its learner class (the same name in both
# packages' rllib.algorithms.<module>), its module kind, spec, loss config
# (None: the learner takes none) and a numpy batch drawn from the seed.
PPO_LOSS = {"clip_param": 0.2, "vf_clip_param": 10.0, "vf_loss_coeff": 0.5, "entropy_coeff": 0.01}
VTRACE_LOSS = {"gamma": 0.99, "clip_rho": 1.0, "clip_c": 1.0, "vf_loss_coeff": 0.5,
               "entropy_coeff": 0.01}


def rl_batch(kind: str, rng: np.random.RandomState, *, n: int, obs_dim: int,
             num_actions: int = 2, act_dim: int = 1, act_limit: float = 2.0, T: int = 8):
    """A numpy batch for the learners of `kind`: "ppo" (with a row mask when
    kind is "ppo_mask"), "vtrace" ([T, n] time-major, with episode ends),
    "q" (transitions with dones), "sac" (continuous actions inside the
    bound), "bc", "marwil" (Monte-Carlo returns)."""
    f32 = np.float32
    obs = rng.randn(n, obs_dim).astype(f32)
    actions = rng.randint(0, max(num_actions, 1), n).astype(np.int64)
    if kind in ("ppo", "ppo_mask"):
        batch = {"obs": obs, "actions": actions,
                 "logp_old": np.log(rng.uniform(0.2, 0.8, n)).astype(f32),
                 "advantages": rng.randn(n).astype(f32),
                 "value_targets": rng.randn(n).astype(f32),
                 "values_old": (0.5 * rng.randn(n)).astype(f32)}
        if kind == "ppo_mask":
            batch["mask"] = (rng.rand(n) > 0.25).astype(f32)
        return batch
    if kind == "vtrace":
        return {"obs": rng.randn(T, n, obs_dim).astype(f32),
                "actions": rng.randint(0, num_actions, (T, n)).astype(np.int64),
                "behavior_logp": np.log(rng.uniform(0.2, 0.8, (T, n))).astype(f32),
                "rewards": rng.randn(T, n).astype(f32),
                "terminateds": rng.rand(T, n) < 0.1,
                "truncateds": rng.rand(T, n) < 0.05,
                "bootstrap_value": rng.randn(n).astype(f32)}
    if kind == "q":
        return {"obs": obs, "actions": actions, "rewards": rng.randn(n).astype(f32),
                "next_obs": rng.randn(n, obs_dim).astype(f32),
                "dones": (rng.rand(n) < 0.1).astype(f32)}
    if kind == "sac":
        return {"obs": obs,
                "actions": rng.uniform(-act_limit, act_limit, (n, act_dim)).astype(f32),
                "rewards": rng.randn(n).astype(f32),
                "next_obs": rng.randn(n, obs_dim).astype(f32),
                "dones": (rng.rand(n) < 0.1).astype(f32)}
    if kind == "bc":
        return {"obs": obs, "actions": actions}
    if kind == "marwil":
        return {"obs": obs, "actions": actions, "returns": (3.0 * rng.randn(n)).astype(f32)}
    raise ValueError(f"unknown batch kind {kind!r}")


def rl_learner_cases(*, seed: int = 0, n: int = 64, T: int = 8, envs: int = 8,
                     hidden=(64, 64), sac_hidden=(256, 256)) -> dict:
    """{case: {"module", "cls", "kind", "spec", "cfg", "batch"}} for every
    learner of the JAX package's rllib: PPO (separate nets; shared torso
    with a row mask), IMPALA and APPO ([T, envs] fragments), DQN, CQL, SAC
    (Pendulum's spaces: obs 3, one action in [-2, 2]), BC and MARWIL.
    Batches of n rows, from RandomState(seed)."""
    rng = np.random.RandomState(seed)
    cart = {"obs_dim": 4, "num_actions": 2, "hidden": tuple(hidden)}
    cases = {
        "ppo": ("ppo", "PPOLearner", "pi_vf", cart, PPO_LOSS, "ppo"),
        "ppo_shared": ("ppo", "PPOLearner", "pi_vf", {**cart, "vf_share_layers": True},
                       PPO_LOSS, "ppo_mask"),
        "impala": ("impala", "IMPALALearner", "pi_vf", cart, VTRACE_LOSS, "vtrace"),
        "appo": ("impala", "APPOLearner", "pi_vf", cart, {**VTRACE_LOSS, "clip_param": 0.2},
                 "vtrace"),
        "dqn": ("dqn", "DQNLearner", "q", cart, {"gamma": 0.99, "double_q": True}, "q"),
        "cql": ("cql", "CQLLearner", "q", cart,
                {"gamma": 0.99, "double_q": True, "cql_alpha": 1.0}, "q"),
        "sac": ("sac", "SACLearner", "sac",
                {"obs_dim": 3, "num_actions": 0, "hidden": tuple(sac_hidden), "act_dim": 1,
                 "act_limit": 2.0},
                {"gamma": 0.99, "tau": 0.005, "target_entropy": -1.0, "initial_alpha": 1.0},
                "sac"),
        "bc": ("bc", "BCLearner", "pi_vf", cart, None, "bc"),
        "marwil": ("marwil", "MARWILLearner", "pi_vf", cart,
                   {"beta": 1.0, "vf_coeff": 1.0, "max_adv_exponent": 10.0}, "marwil"),
    }
    out = {}
    for name, (module, cls, kind, spec, cfg, batch_kind) in cases.items():
        batch = rl_batch(batch_kind, rng, n=envs if batch_kind == "vtrace" else n,
                         obs_dim=spec["obs_dim"],
                         num_actions=max(spec["num_actions"], 1), T=T)
        out[name] = {"module": module, "cls": cls, "kind": kind, "spec": spec, "cfg": cfg,
                     "batch": batch}
    return out
