"""Parity of the port's sharded train step (make_train_step(..., mesh=...),
gloo processes on the CPU) with ray_tpu's make_train_step on the JAX CPU
mesh of the same axes, in f32 from the same initial weights and global
batch: loss and grad_norm at every step, every parameter after 1 and 3
AdamW steps; the same against the port's own unsharded step; each
parameter's local shard shape against the reference's; and the port's
dry run (`python -m ray_tpu_torch.dryrun 4`), both phases."""

import functools

import numpy as np
import pytest

from ray_tpu.testing import force_cpu_mesh

force_cpu_mesh(8)  # before first backend use, like every jax-facing test

import jax  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

from ray_tpu.models import transformer as jax_tr  # noqa: E402
from ray_tpu.parallel import make_mesh  # noqa: E402
from ray_tpu_torch import dryrun  # noqa: E402
from ray_tpu_torch.convert import params_from_jax, params_to_numpy  # noqa: E402
from ray_tpu_torch.models import transformer as tr  # noqa: E402
from ray_tpu_torch.testing import run_in_processes, sharded_steps_worker  # noqa: E402

TINY = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, max_seq_len=64)
LR, WD, STEPS = 1e-3, 0.01, 3
# As tests/test_torch_train_step.py holds the unsharded step: loss and
# grad_norm are f32 sums in other orders (a few ulps); Adam's first step
# moves a weight whose gradient is within roundoff of zero by up to lr
# either way, so 99.9% of entries within 1e-5 and every entry within
# 2 * lr per step taken.
LOSS_RTOL, GNORM_RTOL = 1e-5, 1e-4
PARAM_ATOL, PARAM_FRAC = 1e-5, 1e-3

MESHES = {  # name: (axes, remat)
    "dp2-fsdp2-tp2": ({"data": 2, "fsdp": 2, "tensor": 2}, False),
    "factor4": (dryrun._factor_axes(4), False),
    "factor8-remat": (dryrun._factor_axes(8), True),
    "fsdp4-tp2": ({"fsdp": 4, "tensor": 2}, False),
    "data2": ({"data": 2}, False),  # no fsdp axis: FSDP2 over (data, fsdp of 1)
    "data2-tp2": ({"data": 2, "tensor": 2}, False),
}
WITH_JAX = ["dp2-fsdp2-tp2", "factor4", "factor8-remat"]


def _tokens():
    return np.random.RandomState(1).randint(0, TINY["vocab_size"], (8, 17)).astype(np.int32)


def _jcfg(remat):
    return jax_tr.TransformerConfig(**TINY, dtype=jnp.float32, attention_impl="xla", remat=remat)


def _tcfg(remat):
    return dict(TINY, dtype=torch.float32, attention_impl="kernel", remat=remat)


@functools.lru_cache(maxsize=None)
def _init_tree():
    return jax.tree.map(np.array, jax_tr.transformer_init(jax.random.PRNGKey(0), _jcfg(False)))


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    """The reference's sharded step on the JAX CPU mesh of `name`'s axes:
    [(loss, grad_norm, params at steps 1 and 3 else None)]."""
    axes, remat = MESHES[name]
    n = int(np.prod(list(axes.values())))
    mesh = make_mesh(axes, devices=jax.devices()[:n])
    init_state, step, shardings = jax_tr.make_train_step(
        _jcfg(remat), mesh, optax.adamw(LR, weight_decay=WD))
    state = init_state(jax.random.PRNGKey(0))
    trace = []
    for i in range(1, STEPS + 1):
        state, m = step(state, {"tokens": jnp.asarray(_tokens())})
        params = jax.tree.map(np.array, state["params"]) if i in (1, 3) else None
        trace.append((float(m["loss"]), float(m["grad_norm"]), params))
    return trace


@functools.lru_cache(maxsize=None)
def _port_runs(n):
    """The port's sharded step on n gloo processes, for every mesh of n
    devices in one run: {name: (shard shapes, trace)}."""
    names = [name for name, (axes, _) in MESHES.items() if np.prod(list(axes.values())) == n]
    runs = [(MESHES[name][0], _tcfg(MESHES[name][1])) for name in names]
    got = run_in_processes(sharded_steps_worker, n, runs, _init_tree(), _tokens(), STEPS, LR, WD,
                           timeout=240)
    return dict(zip(names, got))


def _port_run(name):
    axes, _ = MESHES[name]
    return _port_runs(int(np.prod(list(axes.values()))))[name]


@functools.lru_cache(maxsize=None)
def _port_unsharded(remat):
    cfg = tr.TransformerConfig(**_tcfg(remat))
    init_state, step = tr.make_train_step(
        cfg, device="cpu", optimizer=lambda p: tr.adamw(p, lr=LR, weight_decay=WD))
    state = init_state(model=params_from_jax(_init_tree(), cfg, device="cpu"))
    trace = []
    for i in range(1, STEPS + 1):
        state, m = step(state, {"tokens": torch.from_numpy(_tokens()).long()})
        params = params_to_numpy(state["model"]) if i in (1, 3) else None
        trace.append((float(m["loss"]), float(m["grad_norm"]), params))
    return trace


def _assert_traces_close(got, want):
    for i, ((loss, gnorm, params), (ref_loss, ref_gnorm, ref_params)) in enumerate(
            zip(got, want), start=1):
        np.testing.assert_allclose(loss, ref_loss, rtol=LOSS_RTOL, err_msg=f"loss, step {i}")
        np.testing.assert_allclose(gnorm, ref_gnorm, rtol=GNORM_RTOL, err_msg=f"grad_norm, step {i}")
        if params is None:
            continue
        flat_want = dict(jax.tree_util.tree_leaves_with_path(ref_params))
        for path, leaf in jax.tree_util.tree_leaves_with_path(params):
            diff = np.abs(leaf - flat_want[path])
            assert diff.max() <= 2 * LR * i, (i, path, diff.max())
            assert (diff > PARAM_ATOL).mean() <= PARAM_FRAC, (i, path, (diff > PARAM_ATOL).mean())
    assert len(got) == len(want) == STEPS


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name", WITH_JAX)
def test_sharded_step_matches_reference(name):
    _assert_traces_close(_port_run(name)[1], _jax_run(name))


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name", list(MESHES))
def test_sharded_step_matches_port_unsharded(name):
    _assert_traces_close(_port_run(name)[1], _port_unsharded(MESHES[name][1]))


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name", ["fsdp4-tp2", "dp2-fsdp2-tp2"])
def test_local_shard_shapes_match_reference(name):
    """Every parameter's shard on a rank has the shape of the reference's
    NamedSharding(mesh, param_shardings(...)).shard_shape, less the
    reference's stacked layer axis."""
    axes, _ = MESHES[name]
    n = int(np.prod(list(axes.values())))
    mesh = make_mesh(axes, devices=jax.devices()[:n])
    shardings = jax_tr.param_shardings(mesh, _jcfg(False))
    tree = _init_tree()
    shapes = _port_run(name)[0]
    assert set(shapes) == {n for n in tr._param_names(tr.TransformerConfig(**_tcfg(False)))}
    for pname, shape in shapes.items():
        parts = pname.split(".")
        if parts[0] == "blocks":
            s = shardings["blocks"][parts[2]]
            want = s.shard_shape(tree["blocks"][parts[2]].shape)[1:]
        else:
            s = shardings[pname]
            want = s.shard_shape(tree[pname].shape)
        assert isinstance(s, NamedSharding)
        assert shape == tuple(want), (pname, shape, want)


@pytest.mark.timeout(120)
def test_tensor_size_must_keep_kv_groups_whole():
    """Four query heads on one kv head cannot split over tensor 2."""
    cfg = dict(_tcfg(False), n_kv_heads=1)
    tree = params_to_numpy(tr.transformer_init(tr.TransformerConfig(**cfg), device="cpu"))
    with pytest.raises(RuntimeError, match="whole kv heads"):
        run_in_processes(sharded_steps_worker, 2, [({"tensor": 2}, cfg)], tree, _tokens(), 1, LR,
                         WD, timeout=120)


@pytest.mark.timeout(240)
def test_dryrun_multichip_both_phases(capsys):
    """`python -m ray_tpu_torch.dryrun 4`: the sharded step on 4 gloo
    processes, then through a TorchTrainer gang of 4, with equal losses."""
    dryrun.dryrun_multichip(4)
    out = capsys.readouterr().out
    assert "dryrun_multichip ok" in out and "dryrun trainer runtime ok: 4 processes" in out
