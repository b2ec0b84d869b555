"""Parity of the port's train step with ray_tpu's make_train_step on a
1-device mesh (as bench.py builds it), on the CPU in f32: loss and grad_norm
at every step, and all parameters after 1 and after 5 AdamW steps, from the
same initial weights and batch."""

import numpy as np
import pytest

from ray_tpu.testing import force_cpu_mesh

force_cpu_mesh(8)  # before first backend use, like every jax-facing test

import jax  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from ray_tpu.models import transformer as jax_tr  # noqa: E402
from ray_tpu.parallel import make_mesh  # noqa: E402
from ray_tpu_torch.convert import params_from_jax, params_to_numpy  # noqa: E402
from ray_tpu_torch.models import transformer as tr  # noqa: E402

TINY = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, max_seq_len=64)
LR, WD = 1e-3, 0.01
# Loss and grad_norm: f32 sums in different orders (a few ulps).
LOSS_RTOL, GNORM_RTOL = 1e-5, 1e-4
# Parameters: Adam's first step moves each weight by about lr * g/|g|, so a
# gradient entry within f32 roundoff of zero may step to either side: up to
# 2*lr apart. Everywhere else the updates agree to ~1e-7 per step. Hold
# 99.9% of entries to 1e-5 and every entry to 2*lr per step taken.
PARAM_ATOL, PARAM_FRAC = 1e-5, 1e-3


def _run_jax(jcfg, toks, steps):
    mesh = make_mesh({"data": 1}, devices=[jax.devices()[0]])
    init_state, step, _ = jax_tr.make_train_step(
        jcfg, mesh, optax.adamw(LR, weight_decay=WD))
    state = init_state(jax.random.PRNGKey(0))
    init = jax.tree.map(np.array, state["params"])
    trace = []
    for _ in range(steps):
        state, m = step(state, {"tokens": jnp.asarray(toks)})
        trace.append((float(m["loss"]), float(m["grad_norm"]),
                      jax.tree.map(np.array, state["params"])))
    return init, trace


def _assert_params_close(got, want, steps):
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    for path, leaf in flat_got:
        diff = np.abs(leaf - flat_want[path])
        assert diff.max() <= 2 * LR * steps, (path, diff.max())
        assert (diff > PARAM_ATOL).mean() <= PARAM_FRAC, (path, (diff > PARAM_ATOL).mean())


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_matches_jax(remat):
    jcfg = jax_tr.TransformerConfig(**TINY, dtype=jnp.float32, attention_impl="xla", remat=remat)
    tcfg = tr.TransformerConfig(**TINY, dtype=torch.float32, attention_impl="kernel", remat=remat)
    toks = np.random.RandomState(1).randint(0, TINY["vocab_size"], (4, 17)).astype(np.int32)
    init, trace = _run_jax(jcfg, toks, steps=5)

    init_state, step = tr.make_train_step(
        tcfg, device="cpu", optimizer=lambda p: tr.adamw(p, lr=LR, weight_decay=WD))
    state = init_state(model=params_from_jax(init, tcfg, device="cpu"))
    batch = {"tokens": torch.from_numpy(toks).long()}
    for i, (ref_loss, ref_gnorm, ref_params) in enumerate(trace, start=1):
        state, m = step(state, batch)
        np.testing.assert_allclose(float(m["loss"]), ref_loss, rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]), ref_gnorm, rtol=GNORM_RTOL)
        if i in (1, 5):
            _assert_params_close(params_to_numpy(state["model"]), ref_params, i)
    assert state["step"] == 5


def test_train_step_loss_decreases():
    """Port of tests/test_models.py::test_sharded_train_step_loss_decreases on
    one device: five Adam(1e-2) steps on one batch lower the loss."""
    tcfg = tr.TransformerConfig(**TINY, dtype=torch.float32)
    init_state, step = tr.make_train_step(
        tcfg, device="cpu", optimizer=lambda p: torch.optim.Adam(p, lr=1e-2))
    state = init_state(torch.Generator().manual_seed(0))
    toks = torch.randint(0, tcfg.vocab_size, (8, 17), generator=torch.Generator().manual_seed(1))
    losses = []
    for _ in range(5):
        state, m = step(state, {"tokens": toks})
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert state["step"] == 5
