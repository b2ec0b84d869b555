"""The port's attention at any finite scale, on the CPU: flash_attention's
forward and gradients, and flash_fwd (with lse), flash_bwd_dq and
flash_bwd_dkv on the same residuals, at scales below 0 and at 0, against
the JAX package's Pallas kernels in interpret mode, which take any scale.

The kernels take the row max of the raw scores before they scale them, so
the wrappers route a scale <= 0 before the CPU dispatch and any launch:
-q and |scale| below 0 (dq negated), a zero q and scale 1 at 0 (dq zero,
unlaunched). The CPU runs that route through the plain versions. Inputs
come from numpy with a seed; both sides run in f32 (JAX at matmul
precision "highest"); head dims 32 and 64 are both kernel widths."""

import importlib

import numpy as np
import pytest

from ray_tpu.testing import force_cpu_mesh

force_cpu_mesh(8)  # before first backend use, like every jax-facing test

import jax  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ray_tpu.ops.flash_attention import _flash_bwd_dkv, _flash_bwd_dq, _flash_fwd  # noqa: E402
from ray_tpu.ops.flash_attention import flash_attention as jax_flash_attention  # noqa: E402

# The module, not the package's `flash_attention` function of the same name.
fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

# tests/test_torch_head_dims.py's limits: the JAX package's own tolerances
# for its flash kernel against XLA in f32, the forward
# (tests/test_models.py:121) and the gradients
# (tests/test_kernels_and_tensors.py:56).
FWD_ATOL, GRAD_ATOL = 3e-5, 2e-4

SCALES = ["-0.5", "-1/sqrt(D)", "0"]


def _scale(kind, D):
    return {"-0.5": -0.5, "-1/sqrt(D)": -(D ** -0.5), "0": 0.0}[kind]


def _rand(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _attention_case(D, T, S, causal, scale, seed):
    """flash_attention's o and (dq, dk, dv) under the cotangent w, the port's
    and the JAX package's."""
    B, H = 2, 2
    rs = np.random.RandomState(seed)
    q, w = _rand(rs, B, T, H, D), _rand(rs, B, T, H, D)
    k, v = _rand(rs, B, S, H, D), _rand(rs, B, S, H, D)
    o_ref, vjp = jax.vjp(
        lambda q, k, v: jax_flash_attention(q, k, v, causal=causal, scale=scale, interpret=True),
        *(jnp.asarray(x) for x in (q, k, v)))
    grads_ref = vjp(jnp.asarray(w))
    leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
    before = dict(fa.launches)
    o = fa.flash_attention(*leaves, causal=causal, scale=scale)
    o.backward(_t(w))
    assert fa.launches == before  # CPU tensors run the plain versions, never a kernel
    return (o.detach().numpy(), [x.grad.numpy() for x in leaves],
            np.asarray(o_ref), [np.asarray(g) for g in grads_ref])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("kind", SCALES)
def test_attention_matches_pallas_at_scale(kind, D, causal):
    """flash_attention's forward and gradients on [B, T, H, D] at a scale
    below 0 or at 0 against the JAX flash_attention (Pallas, interpret
    mode): o within FWD_ATOL, dq, dk and dv within GRAD_ATOL."""
    scale = _scale(kind, D)
    o, grads, o_ref, grads_ref = _attention_case(D, 64, 64, causal, scale, seed=D + int(causal))
    np.testing.assert_allclose(o, o_ref, atol=FWD_ATOL)
    for g, ref in zip(grads, grads_ref):
        np.testing.assert_allclose(g, ref, atol=GRAD_ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_matches_pallas_at_a_negative_scale_with_more_keys_than_queries(causal):
    """T != S: 64 queries on 192 keys (the reference's 128-key blocks padded
    once) at scale -1/sqrt(D)."""
    o, grads, o_ref, grads_ref = _attention_case(64, 64, 192, causal, -(64 ** -0.5), seed=5)
    np.testing.assert_allclose(o, o_ref, atol=FWD_ATOL)
    for g, ref in zip(grads, grads_ref):
        np.testing.assert_allclose(g, ref, atol=GRAD_ATOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("kind", SCALES)
def test_kernel_wrappers_match_pallas_at_scale(kind, D, causal):
    """flash_fwd(with_lse=True), flash_bwd_dq and flash_bwd_dkv on [BH, T,
    D] against _flash_fwd, _flash_bwd_dq and _flash_bwd_dkv (interpret
    mode) on the same inputs and residuals: o and lse within FWD_ATOL, dq,
    dk and dv within GRAD_ATOL."""
    BH, T = 4, 128
    scale = _scale(kind, D)
    rs = np.random.RandomState(7 * D + int(causal))
    q, k, v, do = (_rand(rs, BH, T, D) for _ in range(4))
    kw = dict(causal=causal, scale=scale, block_q=128, block_k=128, interpret=True)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    o_ref, lse8 = _flash_fwd(jq, jk, jv, with_lse=True, **kw)
    o, lse = fa.flash_fwd(_t(q), _t(k), _t(v), causal=causal, scale=scale, with_lse=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=FWD_ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse8[..., 0]), atol=FWD_ATOL)

    delta = (do * np.asarray(o_ref)).sum(-1).astype(np.float32)
    delta8 = jnp.broadcast_to(jnp.asarray(delta)[..., None], (BH, T, 8))
    dq_ref = _flash_bwd_dq(jq, jk, jv, jdo, lse8, delta8, **kw)
    dk_ref, dv_ref = _flash_bwd_dkv(jq, jk, jv, jdo, lse8, delta8, **kw)
    args = (_t(q), _t(k), _t(v), _t(do), _t(np.asarray(lse8[..., 0])), _t(delta))
    dq = fa.flash_bwd_dq(*args, causal=causal, scale=scale)
    dk, dv = fa.flash_bwd_dkv(*args, causal=causal, scale=scale)
    assert dq.dtype == dk.dtype == dv.dtype == torch.float32
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    np.testing.assert_allclose(dq.numpy(), np.asarray(dq_ref), atol=GRAD_ATOL)
    np.testing.assert_allclose(dk.numpy(), np.asarray(dk_ref), atol=GRAD_ATOL)
    np.testing.assert_allclose(dv.numpy(), np.asarray(dv_ref), atol=GRAD_ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_scale_zero_gives_exactly_zero_dq_and_dk(causal):
    """At scale 0 every score is 0: dq and dk are exactly zero, through
    flash_attention's autograd and through the wrappers."""
    o, (dq, dk, dv), _, _ = _attention_case(32, 64, 64, causal, 0.0, seed=9)
    assert not dq.any() and not dk.any()
    assert dv.any() and np.isfinite(o).all()
    rs = np.random.RandomState(10)
    q, k, v, do = (_t(_rand(rs, 2, 64, 64)) for _ in range(4))
    o, lse = fa.flash_fwd(q, k, v, causal=causal, scale=0.0, with_lse=True)
    delta = (do * o).sum(-1)
    assert not fa.flash_bwd_dq(q, k, v, do, lse, delta, causal=causal, scale=0.0).any()
    assert not fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal, scale=0.0)[0].any()
