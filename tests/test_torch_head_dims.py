"""The port's attention at every head dim the TPU kernels take, on the CPU:
its plain versions (what each kernel computes) against the JAX package's
Pallas kernels in interpret mode at head dims off and on the kernels' widths
(32, 80, 96, 256, 320, 512), the padded route (a head dim zero-padded to the
next width the CUDA kernels are built for: 16 to 32, 80 to 96, 200 to 256)
against the same attention unpadded, the port's Transformer at head dims
96, 256, 32 and 512 against the JAX model on the same weights, and the
shape rules the kernels' calls are held to (any number of heads, as the
TPU kernels' grid takes). Inputs come from numpy with a seed; both sides
run in f32 (JAX at matmul precision "highest")."""

import importlib

import numpy as np
import pytest

from ray_tpu.testing import force_cpu_mesh

force_cpu_mesh(8)  # before first backend use, like every jax-facing test

import jax  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ray_tpu.models import transformer as jax_tr  # noqa: E402
from ray_tpu.ops.flash_attention import _flash_fwd  # noqa: E402
from ray_tpu.ops.flash_attention import flash_attention as jax_flash_attention  # noqa: E402
from ray_tpu_torch.convert import params_from_jax, params_to_numpy  # noqa: E402
from ray_tpu_torch.models import transformer as tr  # noqa: E402

# The module, not the package's `flash_attention` function of the same name.
fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

# The JAX package's own tolerances for its flash kernel against XLA, f32:
# the forward (tests/test_models.py:121) and the gradients
# (tests/test_kernels_and_tensors.py:56).
FWD_ATOL, GRAD_ATOL = 3e-5, 2e-4
# The padded route against the unpadded one: the same f32 sums, in which
# the padded columns add exact zeros; only a matmul's blocking over the
# longer row may reorder them.
PAD_ATOL = 1e-6
# Past 256 (padded to 512) the CPU's matmuls block the 512-column rows
# otherwise than the unpadded ones, so the f32 sums are taken in another
# order: up to 3.3e-6 apart here at outputs of order 1-10 (a few f32 ulps).
# A wrong pad, cut or scale is of order 1.
PAD_WIDE_ATOL = 1e-5


def _rand(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [64, 192])  # 192 exercises the reference's 128-row block padding
@pytest.mark.parametrize("D", [32, 80, 96, 256, 320, 512])
def test_attention_matches_pallas_at_head_dim(D, T, causal):
    """flash_attention's forward and gradients on [B, T, H, D] against the
    JAX flash_attention (Pallas, interpret mode): o within FWD_ATOL, dq, dk
    and dv within GRAD_ATOL."""
    B, H = 2, 2
    rs = np.random.RandomState(D + T)
    q, k, v, w = (_rand(rs, B, T, H, D) for _ in range(4))  # w: the cotangent's weights

    def jax_obj(q, k, v):
        o = jax_flash_attention(q, k, v, causal=causal, interpret=True)
        return (o * w).sum(), o

    (_, o_ref), grads_ref = jax.value_and_grad(jax_obj, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
    before = dict(fa.launches)
    o = fa.flash_attention(*leaves, causal=causal)
    (o * _t(w)).sum().backward()
    assert fa.launches == before  # CPU tensors run the plain versions, never a kernel
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_ref), atol=FWD_ATOL)
    for leaf, ref in zip(leaves, grads_ref):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref), atol=GRAD_ATOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [576, 1024])
def test_forward_past_512_matches_pallas(D, causal):
    """flash_attention without gradients (the forward's rule: padded to the
    next multiple of 512, the streamed forward's route) and flash_fwd's lse
    at head dims past 512 against the JAX package's Pallas forward
    (interpret mode), within FWD_ATOL; with gradients (the same width rule)
    the forward agrees."""
    B, T, H = 1, 64, 2
    rs = np.random.RandomState(D)
    q, k, v = (_rand(rs, B, T, H, D) for _ in range(3))
    o_ref = jax_flash_attention(*(jnp.asarray(x) for x in (q, k, v)), causal=causal, interpret=True)
    with torch.no_grad():
        o = fa.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=FWD_ATOL)
    qf, kf, vf = (_t(x).transpose(1, 2).reshape(B * H, T, D).contiguous() for x in (q, k, v))
    _, lse = fa.flash_fwd(qf, kf, vf, causal=causal, scale=D ** -0.5, with_lse=True)
    _, plse = _flash_fwd(*(jnp.asarray(x.numpy()) for x in (qf, kf, vf)), causal=causal, scale=D ** -0.5,
                         block_q=128, block_k=128, interpret=True, with_lse=True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(plse[..., 0]), atol=FWD_ATOL)
    leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
    np.testing.assert_allclose(fa.flash_attention(*leaves, causal=causal).detach().numpy(), o.numpy(),
                               atol=PAD_WIDE_ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_gqa_at_head_dim_256_matches_pallas(causal):
    """Gemma-2B's attention shape, cut down: 4 query heads on one kv head at
    head dim 256, forward and gradients against the JAX flash_attention."""
    B, T, H, Hk, D = 1, 192, 4, 1, 256
    rs = np.random.RandomState(11)
    q, w = _rand(rs, B, T, H, D), _rand(rs, B, T, H, D)
    k, v = _rand(rs, B, T, Hk, D), _rand(rs, B, T, Hk, D)

    def jax_obj(q, k, v):
        o = jax_flash_attention(q, k, v, causal=causal, interpret=True)
        return (o * w).sum(), o

    (_, o_ref), grads_ref = jax.value_and_grad(jax_obj, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
    o = fa.mha(*leaves, causal=causal, impl="kernel")
    (o * _t(w)).sum().backward()
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_ref), atol=FWD_ATOL)
    for leaf, ref in zip(leaves, grads_ref):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref), atol=GRAD_ATOL)


@pytest.mark.parametrize("D,width", [(8, 32), (16, 32), (32, 32), (33, 64), (65, 96), (80, 96), (100, 128),
                                     (192, 256), (256, 256), (300, 512), (320, 512), (384, 512), (512, 512),
                                     (513, 1024), (576, 1024), (640, 1024), (768, 1024), (1024, 1024),
                                     (2048, 2048)])
def test_kernel_width(D, width):
    """A head dim runs at the next of the kernels' widths, past them at the
    next multiple of 512 (the streamed kernels): one rule for the forward
    and the backward, which the autograd function takes on either
    device."""
    assert fa.kernel_width(D) == width
    for device in ("cpu", "cuda"):
        assert fa.autograd_width(D, torch.float32, device) == width


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [16, 80, 200])
def test_padded_wrappers_match_unpadded_plain_versions(D, causal):
    """Each wrapper at a head dim off the kernels' widths pads q, k, v (and
    do) to the next width and cuts its outputs back: o, lse, dq, dk and dv
    within PAD_ATOL of the plain versions run unpadded, on T != S."""
    _padded_wrappers_vs_unpadded(D, causal, PAD_ATOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [320, 384])
def test_padded_wrappers_past_256_match_unpadded_plain_versions(D, causal):
    """As above, at head dims padded to 512: within PAD_WIDE_ATOL."""
    _padded_wrappers_vs_unpadded(D, causal, PAD_WIDE_ATOL)


def _padded_wrappers_vs_unpadded(D, causal, atol):
    T, S, scale = 70, 130, D ** -0.5
    rs = np.random.RandomState(D)
    q, do = _t(_rand(rs, 3, T, D)), _t(_rand(rs, 3, T, D))
    k, v = _t(_rand(rs, 3, S, D)), _t(_rand(rs, 3, S, D))
    o, lse = fa.flash_fwd(q, k, v, causal=causal, scale=scale, with_lse=True)
    ref_o, ref_lse = fa._flash_fwd_ref(q, k, v, causal, scale, True)
    assert o.shape == (3, T, D) and o.is_contiguous()
    delta = (do * ref_o).sum(-1)
    args = (q, k, v, do, ref_lse, delta)
    got = [o, fa.flash_fwd(q, k, v, causal=causal, scale=scale), lse,
           fa.flash_bwd_dq(*args, causal=causal, scale=scale),
           *fa.flash_bwd_dkv(*args, causal=causal, scale=scale)]
    want = [ref_o, ref_o, ref_lse, fa._flash_bwd_dq_ref(*args, causal, scale),
            *fa._flash_bwd_dkv_ref(*args, causal, scale)]
    for g, r in zip(got, want):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=atol, rtol=0)


@pytest.mark.parametrize("D", [16, 80])
def test_padded_attention_matches_unpadded(D, monkeypatch):
    """flash_attention and the autograd function at a head dim off the
    kernels' widths (padded once, in the copy to [BH, T, D]) against the
    same calls with D made one of the widths (nothing padded): o and the
    three gradients within PAD_ATOL, GQA with 4 query heads on 2 kv heads."""
    _padded_attention_vs_unpadded(D, monkeypatch, PAD_ATOL)


def test_padded_attention_past_256_matches_unpadded(monkeypatch):
    """As above at head dim 320, padded to 512: within PAD_WIDE_ATOL."""
    _padded_attention_vs_unpadded(320, monkeypatch, PAD_WIDE_ATOL)


def _padded_attention_vs_unpadded(D, monkeypatch, atol):
    B, T, H, Hk = 2, 96, 4, 2
    rs = np.random.RandomState(D + 1)
    q, w = _rand(rs, B, T, H, D), _rand(rs, B, T, H, D)
    k, v = _rand(rs, B, T, Hk, D), _rand(rs, B, T, Hk, D)

    def run():
        leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
        o = fa.flash_attention(*leaves, causal=True)
        (o * _t(w)).sum().backward()
        qf = _t(q).transpose(1, 2).reshape(B * H, T, D).requires_grad_(True)
        kf, vf = (_t(x).repeat_interleave(H // Hk, 2).transpose(1, 2).reshape(B * H, T, D)
                  .requires_grad_(True) for x in (k, v))
        of = fa._FlashAttention.apply(qf, kf, vf, True, D ** -0.5)
        (of * _t(w).transpose(1, 2).reshape(B * H, T, D)).sum().backward()
        return [o.detach(), *(x.grad for x in leaves), of.detach(), qf.grad, kf.grad, vf.grad]

    padded = run()
    monkeypatch.setattr(fa, "WIDTHS", tuple(sorted((D, *fa.WIDTHS))))
    unpadded = run()
    for a, b in zip(padded, unpadded):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=atol, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_kernel_route_pads_once_and_matches_plain_route(causal):
    """Ring attention's kernel route at head dim 80 (padded to 96 once, at
    its entry), four shards in loopback, against its plain route: output
    and gradients within the JAX package's tolerances."""
    from ray_tpu_torch.parallel import ring_attention_loopback

    B, T, H, D = 2, 128, 2, 80
    rs = np.random.RandomState(5)
    q, k, v, w = (_rand(rs, B, T, H, D) for _ in range(4))
    out = {}
    for impl in ("kernel", "plain"):
        leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
        o = ring_attention_loopback(*leaves, 4, causal=causal, impl=impl)
        (o * _t(w)).sum().backward()
        out[impl] = [o.detach(), *(x.grad for x in leaves)]
    np.testing.assert_allclose(out["kernel"][0].numpy(), out["plain"][0].numpy(), atol=FWD_ATOL)
    for a, b in zip(out["kernel"][1:], out["plain"][1:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=GRAD_ATOL)


# The port's Transformer against the JAX model at head dims 96 (Phi-3-mini's),
# 256 (Gemma-2B's, one kv head), 32 (the JAX package's example's, GQA) and
# 512 (the widest the kernels are built for, 2 heads): 2 layers at small
# widths, f32, as tests/test_torch_transformer.py holds it.
HEAD_DIM_CONFIGS = {
    96: dict(d_model=192, n_heads=2, n_kv_heads=2),
    256: dict(d_model=256, n_heads=1, n_kv_heads=1),
    32: dict(d_model=128, n_heads=4, n_kv_heads=2),
    512: dict(d_model=1024, n_heads=2, n_kv_heads=2),
}
ATOL, RTOL = 2e-5, 1e-4


def test_transformer_forward_at_head_dim_1024_matches_jax():
    """The port's Transformer without gradients (its scoring and serving
    paths: flash_attention's forward rule) at head dim 1024, one layer of 2
    heads at d_model 2048 with a narrow d_ff and vocabulary, against the JAX
    model on the same weights (params_from_jax): logits within ATOL, RTOL."""
    widths = dict(vocab_size=64, n_layers=1, max_seq_len=32, d_model=2048, n_heads=2, n_kv_heads=2, d_ff=128)
    jcfg = jax_tr.TransformerConfig(**widths, dtype=jnp.float32, attention_impl="xla")
    tcfg = tr.TransformerConfig(**widths, dtype=torch.float32, attention_impl="kernel")
    assert tcfg.head_dim == jcfg.head_dim == 1024
    params = jax.tree.map(np.array, jax_tr.transformer_init(jax.random.PRNGKey(3), jcfg))
    toks = np.random.RandomState(2).randint(0, widths["vocab_size"], (2, 24)).astype(np.int32)
    ref_logits = jax_tr.transformer_apply(params, jnp.asarray(toks), jcfg)
    model = params_from_jax(params, tcfg, device="cpu")
    with torch.no_grad():
        logits = model(torch.from_numpy(toks).long())
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("head_dim", sorted(HEAD_DIM_CONFIGS))
def test_transformer_at_head_dim_matches_jax(head_dim):
    widths = dict(vocab_size=128, n_layers=2, max_seq_len=64, **HEAD_DIM_CONFIGS[head_dim])
    jcfg = jax_tr.TransformerConfig(**widths, dtype=jnp.float32, attention_impl="xla")
    tcfg = tr.TransformerConfig(**widths, dtype=torch.float32, attention_impl="kernel", remat=True)
    assert tcfg.head_dim == jcfg.head_dim == head_dim
    params = jax.tree.map(np.array, jax_tr.transformer_init(jax.random.PRNGKey(0), jcfg))
    toks = np.random.RandomState(1).randint(0, widths["vocab_size"], (2, 41)).astype(np.int32)

    ref_logits = jax_tr.transformer_apply(params, jnp.asarray(toks[:, :-1]), jcfg)
    ref_loss, ref_grads = jax.value_and_grad(jax_tr.transformer_loss)(
        params, {"tokens": jnp.asarray(toks)}, jcfg)
    model = params_from_jax(params, tcfg, device="cpu")
    t = torch.from_numpy(toks).long()
    with torch.no_grad():
        logits = model(t[:, :-1])
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=ATOL, rtol=RTOL)
    loss = tr.transformer_loss(model, {"tokens": t})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-6)
    got = dict(jax.tree_util.tree_leaves_with_path(params_to_numpy(model, grads=True)))
    for path, want in jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, ref_grads)):
        np.testing.assert_allclose(got[path], want, atol=ATOL, rtol=RTOL, err_msg=str(path))


@pytest.mark.parametrize("BH", [1, 65535, 65536, 66560, 2**20])
def test_shape_rules_take_any_number_of_heads(BH):
    """The kernels' shape rules (check_shapes, which the wrappers apply to
    CUDA tensors) take any number of heads in one call, as the Pallas
    grid (BH, num_q, num_k) does, at every width up to 512."""
    for D in (64, 96, 320, 512):
        fa.check_shapes((BH, 64, D), (BH, 100, D), (BH, 100, D))


@pytest.mark.parametrize("D", [576, 768, 1024, 2048])
def test_forward_shape_rules_take_any_head_dim(D):
    """The shape rules (check_shapes, which every wrapper, forward and
    backward, applies to CUDA tensors) take head dims past 512, as the TPU
    kernels do, and the kernels run them at the next multiple of 512."""
    fa.check_shapes((4, 64, D), (4, 100, D), (4, 100, D))
    assert fa.kernel_width(D) % 512 == 0 and 0 <= fa.kernel_width(D) - D < 512


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [513, 576, 1024])
def test_autograd_refuses_past_512_before_any_launch(D, dtype):
    """The autograd function's width (autograd_width, the first thing its
    forward computes) no longer refuses past 512: on the card and on the
    CPU it is the next multiple of 512, where the streamed backward runs;
    at 512 and below both devices run the kernels' width. What it still
    refuses before any launch is a dtype the kernels do not take."""
    assert fa.autograd_width(D, dtype, "cuda") == fa.autograd_width(D, dtype, "cpu") == 1024
    assert fa.autograd_width(D - 512, dtype, "cuda") == fa.kernel_width(D - 512)
    assert fa.autograd_width(512, dtype, "cuda") == 512
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.autograd_width(64, torch.float16, "cuda")


@pytest.mark.parametrize("q,k,v,match", [
    ((4, 64, 0), (4, 64, 0), (4, 64, 0), "head_dim > 0"),
    ((0, 64, 64), (0, 64, 64), (0, 64, 64), "BH, T, S > 0"),
    ((4, 0, 64), (4, 64, 64), (4, 64, 64), "BH, T, S > 0"),
    ((4, 64, 64), (4, 0, 64), (4, 0, 64), "BH, T, S > 0"),
    ((4, 64, 64), (5, 64, 64), (5, 64, 64), "disagree"),
    ((4, 64, 64), (4, 64, 64), (4, 32, 64), "k/v"),
    ((4, 64), (4, 64, 64), (4, 64, 64), "k/v"),
])
def test_shape_rules_refuse_what_the_kernels_do_not_take(q, k, v, match):
    with pytest.raises(ValueError, match=match):
        fa.check_shapes(q, k, v)


def test_many_heads_on_the_cpu_match_per_head_calls():
    """66,560 heads in one call of each wrapper (the CPU's plain versions)
    against the same wrapper on sampled heads alone, the last among them:
    heads are independent, so the two agree exactly."""
    BH, T, D = 66560, 4, 8
    rs = np.random.RandomState(7)
    q, k, v, do = (_t(_rand(rs, BH, T, D)) for _ in range(4))
    o, lse = fa.flash_fwd(q, k, v, causal=True, scale=D ** -0.5, with_lse=True)
    delta = (do * o).sum(-1)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal=True, scale=D ** -0.5)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal=True, scale=D ** -0.5)
    for h in (0, 1, 33279, BH - 1):
        one = [x[h:h + 1] for x in (q, k, v, do, lse, delta)]
        o1, lse1 = fa.flash_fwd(*one[:3], causal=True, scale=D ** -0.5, with_lse=True)
        dq1 = fa.flash_bwd_dq(*one, causal=True, scale=D ** -0.5)
        dk1, dv1 = fa.flash_bwd_dkv(*one, causal=True, scale=D ** -0.5)
        for whole, alone in ((o, o1), (lse, lse1), (dq, dq1), (dk, dk1), (dv, dv1)):
            np.testing.assert_allclose(whole[h:h + 1].numpy(), alone.numpy(), atol=PAD_ATOL, rtol=0)
