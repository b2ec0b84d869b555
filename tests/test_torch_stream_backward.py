"""The streamed backward (bwd_dq_kernel_sm90_stream and
bwd_dkv_kernel_sm90_stream, csrc/flash_attention.cu) on the CPU, and the
port's training path past head dim 512 against the JAX package.

An emulation of both kernels' arithmetic at P = 2 (f32 as bf16 hi and lo
parts), tile by tile in their order and sizes, with S and dP (S^T and dP^T
in bwd_dkv) summed chunk by chunk over 64 columns of D, is held against the
f32 plain versions and against the JAX package's Pallas backward in
interpret mode, within chip_smoke.py's F32_ATOL; each of its five products
with one of its three bf16 products left out misses that limit. Then the
one width rule (kernel_width, autograd_width), flash_attention with
gradients past 512 against jax.grad through the Pallas flash_attention, the
port's Transformer at head dim 1024 against the JAX model's loss and
gradients, and ring attention's kernel route at 1024. Inputs come from numpy
with a seed; both sides run in f32 (JAX at matmul precision "highest")."""

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
from ray_tpu.ops.flash_attention import _flash_bwd_dkv, _flash_bwd_dq  # noqa: E402
from ray_tpu.ops.flash_attention import flash_attention as jax_flash_attention  # noqa: E402
from ray_tpu_torch.convert import params_from_jax, params_to_numpy  # noqa: E402
from ray_tpu_torch.models import transformer as tr  # noqa: E402

fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
cs = importlib.import_module("chip_smoke")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The emulations' matmuls are small: one intra-op thread a process, so
    the suite's parallel workers do not oversubscribe the cores (with a
    thread per core in every worker, these files ran 10-20x slower under
    the suite's load than alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# The streamed kernels' tiles at P = 2 (DqStreamCfg<2>, DkvStreamCfg<2>):
# bwd_dq streams K/V tiles of BN keys, bwd_dkv Q/dO tiles of BQ q rows; both
# sum S and dP over chunks of CHUNK columns of D (128 bytes a row in two
# bf16 parts).
BN, BQ, CHUNK = 16, 16, 64
_LOG2E = 1.4426950408889634
# (part of the first operand, part of the second): 0 = hi, 1 = lo.
PRODUCTS = ((0, 0), (0, 1), (1, 0))
# The five products: S = Q.K^T and dP = dO.V^T (bwd_dkv: S^T = K.Q^T and
# dP^T = V.dO^T, the same set with the roles swapped), dQ = dS.K, dK =
# dS^T.Q and dV = P^T.dO.
NAMES = ("s", "dp", "dq", "dk", "dv")
# The JAX package's own tolerances for its flash kernel against XLA, f32:
# the forward (tests/test_models.py:121) and the gradients
# (tests/test_kernels_and_tensors.py:56); the Transformer's as
# tests/test_torch_head_dims.py holds it at 96-512.
FWD_ATOL, GRAD_ATOL = 3e-5, 2e-4
ATOL, RTOL = 2e-5, 1e-4


def _parts(x):
    """x's hi and lo parts as f32 tensors (split_kernel's split)."""
    return [p.float() for p in fa._split_ref(x.float())]


def _split_trunc(x):
    """The kernels' on-chip split of P and dS (split_bf16x2_trunc): hi = x
    with its low 16 bits cleared, lo = bf16(x - hi) to nearest."""
    hi = (x.view(torch.int32) & -65536).view(torch.float32)
    return [hi, (x - hi).to(torch.bfloat16).float()]


def _products(a, b, eq, products):
    """The sum of the parts' products einsum(eq, a_i, b_j) over `products`."""
    return sum(torch.einsum(eq, a[i], b[j]) for i, j in products)


def _chunked(a, b, eq, products):
    """A product over D summed chunk by chunk (CHUNK columns at a time, in
    order), each chunk as the sum of its parts' products: S and dP as the
    streamed kernels make them."""
    out = 0
    for c0 in range(0, a[0].shape[-1], CHUNK):
        out = out + _products([x[..., c0:c0 + CHUNK] for x in a], [x[..., c0:c0 + CHUNK] for x in b], eq, products)
    return out


def _rows(x, r0, n):
    """Rows [r0, r0 + n) of [BH, R, D] x, zero past its end (TMA's fill)."""
    out = torch.zeros(x.shape[0], n, x.shape[2], dtype=torch.float32)
    m = max(0, min(n, x.shape[1] - r0))
    out[:, :m] = x[:, r0:r0 + m]
    return out


def _probs(s, dp, lse, delta, ok, sl2):
    """P and dS / scale of a tile in the kernels' arithmetic (dq_grads,
    dkv_grads): p = 2^(s * sl2 - lse * log2(e)) in one rounding (fmaf),
    dS / scale = p (dP - delta), both 0 where masked."""
    lse2 = lse * torch.tensor(_LOG2E, dtype=torch.float32)
    p = torch.exp2((s.double() * sl2.double() - lse2.double()).float())
    return torch.where(ok, p, 0.0), torch.where(ok, p * (dp - delta), 0.0)


def _sets(products):
    return {name: products.get(name, PRODUCTS) for name in NAMES}


def stream_dq_emulation(q, k, v, do, lse, delta, causal, scale, **products):
    """bwd_dq_kernel_sm90_stream's arithmetic at P = 2: q, k, v and do split
    into parts; per K/V tile of BN keys, in the kernel's order (tiles above
    a causal item's diagonal add exact zeros), S and dP summed chunk by
    chunk, dS / scale in the kernel's arithmetic (0 where masked), split on
    chip, and dQ += dS.K as the sum of the parts' products, in f32; dQ
    times scale at the end. `products` names a smaller set for any of "s",
    "dp", "dq"."""
    sets = _sets(products)
    BH, T, D = q.shape
    S = k.shape[1]
    sl2 = torch.tensor(scale, dtype=torch.float32) * torch.tensor(_LOG2E, dtype=torch.float32)
    qp, kp, vp, dop = _parts(q), _parts(k), _parts(v), _parts(do)
    rows = torch.arange(T)
    acc = torch.zeros(BH, T, D, dtype=torch.float32)
    for k0 in range(0, S, BN):
        kt, vt = [_rows(x, k0, BN) for x in kp], [_rows(x, k0, BN) for x in vp]
        s = _chunked(qp, kt, "btd,bsd->bts", sets["s"])
        dp = _chunked(dop, vt, "btd,bsd->bts", sets["dp"])
        keys = torch.arange(k0, k0 + BN)
        ok = (keys[None, :] < S) & ((rows[:, None] >= keys[None, :]) if causal else True)
        _, ds = _probs(s, dp, lse[..., None], delta[..., None], ok, sl2)
        acc = acc + _products(_split_trunc(ds), kt, "bts,bsd->btd", sets["dq"])
    return acc * scale


def stream_dkv_emulation(q, k, v, do, lse, delta, causal, scale, **products):
    """bwd_dkv_kernel_sm90_stream's arithmetic at P = 2: per Q/dO tile of BQ
    q rows (a causal item from its diagonal's), S^T = K.Q^T and dP^T =
    V.dO^T summed chunk by chunk (K and V first), P^T and dS^T / scale in
    the kernel's arithmetic, split on chip, dV += P^T.dO and dK += dS^T.Q as
    sums of the parts' products, in f32; dK times scale at the end.
    `products` names a smaller set for any of "s", "dp", "dk", "dv"."""
    sets = _sets(products)
    BH, T, D = q.shape
    S = k.shape[1]
    sl2 = torch.tensor(scale, dtype=torch.float32) * torch.tensor(_LOG2E, dtype=torch.float32)
    qp, kp, vp, dop = _parts(q), _parts(k), _parts(v), _parts(do)
    keys = torch.arange(S)
    dk = torch.zeros(BH, S, D, dtype=torch.float32)
    dv = torch.zeros(BH, S, D, dtype=torch.float32)
    for q0 in range(0, T, BQ):
        qt, dot = [_rows(x, q0, BQ) for x in qp], [_rows(x, q0, BQ) for x in dop]
        lt = _rows(lse[..., None], q0, BQ)[..., 0]
        dlt = _rows(delta[..., None], q0, BQ)[..., 0]
        st = _chunked(kp, qt, "bsd,btd->bst", sets["s"])
        dpt = _chunked(vp, dot, "bsd,btd->bst", sets["dp"])
        qrows = torch.arange(q0, q0 + BQ)
        ok = (qrows[None, :] < T) & ((qrows[None, :] >= keys[:, None]) if causal else True)
        p, ds = _probs(st, dpt, lt[:, None, :], dlt[:, None, :], ok, sl2)
        dv = dv + _products(_split_trunc(p), dot, "bst,btd->bsd", sets["dv"])
        dk = dk + _products(_split_trunc(ds), qt, "bst,btd->bsd", sets["dk"])
    return dk * scale, dv


def _case(seed, T, S, D, causal):
    """Seeded q, k, v and do, lse from the plain forward and delta =
    rowsum(do * o), as the autograd function forms them."""
    rs = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rs.randn(2, n, D).astype(np.float32)) for n in (T, S, S, T))
    scale = D ** -0.5
    o, lse = fa._flash_fwd_ref(q, k, v, causal, scale, with_lse=True)
    return q, k, v, do, lse, (do * o).sum(-1), scale


def _pallas(q, k, v, do, lse, delta, causal, scale):
    """The JAX package's backward kernels (Pallas, interpret mode) at f32,
    with lse and delta broadcast to [BH, T, 8] as _flash_vjp_bwd does:
    (dq, dk, dv)."""
    jq, jk, jv, jdo = (jnp.asarray(x.numpy()) for x in (q, k, v, do))
    jl, jd = (jnp.broadcast_to(jnp.asarray(x.numpy())[..., None], (*x.shape, 8)) for x in (lse, delta))
    kw = dict(causal=causal, scale=scale, block_q=128, block_k=128, interpret=True)
    dq = _flash_bwd_dq(jq, jk, jv, jdo, jl, jd, **kw)
    dk, dv = _flash_bwd_dkv(jq, jk, jv, jdo, jl, jd, **kw)
    return [torch.from_numpy(np.array(x)) for x in (dq, dk, dv)]


CASES = [(D, 192, 192, causal) for D in (512, 1024) for causal in (True, False)] + [(512, 100, 300, True)]


@pytest.mark.parametrize("D,T,S,causal", CASES)
def test_streamed_backward_arithmetic_holds_the_smoke_limit(D, T, S, causal):
    """Both streamed kernels' arithmetic at P = 2, emulated on f32 inputs at
    512 and 1024: dq, dk and dv within half of F32_ATOL of the f32 plain
    versions (the kernels' margin, which the card's plain versions in
    another order may take) and within F32_ATOL of the Pallas backward
    (interpret mode). T = 192 is no multiple of the Pallas blocks; T != S
    with the mask."""
    q, k, v, do, lse, delta, scale = _case(51 + D + T, T, S, D, causal)
    args = (q, k, v, do, lse, delta)
    dq = stream_dq_emulation(*args, causal, scale)
    dk, dv = stream_dkv_emulation(*args, causal, scale)
    ref_dq = fa._flash_bwd_dq_ref(*args, causal, scale)
    ref_dk, ref_dv = fa._flash_bwd_dkv_ref(*args, causal, scale)
    pallas_dq, pallas_dk, pallas_dv = _pallas(*args, causal, scale)
    _, ratios = cs.compare({"plain": [(dq, ref_dq), (dk, ref_dk), (dv, ref_dv)],
                            "pallas": [(dq, pallas_dq), (dk, pallas_dk), (dv, pallas_dv)]})
    assert ratios["plain"] <= 0.5 and ratios["pallas"] <= 1.0, ratios


# Each set one product smaller than the kernels': any of the five products
# without one of its three.
SMALLER = {f"{name}_without_{'hl'[i]}{'hl'[j]}": (name, (i, j)) for name in NAMES for i, j in PRODUCTS}


@pytest.mark.parametrize("name", list(SMALLER))
def test_streamed_next_smaller_product_set_misses_the_smoke_limit(name):
    """Leaving out any one of the three products of S, dP, dQ, dK or dV
    misses F32_ATOL against the plain versions at head dim 512, on one
    causal case (its first rows see few keys, so a rounded operand is not
    averaged away)."""
    which, dropped = SMALLER[name]
    kept = {which: tuple(p for p in PRODUCTS if p != dropped)}
    q, k, v, do, lse, delta, scale = _case(57, 192, 192, 512, True)
    args = (q, k, v, do, lse, delta)
    pairs = []
    if which in ("s", "dp", "dq"):
        dq_kept = {n: p for n, p in kept.items() if n not in ("dk", "dv")}
        pairs.append((stream_dq_emulation(*args, True, scale, **dq_kept), fa._flash_bwd_dq_ref(*args, True, scale)))
    if which != "dq":
        dkv_kept = {n: p for n, p in kept.items() if n != "dq"}
        pairs += zip(stream_dkv_emulation(*args, True, scale, **dkv_kept), fa._flash_bwd_dkv_ref(*args, True, scale))
    _, ratios = cs.compare({"bwd": pairs})
    assert ratios["bwd"] > 1.0, ratios


@pytest.mark.parametrize("D", [513, 576, 1024, 2048])
def test_one_width_rule_on_both_devices(D):
    """Past 512 the forward and the backward run at the next multiple of 512
    on the card and on the CPU alike: kernel_width, autograd_width at both
    dtypes and devices, and the wrappers' shape rules take the head dim."""
    width = -(-D // 512) * 512
    assert fa.kernel_width(D) == width
    for device in ("cpu", "cuda"):
        for dtype in (torch.float32, torch.bfloat16):
            assert fa.autograd_width(D, dtype, device) == width
    assert fa.stream_route(width, torch.bfloat16) and fa.stream_route(width, torch.float32)
    fa.check_shapes((4, 64, D), (4, 100, D), (4, 100, D))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [576, 1024])
def test_attention_gradients_past_512_match_pallas(D, causal):
    """flash_attention with gradients at head dims past 512 (576 padded to
    1024) on the CPU against jax.grad through the JAX package's Pallas
    flash_attention (interpret mode): o within FWD_ATOL, dq, dk and dv
    within GRAD_ATOL, and no kernel launched."""
    B, T, H = 1, 64, 2
    rs = np.random.RandomState(D + causal)
    q, k, v, w = (rs.randn(B, T, H, D).astype(np.float32) for _ in range(4))

    def jax_obj(q, k, v):
        o = jax_flash_attention(q, k, v, causal=causal, interpret=True)
        return (o * w).sum(), o

    (_, o_ref), grads_ref = jax.value_and_grad(jax_obj, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    before = dict(fa.launches)
    o = fa.flash_attention(*leaves, causal=causal)
    (o * torch.from_numpy(w)).sum().backward()
    assert fa.launches == before
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_ref), atol=FWD_ATOL)
    for leaf, ref in zip(leaves, grads_ref):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref), atol=GRAD_ATOL)


def test_transformer_at_head_dim_1024_matches_jax():
    """The port's Transformer trained at head dim 1024 (the kernel route of
    the autograd function, padded to nothing), one layer of 2 heads at
    d_model 2048 with a narrow d_ff and vocabulary, against the JAX model on
    the same weights (params_from_jax): logits and every gradient within
    ATOL, RTOL, the loss within 1e-6."""
    widths = dict(vocab_size=64, n_layers=1, max_seq_len=32, d_model=2048, n_heads=2, n_kv_heads=2, d_ff=128)
    jcfg = jax_tr.TransformerConfig(**widths, dtype=jnp.float32, attention_impl="xla")
    tcfg = tr.TransformerConfig(**widths, dtype=torch.float32, attention_impl="kernel", remat=True)
    assert tcfg.head_dim == jcfg.head_dim == 1024
    params = jax.tree.map(np.array, jax_tr.transformer_init(jax.random.PRNGKey(4), jcfg))
    toks = np.random.RandomState(3).randint(0, widths["vocab_size"], (2, 25)).astype(np.int32)
    ref_logits = jax_tr.transformer_apply(params, jnp.asarray(toks[:, :-1]), jcfg)
    ref_loss, ref_grads = jax.value_and_grad(jax_tr.transformer_loss)(params, {"tokens": jnp.asarray(toks)}, jcfg)
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


@pytest.mark.parametrize("causal", [True, False])
def test_ring_kernel_route_past_512_pads_once_and_matches_plain_route(causal, monkeypatch):
    """Ring attention's kernel route at head dim 1000 (padded to 1024 once,
    at its entry: every hop's wrappers see 1024), four shards in loopback,
    against its plain route: output and gradients within the JAX package's
    tolerances."""
    from ray_tpu_torch.parallel import ring_attention_loopback

    seen = []
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        ring_mod = importlib.import_module("ray_tpu_torch.parallel.ring_attention")
        wrapped = getattr(ring_mod, name)

        def spy(q, *rest, _w=wrapped, **kw):
            seen.append(q.shape[-1])
            return _w(q, *rest, **kw)
        monkeypatch.setattr(ring_mod, name, spy)
    B, T, H, D = 1, 64, 2, 1000
    rs = np.random.RandomState(6)
    q, k, v, w = (rs.randn(B, T, H, D).astype(np.float32) for _ in range(4))
    out = {}
    for impl in ("kernel", "plain"):
        leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
        o = ring_attention_loopback(*leaves, 4, causal=causal, impl=impl)
        (o * torch.from_numpy(w)).sum().backward()
        out[impl] = [o.detach(), *(x.grad for x in leaves)]
    assert seen and set(seen) == {1024}, seen
    np.testing.assert_allclose(out["kernel"][0].numpy(), out["plain"][0].numpy(), atol=FWD_ATOL)
    for a, b in zip(out["kernel"][1:], out["plain"][1:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=GRAD_ATOL)
