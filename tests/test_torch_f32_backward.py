"""The f32 backward on Hopper's tensor cores (bwd_dq_kernel_sm90_f32 and
bwd_dkv_kernel_sm90_f32, csrc/flash_attention.cu) on the CPU: an emulation
of both kernels' arithmetic, tile by tile in their order and sizes, against
the f32 plain versions and against the JAX package's Pallas backward in
interpret mode, within chip_smoke.py's F32_ATOL; the split of do; and the
autograd function's f32 backward on the CPU. The emulation settles the
kernels' product sets: three bf16 products a f32 product (hi.hi, hi.lo,
lo.hi) in each of S, dP, dQ, dK and dV hold the limit, and leaving out any
one of them misses it."""

import importlib

import numpy as np
import pytest

from ray_tpu.testing import force_cpu_mesh

force_cpu_mesh(8)  # before first backend use, like every jax-facing test

import jax  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ray_tpu.ops.flash_attention import _flash_bwd_dkv, _flash_bwd_dq  # noqa: E402

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


# The kernels' streamed tiles (DqCfg<D, 2>, DkvCfg<D, 2>): bwd_dq streams K/V
# tiles of BN keys, bwd_dkv Q/dO tiles of BQ q rows.
BN = {32: 128, 64: 64, 96: 32, 128: 32, 256: 16}
BQ = {32: 64, 64: 64, 96: 32, 128: 32, 256: 16}
_LOG2E = 1.4426950408889634
# (part of the first operand, part of the second): 0 = hi, 1 = lo.
PRODUCTS = ((0, 0), (0, 1), (1, 0))
# The five products of the two kernels: S = Q.K^T and dP = dO.V^T (both
# kernels; bwd_dkv makes S^T = K.Q^T and dP^T = V.dO^T, the same set with
# the operands' roles swapped), dQ = dS.K, dK = dS^T.Q and dV = P^T.dO.
NAMES = ("s", "dp", "dq", "dk", "dv")


def _inputs(seed, BH, T, S, D):
    rs = np.random.RandomState(seed)
    return [rs.randn(BH, n, D).astype(np.float32) for n in (T, S, S, T)]


def _parts(x):
    """x's hi and lo parts as f32 tensors (split_kernel's split)."""
    return [p.float() for p in fa._split_ref(x.float())]


def _split_trunc(x):
    """The kernels' on-chip split of P and dS (split_bf16x2_trunc): hi = x
    with its low 16 bits cleared (bf16 toward zero), lo = bf16(x - hi) to
    nearest."""
    hi = (x.view(torch.int32) & -65536).view(torch.float32)
    return [hi, (x - hi).to(torch.bfloat16).float()]


def _products(a, b, eq, products):
    """The sum of the parts' products einsum(eq, a_i, b_j) over `products`."""
    return sum(torch.einsum(eq, a[i], b[j]) for i, j in products)


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


def _full(products):
    return {name: products.get(name, PRODUCTS) for name in NAMES}


def f32_dq_emulation(q, k, v, do, lse, delta, causal, scale, **products):
    """bwd_dq_kernel_sm90_f32's arithmetic in torch: q, k, v and do split
    into hi and lo parts (the split pass); per K/V tile of BN keys, in the
    kernel's order (the tiles above a causal item's diagonal add nothing and
    are skipped), S and dP as sums of their parts' products, P and dS /
    scale in the kernel's arithmetic, 0 where masked (rows and keys past T
    and S come from TMA's zero fill, with lse and delta 0), dS split on chip
    (hi by truncation, lo to nearest) and dQ += dS.K as the sum of the
    parts' products, in f32; dQ times scale when the item ends. `products`
    names a smaller set for any of "s", "dp", "dq" (default PRODUCTS)."""
    sets = _full(products)
    BH, T, D = q.shape
    S, bn = k.shape[1], BN[D]
    sl2 = torch.tensor(scale, dtype=torch.float32) * torch.tensor(_LOG2E, dtype=torch.float32)
    qp, kp, vp, dop = _parts(q), _parts(k), _parts(v), _parts(do)
    rows = torch.arange(T)
    acc = torch.zeros(BH, T, D, dtype=torch.float32)
    for k0 in range(0, S, bn):
        kt, vt = [_rows(x, k0, bn) for x in kp], [_rows(x, k0, bn) for x in vp]
        s = _products(qp, kt, "btd,bsd->bts", sets["s"])
        dp = _products(dop, vt, "btd,bsd->bts", sets["dp"])
        keys = torch.arange(k0, k0 + bn)
        ok = (keys[None, :] < S) & ((rows[:, None] >= keys[None, :]) if causal else True)
        _, ds = _probs(s, dp, lse[..., None], delta[..., None], ok, sl2)
        acc = acc + _products(_split_trunc(ds), kt, "bts,bsd->btd", sets["dq"])
    return acc * scale


def f32_dkv_emulation(q, k, v, do, lse, delta, causal, scale, **products):
    """bwd_dkv_kernel_sm90_f32's arithmetic in torch: per Q/dO tile of BQ q
    rows, in the kernel's order (a causal item starts at its diagonal's q
    tile), S^T = K.Q^T and dP^T = V.dO^T as sums of their parts' products
    (K and V first), P^T and dS^T / scale in the kernel's arithmetic, 0
    where masked, both split on chip, dV += P^T.dO and dK += dS^T.Q as sums
    of the parts' products, in f32; dK times scale when the item ends.
    `products` names a smaller set for any of "s", "dp", "dk", "dv"."""
    sets = _full(products)
    BH, T, D = q.shape
    S, bq = k.shape[1], BQ[D]
    sl2 = torch.tensor(scale, dtype=torch.float32) * torch.tensor(_LOG2E, dtype=torch.float32)
    qp, kp, vp, dop = _parts(q), _parts(k), _parts(v), _parts(do)
    keys = torch.arange(S)
    dk = torch.zeros(BH, S, D, dtype=torch.float32)
    dv = torch.zeros(BH, S, D, dtype=torch.float32)
    for q0 in range(0, T, bq):
        qt, dot = [_rows(x, q0, bq) for x in qp], [_rows(x, q0, bq) for x in dop]
        lt = _rows(lse[..., None], q0, bq)[..., 0]
        dlt = _rows(delta[..., None], q0, bq)[..., 0]
        st = _products(kp, qt, "bsd,btd->bst", sets["s"])
        dpt = _products(vp, dot, "bsd,btd->bst", sets["dp"])
        qrows = torch.arange(q0, q0 + bq)
        ok = (qrows[None, :] < T) & ((qrows[None, :] >= keys[:, None]) if causal else True)
        p, ds = _probs(st, dpt, lt[:, None, :], dlt[:, None, :], ok, sl2)
        dv = dv + _products(_split_trunc(p), dot, "bst,btd->bsd", sets["dv"])
        dk = dk + _products(_split_trunc(ds), qt, "bst,btd->bsd", sets["dk"])
    return dk * scale, dv


def _case(seed, T, S, D, causal):
    """Seeded q, k, v and do, lse from the plain forward and delta =
    rowsum(do * o), as the autograd function forms them."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(seed, 2, T, S, D))
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


CASES = [(D, T, T, causal) for D in (32, 64, 96, 128, 256) for T in (192, 1000) for causal in (True, False)]
CASES += [(128, 300, 1000, False), (128, 1000, 300, True)]


@pytest.mark.parametrize("D,T,S,causal", CASES)
def test_f32_backward_arithmetic_holds_the_smoke_limit(D, T, S, causal):
    """Both kernels' product sets, emulated on f32 inputs, within F32_ATOL of
    the f32 plain versions and of the Pallas backward (interpret mode), dq,
    dk and dv; at most half of it against the plain versions (the kernels'
    own margin, which the card's plain versions in another order may
    take). T = 1000 is no multiple of any tile; T != S both ways."""
    q, k, v, do, lse, delta, scale = _case(31 + D + T, T, S, D, causal)
    args = (q, k, v, do, lse, delta)
    dq = f32_dq_emulation(*args, causal, scale)
    dk, dv = f32_dkv_emulation(*args, causal, scale)
    ref_dq = fa._flash_bwd_dq_ref(*args, causal, scale)
    ref_dk, ref_dv = fa._flash_bwd_dkv_ref(*args, causal, scale)
    pallas_dq, pallas_dk, pallas_dv = _pallas(*args, causal, scale)
    _, ratios = cs.compare({"plain": [(dq, ref_dq), (dk, ref_dk), (dv, ref_dv)],
                            "pallas": [(dq, pallas_dq), (dk, pallas_dk), (dv, pallas_dv)]})
    assert ratios["plain"] <= 0.5 and ratios["pallas"] <= 1.0, ratios


# Each set one product smaller than the kernels': any of the five products
# without one of its three (dV without P_lo.dO_hi is P rounded once, dQ and
# dK without dS_lo.x_hi dS truncated once to bf16).
SMALLER = {f"{name}_without_{'hl'[i]}{'hl'[j]}": (name, (i, j)) for name in NAMES for i, j in PRODUCTS}


@pytest.mark.parametrize("name", list(SMALLER))
def test_next_smaller_product_set_misses_the_smoke_limit(name):
    """Leaving out any one of the three products of S, dP, dQ, dK or dV
    misses F32_ATOL against the plain versions, at every head dim, on one
    causal case (its first rows see few keys, so a rounded operand is not
    averaged away)."""
    which, dropped = SMALLER[name]
    kept = {which: tuple(p for p in PRODUCTS if p != dropped)}
    for D in (32, 64, 96, 128, 256):
        q, k, v, do, lse, delta, scale = _case(37 + D, 192, 192, D, True)
        args = (q, k, v, do, lse, delta)
        pairs = []
        if which in ("s", "dp", "dq"):
            dq_kept = {n: p for n, p in kept.items() if n != "dk" and n != "dv"}
            pairs.append((f32_dq_emulation(*args, True, scale, **dq_kept),
                          fa._flash_bwd_dq_ref(*args, True, scale)))
        if which != "dq":
            dkv_kept = {n: p for n, p in kept.items() if n != "dq"}
            pairs += zip(f32_dkv_emulation(*args, True, scale, **dkv_kept),
                         fa._flash_bwd_dkv_ref(*args, True, scale))
        _, ratios = cs.compare({"bwd": pairs})
        assert ratios["bwd"] > 1.0, (D, ratios)


def test_split_of_do_on_the_cpu():
    """split_parts of do alone, and of q, k, v and do together, on CPU
    tensors is the plain version, [2, *shape] each."""
    q, k, v, do = (torch.randn(3, n, 64) for n in (5, 7, 7, 5))
    (part,) = fa.split_parts(do)
    assert part.shape == (2, *do.shape) and torch.equal(part, fa._split_ref(do))
    for part, x in zip(fa.split_parts(q, k, v, do), (q, k, v, do)):
        assert part.shape == (2, *x.shape) and torch.equal(part, fa._split_ref(x))


def test_autograd_f32_backward_on_the_cpu_splits_nothing():
    """The autograd function's f32 backward on CPU tensors takes no parts:
    no split pass and no kernel launch, and its gradients are the plain
    versions' on the saved forward."""
    g = torch.Generator().manual_seed(3)
    q, k, v, do = (torch.randn(2, 100, 64, generator=g) for _ in range(4))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fa.reset_launches()
    o = fa._FlashAttention.apply(*leaves, True, 0.125)
    got = torch.autograd.grad(o, leaves, do)
    assert not any(fa.launches.values()) and not any(fa.f32_launches.values())
    ref_o, lse = fa._flash_fwd_ref(q, k, v, True, 0.125, with_lse=True)
    delta = (do * ref_o).sum(-1)
    want = (fa._flash_bwd_dq_ref(q, k, v, do, lse, delta, True, 0.125),
            *fa._flash_bwd_dkv_ref(q, k, v, do, lse, delta, True, 0.125))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not fa.parts_route(q)
