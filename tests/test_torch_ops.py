"""Parity of ray_tpu_torch.ops with ray_tpu.ops on the CPU: RMSNorm, cross
entropy, the chunked LM-head CE, the plain version of each flash kernel
against the Pallas kernel in interpret mode, and flash_attention/mha forward
and gradients with GQA. Inputs come from numpy with a seed; both sides run
in f32 (JAX at matmul precision "highest"). Also: why the bf16 tensor-core
kernels split P and dS into two bf16 terms, what chip_smoke.py's first-step
gradient check can and cannot see of a broken dq, and chip_smoke.py's
readers of the compiler's reports."""

import importlib

import numpy as np
import pytest

from ray_tpu.testing import force_cpu_mesh

force_cpu_mesh(8)  # before first backend use, like every jax-facing test

import jax  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ray_tpu.ops.flash_attention import (  # noqa: E402
    _flash_bwd_dkv,
    _flash_bwd_dq,
    _flash_fwd,
)
from ray_tpu.ops.flash_attention import flash_attention as jax_flash_attention  # noqa: E402
from ray_tpu.ops.fused import (  # noqa: E402
    fused_rmsnorm as jax_rmsnorm,
    lm_head_cross_entropy as jax_lm_head_ce,
    softmax_cross_entropy as jax_ce,
)
from ray_tpu_torch.ops.flash_attention import (  # noqa: E402
    _bwd_tile_ref,
    _flash_bwd_dkv_ref,
    _flash_bwd_dq_ref,
    _flash_fwd_ref,
    launches,
    mha,
)
from ray_tpu_torch.ops.fused import (  # noqa: E402
    fused_rmsnorm,
    lm_head_cross_entropy,
    softmax_cross_entropy,
)

# f32 on both sides; the two frameworks sum in different orders, so results
# agree to a few f32 ulps of the operands' scale, not bit for bit.
F32_ATOL = 1e-5
# Attention outputs and gradients sum over up to 192 keys of O(1) products:
# the bound the JAX package's own kernel-vs-XLA test uses.
ATTN_ATOL = 2e-4


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax(dtype):
    rs = np.random.RandomState(0)
    x = rs.randn(2, 5, 32).astype(np.float32)
    w = rs.randn(32).astype(np.float32)
    jt, tt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jax_rmsnorm(jnp.asarray(x).astype(jt), jnp.asarray(w))
    out = fused_rmsnorm(_t(x).to(tt), _t(w))
    assert out.dtype == tt
    ref = np.asarray(ref.astype(jnp.float32))
    # bf16: both round the same f32 value, so at most one bf16 ulp apart.
    tol = dict(atol=F32_ATOL) if dtype == "float32" else dict(rtol=2 ** -7, atol=1e-6)
    np.testing.assert_allclose(out.float().numpy(), ref, **tol)


def test_softmax_cross_entropy_matches_jax():
    rs = np.random.RandomState(1)
    logits = rs.randn(3, 7, 50).astype(np.float32) * 3
    labels = rs.randint(0, 50, (3, 7))
    labels[0, :3] = -100
    ref_loss, ref_n = jax_ce(jnp.asarray(logits), jnp.asarray(labels))
    loss, n = softmax_cross_entropy(_t(logits), _t(labels))
    assert float(n) == float(ref_n) == 18.0
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-6)


@pytest.mark.parametrize("chunk_tokens", [64, 80])  # 192 tokens: divides, and not
def test_lm_head_cross_entropy_matches_jax(chunk_tokens):
    B, T, d, V = 2, 96, 32, 257
    rs = np.random.RandomState(2)
    hidden = rs.randn(B, T, d).astype(np.float32)
    unembed = rs.randn(d, V).astype(np.float32)
    targets = rs.randint(0, V, (B, T))
    targets[1, -7:] = -100

    def jax_loss(h, w):
        return jax_lm_head_ce(h, w, jnp.asarray(targets), chunk_tokens=chunk_tokens)[0]

    ref_loss = jax_loss(jnp.asarray(hidden), jnp.asarray(unembed))
    ref_gh, ref_gw = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(hidden), jnp.asarray(unembed))

    h = _t(hidden).requires_grad_(True)
    w = _t(unembed).requires_grad_(True)
    loss, n = lm_head_cross_entropy(h, w, _t(targets), chunk_tokens=chunk_tokens)
    loss.backward()
    assert float(n) == B * T - 7
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-6)
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(ref_gh), atol=F32_ATOL)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(ref_gw), atol=F32_ATOL)


def test_lm_head_cross_entropy_all_ignored_counts_one():
    h = torch.randn(1, 4, 8)
    loss, n = lm_head_cross_entropy(h, torch.randn(8, 11), torch.full((1, 4), -100), chunk_tokens=3)
    assert float(n) == 1.0 and float(loss) == 0.0


def _qkv(seed, BH, T, D, n=4):
    rs = np.random.RandomState(seed)
    return [rs.randn(BH, T, D).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("seq", [128, 192])  # 192 exercises the 128-row block padding
def test_plain_kernels_match_pallas(causal, seq):
    """Each plain version against its Pallas kernel run in interpret mode:
    o and lse (B1/B2), dq (B3), dk and dv (B4), from the same residuals."""
    BH, D = 4, 64
    q, k, v, do = _qkv(3, BH, seq, D)
    scale = 1.0 / np.sqrt(D)
    kw = dict(causal=causal, scale=scale, block_q=128, block_k=128, interpret=True)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))

    o_ref, lse8 = _flash_fwd(jq, jk, jv, with_lse=True, **kw)
    o_only = _flash_fwd(jq, jk, jv, **kw)
    o, lse = _flash_fwd_ref(_t(q), _t(k), _t(v), causal, scale, with_lse=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=ATTN_ATOL)
    np.testing.assert_allclose(_flash_fwd_ref(_t(q), _t(k), _t(v), causal, scale).numpy(),
                               np.asarray(o_only), atol=ATTN_ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse8[..., 0]), atol=ATTN_ATOL)

    delta = (do * np.asarray(o_ref)).sum(-1).astype(np.float32)
    delta8 = jnp.broadcast_to(jnp.asarray(delta)[..., None], (BH, seq, 8))
    dq_ref = _flash_bwd_dq(jq, jk, jv, jdo, lse8, delta8, **kw)
    dk_ref, dv_ref = _flash_bwd_dkv(jq, jk, jv, jdo, lse8, delta8, **kw)
    lse_np = np.asarray(lse8[..., 0])
    args = (_t(q), _t(k), _t(v), _t(do), _t(lse_np), _t(delta), causal, scale)
    dq = _flash_bwd_dq_ref(*args)
    dk, dv = _flash_bwd_dkv_ref(*args)
    assert dq.dtype == dk.dtype == dv.dtype == torch.float32
    np.testing.assert_allclose(dq.numpy(), np.asarray(dq_ref), atol=ATTN_ATOL)
    np.testing.assert_allclose(dk.numpy(), np.asarray(dk_ref), atol=ATTN_ATOL)
    np.testing.assert_allclose(dv.numpy(), np.asarray(dv_ref), atol=ATTN_ATOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_mha_gqa_forward_and_grads_match_jax(impl, causal):
    """[B, T, H, D] attention with 4 query heads on 2 kv heads, against the
    JAX flash_attention (Pallas, interpret mode) forward and gradients."""
    B, T, H, Hk, D = 2, 192, 4, 2, 64
    rs = np.random.RandomState(4)
    q = rs.randn(B, T, H, D).astype(np.float32)
    k = rs.randn(B, T, Hk, D).astype(np.float32)
    v = rs.randn(B, T, Hk, D).astype(np.float32)
    w = rs.randn(B, T, H, D).astype(np.float32)  # cotangent weights

    def jax_obj(q, k, v):
        o = jax_flash_attention(q, k, v, causal=causal, interpret=True)
        return (o * w).sum(), o

    (_, o_ref), grads_ref = jax.value_and_grad(jax_obj, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
    before = dict(launches)
    o = mha(*leaves, causal=causal, impl=impl)
    (o * _t(w)).sum().backward()
    assert launches == before  # CPU tensors run the plain versions, never a kernel
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_ref), atol=ATTN_ATOL)
    for leaf, ref in zip(leaves, grads_ref):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref), atol=ATTN_ATOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 128])
def test_tensor_core_operands_need_the_hi_lo_split(D, causal):
    """The bf16 kernels hand P (in P.V and P^T.dO) and dS (in dS.K and
    dS^T.Q), f32 values made on chip, to bf16 tensor cores. Rounded once,
    they miss chip_smoke.py's kernel limits; split into hi = bf16(x) and lo =
    bf16(x - hi), one product each, they hold them. Emulated here through the
    plain versions' math: the inputs are bf16, so every product is exact in
    f32 and only the rounding of P and dS differs from the plain versions."""
    cs = importlib.import_module("chip_smoke")
    T = 1024
    q, k, v, do = (_t(x).bfloat16() for x in _qkv(7, 2, T, D))
    scale = D ** -0.5
    ref_o, lse = _flash_fwd_ref(q, k, v, causal, scale, with_lse=True)
    delta = (do.float() * ref_o.float()).sum(-1)
    ref_dq = _flash_bwd_dq_ref(q, k, v, do, lse, delta, causal, scale)
    ref_dk, ref_dv = _flash_bwd_dkv_ref(q, k, v, do, lse, delta, causal, scale)
    # P as the forward holds it: exp(s - row max), not yet divided by l.
    s = torch.einsum("btd,bsd->bts", q.float(), k.float()) * scale
    if causal:
        s = s.masked_fill(~torch.ones(T, T, dtype=torch.bool).tril(), -1e30)
    p_fwd = torch.exp(s - s.amax(-1, keepdim=True))
    l = p_fwd.sum(-1, keepdim=True)
    p, ds = _bwd_tile_ref(q, k, v, do, lse, delta, causal, scale)

    def once(x):
        return [x.bfloat16().float()]

    def split(x):
        hi = x.bfloat16().float()
        return [hi, (x - hi).bfloat16().float()]

    def ratios(rounding):
        o = sum(torch.einsum("bts,bsd->btd", t, v.float()) for t in rounding(p_fwd)) / l
        dq = sum(torch.einsum("bts,bsd->btd", t, k.float()) for t in rounding(ds))
        dk = sum(torch.einsum("bts,btd->bsd", t, q.float()) for t in rounding(ds))
        dv = sum(torch.einsum("bts,btd->bsd", t, do.float()) for t in rounding(p))
        return cs.compare({"o": [(o.bfloat16(), ref_o)], "dq": [(dq, ref_dq)],
                           "dkv": [(dk, ref_dk), (dv, ref_dv)]})[1]

    rounded_once, split_in_two = ratios(once), ratios(split)
    assert all(r > 1.0 for r in rounded_once.values()), rounded_once
    assert all(r <= 1.0 for r in split_in_two.values()), split_in_two


# The Hopper forward's tiles (csrc/flash_attention.cu, FWD_BQ and FwdCfg):
# 128 q rows a work item, two consumer warpgroups of 64; 128 keys a K/V tile
# at D = 64 and 96, 64 at D = 128, 32 at 256.
SM90_BQ, SM90_BN = 128, {64: 128, 96: 128, 128: 64, 256: 32}
_LOG2E, _LN2 = 1.4426950408889634, 0.6931471805599453


def _fwd_sm90_emulation(q, k, v, causal, scale, split=True):
    """fwd_kernel_sm90's arithmetic in torch, tile by tile in its order and
    sizes: per K/V tile, each 64-row warpgroup takes the masked path only on
    the diagonal or past S (as the kernel decides), the running max in log2
    units with scale * log2(e) folded into one FMA, exp2, the rescale of the
    sums made under the old max; P split into hi = bf16(P) and lo = bf16(P -
    hi) (or, not split, rounded once), each times V into the f32 sum, which
    is rescaled after the product of the previous tile has landed; o is that
    sum times 1 / l. Returns (o bf16, lse f32)."""
    BH, T, D = q.shape
    S, bn = k.shape[1], SM90_BN[D]
    f32 = torch.float32
    sl2 = torch.tensor(scale, dtype=f32) * torch.tensor(_LOG2E, dtype=f32)
    big_neg = torch.tensor(-1e30, dtype=f32)
    o = torch.empty(BH, T, D, dtype=torch.bfloat16)
    lse = torch.empty(BH, T, dtype=f32)
    for q0 in range(0, T, SM90_BQ):
        rows = torch.arange(q0, q0 + SM90_BQ)
        qt = torch.zeros(BH, SM90_BQ, D, dtype=f32)  # TMA zero-fills rows past T
        qt[:, :T - q0] = q[:, q0:q0 + SM90_BQ].float()
        n = -(-S // bn)
        if causal:
            n = min(n, (q0 + SM90_BQ - 1) // bn + 1)  # tiles above the diagonal are skipped
        m = torch.full((BH, SM90_BQ), -1e30, dtype=f32)
        l = torch.zeros(BH, SM90_BQ, dtype=f32)
        acc = torch.zeros(BH, SM90_BQ, D, dtype=f32)
        pv = None  # P.V of the previous tile, added before this tile's rescale
        for k0 in range(0, n * bn, bn):
            kk, vv = (torch.zeros(BH, bn, D, dtype=f32) for _ in range(2))  # TMA zero-fills past S
            kk[:, :S - k0] = k[:, k0:k0 + bn].float()
            vv[:, :S - k0] = v[:, k0:k0 + bn].float()
            s = torch.einsum("btd,bsd->bts", qt, kk)
            keys = torch.arange(k0, k0 + bn)
            ok = (keys[None, :] < S) & ((rows[:, None] >= keys[None, :]) if causal else True)
            ok = ok.expand(SM90_BQ, bn)
            p, alpha = torch.empty_like(s), torch.empty_like(m)
            for w0 in range(0, SM90_BQ, 64):  # one consumer warpgroup's rows
                w = slice(w0, w0 + 64)
                if k0 + bn > S or (causal and k0 + bn - 1 > q0 + w0):
                    s2 = torch.where(ok[w], s[:, w] * sl2, big_neg)
                    mn = torch.maximum(m[:, w], s2.amax(-1))
                    p[:, w] = torch.where(ok[w], torch.exp2(s2 - mn[..., None]), 0.0)
                else:
                    mn = torch.maximum(m[:, w], s[:, w].amax(-1) * sl2)
                    # fmaf(s, sl2, -m): one rounding
                    p[:, w] = torch.exp2((s[:, w].double() * sl2.double() - mn[..., None].double()).float())
                alpha[:, w] = torch.exp2(m[:, w] - mn)
                m[:, w] = mn
            l = l * alpha + p.sum(-1)
            if pv is not None:
                acc = acc + pv
            acc = acc * alpha[..., None]
            hi = p.bfloat16().float()
            terms = [hi, (p - hi).bfloat16().float()] if split else [hi]
            pv = sum(torch.einsum("bts,bsd->btd", t, vv) for t in terms)
        lsafe = l.clamp_min(1e-30)
        keep = rows < T
        o[:, rows[keep]] = ((acc + pv) * (1 / lsafe)[..., None])[:, keep].bfloat16()
        lse[:, rows[keep]] = (m * _LN2 + torch.log(lsafe))[:, keep]
    return o, lse


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [192, 1000, 1024])
@pytest.mark.parametrize("D", [64, 128])
def test_sm90_forward_arithmetic_holds_the_smoke_limits(D, T, causal):
    """The Hopper forward's arithmetic, emulated on bf16 inputs, against the
    plain version and against the Pallas kernel (interpret mode) within
    chip_smoke.py's limits; with P rounded once instead of split, it misses
    them."""
    _check_sm90_forward(D, T, causal)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [192, 1000])
@pytest.mark.parametrize("D", [96, 256])
def test_sm90_forward_arithmetic_at_wide_head_dims(D, T, causal):
    """As test_sm90_forward_arithmetic_holds_the_smoke_limits, with the
    tiles of the D = 96 and D = 256 forward."""
    _check_sm90_forward(D, T, causal)


def _check_sm90_forward(D, T, causal):
    cs = importlib.import_module("chip_smoke")
    q, k, v = _qkv(11, 2, T, D, n=3)
    scale = D ** -0.5
    tq, tk, tv = (_t(x).bfloat16() for x in (q, k, v))
    o, lse = _fwd_sm90_emulation(tq, tk, tv, causal, scale)
    ref_o, ref_lse = _flash_fwd_ref(tq, tk, tv, causal, scale, with_lse=True)
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    pallas_o, pallas_lse = _flash_fwd(jq, jk, jv, causal=causal, scale=scale, block_q=128,
                                      block_k=128, interpret=True, with_lse=True)
    pallas_o = _t(np.asarray(pallas_o.astype(jnp.float32))).bfloat16()
    pallas_lse = _t(np.asarray(pallas_lse[..., 0]))
    _, ratios = cs.compare({"plain": [(o, ref_o), (lse, ref_lse)],
                            "pallas": [(o, pallas_o), (lse, pallas_lse)]})
    assert all(r <= 1.0 for r in ratios.values()), ratios
    once_o, _ = _fwd_sm90_emulation(tq, tk, tv, causal, scale, split=False)
    _, once = cs.compare({"plain": [(once_o, ref_o)], "pallas": [(once_o, pallas_o)]})
    assert all(r > 1.0 for r in once.values()), once


# The Hopper backward's tiles (csrc/flash_attention.cu, DkvCfg and DqCfg):
# 128 resident rows a work item, 64 per consumer warpgroup; bwd_dkv streams
# q tiles of 64 rows (32 at D = 96, 128 and 256; at 256 in two passes of
# 128 columns, which recompute every element's terms in the same order, so
# the emulation needs no passes), bwd_dq K/V tiles of 64 keys (32 at 256).
SM90_DKV_BQ, SM90_DQ_BN = {64: 64, 96: 32, 128: 32, 256: 32}, {64: 64, 96: 64, 128: 64, 256: 32}


def _split_trunc(x, split=True):
    """The backward's hi/lo split: hi = x with its low 16 bits cleared (bf16
    toward zero), lo = bf16(x - hi) to nearest; not split, x rounded to bf16
    once."""
    if not split:
        return [x.bfloat16().float()]
    hi = (x.view(torch.int32) & -65536).view(torch.float32)
    return [hi, (x - hi).bfloat16().float()]


def _rows(x, r0, n):
    """Rows [r0, r0 + n) of [BH, R, ...] x, zero past its end (TMA's fill)."""
    out = torch.zeros((x.shape[0], n) + tuple(x.shape[2:]), dtype=torch.float32)
    m = max(0, min(n, x.shape[1] - r0))
    out[:, :m] = x[:, r0:r0 + m].float()
    return out


def _exp2_fma(s, sl2, sub):
    """ex2(fmaf(s, sl2, -sub)): the FMA rounds once."""
    return torch.exp2((s.double() * sl2.double() - sub.double()).float())


def _dkv_sm90_emulation(q, k, v, do, lse, delta, causal, scale, split=True):
    """bwd_dkv_kernel_sm90's arithmetic in torch, tile by tile in its order
    and sizes: per item of 128 k rows, each 64-row warpgroup walks the q
    tiles that see its item (from q0 = k0 when causal, skipping those wholly
    above its rows), takes the masked path only on tiles that cross the
    diagonal or the end of T or S, makes P^T = exp2(S^T * scale * log2(e) -
    lse * log2(e)) and dS^T / scale = P^T (dP^T - delta), splits each into hi
    (truncated) and lo, and adds both products into f32 dK and dV; dK takes
    the scale when the item ends. Returns (dk, dv), [BH, S, D] f32."""
    BH, T, D = q.shape
    S, bq = k.shape[1], SM90_DKV_BQ[D]
    f32 = torch.float32
    sl2 = torch.tensor(scale, dtype=f32) * torch.tensor(_LOG2E, dtype=f32)
    lse2 = lse.float() * torch.tensor(_LOG2E, dtype=f32)
    dk, dv = (torch.zeros(BH, S, D, dtype=f32) for _ in range(2))
    n_qt = -(-T // bq)
    for k0 in range(0, S, SM90_BQ):
        for row0 in (k0, k0 + 64):  # the two consumer warpgroups
            kk, vv = _rows(k, row0, 64), _rows(v, row0, 64)
            kp = torch.arange(row0, row0 + 64)[:, None]
            dka, dva = (torch.zeros(BH, 64, D, dtype=f32) for _ in range(2))
            qt0 = k0 // bq if causal else 0
            t0 = (row0 - k0) // bq if causal else 0
            for qt in range(qt0 + t0, n_qt):
                q0 = qt * bq
                qq, dd = _rows(q, q0, bq), _rows(do, q0, bq)
                l2, dl = _rows(lse2[..., None], q0, bq)[..., 0], _rows(delta[..., None], q0, bq)[..., 0]
                st = torch.einsum("bkd,bqd->bkq", kk, qq)
                dpt = torch.einsum("bkd,bqd->bkq", vv, dd)
                p = _exp2_fma(st, sl2, l2[:, None, :])
                ds = p * (dpt - dl[:, None, :])
                if q0 + bq > T or row0 + 64 > S or (causal and q0 < row0 + 63):
                    qp = torch.arange(q0, q0 + bq)[None, :]
                    ok = (qp < T) & (kp < S) & ((qp >= kp) if causal else True)
                    p, ds = torch.where(ok, p, 0.0), torch.where(ok, ds, 0.0)
                for t in _split_trunc(p, split):
                    dva += torch.einsum("bkq,bqd->bkd", t, dd)
                for t in _split_trunc(ds, split):
                    dka += torch.einsum("bkq,bqd->bkd", t, qq)
            n = max(0, min(64, S - row0))
            dk[:, row0:row0 + n] = (dka * scale)[:, :n]
            dv[:, row0:row0 + n] = dva[:, :n]
    return dk, dv


def _dq_sm90_emulation(q, k, v, do, lse, delta, causal, scale, split=True):
    """bwd_dq_kernel_sm90's arithmetic in torch, tile by tile in its order
    and sizes: per item of 128 q rows, each 64-row warpgroup walks the K/V
    tiles up to the item's diagonal, takes the masked path only on tiles on
    the diagonal or past S, makes P and dS / scale = P (dP - delta), splits
    dS into hi (truncated) and lo and adds both products into f32 dQ, which
    takes the scale when the item ends. Returns dq, [BH, T, D] f32."""
    BH, T, D = q.shape
    S, bn = k.shape[1], SM90_DQ_BN[D]
    f32 = torch.float32
    sl2 = torch.tensor(scale, dtype=f32) * torch.tensor(_LOG2E, dtype=f32)
    lse2 = lse.float() * torch.tensor(_LOG2E, dtype=f32)
    dq = torch.zeros(BH, T, D, dtype=f32)
    for q0 in range(0, T, SM90_BQ):
        n = -(-S // bn)
        if causal:
            n = min(n, (q0 + SM90_BQ - 1) // bn + 1)  # stop at the diagonal tile
        for row0 in (q0, q0 + 64):
            qq, dd = _rows(q, row0, 64), _rows(do, row0, 64)
            l2, dl = _rows(lse2[..., None], row0, 64), _rows(delta[..., None], row0, 64)
            qp = torch.arange(row0, row0 + 64)[:, None]
            dqa = torch.zeros(BH, 64, D, dtype=f32)
            for k0 in range(0, n * bn, bn):
                kk, vv = _rows(k, k0, bn), _rows(v, k0, bn)
                s = torch.einsum("bqd,bkd->bqk", qq, kk)
                dp = torch.einsum("bqd,bkd->bqk", dd, vv)
                p = _exp2_fma(s, sl2, l2)
                ds = p * (dp - dl)
                if k0 + bn > S or (causal and k0 + bn - 1 > row0):
                    kp = torch.arange(k0, k0 + bn)[None, :]
                    ok = (kp < S) & ((qp >= kp) if causal else True)
                    ds = torch.where(ok, ds, 0.0)
                for t in _split_trunc(ds, split):
                    dqa += torch.einsum("bqk,bkd->bqd", t, kk)
            m = max(0, min(64, T - row0))
            dq[:, row0:row0 + m] = (dqa * scale)[:, :m]
    return dq


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T,S", [(1, 1), (100, 100), (1000, 1000), (100, 300), (300, 100)])
@pytest.mark.parametrize("D", [64, 128])
def test_sm90_backward_arithmetic_holds_the_smoke_limits(D, T, S, causal):
    """The Hopper backward's arithmetic (B3 and B4), emulated on bf16 inputs,
    against the plain versions and against the Pallas kernels (interpret
    mode) within chip_smoke.py's limits, on the plain forward's lse and
    delta; with P and dS rounded to bf16 once instead of split, it misses
    them where a long row sums many products (T = S = 1000)."""
    _check_sm90_backward(D, T, S, causal)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T,S", [(1, 1), (100, 100), (1000, 1000), (100, 300), (300, 100)])
@pytest.mark.parametrize("D", [96, 256])
def test_sm90_backward_arithmetic_at_wide_head_dims(D, T, S, causal):
    """As test_sm90_backward_arithmetic_holds_the_smoke_limits, with the
    tiles of the D = 96 and D = 256 backward kernels."""
    _check_sm90_backward(D, T, S, causal)


def _check_sm90_backward(D, T, S, causal):
    cs = importlib.import_module("chip_smoke")
    rs = np.random.RandomState(13)
    q, do = (rs.randn(2, T, D).astype(np.float32) for _ in range(2))
    k, v = (rs.randn(2, S, D).astype(np.float32) for _ in range(2))
    scale = D ** -0.5
    tq, tk, tv, tdo = (_t(x).bfloat16() for x in (q, k, v, do))
    ref_o, lse = _flash_fwd_ref(tq, tk, tv, causal, scale, with_lse=True)
    delta = (tdo.float() * ref_o.float()).sum(-1)
    args = (tq, tk, tv, tdo, lse, delta)
    dq = _dq_sm90_emulation(*args, causal, scale)
    dk, dv = _dkv_sm90_emulation(*args, causal, scale)
    ref_dq = _flash_bwd_dq_ref(*args, causal, scale)
    ref_dk, ref_dv = _flash_bwd_dkv_ref(*args, causal, scale)
    jq, jk, jv, jdo = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v, do))
    jl, jd = (jnp.broadcast_to(jnp.asarray(x.numpy())[..., None], (2, T, 8)) for x in (lse, delta))
    kw = dict(causal=causal, scale=scale, block_q=128, block_k=128, interpret=True)
    pallas_dq = _t(np.asarray(_flash_bwd_dq(jq, jk, jv, jdo, jl, jd, **kw)))
    pallas_dk, pallas_dv = (_t(np.asarray(x)) for x in _flash_bwd_dkv(jq, jk, jv, jdo, jl, jd, **kw))
    _, ratios = cs.compare({"plain_dq": [(dq, ref_dq)], "plain_dkv": [(dk, ref_dk), (dv, ref_dv)],
                            "pallas_dq": [(dq, pallas_dq)],
                            "pallas_dkv": [(dk, pallas_dk), (dv, pallas_dv)]})
    assert all(r <= 1.0 for r in ratios.values()), ratios
    if T == S == 1000:
        once_dq = _dq_sm90_emulation(*args, causal, scale, split=False)
        once_dk, once_dv = _dkv_sm90_emulation(*args, causal, scale, split=False)
        _, once = cs.compare({"dq": [(once_dq, ref_dq)], "dkv": [(once_dk, ref_dk), (once_dv, ref_dv)]})
        assert all(r > 1.0 for r in once.values()), once


@pytest.mark.parametrize("broken", ["ds_rounded_once", "drops_diagonal_tile"])
def test_gradient_check_sees_a_lost_tile_not_a_once_rounded_ds(broken, monkeypatch):
    """chip_smoke.py's first-step gradient check, run here through the plain
    versions with dq broken as two of tests/test_torch_cuda.py's mutants
    break bwd_dq_kernel_sm90, on that file's model. A dq that stops one
    64-key tile short of each 128-row item's diagonal (which loses the
    diagonal keys of the item's second 64 rows) fails the check. A dq whose
    dS was rounded to bf16 once passes it: that error is below the bf16
    path's own, so only the element limits of phase 2 catch it."""
    cs = importlib.import_module("chip_smoke")
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    tr = importlib.import_module("ray_tpu_torch.models.transformer")

    def broken_dq(q, k, v, do, lse, delta, causal, scale):
        _, ds = _bwd_tile_ref(q, k, v, do, lse, delta, causal, scale)
        if broken == "ds_rounded_once":
            ds = ds.bfloat16().float()
        else:  # keys up to the end of the 64-key tile before the item's last
            rows, keys = torch.arange(q.shape[1]), torch.arange(k.shape[1])
            ds = ds * (keys[None, :] < (rows // 128 * 128 + 64)[:, None])
        return torch.einsum("bts,bsd->btd", ds, k.float())

    monkeypatch.setattr(fa, "_flash_bwd_dq_ref", broken_dq)
    dev = torch.device("cpu")
    cfg = tr.TransformerConfig(vocab_size=512, d_model=256, n_layers=2, n_heads=4,
                               max_seq_len=1024, dtype=torch.bfloat16, attention_impl="kernel")
    g = torch.Generator(device=dev).manual_seed(0)
    raw = torch.randint(0, cfg.vocab_size, (2, 1025), generator=g)
    batch = {"tokens": raw[:, :-1].contiguous(), "targets": raw[:, 1:].contiguous()}
    model = tr.transformer_init(cfg, g, device=dev)
    if broken == "ds_rounded_once":
        cs.grads_check(tr, cfg, dev, model, batch)
    else:
        with pytest.raises(cs.SmokeFailure, match="gradients"):
            cs.grads_check(tr, cfg, dev, model, batch)


def test_build_report_parsers():
    """chip_smoke.py's readers of ptxas -v and cuobjdump -sass output: the
    Hopper kernels' mangled names (nvcc's file-scoped anonymous namespace,
    CUtensorMap parameters), their HGMMA (wgmma) apart from HMMA (mma.sync),
    and ptxas's warnings where it serialized a kernel's wgmma, in either of
    its wordings."""
    cs = importlib.import_module("chip_smoke")
    fwd = "_ZN12_GLOBAL__N_113fwd_kernel_tcILi64ELb1ELb0EEEvPK13__nv_bfloat16S3_S3_PS1_Pfiif"
    sm90 = ("_ZN51_GLOBAL__N__c4b42d03_18_flash_attention_cu_e1dd8ece15fwd_kernel_sm90ILi64ELb1ELb0EEEv"
            "14CUtensorMap_stS1_S1_P13__nv_bfloat16Pfiiif")
    sm90_nc = sm90.replace("ILi64ELb1ELb0EE", "ILi128ELb0ELb1EE")
    dq = "_ZN12_GLOBAL__N_113bwd_dq_kernelI13__nv_bfloat16Li128ELb0EEEvPKT_S4_S4_S4_PKfS6_Pfiif"
    dq_tc = "_ZN12_GLOBAL__N_116bwd_dq_kernel_tcILi64ELb1EEEvPK13__nv_bfloat16S3_S3_S3_PKfS5_Pfiif"
    old = "_ZN12_GLOBAL__N_110fwd_kernelIfLi64ELb1ELb1EEEvPKT_S4_S4_PS2_Pfiif"
    ns = "_ZN51_GLOBAL__N__c4b42d03_18_flash_attention_cu_e1dd8ece"
    dkv_sm90 = ns + "19bwd_dkv_kernel_sm90ILi128ELb0EEEv14CUtensorMap_stS1_S1_S1_PKfS3_PfS4_iiif"
    dq_sm90 = ns + "18bwd_dq_kernel_sm90ILi64ELb1EEEv14CUtensorMap_stS1_S1_S1_PKfS3_Pfiiif"
    assert cs.kernel_label(dkv_sm90) == "bwd_dkv_kernel_sm90<128,false>"
    assert cs.kernel_label(dq_sm90) == "bwd_dq_kernel_sm90<64,true>"
    assert cs.kernel_label(fwd) == "fwd_kernel_tc<64,true,false>"
    assert cs.kernel_label(sm90) == "fwd_kernel_sm90<64,true,false>"
    assert cs.kernel_label(sm90_nc) == "fwd_kernel_sm90<128,false,true>"
    assert cs.kernel_label(dq) == "bwd_dq_kernel<bf16,128,false>"
    assert cs.kernel_label(dq_tc) == "bwd_dq_kernel_tc<64,true>"
    assert cs.kernel_label(old) == "fwd_kernel<f32,64,true,true>"
    assert cs.kernel_label("_Z3foov") == "_Z3foov"
    log = (f"ptxas info    : Compiling entry function '{fwd}' for 'sm_90a'\n"
           f"ptxas info    : Function properties for {fwd}\n"
           "    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads\n"
           "ptxas info    : Used 168 registers, used 1 barriers, 380 bytes cmem[0]\n"
           f"ptxas info    : Compiling entry function '{dq_tc}' for 'sm_90a'\n"
           f"ptxas info    : Function properties for {dq_tc}\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 154 registers, used 1 barriers, 380 bytes cmem[0]\n"
           f"ptxas info    : Compiling entry function '{sm90}' for 'sm_90a'\n"
           f"ptxas info    : Function properties for {sm90}\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 168 registers, used 16 barriers\n"
           "ptxas info    : (C7520) Potential Performance Loss: wgmma.mma_async instructions are "
           "serialized due to program dependence on compiler-inserted WG.AR in divergent path in the "
           f"function '{sm90}'\n"
           f"ptxas info    : Compiling entry function '{dkv_sm90}' for 'sm_90a'\n"
           f"ptxas info    : Function properties for {dkv_sm90}\n"
           "    24 bytes stack frame, 20 bytes spill stores, 24 bytes spill loads\n"
           "ptxas info    : Used 168 registers, used 16 barriers\n"
           "ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async instructions are "
           f"serialized due to insufficient register resources for the function '{dkv_sm90}'\n"
           f"ptxas info    : Compiling entry function '{dq_sm90}' for 'sm_90a'\n"
           f"ptxas info    : Function properties for {dq_sm90}\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 168 registers, used 16 barriers\n")
    assert cs.ptxas_report(log) == {
        "fwd_kernel_tc<64,true,false>": {"registers": 168, "spill_stores": 8, "spill_loads": 12},
        "bwd_dq_kernel_tc<64,true>": {"registers": 154, "spill_stores": 0, "spill_loads": 0},
        "fwd_kernel_sm90<64,true,false>": {
            "registers": 168, "spill_stores": 0, "spill_loads": 0,
            "wgmma_serialized": "program dependence on compiler-inserted WG.AR in divergent path"},
        "bwd_dkv_kernel_sm90<128,false>": {
            "registers": 168, "spill_stores": 20, "spill_loads": 24,
            "wgmma_serialized": "insufficient register resources"},
        "bwd_dq_kernel_sm90<64,true>": {"registers": 168, "spill_stores": 0, "spill_loads": 0}}
    sass = (f"\t\tFunction : {fwd}\n        /*0100*/  HMMA.16816.F32.BF16 R4, R8, R12, R4 ;\n"
            "        /*0110*/  HMMA.16816.F32.BF16 R16, R8, R14, R16 ;\n"
            f"\t\tFunction : {sm90}\n"
            "        /*0200*/  HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT, gsb0 ;\n"
            "        /*0210*/  HGMMA.64x64x16.F32.BF16 R88, R152, gdesc[UR8], R88, gsb0 ;\n"
            "        /*0220*/  WARPGROUP.DEPBAR.LE gsb0, 0x0 ;\n"
            f"\t\tFunction : {dq_tc}\n        /*0100*/  HMMA.16816.F32.BF16 R4, R8, R12, R4 ;\n"
            f"\t\tFunction : {old}\n        /*0100*/  FFMA R1, R2, R3, R1 ;\n"
            f"\t\tFunction : {dq_sm90}\n"
            "        /*0300*/  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT, gsb0 ;\n")
    assert cs.sass_mma(sass) == {"fwd_kernel_tc<64,true,false>": {"hmma": 2, "hgmma": 0},
                                 "fwd_kernel_sm90<64,true,false>": {"hmma": 0, "hgmma": 2},
                                 "bwd_dq_kernel_tc<64,true>": {"hmma": 1, "hgmma": 0},
                                 "fwd_kernel<f32,64,true,true>": {"hmma": 0, "hgmma": 0},
                                 "bwd_dq_kernel_sm90<64,true>": {"hmma": 0, "hgmma": 1}}
    # The build check refuses a Hopper kernel that spills or whose wgmma ptxas
    # serialized, and a build without all of them.
    good = {"hgmma": 8, "spill_stores": 0, "spill_loads": 0}
    report = {f"fwd_kernel_sm90<{i}>": dict(good) for i in range(cs.N_SM90_KERNELS)}
    cs.check_sm90(report)
    for bad in ({"spill_stores": 4}, {"wgmma_serialized": "insufficient register resources"},
                {"hgmma": 0}):
        with pytest.raises(cs.SmokeFailure):
            cs.check_sm90({**report, "fwd_kernel_sm90<0>": {**good, **bad}})
    with pytest.raises(cs.SmokeFailure):
        cs.check_sm90({k: r for k, r in report.items() if k != "fwd_kernel_sm90<0>"})


def test_library_hash_covers_headers_beside_the_source(tmp_path, monkeypatch):
    """A library is named by the hash of its source, every header under
    csrc/ (any of which it may include) and the flags: editing a header
    names a new library, so a stale one is never loaded."""
    from ray_tpu_torch.ops import _build

    (tmp_path / "k.cu").write_text('#include "k.cuh"\n')
    (tmp_path / "inc").mkdir()
    (tmp_path / "k.cuh").write_text("constexpr int kTile = 64;\n")
    (tmp_path / "inc" / "deep.cuh").write_text("// nested\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path("k")
    assert first == _build.library_path("k") and first.name.startswith("k-")
    (tmp_path / "k.cuh").write_text("constexpr int kTile = 128;\n")
    second = _build.library_path("k")
    (tmp_path / "inc" / "deep.cuh").write_text("// nested, edited\n")
    third = _build.library_path("k")
    (tmp_path / "other.cu").write_text("// another library's source\n")
    assert len({first, second, third}) == 3 and _build.library_path("k") == third
    monkeypatch.setattr(_build, "NVCC_FLAGS", (*_build.NVCC_FLAGS, "-lineinfo"))
    assert _build.library_path("k") != third


def test_mha_auto_takes_plain_path_on_cpu_and_rejects_unknown_impl():
    q = torch.randn(1, 8, 2, 16)
    np.testing.assert_allclose(mha(q, q, q, causal=True).numpy(),
                               mha(q, q, q, causal=True, impl="torch").numpy())
    with pytest.raises(ValueError):
        mha(q, q, q, impl="pallas")


@pytest.mark.parametrize("B", [1, 3])
def test_to_bhtd_is_contiguous_for_every_batch(B):
    """The kernels take contiguous [BH, T, D]: with a batch of one (a Serve
    replica's lone request) the transposed reshape alone is a strided view."""
    from ray_tpu_torch.ops.flash_attention import _to_bhtd

    x = torch.randn(B, 5, 4, 8)
    for rep in (1, 2):
        got = _to_bhtd(x, rep)
        assert got.is_contiguous()
        want = x.repeat_interleave(rep, dim=2).permute(0, 2, 1, 3).reshape(B * 4 * rep, 5, 8)
        assert torch.equal(got, want)
