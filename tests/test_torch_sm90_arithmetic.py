"""The bf16 Hopper kernels' arithmetic on the CPU (fwd_kernel_sm90,
bwd_dq_kernel_sm90 and bwd_dkv_kernel_sm90, csrc/flash_attention.cu): an
emulation of each, tile by tile in its order and sizes, on bf16 inputs,
against the plain versions and against the JAX package's Pallas kernels in
interpret mode within chip_smoke.py's limits; with P and dS rounded to bf16
once instead of split into hi and lo, it misses them. Inputs come from
numpy with a seed (JAX at matmul precision "highest"). A file of its own
so that, under the suite's `--dist loadfile`, these cases run beside
tests/test_torch_ops.py's on another worker."""

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
from ray_tpu_torch.ops.flash_attention import (  # noqa: E402
    _flash_bwd_dkv_ref,
    _flash_bwd_dq_ref,
    _flash_fwd_ref,
)


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


def _t(x):
    return torch.from_numpy(np.array(x))


def _qkv(seed, BH, T, D, n=4):
    rs = np.random.RandomState(seed)
    return [rs.randn(BH, T, D).astype(np.float32) for _ in range(n)]


# The Hopper forward's tiles (csrc/flash_attention.cu, FWD_BQ and FwdCfg):
# 128 q rows a work item, two consumer warpgroups of 64; 128 keys a K/V tile
# at D = 32, 64 and 96, 64 at D = 128, 32 at 256.
SM90_BQ, SM90_BN = 128, {32: 128, 64: 128, 96: 128, 128: 64, 256: 32}
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
@pytest.mark.parametrize("D", [32, 96, 256])
def test_sm90_forward_arithmetic_at_wide_head_dims(D, T, causal):
    """As test_sm90_forward_arithmetic_holds_the_smoke_limits, with the
    tiles of the D = 32, 96 and 256 forward."""
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
# q tiles of 64 rows (at D = 32 and 64; 32 at D = 96, 128 and 256; at 256
# in two passes of 128 columns, which recompute every element's terms in
# the same order, so the emulation needs no passes), bwd_dq K/V tiles of 64
# keys (128 at 32, 32 at 256).
SM90_DKV_BQ = {32: 64, 64: 64, 96: 32, 128: 32, 256: 32}
SM90_DQ_BN = {32: 128, 64: 64, 96: 64, 128: 64, 256: 32}


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
@pytest.mark.parametrize("D", [32, 96, 256])
def test_sm90_backward_arithmetic_at_wide_head_dims(D, T, S, causal):
    """As test_sm90_backward_arithmetic_holds_the_smoke_limits, with the
    tiles of the D = 32, 96 and 256 backward kernels."""
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
