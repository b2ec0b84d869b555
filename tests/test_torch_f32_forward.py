"""The f32 forward on Hopper's tensor cores (fwd_kernel_sm90_f32 and its split
pass, csrc/flash_attention.cu) on the CPU: the split pass's plain version,
and an emulation of the kernel's arithmetic, tile by tile in its order and
sizes, against the f32 plain version and against the JAX package's Pallas
forward in interpret mode, within chip_smoke.py's F32_ATOL. The emulation
settles the kernel's product set: three bf16 products a f32 product (hi.hi,
hi.lo, lo.hi) in S = Q.K^T and in P.V hold the limit, and leaving out any
one of them misses it. The same at 512 and 1024 for the streamed forward
(fwd_kernel_sm90_stream at P = 2): 64-row items, 32-key tiles, and S summed
chunk by chunk over 64 columns of D in the kernel's order."""

import importlib

import numpy as np
import pytest

from ray_tpu.testing import force_cpu_mesh

force_cpu_mesh(8)  # before first backend use, like every jax-facing test

import jax  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ray_tpu.ops.flash_attention import _flash_fwd  # noqa: E402

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


# The f32 forward's tiles (F32FwdCfg): 128 q rows a work item, two consumer
# warpgroups of 64; 128 keys a K/V tile at D = 32 and 64, 64 at 96 and 128,
# 16 at 256.
ROWS, BN = 128, {32: 128, 64: 128, 96: 64, 128: 64, 256: 16}
# The streamed forward's (StreamCfg<2>): 64 q rows an item (both consumer
# warpgroups on all of them), 32-key tiles, S's contraction in chunks of 64
# columns of D (each in two bf16 parts).
STREAM_ROWS, STREAM_BN, STREAM_CHUNK = 64, 32, 64
STREAM_WIDTHS = (512, 1024)
_LOG2E, _LN2 = 1.4426950408889634, 0.6931471805599453
# (part of the first operand, part of the second): 0 = hi, 1 = lo.
PRODUCTS = ((0, 0), (0, 1), (1, 0))


def _qkv(seed, BH, T, D):
    rs = np.random.RandomState(seed)
    return [rs.randn(BH, T, D).astype(np.float32) for _ in range(3)]


def _parts(x):
    """x's hi and lo parts as f32 tensors (split_kernel's and split_p's split)."""
    return [p.float() for p in fa._split_ref(x.float())]


def _products(a, b, eq, products):
    """The sum of the parts' products einsum(eq, a_i, b_j) over `products`."""
    return sum(torch.einsum(eq, a[i], b[j]) for i, j in products)


def _rows(x, r0, n):
    """Rows [r0, r0 + n) of [BH, R, D] x, zero past its end (TMA's fill)."""
    out = torch.zeros(x.shape[0], n, x.shape[2], dtype=torch.float32)
    m = max(0, min(n, x.shape[1] - r0))
    out[:, :m] = x[:, r0:r0 + m]
    return out


def f32_forward_emulation(q, k, v, causal, scale, s_products=PRODUCTS, pv_products=PRODUCTS, *,
                          rows=ROWS, bn=None, chunk=None):
    """fwd_kernel_sm90_f32's arithmetic in torch, tile by tile in its order
    and sizes (or, with rows, bn and chunk, fwd_kernel_sm90_stream's at P =
    2: S summed over D's chunks of `chunk` columns, chunk by chunk, each
    chunk's products in turn): q, k and v split into hi and lo parts (the
    split pass); per K/V tile, S as the sum of the `s_products` of Q's and
    K's parts; each
    64-row warpgroup takes the masked path only on the diagonal or past S
    (as the kernel decides), the running max in log2 units with scale *
    log2(e) folded into one FMA, exp2, the rescale of the sums made under
    the old max; P split into hi and lo on chip, and P.V as the sum of the
    `pv_products` of P's and V's parts, added to the f32 sums, which are
    rescaled after the previous tile's P.V has landed; o is those sums
    times 1 / l. Returns (o, lse), both f32."""
    BH, T, D = q.shape
    S, bn, ROWS = k.shape[1], bn or BN[D], rows
    f32 = torch.float32
    sl2 = torch.tensor(scale, dtype=f32) * torch.tensor(_LOG2E, dtype=f32)
    big_neg = torch.tensor(-1e30, dtype=f32)
    qp, kp, vp = _parts(q), _parts(k), _parts(v)
    o = torch.empty(BH, T, D, dtype=f32)
    lse = torch.empty(BH, T, dtype=f32)
    for q0 in range(0, T, ROWS):
        rows = torch.arange(q0, q0 + ROWS)
        qt = [_rows(x, q0, ROWS) for x in qp]
        n = -(-S // bn)
        if causal:
            n = min(n, (q0 + ROWS - 1) // bn + 1)  # tiles above the diagonal are skipped
        m = torch.full((BH, ROWS), -1e30, dtype=f32)
        l = torch.zeros(BH, ROWS, dtype=f32)
        acc = torch.zeros(BH, ROWS, D, dtype=f32)
        pv = None  # P.V of the previous tile, added before this tile's rescale
        for k0 in range(0, n * bn, bn):
            kt, vt = [_rows(x, k0, bn) for x in kp], [_rows(x, k0, bn) for x in vp]
            if chunk is None:
                s = _products(qt, kt, "btd,bsd->bts", s_products)
            else:  # S = sum_c Q_c.K_c^T, chunk by chunk in the kernel's order
                s = 0
                for c0 in range(0, D, chunk):
                    s = s + _products([x[..., c0:c0 + chunk] for x in qt], [x[..., c0:c0 + chunk] for x in kt],
                                      "btd,bsd->bts", s_products)
            keys = torch.arange(k0, k0 + bn)
            ok = (keys[None, :] < S) & ((rows[:, None] >= keys[None, :]) if causal else True)
            ok = ok.expand(ROWS, bn)
            p, alpha = torch.empty_like(s), torch.empty_like(m)
            for w0 in range(0, ROWS, 64):  # one consumer warpgroup's rows
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
            pv = _products(_parts(p), vt, "bts,bsd->btd", pv_products)
        lsafe = l.clamp_min(1e-30)
        keep = rows < T
        o[:, rows[keep]] = ((acc + pv) * (1 / lsafe)[..., None])[:, keep]
        lse[:, rows[keep]] = (m * _LN2 + torch.log(lsafe))[:, keep]
    return o, lse


def _pallas(q, k, v, causal, scale):
    """The JAX package's forward (Pallas, interpret mode) at f32: (o, lse)."""
    po, plse = _flash_fwd(*(jnp.asarray(x) for x in (q, k, v)), causal=causal, scale=scale,
                          block_q=128, block_k=128, interpret=True, with_lse=True)
    return torch.from_numpy(np.array(po)), torch.from_numpy(np.array(plse[..., 0]))


# ---------------------------------------------------------------- the split

def _split_values():
    """Seeded normals, large and tiny normals, and subnormals on bf16's grid
    (multiples of 2^-133, its smallest subnormal), with both signs."""
    rs = np.random.RandomState(5)
    normal = rs.randn(4096)
    large = rs.uniform(1, 2, 512) * 2.0 ** rs.randint(60, 127, 512)
    tiny = rs.uniform(1, 2, 512) * 2.0 ** rs.randint(-126, -60, 512)
    sub = rs.randint(1, 2 ** 7, 512) * 2.0 ** -133
    x = np.concatenate([normal, large, tiny, sub, [0.0, 3.3e38, 2.0 ** -126]])
    x = (x * np.where(rs.rand(x.size) < 0.5, -1, 1)).astype(np.float32)
    return torch.from_numpy(x)


def test_split_parts_are_bf16_rounding_and_its_remainder():
    """hi = bf16(x) and lo = bf16(x - hi), both to nearest, bitwise; x - hi
    is exact in f32, and hi + lo + (x - hi - lo) == x bitwise, the part the
    kernel leaves out at most 2^-16 |x| (half a bf16 ulp of x - hi, itself at
    most half a bf16 ulp of x); below 2^-110, where lo lies among bf16's
    subnormals (multiples of 2^-133), at most 2^-134."""
    x = _split_values()
    hi, lo = fa._split_ref(x)
    assert hi.dtype == lo.dtype == torch.bfloat16 and hi.shape == lo.shape == x.shape
    assert torch.equal(hi, x.to(torch.bfloat16))
    rest = x - hi.float()
    assert torch.equal(lo, rest.to(torch.bfloat16))
    dropped = rest - lo.float()
    assert torch.equal(hi.float() + lo.float() + dropped, x)
    assert torch.equal((x.double() - hi.double()).float(), rest)  # x - hi is exact
    assert bool((dropped.abs() <= torch.clamp(2.0 ** -16 * x.abs(), min=2.0 ** -134)).all())
    assert bool((dropped[x.abs() >= 2.0 ** -110].abs() <= 2.0 ** -16 * x[x.abs() >= 2.0 ** -110].abs()).all())


def test_split_on_bf16_values_is_exact():
    """A value bf16 holds splits into itself and 0: bf16 operands lose
    nothing on the f32 route."""
    x = torch.randn(1000).to(torch.bfloat16).float()
    hi, lo = fa._split_ref(x)
    assert torch.equal(hi.float(), x) and not lo.float().any()


def test_split_parts_shapes_on_the_cpu():
    """split_parts on CPU tensors is the plain version, [2, *shape] each."""
    q, k, v = (torch.randn(3, n, 64) for n in (5, 7, 7))
    for part, x in zip(fa.split_parts(q, k, v), (q, k, v)):
        assert part.shape == (2, *x.shape) and torch.equal(part, fa._split_ref(x))


# ----------------------------------------------------- the kernel's arithmetic

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [192, 1000])
@pytest.mark.parametrize("D", [32, 64, 96, 128, 256])
def test_f32_forward_arithmetic_holds_the_smoke_limit(D, T, causal):
    """The kernel's product set, emulated on f32 inputs, within F32_ATOL of
    the f32 plain version and of the Pallas forward (interpret mode), o and
    lse; at most half of it against the plain version (the kernel's own
    margin, which the card's plain version in another order may take)."""
    q, k, v = _qkv(23 + D, 2, T, D)
    scale = D ** -0.5
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    o, lse = f32_forward_emulation(tq, tk, tv, causal, scale)
    ref_o, ref_lse = fa._flash_fwd_ref(tq, tk, tv, causal, scale, with_lse=True)
    pallas_o, pallas_lse = _pallas(q, k, v, causal, scale)
    _, ratios = cs.compare({"plain": [(o, ref_o), (lse, ref_lse)],
                            "pallas": [(o, pallas_o), (lse, pallas_lse)]})
    assert ratios["plain"] <= 0.5 and ratios["pallas"] <= 1.0, ratios


# Each set one product smaller than the kernel's: S or P.V without one of its
# three products (P.V without P_lo.V_hi is P rounded once to bf16).
SMALLER = {f"{where}_without_{'hl'[i]}{'hl'[j]}": (where, (i, j))
           for where in ("s", "pv") for i, j in PRODUCTS}


@pytest.mark.parametrize("name", list(SMALLER))
def test_next_smaller_product_set_misses_the_smoke_limit(name):
    """Leaving out any one of the three products of S or of P.V misses
    F32_ATOL against the plain version, at every head dim, on one causal
    case (its first rows see few keys, so a rounded V is not averaged
    away)."""
    where, dropped = SMALLER[name]
    kept = tuple(p for p in PRODUCTS if p != dropped)
    sets = {"s_products": kept} if where == "s" else {"pv_products": kept}
    for D in (32, 64, 96, 128, 256):
        q, k, v = (torch.from_numpy(x) for x in _qkv(29 + D, 2, 192, D))
        scale = D ** -0.5
        o, lse = f32_forward_emulation(q, k, v, True, scale, **sets)
        ref_o, ref_lse = fa._flash_fwd_ref(q, k, v, True, scale, with_lse=True)
        _, ratios = cs.compare({"fwd": [(o, ref_o), (lse, ref_lse)]})
        assert ratios["fwd"] > 1.0, (D, ratios)


def _stream_emulation(q, k, v, causal, scale, **sets):
    return f32_forward_emulation(q, k, v, causal, scale, rows=STREAM_ROWS, bn=STREAM_BN, chunk=STREAM_CHUNK,
                                 **sets)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", STREAM_WIDTHS)
def test_streamed_f32_forward_arithmetic_holds_the_smoke_limit(D, causal):
    """The streamed forward's arithmetic at P = 2 (S's contraction chunk by
    chunk over D), emulated on f32 inputs at 512 and 1024, T = 192: within
    half of F32_ATOL of the f32 plain version and within F32_ATOL of the
    Pallas forward (interpret mode), o and lse, as at 64-256."""
    q, k, v = _qkv(41 + D, 2, 192, D)
    scale = D ** -0.5
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    o, lse = _stream_emulation(tq, tk, tv, causal, scale)
    ref_o, ref_lse = fa._flash_fwd_ref(tq, tk, tv, causal, scale, with_lse=True)
    pallas_o, pallas_lse = _pallas(q, k, v, causal, scale)
    _, ratios = cs.compare({"plain": [(o, ref_o), (lse, ref_lse)],
                            "pallas": [(o, pallas_o), (lse, pallas_lse)]})
    assert ratios["plain"] <= 0.5 and ratios["pallas"] <= 1.0, ratios


@pytest.mark.parametrize("name", list(SMALLER))
def test_streamed_next_smaller_product_set_misses_the_smoke_limit(name):
    """As at 64-256: the streamed forward's S or P.V without any one of its
    three products misses F32_ATOL against the plain version at 512 and
    1024, on one causal case."""
    where, dropped = SMALLER[name]
    kept = tuple(p for p in PRODUCTS if p != dropped)
    sets = {"s_products": kept} if where == "s" else {"pv_products": kept}
    for D in STREAM_WIDTHS:
        q, k, v = (torch.from_numpy(x) for x in _qkv(43 + D, 2, 192, D))
        scale = D ** -0.5
        o, lse = _stream_emulation(q, k, v, True, scale, **sets)
        ref_o, ref_lse = fa._flash_fwd_ref(q, k, v, True, scale, with_lse=True)
        _, ratios = cs.compare({"fwd": [(o, ref_o), (lse, ref_lse)]})
        assert ratios["fwd"] > 1.0, (D, ratios)


def test_build_check_counts_the_f32_hopper_kernels():
    """chip_smoke.py's build check reads the f32 Hopper kernels' mangled
    names (fwd_kernel_sm90_f32, bwd_dq_kernel_sm90_f32,
    bwd_dkv_kernel_sm90_f32) and the streamed kernels'
    (fwd_kernel_sm90_stream, bwd_dq_kernel_sm90_stream,
    bwd_dkv_kernel_sm90_stream) and counts their 40 and 16 instantiations
    among the 104 Hopper kernels: a build that lacks one, or where one
    spills, fails it."""
    ns = "_ZN51_GLOBAL__N__c4b42d03_18_flash_attention_cu_e1dd8ece"
    f32 = ns + "19fwd_kernel_sm90_f32ILi256ELb1ELb0EEEv14CUtensorMap_stS1_S1_PfS2_iiif"
    assert cs.kernel_label(f32) == "fwd_kernel_sm90_f32<256,true,false>"
    dq = ns + "22bwd_dq_kernel_sm90_f32ILi96ELb0EEEv14CUtensorMap_stS1_S1_S1_PKfS3_Pfiiif"
    assert cs.kernel_label(dq) == "bwd_dq_kernel_sm90_f32<96,false>"
    dkv = ns + "23bwd_dkv_kernel_sm90_f32ILi128ELb1EEEv14CUtensorMap_stS1_S1_S1_PKfS3_PfS4_iiif"
    assert cs.kernel_label(dkv) == "bwd_dkv_kernel_sm90_f32<128,true>"
    stream = ns + "22fwd_kernel_sm90_streamILi2ELb1ELb0EEEv14CUtensorMap_stS1_S1_PvPfiiiif"
    assert cs.kernel_label(stream) == "fwd_kernel_sm90_stream<2,true,false>"
    sdq = ns + "25bwd_dq_kernel_sm90_streamILi2ELb1EEEv14CUtensorMap_stS1_S1_S1_PKfS3_Pfiiiif"
    assert cs.kernel_label(sdq) == "bwd_dq_kernel_sm90_stream<2,true>"
    sdkv = ns + "26bwd_dkv_kernel_sm90_streamILi1ELb0EEEv14CUtensorMap_stS1_S1_S1_PKfS3_PfS4_iiiif"
    assert cs.kernel_label(sdkv) == "bwd_dkv_kernel_sm90_stream<1,false>"
    assert cs.N_SM90_KERNELS == 104 == 6 * (4 + 2 + 2) + 5 * (4 + 2 + 2) + 2 * 4 + 2 * (2 + 2)
    good = {"hgmma": 8, "spill_stores": 0, "spill_loads": 0}
    bf16 = {f"fwd_kernel_sm90<{i}>": dict(good) for i in range(48)}
    f32s = {f"fwd_kernel_sm90_f32<{i}>": dict(good) for i in range(20)}
    f32s.update({f"bwd_{k}_kernel_sm90_f32<{i}>": dict(good) for k in ("dq", "dkv") for i in range(10)})
    f32s.update({f"fwd_kernel_sm90_stream<{i}>": dict(good) for i in range(8)})
    f32s.update({f"bwd_{k}_kernel_sm90_stream<{i}>": dict(good) for k in ("dq", "dkv") for i in range(4)})
    cs.check_sm90({**bf16, **f32s, "fwd_kernel<f32,512,true,true>": {"hgmma": 0}})
    with pytest.raises(cs.SmokeFailure):
        cs.check_sm90(bf16)
    with pytest.raises(cs.SmokeFailure):
        cs.check_sm90({**bf16, **f32s, "fwd_kernel_sm90_f32<0>": {**good, "spill_stores": 4}})
