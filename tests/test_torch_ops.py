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
