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
    break bwd_dq_kernel_tc, on that file's model. A dq that loses each q
    tile's diagonal key tile fails the check. A dq whose dS was rounded to
    bf16 once passes it: that error is below the bf16 path's own, so only
    the element limits of phase 2 catch it."""
    cs = importlib.import_module("chip_smoke")
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    tr = importlib.import_module("ray_tpu_torch.models.transformer")

    def broken_dq(q, k, v, do, lse, delta, causal, scale):
        _, ds = _bwd_tile_ref(q, k, v, do, lse, delta, causal, scale)
        if broken == "ds_rounded_once":
            ds = ds.bfloat16().float()
        else:  # the kernel's 64-row tiles: keep only key tiles left of the diagonal
            tile = torch.arange(q.shape[1]) // 64
            ds = ds * (tile[None, :] < tile[:, None])
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
    """chip_smoke.py's readers of ptxas -v and cuobjdump -sass output."""
    cs = importlib.import_module("chip_smoke")
    fwd = "_ZN12_GLOBAL__N_113fwd_kernel_tcILi64ELb1ELb0EEEvPK13__nv_bfloat16S3_S3_PS1_Pfiif"
    dq = "_ZN12_GLOBAL__N_113bwd_dq_kernelI13__nv_bfloat16Li128ELb0EEEvPKT_S4_S4_S4_PKfS6_Pfiif"
    dq_tc = "_ZN12_GLOBAL__N_116bwd_dq_kernel_tcILi64ELb1EEEvPK13__nv_bfloat16S3_S3_S3_PKfS5_Pfiif"
    old = "_ZN12_GLOBAL__N_110fwd_kernelIfLi64ELb1ELb1EEEvPKT_S4_S4_PS2_Pfiif"
    assert cs.kernel_label(fwd) == "fwd_kernel_tc<64,true,false>"
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
           "ptxas info    : Used 154 registers, used 1 barriers, 380 bytes cmem[0]\n")
    assert cs.ptxas_report(log) == {
        "fwd_kernel_tc<64,true,false>": {"registers": 168, "spill_stores": 8, "spill_loads": 12},
        "bwd_dq_kernel_tc<64,true>": {"registers": 154, "spill_stores": 0, "spill_loads": 0}}
    sass = (f"\t\tFunction : {fwd}\n        /*0100*/  HMMA.16816.F32.BF16 R4, R8, R12, R4 ;\n"
            "        /*0110*/  HMMA.16816.F32.BF16 R16, R8, R14, R16 ;\n"
            f"\t\tFunction : {dq_tc}\n        /*0100*/  HMMA.16816.F32.BF16 R4, R8, R12, R4 ;\n"
            f"\t\tFunction : {old}\n        /*0100*/  FFMA R1, R2, R3, R1 ;\n")
    assert cs.sass_hmma(sass) == {"fwd_kernel_tc<64,true,false>": 2, "bwd_dq_kernel_tc<64,true>": 1,
                                  "fwd_kernel<f32,64,true,true>": 0}


def test_mha_auto_takes_plain_path_on_cpu_and_rejects_unknown_impl():
    q = torch.randn(1, 8, 2, 16)
    np.testing.assert_allclose(mha(q, q, q, causal=True).numpy(),
                               mha(q, q, q, causal=True, impl="torch").numpy())
    with pytest.raises(ValueError):
        mha(q, q, q, impl="pallas")
