"""The port's CUDA kernels on the card: each against its plain version, the
wrappers' refusals, a small model through the kernels, and broken copies of
the kernels against chip_smoke.py's limits. Needs a CUDA card
and nvcc, so every test is marked `cuda` and skips without a card. On a
machine with an H100:

    python -m pytest tests/test_torch_cuda.py -q
"""

import ctypes
import dataclasses
import importlib
import subprocess

import pytest
import torch

pytestmark = pytest.mark.cuda

fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
tr = importlib.import_module("ray_tpu_torch.models.transformer")
_build = importlib.import_module("ray_tpu_torch.ops._build")

# f32 with TF32 off: kernel and plain version sum in different orders, as in
# tests/test_kernels_and_tensors.py:56.
ATOL = 2e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _err(a, b):
    return float((a.detach().float() - b.detach().float()).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [192, 1000])
@pytest.mark.parametrize("D", [64, 128])
def test_kernels_match_plain_versions(dev, causal, T, D, dtype):
    """f32 runs the forward on the tensor cores through the split pass and
    the backward on the CUDA cores, bf16 all four on the tensor cores; both
    are held to chip_smoke.py's limits: ATOL for f32 outputs, one bf16 ulp
    for the bf16 o."""
    cs = importlib.import_module("chip_smoke")
    g = torch.Generator(device=dev).manual_seed(T + D)
    q, k, v, do = (torch.randn(3, T, D, device=dev, generator=g).to(dtype) for _ in range(4))
    scale = D ** -0.5
    o, lse = fa.flash_fwd(q, k, v, causal=causal, scale=scale, with_lse=True)
    ref_o, ref_lse = fa._flash_fwd_ref(q, k, v, causal, scale, True)
    delta = (do.float() * ref_o.float()).sum(-1)
    dq = fa.flash_bwd_dq(q, k, v, do, ref_lse, delta, causal=causal, scale=scale)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, ref_lse, delta, causal=causal, scale=scale)
    ref_dk, ref_dv = fa._flash_bwd_dkv_ref(q, k, v, do, ref_lse, delta, causal, scale)
    torch.cuda.synchronize()
    assert cs.F32_ATOL == ATOL
    _, ratios = cs.compare({
        "fwd": [(fa.flash_fwd(q, k, v, causal=causal, scale=scale), ref_o)],
        "fwd_lse": [(o, ref_o), (lse, ref_lse)],
        "bwd_dq": [(dq, fa._flash_bwd_dq_ref(q, k, v, do, ref_lse, delta, causal, scale))],
        "bwd_dkv": [(dk, ref_dk), (dv, ref_dv)],
    })
    assert all(r <= 1.0 for r in ratios.values()), ratios


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    """Each refusal raises before any launch. At head dim 520 (past 512) the
    backward's wrappers, the autograd function and flash_attention with
    gradients refuse a dtype the kernels do not take, and parts of a width
    no kernel is built for; the same calls in f32 run, at width 1024."""
    q = torch.randn(2, 64, 64, device=dev)
    wide = torch.randn(2, 64, 520, device=dev)
    lse = torch.zeros(2, 64, device=dev)
    wide_parts = tuple(torch.zeros(2, 2, 64, 520, dtype=torch.bfloat16, device=dev) for _ in range(4))
    refused = [
        lambda: fa.flash_fwd(q.half(), q.half(), q.half(), causal=True, scale=1.0),  # dtype
        lambda: fa.flash_fwd(q, q.bfloat16(), q, causal=True, scale=1.0),  # mixed dtypes
        lambda: fa.flash_bwd_dq_parts(wide_parts, lse, lse, causal=True, scale=1.0),  # parts at 520
        lambda: fa._FlashAttention.apply(wide.half().requires_grad_(True), wide.half(), wide.half(), True, 1.0),
        lambda: fa.flash_attention(*(wide.view(2, 64, 1, 520).half().requires_grad_(True) for _ in range(3))),
        lambda: fa.flash_fwd(q.transpose(1, 2), q, q, causal=True, scale=1.0),  # strides
        lambda: fa.flash_fwd(q, q.cpu(), q, causal=True, scale=1.0),  # devices
        lambda: fa.flash_bwd_dq(q, q, q, q, lse[:, :32], lse, causal=True, scale=1.0),
        lambda: fa.flash_bwd_dkv(q, q, q, q, lse, lse.double(), causal=True, scale=1.0),
    ]
    before = dict(fa.launches)
    for call in refused:
        with pytest.raises(ValueError):
            call()
    assert fa.launches == before
    fa.reset_launches()
    fa.flash_bwd_dq(wide, wide, wide, wide, lse, lse, causal=True, scale=1.0)
    leaves = [t.clone().requires_grad_(True) for t in (wide, wide, wide)]
    torch.autograd.grad(fa._FlashAttention.apply(*leaves, True, 1.0).sum(), leaves)
    assert fa.launches_by_width == {"bwd_dq@1024": 2, "fwd_lse@1024": 1, "bwd_dkv@1024": 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [32, 80, 96, 192, 256, 320, 384, 512])
def test_kernels_match_plain_versions_at_head_dim(dev, D, causal, dtype):
    """The kernels at head dims beside 64 and 128: 32, 96, 256 and 512
    natively, 80, 192, 320 and 384 padded to the next of those; T != S, a
    partial last tile.
    chip_smoke.py's limits, and the launches count at the width run."""
    cs = importlib.import_module("chip_smoke")
    g = torch.Generator(device=dev).manual_seed(D)
    T, S = 1000, 300 if causal else 700
    q, do = (torch.randn(3, T, D, device=dev, generator=g).to(dtype) for _ in range(2))
    k, v = (torch.randn(3, S, D, device=dev, generator=g).to(dtype) for _ in range(2))
    scale = D ** -0.5
    fa.reset_launches()
    o, lse = fa.flash_fwd(q, k, v, causal=causal, scale=scale, with_lse=True)
    ref_o, ref_lse = fa._flash_fwd_ref(q, k, v, causal, scale, True)
    delta = (do.float() * ref_o.float()).sum(-1)
    args = (q, k, v, do, ref_lse, delta)
    _, ratios = cs.compare({
        "fwd": [(fa.flash_fwd(q, k, v, causal=causal, scale=scale), ref_o)],
        "fwd_lse": [(o, ref_o), (lse, ref_lse)],
        "bwd_dq": [(fa.flash_bwd_dq(*args, causal=causal, scale=scale),
                    fa._flash_bwd_dq_ref(*args, causal, scale))],
        "bwd_dkv": list(zip(fa.flash_bwd_dkv(*args, causal=causal, scale=scale),
                            fa._flash_bwd_dkv_ref(*args, causal, scale))),
    })
    assert all(r <= 1.0 for r in ratios.values()), ratios
    width = fa.kernel_width(D)
    assert fa.launches_by_width == {f"{key}@{width}": 1 for key in fa.launches}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,D,causal", [(65536, 64, True), (66560, 96, False)])
def test_kernels_take_more_than_65535_heads(dev, BH, D, causal, dtype):
    """More heads in one call than a grid's y dimension holds, as the TPU
    kernels' grid takes: every kernel against its plain version on the
    whole call, by chip_smoke.py's limits."""
    cs = importlib.import_module("chip_smoke")
    g = torch.Generator(device=dev).manual_seed(BH)
    q, k, v, do = (torch.randn(BH, 64, D, device=dev, generator=g).to(dtype) for _ in range(4))
    scale = D ** -0.5
    ref_o, ref_lse = fa._flash_fwd_ref(q, k, v, causal, scale, True)
    delta = (do.float() * ref_o.float()).sum(-1)
    args = (q, k, v, do, ref_lse, delta)
    o, lse = fa.flash_fwd(q, k, v, causal=causal, scale=scale, with_lse=True)
    _, ratios = cs.compare({
        "fwd": [(fa.flash_fwd(q, k, v, causal=causal, scale=scale), ref_o)],
        "fwd_lse": [(o, ref_o), (lse, ref_lse)],
        "bwd_dq": [(fa.flash_bwd_dq(*args, causal=causal, scale=scale),
                    fa._flash_bwd_dq_ref(*args, causal, scale))],
        "bwd_dkv": list(zip(fa.flash_bwd_dkv(*args, causal=causal, scale=scale),
                            fa._flash_bwd_dkv_ref(*args, causal, scale))),
    })
    assert all(r <= 1.0 for r in ratios.values()), ratios


def test_kernels_past_two_to_the_31_elements_on_sampled_heads(dev, monkeypatch):
    """[65600, 256, 128] bf16: each operand holds more than 2^31 elements,
    so a head's offset overflows an int. B1-B4 on the whole call, held on
    sampled heads (the first, the middle and the last) against the plain
    versions run on each head alone (chip_smoke.py's heads_cases)."""
    cs = importlib.import_module("chip_smoke")
    assert cs.HUGE_CASE[0] * cs.HUGE_CASE[1] * cs.HUGE_CASE[2] > 2**31
    assert cs.HUGE_HEADS[-1] == cs.HUGE_CASE[0] - 1
    monkeypatch.setattr(cs, "BH_CASES", ())  # the huge case alone
    cs.heads_cases(fa, dev, torch.Generator(device=dev).manual_seed(0))


@pytest.mark.parametrize("D", [8, 80, 200])
def test_entry_points_take_any_head_dim(dev, D):
    """mha, the autograd function and the ring's kernel route (loopback,
    four shards) at head dims off the kernels' widths, f32, GQA: outputs and
    gradients within ATOL of the plain attention, every launch at the next
    width."""
    from ray_tpu_torch.parallel import ring_attention_loopback

    g = torch.Generator(device=dev).manual_seed(D)
    B, T, H, Hk = 2, 256, 4, 2
    q, do = (torch.randn(B, T, H, D, device=dev, generator=g) for _ in range(2))
    k, v = (torch.randn(B, T, Hk, D, device=dev, generator=g) for _ in range(2))
    width = fa.kernel_width(D)

    def run(attend, *xs, grad=do):
        leaves = [t.clone().requires_grad_(True) for t in xs]
        o = attend(*leaves)
        return [o, *torch.autograd.grad(o, leaves, grad)]

    want = run(lambda *x: fa.mha(*x, causal=True, impl="torch"), q, k, v)
    fa.reset_launches()
    got = run(lambda *x: fa.mha(*x, causal=True, impl="kernel"), q, k, v)
    assert all(_err(a, b) <= ATOL for a, b in zip(got, want))
    kr, vr = (t.repeat_interleave(H // Hk, dim=2) for t in (k, v))
    want_rep = run(lambda *x: fa.mha(*x, causal=True, impl="torch"), q, kr, vr)
    got_ring = run(lambda *x: ring_attention_loopback(*x, 4, causal=True, impl="kernel"), q, kr, vr)
    assert all(_err(a, b) <= ATOL for a, b in zip(got_ring, want_rep))

    def bhtd(x):
        return x.transpose(1, 2).reshape(B * H, T, D).contiguous()

    got_fn = run(lambda *x: fa._FlashAttention.apply(*x, True, D ** -0.5), bhtd(q), bhtd(kr), bhtd(vr),
                 grad=bhtd(do))
    assert all(_err(a, bhtd(b)) <= ATOL for a, b in zip(got_fn, want_rep))
    assert fa.launches["bwd_dkv"] > 0
    assert all(key.endswith(f"@{width}") for key in fa.launches_by_width), fa.launches_by_width


def test_small_model_through_the_kernels_matches_plain_path(dev):
    cfg = tr.TransformerConfig(vocab_size=256, d_model=128, n_layers=2, n_heads=2,
                               n_kv_heads=1, dtype=torch.float32, attention_impl="kernel",
                               remat=True)
    model = tr.transformer_init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    plain = tr.Transformer(dataclasses.replace(cfg, attention_impl="torch"), dev)
    plain.load_state_dict(model.state_dict())
    toks = torch.randint(0, cfg.vocab_size, (2, 193), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    fa.reset_launches()
    loss = tr.transformer_loss(model, {"tokens": toks})
    loss.backward()
    assert fa.launches["fwd_lse"] == 4 and fa.launches["bwd_dq"] == fa.launches["bwd_dkv"] == 2
    ref = tr.transformer_loss(plain, {"tokens": toks})
    ref.backward()
    assert abs(loss.item() - ref.item()) <= 1e-5
    for (name, p), r in zip(model.named_parameters(), plain.parameters()):
        assert _err(p.grad, r.grad) <= ATOL, name


def test_batch_of_one_forward_through_the_kernels(dev):
    """A lone prompt (a Serve replica's batch of one) under inference_mode:
    B1 takes its [H, T, D] operands, and the logits match the plain path."""
    cfg = tr.TransformerConfig(vocab_size=256, d_model=128, n_layers=2, n_heads=2,
                               dtype=torch.float32, attention_impl="kernel")
    model = tr.transformer_init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    plain = tr.Transformer(dataclasses.replace(cfg, attention_impl="torch"), dev)
    plain.load_state_dict(model.state_dict())
    toks = torch.randint(0, cfg.vocab_size, (1, 77), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    fa.reset_launches()
    with torch.inference_mode():
        got = tr.transformer_apply(model, toks)
        want = tr.transformer_apply(plain, toks)
    assert fa.launches["fwd"] == cfg.n_layers and fa.launches["fwd_lse"] == 0
    assert _err(got, want) <= ATOL


# B3's K/V tile count, in its producer and its consumers (the forward's
# lines read the same up to their next line).
_DQ_TILES = "const int n_kv_tiles = kv_tiles<CAUSAL, BN, ROWS>(q0, seq_k);"
_DQ_PRODUCER = _DQ_TILES + "\n          mbar_wait(qdo_empty"
_DQ_CONSUMER = _DQ_TILES + "\n        const int row0 = q0 + It::row(wg);\n" \
    "        const int r0 = row0 + warp * 16 + lane / 4;  // this thread's rows: r0 and r0 + 8\n" \
    "        float lse2[2], dl[2];"


def _dq_tiles(expr):
    """B3's producer and consumers both taking `expr` K/V tiles an item."""
    return [(_DQ_PRODUCER, _DQ_PRODUCER.replace("kv_tiles<CAUSAL, BN, ROWS>(q0, seq_k)", expr)),
            (_DQ_CONSUMER, _DQ_CONSUMER.replace("kv_tiles<CAUSAL, BN, ROWS>(q0, seq_k)", expr))]


# 2-D [heads * rows, D] tensor maps, in place of the 3-D [heads, rows, D]
# ones: a box's rows past the head's end come from the next head.
_FLAT_MAPS = [
    ("const cuuint64_t dims[3] = {cuuint64_t(D), cuuint64_t(rows), cuuint64_t(heads)};",
     "const cuuint64_t dims[3] = {cuuint64_t(D), cuuint64_t(rows) * heads, 1};"),
    ("const cuuint64_t strides[2] = {cuuint64_t(D) * 2, cuuint64_t(rows) * D * 2};",
     "const cuuint64_t strides[2] = {cuuint64_t(D) * 2, cuuint64_t(rows) * heads * D * 2};"),
]

# Both backward kernels' (bf16 and f32: one body, bwd_dq_body and
# bwd_dkv_body) TMA loads of each operand's rows from flat maps: head h's
# rows (the lo part's: head h + bh) as rows of one [heads * rows, D] tensor.
_BWD_FLAT_LOADS = [
    (f"load_rows<{rows}, D>({dst}, {m}, {bar}, head + part * bh, {row});",
     f"load_rows<{rows}, D>({dst}, {m}, {bar}, 0, (head + part * bh) * {seq} + {row});")
    for rows, dst, m, bar, seq, row in (
        ("ROWS", "ks + part * ROWS * D", "k_map", "kv_full", "seq_k", "k0"),
        ("ROWS", "vs + part * ROWS * D", "v_map", "kv_full", "seq_k", "k0"),
        ("BQ", "qs + (st * P + part) * BQ * D", "q_map", "full", "seq_q", "qt * BQ"),
        ("BQ", "dos + (st * P + part) * BQ * D", "do_map", "full", "seq_q", "qt * BQ"),
        ("ROWS", "qs + part * ROWS * D", "q_map", "qdo_full", "seq_q", "q0"),
        ("ROWS", "dos + part * ROWS * D", "do_map", "qdo_full", "seq_q", "q0"),
        ("BN", "ks + (st * P + part) * BN * D", "k_map", "ring_full", "seq_k", "kt * BN"),
        ("BN", "vs + (st * P + part) * BN * D", "v_map", "ring_full", "seq_k", "kt * BN"),
    )
]

# Deliberately broken copies of the kernels' source, each built into the
# test's own directory and bound in place of the real library, to show that
# chip_smoke.py's limits fail a subtly wrong bf16 (Hopper) kernel: {name:
# [(text, broken text), ...]}; each text occurs once in the source. The
# name's first word says which kernel must miss: fwd, dq (B3), dkv (B4) or
# bwd (both).
MUTANTS = {
    # fwd_kernel_sm90 (and bwd_dq_kernel_sm90, which shares kv_tiles) drops
    # the last, partial key tile.
    "fwd_drops_partial_key_tile": [("const int n = (seq_k + BN - 1) / BN;",
                                    "const int n = seq_k / BN;")],
    # fwd_kernel_sm90 rounds P to bf16 once: it drops the P_lo.V product.
    "fwd_drops_lo_term": [("wgmma_rs(acc, p_lo[c], b);", "")],
    # fwd_kernel_sm90 reads q, k and v through flat tensor maps: rows past S
    # come from the next head instead of TMA's zero fill.
    "fwd_flat_tensor_maps": _FLAT_MAPS + [
        ("load_rows<ROWS, D>(qs, &q_map, q_full, head, q0);",
         "load_rows<ROWS, D>(qs, &q_map, q_full, 0, head * seq_q + q0);"),
        ("load_rows<BN, D>(ks + st * BN * D, &k_map, full, head, kt * BN);",
         "load_rows<BN, D>(ks + st * BN * D, &k_map, full, 0, head * seq_k + kt * BN);"),
        ("load_rows<BN, D>(vs + st * BN * D, &v_map, full, head, kt * BN);",
         "load_rows<BN, D>(vs + st * BN * D, &v_map, full, 0, head * seq_k + kt * BN);"),
    ],
    # bwd_dkv_kernel_sm90 drops the last q tile.
    "dkv_drops_last_q_tile": [("const int n_qt = (seq_q + BQ - 1) / BQ;",
                               "const int n_qt = (seq_q + BQ - 1) / BQ - 1;")],
    # bwd_dkv_kernel_sm90 starts a causal item one q tile past the diagonal.
    "dkv_drops_diagonal_tile": [
        ("for (int qt = CAUSAL ? k0 / BQ : 0; qt < n_qt; ++qt, ++it) {",
         "for (int qt = CAUSAL ? k0 / BQ + 1 : 0; qt < n_qt; ++qt, ++it) {"),
        ("const int qt0 = CAUSAL ? k0 / BQ : 0, n_t = max(n_qt - qt0, 0);",
         "const int qt0 = CAUSAL ? k0 / BQ + 1 : 0, n_t = max(n_qt - qt0, 0);")],
    # bwd_dkv_kernel_sm90 rounds P^T to bf16 once: its lo term is zero.
    "dkv_drops_lo_term": [("      split_p<true>(s, p_hi, p_lo);\n",
                           "      split_p<true>(s, p_hi, p_lo);\n"
                           "      for (auto& c : p_lo) for (auto& r : c) r = 0;\n")],
    # bwd_dq_kernel_sm90 rounds dS to bf16 once: its lo term is zero.
    "dq_drops_lo_term": [
        ("        split_p<true>(dp, ds_hi, ds_lo);\n        for (int kt = 1;",
         "        split_p<true>(dp, ds_hi, ds_lo);\n"
         "        for (auto& c : ds_lo) for (auto& r : c) r = 0;\n        for (int kt = 1;"),
        ("          split_p<true>(dp, ds_hi, ds_lo);\n          STAMP(TL",
         "          split_p<true>(dp, ds_hi, ds_lo);\n"
         "          for (auto& c : ds_lo) for (auto& r : c) r = 0;\n          STAMP(TL")],
    # bwd_dq_kernel_sm90 drops the last, partial key tile.
    "dq_drops_partial_key_tile": _dq_tiles("kv_tiles<CAUSAL, BN, ROWS>(q0, seq_k / BN * BN)"),
    # bwd_dq_kernel_sm90 stops one tile short of the causal diagonal.
    "dq_drops_diagonal_tile": _dq_tiles("kv_tiles<CAUSAL, BN, ROWS>(q0 - BN, seq_k)"),
    # Both backward kernels read q, k, v and do through flat tensor maps.
    "bwd_flat_tensor_maps": _FLAT_MAPS + _BWD_FLAT_LOADS,
}


# Broken copies of the D = 512 kernels, where the two consumer warpgroups
# split an item's output columns (Items<512>): each makes the other's
# columns, or the same ones.
WIDE_MUTANTS = {
    # fwd_kernel_sm90: both warpgroups take V's first 256 columns.
    "fwd_cols_share_v": [("const uint32_t v_at = It::col(wg) / Lay<D>::BW * BN * Lay<D>::RB;",
                          "const uint32_t v_at = 0;")],
    # bwd_dq_kernel_sm90: both warpgroups take K's first 256 columns.
    "dq_cols_share_k": [("const uint32_t k_at = It::col(wg) / Lay<D>::BW * BN * Lay<D>::RB;",
                         "const uint32_t k_at = 0;")],
    # bwd_dkv_kernel_sm90: both warpgroups make and store columns 0-255.
    "dkv_cols_share_passes": [("auto chunk = [&](int pass) { return It::col(wg) / DA + pass; };",
                               "auto chunk = [&](int pass) { return pass; };")],
}


# Broken copies of the f32 forward (fwd_kernel_sm90_f32): each must miss
# chip_smoke.py's F32_ATOL on f32 inputs.
F32_MUTANTS = {
    # S without Q_lo.K_hi^T: K's lo part still counts, Q's not.
    "f32_drops_s_cross_product": [("  issue_s_add<D, AROWS>(s, q_addr + q_lo, k_addr);\n", "")],
    # P.V without P_hi.V_lo: V rounded once to bf16.
    "f32_drops_pv_cross_product": [("  issue_pv_part<D>(acc, p_hi, v_addr + v_lo);\n", "")],
    # P.V without P_lo.V_hi: P rounded once to bf16 (split in one part, not two).
    "f32_rounds_p_once": [("  issue_pv_part<D>(acc, p_lo, v_addr);\n", "")],
    # Flat [2 heads * rows, D] maps: rows past S come from the next head (or
    # the next part) instead of TMA's zero fill.
    "f32_flat_tensor_maps": _FLAT_MAPS + [
        ("load_rows_at<ROWS, D>(sm + part * QP, &q_map, q_full, head + part * bh, q0);",
         "load_rows_at<ROWS, D>(sm + part * QP, &q_map, q_full, 0, (head + part * bh) * seq_q + q0);"),
        ("load_rows_at<BN, D>(k_at(st) + part * KP, &k_map, k_full + 8 * st, head + part * bh, kt * BN);",
         "load_rows_at<BN, D>(k_at(st) + part * KP, &k_map, k_full + 8 * st, 0, "
         "(head + part * bh) * seq_k + kt * BN);"),
        ("load_rows_at<BN, D>(v_at(st) + part * KP, &v_map, v_full + 8 * st, head + part * bh, kt * BN);",
         "load_rows_at<BN, D>(v_at(st) + part * KP, &v_map, v_full + 8 * st, 0, "
         "(head + part * bh) * seq_k + kt * BN);"),
    ],
}


# Broken copies of the streamed forward (fwd_kernel_sm90_stream): each must
# miss chip_smoke.py's limits at head dim 1024 (bf16 and f32) or f32 512.
_STREAM_Q = ("tma_load_at(s_at(is) + (part * G / 64 + b) * ROWS * 128, &q_map, full, c * G + 64 * b, q0,\n"
             "                              head + part * bh);")
_STREAM_K = ("c * G + 64 * b, kt * BN, head + part * bh);")
_STREAM_V = ("slice * STREAM_SLICE + 64 * b, kt * BN, head + part * bh);")
STREAM_MUTANTS = {
    # Every slice takes the first slice's columns of V (D past 512).
    "stream_slices_share_v": [(_STREAM_V, "64 * b, kt * BN, head + part * bh);")],
    # The f32 S (P = 2) without Q_lo.K_hi^T past its first chunk.
    "stream_drops_s_cross_product": [("      issue_s_add<G, Cfg::ROWS>(s, q_addr + Cfg::Q_PART, k_addr);\n", "")],
    # Each tile's mask and softmax taken one tile of keys further on.
    "stream_shifts_the_mask": [("softmax_tile<CAUSAL>(s, m, l, alpha, kt * BN, q0, r0, tg, seq_k, sl2);",
                                "softmax_tile<CAUSAL>(s, m, l, alpha, kt * BN + BN, q0, r0, tg, seq_k, sl2);")],
    # Flat [heads * rows, D] maps: rows past T or S come from the next head
    # (or the next part) instead of TMA's zero fill.
    "stream_flat_tensor_maps": _FLAT_MAPS + [
        (_STREAM_Q, _STREAM_Q.replace("q0,\n                              head + part * bh);",
                                      "(head + part * bh) * seq_q + q0, 0);")),
        (_STREAM_K, "c * G + 64 * b, (head + part * bh) * seq_k + kt * BN, 0);"),
        (_STREAM_V, "slice * STREAM_SLICE + 64 * b, (head + part * bh) * seq_k + kt * BN, 0);"),
    ],
}


# Broken copies of the f32 backward (bwd_dq_kernel_sm90_f32,
# bwd_dkv_kernel_sm90_f32): each must miss chip_smoke.py's F32_ATOL on f32
# inputs in the kernel its name's second word says (dq, dkv or bwd: both).
F32_BWD_MUTANTS = {
    # dQ += dS.K without dS_hi.K_lo: K rounded once to bf16.
    "f32_dq_drops_ds_k_cross_product": [
        ("        issue_pv_split<OUT>(dqa, ds_hi, ds_lo, k_addr(st) + k_at, Cfg::KV_PART);\n",
         "      {\n        issue_pv_part<OUT>(dqa, ds_hi, k_addr(st) + k_at);\n"
         "        issue_pv_part<OUT>(dqa, ds_lo, k_addr(st) + k_at);\n      }\n")],
    # dV += P^T.dO without P^T_lo.dO_hi: P rounded once to bf16.
    "f32_dkv_rounds_p_once": [
        ("        issue_pv_split<DA>(dva, p_hi, p_lo, do_addr(st) + at, Cfg::QT_PART);\n",
         "        issue_pv_part<DA>(dva, p_hi, do_addr(st) + at);\n"
         "        issue_pv_part<DA>(dva, p_hi, do_addr(st) + at + Cfg::QT_PART);\n")],
    # S (bwd_dq) without Q_lo.K_hi^T and S^T (bwd_dkv) without K_lo.Q_hi^T.
    "f32_bwd_drops_s_cross_product": [
        ("        issue_s_split<D, ROWS>(s, q_addr, k_addr(st), Cfg::Q_PART, Cfg::KV_PART);\n",
         "        issue_s<D, ROWS, true>(s, q_addr, k_addr(st));\n"
         "        issue_s_add<D, ROWS>(s, q_addr, k_addr(st) + Cfg::KV_PART);\n"),
        ("        issue_s_split<D, ROWS>(s, k_addr, q_addr(st), Cfg::KV_PART, Cfg::QT_PART);\n",
         "        issue_s<D, ROWS, true>(s, k_addr, q_addr(st));\n"
         "        issue_s_add<D, ROWS>(s, k_addr, q_addr(st) + Cfg::QT_PART);\n")],
    # Flat [2 heads * rows, D] maps: rows past T or S come from the next head
    # (or the next part) instead of TMA's zero fill.
    "f32_bwd_flat_tensor_maps": _FLAT_MAPS + _BWD_FLAT_LOADS,
}


@pytest.fixture
def mutant(dev, request, tmp_path, monkeypatch):
    if request.param is None:
        return None
    src = (_build.CSRC / "flash_attention.cu").read_text()
    for line, broken in {**MUTANTS, **WIDE_MUTANTS, **F32_MUTANTS, **F32_BWD_MUTANTS,
                         **STREAM_MUTANTS, **STREAM_BWD_MUTANTS}[request.param]:
        assert src.count(line) == 1
        src = src.replace(line, broken, 1)
    cu, so = tmp_path / "mutant.cu", tmp_path / "mutant.so"
    cu.write_text(src)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)], check=True)
    monkeypatch.setattr(fa, "_lib", fa._bind(ctypes.CDLL(str(so))))
    return request.param


@pytest.mark.parametrize("mutant", list(MUTANTS), indirect=True)
def test_smoke_limits_catch_a_broken_kernel(dev, mutant):
    """Each broken kernel misses chip_smoke.py's limits in one of the two
    causal modes at T = 1000 (a partial last tile). The rows past T or S are
    masked, so rows read from the next head in their place change nothing
    unless they hold a value that survives a zero weight: for the flat-map
    mutants the inputs are the first 4 heads of 5 and the first rows of
    every later head are inf (the TPU kernels zero the padding rows against
    just this) in V for the forward and in q, k, v and do for the backward,
    and only head 0, whose own values are all finite, is compared."""
    cs = importlib.import_module("chip_smoke")
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v, do = (torch.randn(4, 1000, 64, device=dev, generator=g).bfloat16() for _ in range(4))
    heads = slice(None)
    if mutant.endswith("flat_tensor_maps"):
        def next_heads_inf(x):  # the rows a flat map reads for the partial tile of the head before
            x5 = torch.cat([x, torch.randn(1, 1000, 64, device=dev, generator=g).bfloat16()])
            x5[1:, :24] = float("inf")
            return x5[:4]

        if mutant.startswith("fwd"):
            v = next_heads_inf(v)
        else:
            q, k, v, do = (next_heads_inf(x) for x in (q, k, v, do))
        heads = slice(0, 1)
    scale = 0.125
    worst = {}
    for causal in (False, True):
        ref_o, ref_lse = fa._flash_fwd_ref(q, k, v, causal, scale, True)
        delta = (do.float() * ref_o.float()).sum(-1)
        args = (q, k, v, do, ref_lse, delta)
        _, ratios = cs.compare({
            "fwd": [(fa.flash_fwd(q, k, v, causal=causal, scale=scale)[heads], ref_o[heads])],
            "bwd_dq": [(fa.flash_bwd_dq(*args, causal=causal, scale=scale)[heads],
                        fa._flash_bwd_dq_ref(*args, causal, scale)[heads])],
            "bwd_dkv": [(got[heads], want[heads]) for got, want in
                        zip(fa.flash_bwd_dkv(*args, causal=causal, scale=scale),
                            fa._flash_bwd_dkv_ref(*args, causal, scale))],
        })
        for key, r in ratios.items():
            if not r <= worst.get(key, 0.0):  # NaN (inf times a zero weight) counts as worst
                worst[key] = r
    broken = {"fwd": ["fwd"], "dq": ["bwd_dq"], "dkv": ["bwd_dkv"],
              "bwd": ["bwd_dq", "bwd_dkv"]}[mutant.split("_")[0]]
    assert not any(worst[key] <= 1.0 for key in broken), worst


@pytest.mark.parametrize("mutant", list(F32_MUTANTS), indirect=True)
def test_smoke_limits_catch_a_broken_f32_forward(dev, mutant):
    """Each broken f32 forward misses chip_smoke.py's F32_ATOL (o or lse) in
    one of the two causal modes at T = 1000 (a partial last tile), at head
    dim 64 and at 256 (its 16-key tiles). For the flat-map mutant the
    inputs are the first 4 heads of 5, the first rows of every later head
    inf in V (their lo parts NaN), and only head 0 is compared, as in
    test_smoke_limits_catch_a_broken_kernel."""
    cs = importlib.import_module("chip_smoke")
    g = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0
    for D in (64, 256):
        q, k, v = (torch.randn(4, 1000, D, device=dev, generator=g) for _ in range(3))
        heads = slice(None)
        if mutant == "f32_flat_tensor_maps":
            v5 = torch.cat([v, torch.randn(1, 1000, D, device=dev, generator=g)])
            v5[1:, :24] = float("inf")
            v, heads = v5[:4], slice(0, 1)
        for causal in (False, True):
            o, lse = fa.flash_fwd(q, k, v, causal=causal, scale=D ** -0.5, with_lse=True)
            ref_o, ref_lse = fa._flash_fwd_ref(q, k, v, causal, D ** -0.5, True)
            _, ratios = cs.compare({"fwd_lse": [(o[heads], ref_o[heads]), (lse[heads], ref_lse[heads])]})
            r = ratios["fwd_lse"]
            worst = r if not r <= worst else worst  # NaN counts as worst
    assert not worst <= 1.0, worst


@pytest.mark.parametrize("mutant", list(F32_BWD_MUTANTS), indirect=True)
def test_smoke_limits_catch_a_broken_f32_backward(dev, mutant):
    """Each broken f32 backward misses chip_smoke.py's F32_ATOL (dq, or dk
    or dv) in one of the two causal modes at T = 1000 (a partial last
    tile), at head dim 64 and at 256 (its 64-row items and 16-row tiles).
    For the flat-map mutant the inputs are the first 4 heads of 5, the
    first rows of every later head inf in q, k, v and do (their lo parts
    NaN), and only head 0 is compared, as in
    test_smoke_limits_catch_a_broken_kernel."""
    cs = importlib.import_module("chip_smoke")
    g = torch.Generator(device=dev).manual_seed(0)
    worst = {}
    for D in (64, 256):
        q, k, v, do = (torch.randn(4, 1000, D, device=dev, generator=g) for _ in range(4))
        heads = slice(None)
        if mutant == "f32_bwd_flat_tensor_maps":
            def next_heads_inf(x):
                x5 = torch.cat([x, torch.randn(1, 1000, D, device=dev, generator=g)])
                x5[1:, :24] = float("inf")
                return x5[:4]

            q, k, v, do = (next_heads_inf(x) for x in (q, k, v, do))
            heads = slice(0, 1)
        for causal in (False, True):
            scale = D ** -0.5
            ref_o, ref_lse = fa._flash_fwd_ref(q[heads], k[heads], v[heads], causal, scale, True)
            lse = torch.zeros(q.shape[:2], device=dev)
            delta = torch.zeros(q.shape[:2], device=dev)
            lse[heads], delta[heads] = ref_lse, (do[heads] * ref_o).sum(-1)
            args = (q, k, v, do, lse, delta)
            plain = [x[heads] for x in args]
            _, ratios = cs.compare({
                "bwd_dq": [(fa.flash_bwd_dq(*args, causal=causal, scale=scale)[heads],
                            fa._flash_bwd_dq_ref(*plain, causal, scale))],
                "bwd_dkv": [(got[heads], want) for got, want in
                            zip(fa.flash_bwd_dkv(*args, causal=causal, scale=scale),
                                fa._flash_bwd_dkv_ref(*plain, causal, scale))],
            })
            for key, r in ratios.items():
                if not r <= worst.get(key, 0.0):  # NaN counts as worst
                    worst[key] = r
    broken = {"dq": ["bwd_dq"], "dkv": ["bwd_dkv"], "bwd": ["bwd_dq", "bwd_dkv"]}[mutant.split("_")[1]]
    assert not any(worst[key] <= 1.0 for key in broken), worst


def test_f32_backward_route_by_width(dev):
    """f32 B3 and B4 through their wrappers go through one split pass each
    (q, k, v and do) and the f32 Hopper kernels at 64-256, the streamed ones
    at 512, by the profiler's kernel names and f32_launches."""
    from torch.profiler import ProfilerActivity, profile

    cs = importlib.import_module("chip_smoke")
    for D in fa.WIDTHS:
        q, k, v, do = (torch.randn(2, 300, D, device=dev) for _ in range(4))
        o, lse = fa._flash_fwd_ref(q, k, v, True, D ** -0.5, True)
        args = (q, k, v, do, lse, (do * o).sum(-1))
        fa.reset_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fa.flash_bwd_dq(*args, causal=True, scale=D ** -0.5)
            fa.flash_bwd_dkv(*args, causal=True, scale=D ** -0.5)
            torch.cuda.synchronize()
        names = cs.flash_kernel_names(prof)
        kind = "_f32" if D in fa.SPLIT_WIDTHS else "_stream"
        args_ = f"{D}, true" if D in fa.SPLIT_WIDTHS else "2, true"
        want = [f"bwd_dkv_kernel_sm90{kind}<{args_}>", f"bwd_dq_kernel_sm90{kind}<{args_}>", "split_kernel"]
        assert names == sorted(want), (D, names)
        assert fa.f32_launches == {"split": 2, "fwd": 0, "fwd_lse": 0, "bwd_dq": 1, "bwd_dkv": 1}, (D, fa.f32_launches)
        assert fa.launches["bwd_dq"] == fa.launches["bwd_dkv"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_dim_32_runs_natively(dev, dtype):
    """At head dim 32 the autograd function's forward and backward run the
    kernels built at 32, by the profiler's names (bf16: fwd_kernel_sm90<32,
    true, true> and both backward kernels; f32: their *_sm90_f32 twins and
    the split pass), make no pad or cut copy, and agree with the plain
    versions by chip_smoke.py's limits."""
    from torch.profiler import ProfilerActivity, profile

    cs = importlib.import_module("chip_smoke")
    g = torch.Generator(device=dev).manual_seed(32)
    q, k, v, do = (torch.randn(4, 1000, 32, device=dev, generator=g).to(dtype) for _ in range(4))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fa.reset_launches()
    with cs.pad_copies(fa) as copies, profile(activities=[ProfilerActivity.CUDA]) as prof:
        o = fa._FlashAttention.apply(*leaves, True, 32 ** -0.5)
        grads = torch.autograd.grad(o, leaves, do)
        torch.cuda.synchronize()
    kind = "_f32" if dtype == torch.float32 else ""
    want = [f"fwd_kernel_sm90{kind}<32, true, true>", f"bwd_dq_kernel_sm90{kind}<32, true>",
            f"bwd_dkv_kernel_sm90{kind}<32, true>"] + (["split_kernel"] if kind else [])
    assert cs.flash_kernel_names(prof) == sorted(want)
    assert copies == {"pad": 0, "cut": 0}
    assert fa.launches_by_width == {"fwd_lse@32": 1, "bwd_dq@32": 1, "bwd_dkv@32": 1}
    ref_o, lse = fa._flash_fwd_ref(q, k, v, True, 32 ** -0.5, True)
    args = (q, k, v, do, lse, (do.float() * o.detach().float()).sum(-1))
    ref_dq = fa._flash_bwd_dq_ref(*args, True, 32 ** -0.5)
    ref_dk, ref_dv = fa._flash_bwd_dkv_ref(*args, True, 32 ** -0.5)
    _, ratios = cs.compare({"o": [(o, ref_o)], "dq": [(grads[0], ref_dq.to(dtype))],  # grads in q's dtype
                            "dkv": [(grads[1], ref_dk.to(dtype)), (grads[2], ref_dv.to(dtype))]})
    assert all(r <= 1.0 for r in ratios.values()), ratios


def test_f32_route_by_width_includes_32(dev):
    """32 is a width of the f32 route: f32 B1-B4 at head dim 32, and at 16
    padded once to 32, go through the split passes and the
    *_sm90_f32<32, ...> kernels, by the profiler's names and the launches
    by width."""
    from torch.profiler import ProfilerActivity, profile

    cs = importlib.import_module("chip_smoke")
    assert fa.WIDTHS[0] == fa.SPLIT_WIDTHS[0] == 32
    want = sorted(["fwd_kernel_sm90_f32<32, true, false>", "fwd_kernel_sm90_f32<32, true, true>",
                   "bwd_dq_kernel_sm90_f32<32, true>", "bwd_dkv_kernel_sm90_f32<32, true>", "split_kernel"])
    for D in (32, 16):
        q, k, v, do = (torch.randn(2, 300, D, device=dev) for _ in range(4))
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        fa.reset_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fa.flash_fwd(q, k, v, causal=True, scale=D ** -0.5)
            torch.autograd.grad(fa._FlashAttention.apply(*leaves, True, D ** -0.5), leaves, do)
            torch.cuda.synchronize()
        assert cs.flash_kernel_names(prof) == want, D
        assert fa.launches_by_width == {"fwd@32": 1, "fwd_lse@32": 1, "bwd_dq@32": 1, "bwd_dkv@32": 1}, D
        assert fa.f32_launches == {"split": 3, "fwd": 1, "fwd_lse": 1, "bwd_dq": 1, "bwd_dkv": 1}, D


def test_f32_backward_repeats_bitwise(dev):
    """Two f32 backward calls of the autograd function on the same inputs
    give the same gradients bit for bit (no atomics: each output row is
    written by one block, its sums in one order), at 64, 256 and 512."""
    g = torch.Generator(device=dev).manual_seed(4)
    for D in (64, 256, 512):
        q, k, v, do = (torch.randn(8, 1000, D, device=dev, generator=g) for _ in range(4))
        runs = []
        for _ in range(2):
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            runs.append(torch.autograd.grad(fa._FlashAttention.apply(*leaves, True, D ** -0.5), leaves, do))
        assert all(torch.equal(a, b) for a, b in zip(*runs)), D


def test_split_pass_is_its_plain_version_bitwise(dev):
    """The split kernel against _split_ref, bitwise, on seeded normals, large
    and tiny normals and subnormals on bf16's grid, both signs; q, k and v
    of different lengths land in their own parts."""
    g = torch.Generator(device=dev).manual_seed(1)
    mags = torch.cat([torch.ones(2048, device=dev),
                      2.0 ** torch.randint(-126, 127, (2048,), device=dev, generator=g).float()])
    x = torch.randn(4096, device=dev, generator=g) * mags
    x[:128] = torch.randint(1, 128, (128,), device=dev, generator=g).float() * 2.0 ** -133
    q = x.view(2, 32, 64)
    k, v = (torch.randn(2, 48, 64, device=dev, generator=g) for _ in range(2))
    do = torch.randn(2, 32, 64, device=dev, generator=g)
    fa.reset_launches()
    parts = fa.split_parts(q, k, v)
    assert fa.f32_launches["split"] == 1
    for part, t in zip(parts, (q, k, v)):
        assert torch.equal(part, fa._split_ref(t))
    for xs in ((do,), (q, k, v, do)):  # the backward's splits
        for part, t in zip(fa.split_parts(*xs), xs):
            assert torch.equal(part, fa._split_ref(t))


def test_f32_forward_route_by_width(dev):
    """f32 B1-B4 at 64-256 go through the split passes and the f32 Hopper
    kernels, at 512 through the split passes and the streamed kernels, by
    the profiler's kernel names and f32_launches (chip_smoke.py's
    f32_route)."""
    importlib.import_module("chip_smoke").f32_route(fa, dev)


def _stream_inputs(dev, dtype, D, T, S, seed, heads=3):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(heads, T, D, device=dev, generator=g).to(dtype)
    k, v = (torch.randn(heads, S, D, device=dev, generator=g).to(dtype) for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("dtype,D", [(torch.float32, 512)] + [(dt, D) for dt in (torch.float32, torch.bfloat16)
                                                               for D in (576, 768, 1024, 2048)])
@pytest.mark.parametrize("causal", [True, False])
def test_streamed_forward_matches_plain_version(dev, dtype, D, causal):
    """B1 and B2 on the streamed forward (fwd_kernel_sm90_stream: f32 at
    512, both dtypes past 512, 576 and 768 padded to 1024) against
    _flash_fwd_ref at T = 1000 on S = 300 (causal) or 700, by chip_smoke.py's
    limits; launches counted at the width run."""
    cs = importlib.import_module("chip_smoke")
    q, k, v = _stream_inputs(dev, dtype, D, 1000, 300 if causal else 700, D)
    scale = D ** -0.5
    fa.reset_launches()
    o, lse = fa.flash_fwd(q, k, v, causal=causal, scale=scale, with_lse=True)
    o1 = fa.flash_fwd(q, k, v, causal=causal, scale=scale)
    ref_o, ref_lse = fa._flash_fwd_ref(q, k, v, causal, scale, True)
    _, ratios = cs.compare({"fwd": [(o1, ref_o)], "fwd_lse": [(o, ref_o), (lse, ref_lse)]})
    assert all(r <= 1.0 for r in ratios.values()), ratios
    width = fa.kernel_width(D)
    assert fa.launches_by_width == {f"fwd@{width}": 1, f"fwd_lse@{width}": 1}
    assert fa.f32_launches["split"] == 2 * (dtype == torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_streamed_forward_slices_agree_and_repeat_bitwise(dev, dtype):
    """Every column slice of a row tile makes S in the same chunk order, so
    their m and l agree bitwise: with V's second 512 columns a copy of its
    first at 1024, o's two halves are equal bit for bit (a slice that
    normalised by another l or max would differ); and two calls give the
    same o and lse bit for bit (no atomics)."""
    q, k, v = _stream_inputs(dev, dtype, 1024, 1000, 1000, 7, heads=4)
    v[..., 512:] = v[..., :512]
    for causal in (True, False):
        o, lse = fa.flash_fwd(q, k, v, causal=causal, scale=1024 ** -0.5, with_lse=True)
        o2, lse2 = fa.flash_fwd(q, k, v, causal=causal, scale=1024 ** -0.5, with_lse=True)
        assert torch.equal(o[..., 512:], o[..., :512])
        assert torch.equal(o, o2) and torch.equal(lse, lse2)


def test_autograd_past_512_raises_before_any_launch_and_no_grad_runs(dev):
    """At head dim 1024 on the card the autograd function no longer raises:
    flash_attention with gradients runs B2, B3 and B4 once each on the
    streamed kernels, its output and gradients against the kernels' plain
    versions composed as the autograd function composes them (delta from
    the kernel path's bf16 o, as chip_smoke.py's gqa_case); without
    gradients it runs the streamed forward once. Both by chip_smoke.py's
    limits (bf16)."""
    cs = importlib.import_module("chip_smoke")
    g = torch.Generator(device=dev).manual_seed(3)
    B, T, H, D = 2, 300, 2, 1024
    q, k, v, do = (torch.randn(B, T, H, D, device=dev, generator=g).bfloat16() for _ in range(4))
    fa.reset_launches()
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = fa.flash_attention(*leaves, causal=True)
    got = (o, *torch.autograd.grad(o, leaves, do))
    assert fa.launches_by_width == {"fwd_lse@1024": 1, "bwd_dq@1024": 1, "bwd_dkv@1024": 1}

    def bhtd(x):  # [B, T, H, D] -> [B*H, T, D]
        return x.transpose(1, 2).reshape(-1, T, D)

    def bthd(x):  # [B*H, T, D] -> [B, T, H, D]
        return x.reshape(B, -1, T, D).transpose(1, 2)

    args = [bhtd(t) for t in (q, k, v, do)]
    o_ref, lse = fa._flash_fwd_ref(*args[:3], True, D ** -0.5, True)
    args += [lse, (args[3].float() * bhtd(got[0].detach()).float()).sum(-1)]
    want = (bthd(o_ref), bthd(fa._flash_bwd_dq_ref(*args, True, D ** -0.5).bfloat16()),
            *(bthd(x.bfloat16()) for x in fa._flash_bwd_dkv_ref(*args, True, D ** -0.5)))
    _, ratios = cs.compare({"grads": list(zip(got, want))})
    assert ratios["grads"] <= 1.0, ratios
    fa.reset_launches()
    with torch.no_grad():
        o = fa.flash_attention(q, k, v, causal=True)
        ref = fa.mha(q, k, v, causal=True, impl="torch")
    assert fa.launches_by_width == {"fwd@1024": 1}
    _, ratios = cs.compare({"fwd": [(o, ref)]})
    assert ratios["fwd"] <= 1.0, ratios


def _stream_bwd_args(dev, dtype, D, T, S, causal, seed, heads=3):
    """q, k, v, do from a seed, the plain forward's lse and delta."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn(heads, T, D, device=dev, generator=g).to(dtype) for _ in range(2))
    k, v = (torch.randn(heads, S, D, device=dev, generator=g).to(dtype) for _ in range(2))
    ref_o, lse = fa._flash_fwd_ref(q, k, v, causal, D ** -0.5, True)
    return q, k, v, do, lse, (do.float() * ref_o.float()).sum(-1)


@pytest.mark.parametrize("kind", ["-1/sqrt(D)", "0"])
@pytest.mark.parametrize("case", range(8))
def test_kernels_take_any_scale(dev, case, kind):
    """chip_smoke.py's SCALE_CASES at each of its scales: B1-B4 through their
    wrappers (a scale <= 0 routed before any launch) against their plain
    versions at that scale, by phase 2's limits; each kernel launched once,
    dq none at 0, where dq and dk come out exactly zero."""
    cs = importlib.import_module("chip_smoke")
    assert len(cs.SCALE_CASES) == 8
    dtype, D, T, S, causal = cs.SCALE_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(case)
    got = cs.scale_case(fa, dev, gen, dtype, D, T, S, causal, kind)
    assert cs.scale_ok(got), got


@pytest.mark.parametrize("dtype,D", [(torch.float32, 512), (torch.float32, 576), (torch.float32, 1024),
                                     (torch.bfloat16, 1024), (torch.bfloat16, 2048)])
@pytest.mark.parametrize("causal", [True, False])
def test_streamed_backward_matches_plain_version(dev, dtype, D, causal):
    """B3 and B4 on the streamed kernels (bwd_dq_kernel_sm90_stream,
    bwd_dkv_kernel_sm90_stream: f32 at 512 and past, bf16 past 512, 576
    padded to 1024) against their plain versions at T = 1000 on S = 300
    (causal) or 700, by chip_smoke.py's limits; one launch each at the
    width run."""
    cs = importlib.import_module("chip_smoke")
    args = _stream_bwd_args(dev, dtype, D, 1000, 300 if causal else 700, causal, D)
    scale = D ** -0.5
    fa.reset_launches()
    dq = fa.flash_bwd_dq(*args, causal=causal, scale=scale)
    dk, dv = fa.flash_bwd_dkv(*args, causal=causal, scale=scale)
    _, ratios = cs.compare({"bwd_dq": [(dq, fa._flash_bwd_dq_ref(*args, causal, scale))],
                            "bwd_dkv": list(zip((dk, dv), fa._flash_bwd_dkv_ref(*args, causal, scale)))})
    assert all(r <= 1.0 for r in ratios.values()), ratios
    width = fa.kernel_width(D)
    assert fa.launches_by_width == {f"bwd_dq@{width}": 1, f"bwd_dkv@{width}": 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_streamed_backward_slices_agree_and_repeat_bitwise(dev, dtype):
    """Every slice makes S and dP from the same chunks in the same order, so
    P and dS agree bitwise across slices: with q's, k's and do's second 512
    columns a copy of their first at 1024, the halves of dq, dk and dv are
    equal bit for bit; and two calls give the same dq, dk and dv bit for
    bit (no atomics)."""
    q, k, v, do = (torch.randn(4, 1000, 1024, device=dev, generator=torch.Generator(device=dev).manual_seed(i))
                   .to(dtype) for i in range(4))
    for x in (q, k, do):
        x[..., 512:] = x[..., :512]
    for causal in (True, False):
        ref_o, lse = fa._flash_fwd_ref(q, k, v, causal, 1024 ** -0.5, True)
        args = (q, k, v, do, lse, (do.float() * ref_o.float()).sum(-1))
        runs = [(fa.flash_bwd_dq(*args, causal=causal, scale=1024 ** -0.5),
                 *fa.flash_bwd_dkv(*args, causal=causal, scale=1024 ** -0.5)) for _ in range(2)]
        assert all(torch.equal(x[..., 512:], x[..., :512]) for x in runs[0])
        assert all(torch.equal(a, b) for a, b in zip(*runs))


# Broken copies of the streamed backward (bwd_dq_kernel_sm90_stream,
# bwd_dkv_kernel_sm90_stream): each must miss chip_smoke.py's limits at head
# dim 1024 (bf16 and f32) or f32 512, in the kernel its name's first word
# says (dq or dkv).
STREAM_BWD_MUTANTS = {
    # Every slice of dQ takes the first slice's columns of K.
    "dq_slices_share_k": [("slice * STREAM_SLICE + 64 * b, k0, head + part * bh);",
                           "64 * b, k0, head + part * bh);")],
    # Each warpgroup's dV columns written where the other's belong.
    "dkv_dv_at_wrong_columns": [("store_rows<OUT>(dv + at, dva, r0, tg, seq_k, D);",
                                 "store_rows<OUT>(dv + at + (1 - 2 * wg) * OUT, dva, r0, tg, seq_k, D);")],
    # dP (bwd_dq) without its second chunk of D.
    "dq_drops_a_dp_chunk": [("issue_s_chunk<P, false>(dp, s_at(i) + Cfg::DO_AT, s_at(i) + Cfg::V_AT);",
                             "if (c != 1) issue_s_chunk<P, false>(dp, s_at(i) + Cfg::DO_AT, s_at(i) + Cfg::V_AT);")],
}


@pytest.mark.parametrize("mutant", list(STREAM_MUTANTS), indirect=True)
def test_smoke_limits_catch_a_broken_streamed_forward(dev, mutant):
    """Each broken streamed forward misses chip_smoke.py's limits (o or lse)
    in one of the two causal modes at T = 1000 (a partial last tile), at
    head dim 1024 in bf16 and f32 and at f32 512. For the flat-map mutant
    the inputs are the first 4 heads of 5, the first rows of every later
    head inf in V, and only head 0 is compared, as in
    test_smoke_limits_catch_a_broken_kernel."""
    cs = importlib.import_module("chip_smoke")
    worst = 0.0
    for dtype, D in ((torch.bfloat16, 1024), (torch.float32, 1024), (torch.float32, 512)):
        q, k, v = _stream_inputs(dev, dtype, D, 1000, 1000, D, heads=4)
        heads = slice(None)
        if mutant == "stream_flat_tensor_maps":
            v5 = torch.cat([v, _stream_inputs(dev, dtype, D, 1, 1000, 1, heads=1)[1]])
            v5[1:, :24] = float("inf")
            v, heads = v5[:4], slice(0, 1)
        for causal in (False, True):
            o, lse = fa.flash_fwd(q, k, v, causal=causal, scale=D ** -0.5, with_lse=True)
            ref_o, ref_lse = fa._flash_fwd_ref(q, k, v, causal, D ** -0.5, True)
            _, ratios = cs.compare({"fwd_lse": [(o[heads], ref_o[heads]), (lse[heads], ref_lse[heads])]})
            r = ratios["fwd_lse"]
            worst = r if not r <= worst else worst  # NaN counts as worst
    assert not worst <= 1.0, worst


@pytest.mark.parametrize("mutant", list(STREAM_BWD_MUTANTS), indirect=True)
def test_smoke_limits_catch_a_broken_streamed_backward(dev, mutant):
    """Each broken streamed backward misses chip_smoke.py's limits (dq, or
    dk and dv) in one of the two causal modes at T = 1000 (a partial last
    tile), at head dim 1024 in bf16 and f32 and at f32 512."""
    cs = importlib.import_module("chip_smoke")
    key = {"dq": "bwd_dq", "dkv": "bwd_dkv"}[mutant.split("_")[0]]
    worst = 0.0
    for dtype, D in ((torch.bfloat16, 1024), (torch.float32, 1024), (torch.float32, 512)):
        for causal in (False, True):
            args = _stream_bwd_args(dev, dtype, D, 1000, 1000, causal, D, heads=4)
            scale = D ** -0.5
            if key == "bwd_dq":
                pairs = [(fa.flash_bwd_dq(*args, causal=causal, scale=scale),
                          fa._flash_bwd_dq_ref(*args, causal, scale))]
            else:
                pairs = list(zip(fa.flash_bwd_dkv(*args, causal=causal, scale=scale),
                                 fa._flash_bwd_dkv_ref(*args, causal, scale)))
            _, ratios = cs.compare({key: pairs})
            r = ratios[key]
            worst = r if not r <= worst else worst  # NaN counts as worst
    assert not worst <= 1.0, worst


@pytest.mark.parametrize("mutant", list(WIDE_MUTANTS), indirect=True)
def test_smoke_limits_catch_a_broken_kernel_at_head_dim_512(dev, mutant):
    """Each broken D = 512 kernel misses chip_smoke.py's limits in one of
    the two causal modes at T = 1000, bf16."""
    cs = importlib.import_module("chip_smoke")
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v, do = (torch.randn(4, 1000, 512, device=dev, generator=g).bfloat16() for _ in range(4))
    scale = 512 ** -0.5
    worst = {}
    for causal in (False, True):
        ref_o, ref_lse = fa._flash_fwd_ref(q, k, v, causal, scale, True)
        delta = (do.float() * ref_o.float()).sum(-1)
        args = (q, k, v, do, ref_lse, delta)
        _, ratios = cs.compare({
            "fwd": [(fa.flash_fwd(q, k, v, causal=causal, scale=scale), ref_o)],
            "bwd_dq": [(fa.flash_bwd_dq(*args, causal=causal, scale=scale),
                        fa._flash_bwd_dq_ref(*args, causal, scale))],
            "bwd_dkv": list(zip(fa.flash_bwd_dkv(*args, causal=causal, scale=scale),
                                fa._flash_bwd_dkv_ref(*args, causal, scale))),
        })
        for key, r in ratios.items():
            if not r <= worst.get(key, 0.0):  # NaN counts as worst
                worst[key] = r
    broken = {"fwd": "fwd", "dq": "bwd_dq", "dkv": "bwd_dkv"}[mutant.split("_")[0]]
    assert not worst[broken] <= 1.0, worst


@pytest.mark.parametrize("mutant", [None, "dkv_drops_last_q_tile", "dq_drops_diagonal_tile"],
                         indirect=True)
def test_smoke_gradient_check_catches_a_broken_backward(dev, mutant):
    """The first loss cannot see a broken backward kernel; the gradients can
    (but not a dropped lo term: tests/test_torch_ops.py,
    test_gradient_check_sees_a_lost_tile_not_a_once_rounded_ds)."""
    cs = importlib.import_module("chip_smoke")
    cfg = tr.TransformerConfig(vocab_size=512, d_model=256, n_layers=2, n_heads=4,
                               max_seq_len=1024, dtype=torch.bfloat16, attention_impl="kernel")
    g = torch.Generator(device=dev).manual_seed(0)
    raw = torch.randint(0, cfg.vocab_size, (2, 1025), device=dev, generator=g)
    batch = {"tokens": raw[:, :-1].contiguous(), "targets": raw[:, 1:].contiguous()}
    model = tr.transformer_init(cfg, g, device=dev)
    if mutant is None:
        cs.grads_check(tr, cfg, dev, model, batch)
    else:
        with pytest.raises(cs.SmokeFailure, match="gradients"):
            cs.grads_check(tr, cfg, dev, model, batch)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_kernel_route_matches_plain_route(dev, causal):
    """Ring attention's kernel route (B2 per hop, merged by LSE; B3 and B4
    per hop with the global LSE), four shards in loopback, against its
    plain route (the reference's online softmax in global positions), f32:
    output and gradients within ATOL, one launch of each per hop run."""
    from ray_tpu_torch.parallel import ring_attention_loopback

    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v, do = (torch.randn(2, 256, 4, 64, device=dev, generator=g) for _ in range(4))
    out = {}
    for impl in ("kernel", "plain"):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        fa.reset_launches()
        o = ring_attention_loopback(*leaves, 4, causal=causal, impl=impl)
        out[impl] = [o, *torch.autograd.grad(o, leaves, do)]
        torch.cuda.synchronize()
        out[impl + "_launches"] = dict(fa.launches)
    for a, b in zip(out["kernel"], out["plain"]):
        assert _err(a, b) <= ATOL
    hops = 10 if causal else 16
    assert out["kernel_launches"] == {"fwd": 0, "fwd_lse": hops, "bwd_dq": hops, "bwd_dkv": hops}
    assert not any(out["plain_launches"].values())


def test_nccl_group_at_world_one(dev):
    """A collective group on NCCL at world 1 in this process: every op on
    bf16 and f32 CUDA tensors gives back the input's kind on the card,
    equal to its input (a world of one), and ring/Ulysses attention on the
    group launch the flash kernels (one B2, B3 and B4 each)."""
    from ray_tpu_torch.parallel import ring_attention_on_group, ulysses_attention_on_group
    from ray_tpu_torch.util import collective as col

    col.init_collective_group(1, 0, backend="nccl", group_name="t_nccl1")
    try:
        assert col.get_group_mesh("t_nccl1").device_type == "cuda"
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(64, 32, device=dev).to(dtype)
            for op in ("sum", "product", "min", "max"):
                assert torch.equal(col.allreduce(x, "t_nccl1", op=op), x)
            (g,) = col.allgather(x, "t_nccl1")
            for out in (g, col.reducescatter(x, "t_nccl1"), col.broadcast(x, 0, "t_nccl1")):
                assert out.device.type == "cuda" and torch.equal(out, x)
            col.barrier("t_nccl1")
            col.send(x, 0, "t_nccl1", tag=3)
            assert torch.equal(col.recv(0, "t_nccl1", tag=3), x)
        q, k, v = (torch.randn(2, 128, 4, 64, device=dev).to(torch.bfloat16).requires_grad_(True)
                   for _ in range(3))
        for f in (ring_attention_on_group, ulysses_attention_on_group):
            fa.reset_launches()
            o = f(q, k, v, causal=True, group_name="t_nccl1")
            torch.autograd.grad(o, (q, k, v), torch.ones_like(o))
            torch.cuda.synchronize()
            assert {key: fa.launches[key] for key in ("fwd_lse", "bwd_dq", "bwd_dkv")} == \
                {"fwd_lse": 1, "bwd_dq": 1, "bwd_dkv": 1}, (f.__name__, fa.launches)
    finally:
        col.destroy_collective_group("t_nccl1")


def test_device_channel_ipc_between_two_actors(dev):
    """Two GPU actors share the card (num_gpus=0.5 each) in a 2-rank gloo
    group: a device channel between them resolves to CUDA IPC, and bf16 CUDA
    tensors arrive on the card bitwise, the reader opening the writer's
    buffer once for repeated writes of one size."""
    import ray_tpu_torch as rt

    rt.init(num_cpus=2, num_gpus=1)
    try:
        @rt.remote(num_gpus=0.5)
        class End:
            def join(self, rank):
                from ray_tpu_torch.util import collective as col

                col.init_collective_group(2, rank, backend="gloo", group_name="t_ipc")

            def open(self, spec):
                from ray_tpu_torch.dag.channel import make_channel

                self.ch = make_channel(spec)
                return self.ch.mode

            def write(self, seed):
                g = torch.Generator(device="cuda").manual_seed(seed)
                self.ch.write(torch.randn(1 << 20, device="cuda", generator=g).to(torch.bfloat16))

            def read(self, seed):
                from ray_tpu_torch.dag import tensor_channel as tc

                got = self.ch.read(timeout=60)
                g = torch.Generator(device="cuda").manual_seed(seed)
                want = torch.randn(1 << 20, device="cuda", generator=g).to(torch.bfloat16)
                return (got.device.type, torch.equal(got.view(torch.int16), want.view(torch.int16)),
                        id(self.ch._opened[1]), tc.routes["ipc"])

        from ray_tpu_torch.dag.channel import make_channel

        w, r = End.remote(), End.remote()
        rt.get([w.join.remote(0), r.join.remote(1)], timeout=120)
        spec = ("rtdag_t_ipc", 1 << 20, "device", {"group": "t_ipc", "src": 0, "dst": 1})
        chan = make_channel(spec, create=True)
        assert rt.get([w.open.remote(spec), r.open.remote(spec)], timeout=60) == ["ipc", "ipc"]
        outs = []
        for seed in (1, 2, 3):
            got = r.read.remote(seed)
            rt.get(w.write.remote(seed), timeout=60)
            outs.append(rt.get(got, timeout=60))
        assert [o[:2] for o in outs] == [("cuda", True)] * 3
        assert len({o[2] for o in outs}) == 1 and outs[-1][3] == 3
        chan.close(unlink=True)
    finally:
        rt.shutdown()


def test_device_channel_loopback_hop(dev):
    """One process addressing two cards: the tensor is copied onto the dst
    card (make_cuda_hop) and handed to a same-process reader; a reader
    without the parked tensor decodes the frame's bytes."""
    if torch.cuda.device_count() < 2:
        pytest.skip("the loopback route needs two cards")
    from ray_tpu_torch.dag import tensor_channel as tc

    w = tc.DeviceTensorChannel("rtdag_t_loop", 1 << 22, create=True, meta={"src": 0, "dst": 1})
    try:
        r = tc.DeviceTensorChannel("rtdag_t_loop", 1 << 22, meta={"src": 0, "dst": 1})
        x = torch.arange(64 * 64, device="cuda:0", dtype=torch.float32).reshape(64, 64)
        w.write(x)
        assert w.mode == "loopback"
        out = r.read(timeout=10)
        assert out.device == torch.device("cuda", 1) and torch.equal(out.cpu(), x.cpu())
        w.write(("ok", x))
        tc._DEVICE_SLOTS.pop("rtdag_t_loop")  # a reader in another process
        kind, host = r.read(timeout=10)
        assert kind == "ok" and host.device.type == "cpu" and torch.equal(host, x.cpu())
    finally:
        w.close(unlink=True)
