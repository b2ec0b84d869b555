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
    """f32 runs the CUDA-core kernels, bf16 the tensor-core ones; both are
    held to chip_smoke.py's limits: ATOL for f32 outputs, one bf16 ulp for
    the bf16 o."""
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
    q = torch.randn(2, 64, 64, device=dev)
    wide = torch.randn(2, 64, 520, device=dev)
    lse = torch.zeros(2, 64, device=dev)
    refused = [
        lambda: fa.flash_fwd(q.half(), q.half(), q.half(), causal=True, scale=1.0),  # dtype
        lambda: fa.flash_fwd(q, q.bfloat16(), q, causal=True, scale=1.0),  # mixed dtypes
        lambda: fa.flash_fwd(wide, wide, wide, causal=True, scale=1.0),  # head_dim 520 > 512
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [32, 80, 96, 192, 256, 320, 384, 512])
def test_kernels_match_plain_versions_at_head_dim(dev, D, causal, dtype):
    """The kernels at head dims past 64 and 128: 96, 256 and 512 natively,
    32, 80, 192, 320 and 384 padded to the next of those; T != S, a partial
    last tile.
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
    width = fa.kernel_width(D, dev)
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
    width = fa.kernel_width(D, dev)

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
        ("          split_p<true>(dp, ds_hi, ds_lo);\n          STAMP(1",
         "          split_p<true>(dp, ds_hi, ds_lo);\n"
         "          for (auto& c : ds_lo) for (auto& r : c) r = 0;\n          STAMP(1")],
    # bwd_dq_kernel_sm90 drops the last, partial key tile.
    "dq_drops_partial_key_tile": _dq_tiles("kv_tiles<CAUSAL, BN, ROWS>(q0, seq_k / BN * BN)"),
    # bwd_dq_kernel_sm90 stops one tile short of the causal diagonal.
    "dq_drops_diagonal_tile": _dq_tiles("kv_tiles<CAUSAL, BN, ROWS>(q0 - BN, seq_k)"),
    # Both backward kernels read q, k, v and do through flat tensor maps.
    "bwd_flat_tensor_maps": _FLAT_MAPS + [
        ("load_rows<ROWS, D>(ks, &k_map, kv_full, head, k0);",
         "load_rows<ROWS, D>(ks, &k_map, kv_full, 0, head * seq_k + k0);"),
        ("load_rows<ROWS, D>(vs, &v_map, kv_full, head, k0);",
         "load_rows<ROWS, D>(vs, &v_map, kv_full, 0, head * seq_k + k0);"),
        ("load_rows<BQ, D>(qs + st * BQ * D, &q_map, full, head, qt * BQ);",
         "load_rows<BQ, D>(qs + st * BQ * D, &q_map, full, 0, head * seq_q + qt * BQ);"),
        ("load_rows<BQ, D>(dos + st * BQ * D, &do_map, full, head, qt * BQ);",
         "load_rows<BQ, D>(dos + st * BQ * D, &do_map, full, 0, head * seq_q + qt * BQ);"),
        ("load_rows<ROWS, D>(qs, &q_map, qdo_full, head, q0);",
         "load_rows<ROWS, D>(qs, &q_map, qdo_full, 0, head * seq_q + q0);"),
        ("load_rows<ROWS, D>(dos, &do_map, qdo_full, head, q0);",
         "load_rows<ROWS, D>(dos, &do_map, qdo_full, 0, head * seq_q + q0);"),
        ("load_rows<BN, D>(ks + st * BN * D, &k_map, ring_full, head, kt * BN);",
         "load_rows<BN, D>(ks + st * BN * D, &k_map, ring_full, 0, head * seq_k + kt * BN);"),
        ("load_rows<BN, D>(vs + st * BN * D, &v_map, ring_full, head, kt * BN);",
         "load_rows<BN, D>(vs + st * BN * D, &v_map, ring_full, 0, head * seq_k + kt * BN);"),
    ],
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


@pytest.fixture
def mutant(dev, request, tmp_path, monkeypatch):
    if request.param is None:
        return None
    src = (_build.CSRC / "flash_attention.cu").read_text()
    for line, broken in {**MUTANTS, **WIDE_MUTANTS}[request.param]:
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
