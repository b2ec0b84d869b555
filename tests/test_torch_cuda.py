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
    lse = torch.zeros(2, 64, device=dev)
    refused = [
        lambda: fa.flash_fwd(q.half(), q.half(), q.half(), causal=True, scale=1.0),  # dtype
        lambda: fa.flash_fwd(q, q.bfloat16(), q, causal=True, scale=1.0),  # mixed dtypes
        lambda: fa.flash_fwd(q[..., :32].contiguous(), q[..., :32].contiguous(),
                             q[..., :32].contiguous(), causal=True, scale=1.0),  # head_dim 32
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


# Deliberately broken copies of the kernels' source, each built into the
# test's own directory and bound in place of the real library, to show that
# chip_smoke.py's limits fail a subtly wrong bf16 (tensor-core) kernel:
# {name: (line, broken line)}; each line occurs once in the source.
MUTANTS = {
    # fwd_kernel_tc drops the last, partial key tile.
    "fwd_drops_partial_key_tile": ("int n_kv_tiles = (seq_k + BK - 1) / BK;",
                                   "int n_kv_tiles = seq_k / BK;"),
    # fwd_kernel_tc rounds P to bf16 once: it drops the lo term of P.V.
    "fwd_drops_lo_term": ("mma_pair(acc[2 * j], acc[2 * j + 1], p_lo, b);", ""),
    # bwd_dkv_kernel_tc drops the last q tile.
    "dkv_drops_last_q_tile": ("const int n_q_tiles = (seq_q + BQ - 1) / BQ;",
                              "const int n_q_tiles = (seq_q + BQ - 1) / BQ - 1;"),
    # bwd_dq_kernel_tc rounds dS to bf16 once: it drops the lo term of dS.K.
    "dq_drops_lo_term": ("mma_pair(dqa[2 * j], dqa[2 * j + 1], ds_lo, b);", ""),
    # bwd_dq_kernel_tc drops the last, partial key tile.
    "dq_drops_partial_key_tile": ("int n_k_tiles = (seq_k + BK - 1) / BK;",
                                  "int n_k_tiles = seq_k / BK;"),
    # bwd_dq_kernel_tc stops one tile short of the causal diagonal.
    "dq_drops_diagonal_tile": ("n_k_tiles = min(n_k_tiles, (q0 + BQ - 1) / BK + 1);",
                               "n_k_tiles = min(n_k_tiles, (q0 + BQ - 1) / BK);"),
}


@pytest.fixture
def mutant(dev, request, tmp_path, monkeypatch):
    if request.param is None:
        return None
    line, broken = MUTANTS[request.param]
    src = (_build.CSRC / "flash_attention.cu").read_text()
    assert src.count(line) == 1
    cu, so = tmp_path / "mutant.cu", tmp_path / "mutant.so"
    cu.write_text(src.replace(line, broken, 1))
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)], check=True)
    monkeypatch.setattr(fa, "_lib", fa._bind(ctypes.CDLL(str(so))))
    return request.param


@pytest.mark.parametrize("mutant", list(MUTANTS), indirect=True)
def test_smoke_limits_catch_a_broken_kernel(dev, mutant):
    """Each broken kernel misses chip_smoke.py's limits in one of the two
    causal modes at T = 1000 (a partial last tile)."""
    cs = importlib.import_module("chip_smoke")
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v, do = (torch.randn(4, 1000, 64, device=dev, generator=g).bfloat16() for _ in range(4))
    scale = 0.125
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
        worst = {key: max(r, worst.get(key, 0.0)) for key, r in ratios.items()}
    broken = {"fwd": "fwd", "dq": "bwd_dq", "dkv": "bwd_dkv"}[mutant.split("_")[0]]
    assert worst[broken] > 1.0, worst


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
