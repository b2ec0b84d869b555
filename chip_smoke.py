"""Smoke run of ray_tpu_torch on one NVIDIA GPU: builds the CUDA kernels from
the checkout, holds each against its plain PyTorch version, then drives the
GPT-2-small forward and train step through them.

    python3 chip_smoke.py            # needs one CUDA card, nvcc, the checkout

Phases, each printing one JSON line:
  1. card     nvidia-smi's name and power limit, torch's device name;
     build    each kernel's registers and spills (ptxas -v) and its count of
              tensor-core instructions (HMMA in cuobjdump -sass); every
              tensor-core (*_tc) kernel must have HMMA and no spill;
  2. kernels  every kernel against its plain version, element by element
              (f32 with TF32 off and bf16; causal and not; head_dim 64 and
              128; T in 192, 1000, 1024; GQA through `mha`), then at the
              slice's shape the kernel's time, the plain version's,
              F.scaled_dot_product_attention's (a yardstick only: the port
              never calls it), the bound, the useful TFLOP/s and the share
              of the bound reached (bound_ms / ms);
  3. forward  transformer_apply at GPT-2-small widths through the kernels and
              through the plain attention in bf16, each against the same
              weights run in f32;
  4. train    the first step's loss and gradients through the kernels and
              through the plain attention in bf16, each against f32; then
              make_train_step: a warm-up and ten steps on one repeated
              batch; losses, tokens/s, useful- and hardware-MFU;
  5. profile  where a train step spends its device time, by kernel family,
              and the device's idle share;
  6. the kernels line, with each kernel's launches in phases 3 and 4.
Any failure exits non-zero. The last line is the ok line.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import math
import os
import re
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

SEED = 0
# GPT-2 small, as the JAX package's bench configures it, at batch 8.
GPT2_SMALL = dict(vocab_size=50304, d_model=768, n_layers=12, n_heads=12,
                  max_seq_len=1024, dtype=torch.bfloat16, remat=True)
BATCH, SEQ, TRAIN_STEPS = 8, 1024, 10
# Peaks from NVIDIA's data sheets (dense bf16) and the H100's HBM3 rate.
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
HBM_BYTES_PER_S = 3.35e12
# Kernel against its plain version, element by element. Both take the same
# inputs, do f32 arithmetic (TF32 off) and differ only in the order they sum.
#  - f32 outputs (lse, dq, dk, dv always; o from f32 inputs): within
#    F32_ATOL, as tests/test_kernels_and_tensors.py:56 holds its kernels.
#  - bf16 outputs (o from bf16 inputs, the grads `mha` casts back to bf16):
#    both sides round f32 values that agree to ~1e-6, so they end at most
#    one bf16 ulp apart, and an ulp is at most 2^-7 of the value:
#    |kernel - plain| <= BF16_RTOL * |plain| + BF16_ATOL, where BF16_ATOL
#    covers the f32 difference near 0. A limit relative to each element
#    holds the small outputs too, which an absolute one would not.
F32_ATOL = 2e-4
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-4
# Logits: the kernel path and the plain path both run in bf16 and round at
# different places, and an ulp of difference spreads through 12 random-init
# layers. So each is held against the same weights run in f32 through the
# plain path, and the kernel path must be no further from that than the
# plain bf16 path is: mean abs error within 1.25x, max abs error within 2x
# (the max is a count of whole bf16 ulps at the largest logits).
LOGITS_MEAN_RATIO, LOGITS_MAX_RATIO = 1.25, 2.0
# The first step's gradients, the same way: every parameter's gradient
# through the kernels no further (relative L2) from the f32 run's than the
# plain bf16 path's is, within 1.25x. The attention projections get their
# gradients only through the backward kernels, so a wrong dq, dk or dv shows
# there as an error of order 1, against bf16's ~1e-2.
GRAD_RATIO = 1.25
# First loss, kernel path against plain path, both bf16 on the same weights
# and batch: ln(V) plus O(0.1) at random init, so this is a weak check
# beside the gradients'; the two differ by rounding only.
LOSS_BOUND = 1e-3

KERNELS = [  # name, launch-count key, TPU kernel it replaces
    ("flash_fwd", "fwd", "ray_tpu/ops/flash_attention.py:35"),
    ("flash_fwd_lse", "fwd_lse", "ray_tpu/ops/flash_attention.py:109"),
    ("flash_bwd_dq", "bwd_dq", "ray_tpu/ops/flash_attention.py:289"),
    ("flash_bwd_dkv", "bwd_dkv", "ray_tpu/ops/flash_attention.py:328"),
]
SOURCE = "ray_tpu_torch/ops/csrc/flash_attention.cu"


class SmokeFailure(Exception):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def max_err(a, b) -> float:
    return float((a.detach().float() - b.detach().float()).abs().max())


def err_ratio(x, ref, slack=None) -> float:
    """Worst element of |x - ref| over its limit; the check passes at <= 1.
    The limit is F32_ATOL for f32 outputs and BF16_RTOL * (|ref| + slack) +
    BF16_ATOL for bf16 ones, where `slack` is the magnitude of bf16 terms
    that were each rounded before they were summed into ref."""
    err = (x.detach().float() - ref.detach().float()).abs()
    if x.dtype != torch.bfloat16:
        return float(err.max()) / F32_ATOL
    mag = ref.detach().float().abs()
    if slack is not None:
        mag = mag + slack
    return float((err / (BF16_RTOL * mag + BF16_ATOL)).max())


def compare(pairs: dict) -> tuple:
    """{kernel: [(out, plain out[, slack]), ...]} -> ({kernel: max abs
    error}, {kernel: worst error-to-limit ratio})."""
    errs = {key: max(max_err(p[0], p[1]) for p in ps) for key, ps in pairs.items()}
    ratios = {key: max(err_ratio(*p) for p in ps) for key, ps in pairs.items()}
    return errs, ratios


def check_ratios(ratios: dict, where) -> None:
    for key, r in ratios.items():
        check(math.isfinite(r) and r <= 1.0, f"{key} off its plain version in {where}: {ratios}")


def time_ms(fn, reps: int = 20) -> float:
    """Mean device time of fn over reps calls run back to back, after one
    warm-up. The stream is held busy (torch.cuda._sleep) until every call is
    queued, so the card never waits on the host between calls: a host slower
    than the card, as for an autograd backward of many small launches, would
    otherwise set the figure. The hold grows until the start event is still
    pending once the last call is queued."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for hold in (10_000_000 * 4 ** i for i in range(6)):  # GPU cycles, ~5 ms up
        torch.cuda._sleep(hold)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued_in_time = not start.query()
        torch.cuda.synchronize()
        if queued_in_time:
            return start.elapsed_time(end) / reps
    raise SmokeFailure("the host could not queue the timed calls ahead of the card")


def card() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    return {"nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def peak_bf16_for(name: str) -> float:
    """Dense bf16 peak of the card by its name (NVIDIA's data sheets)."""
    if "H100" in name and "PCIe" in name:
        return 756e12
    if "H100" in name or "H200" in name:
        return 989e12
    raise SmokeFailure(f"no bf16 peak known for {name!r}")


# ------------------------------------------------------------ build report

_KERNEL_NAME = re.compile(r"((?:fwd|bwd_dq|bwd_dkv)_kernel(?:_tc)?)"
                          r"I((?:Li\d+E|Lb[01]E|f|13__nv_bfloat16)+)E")
# Tensor-core kernels in the build: fwd_kernel_tc (D x CAUSAL x WRITE_LSE),
# bwd_dq_kernel_tc and bwd_dkv_kernel_tc (D x CAUSAL each).
N_TC_KERNELS = 16
_TEMPLATE_ARG = re.compile(r"Li(\d+)E|Lb([01])E|(13__nv_bfloat16|f)")


def kernel_label(mangled: str) -> str:
    """A kernel's mangled name as 'fwd_kernel_tc<64,true,false>'; other
    names unchanged."""
    m = _KERNEL_NAME.search(mangled)
    if not m:
        return mangled
    args = [n or {"1": "true", "0": "false"}.get(b) or {"f": "f32"}.get(t, "bf16")
            for n, b, t in _TEMPLATE_ARG.findall(m.group(2))]
    return f"{m.group(1)}<{','.join(args)}>"


def ptxas_report(log: str) -> dict:
    """{kernel: {"registers", "spill_stores", "spill_loads"}} from ptxas -v."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )([^'\s]+)", line)
        if m:
            cur = out.setdefault(kernel_label(m.group(1)), {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur is not None:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return out


def sass_hmma(sass: str) -> dict:
    """{kernel: count of tensor-core (HMMA) instructions} from cuobjdump -sass."""
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = kernel_label(m.group(1))
            out[cur] = 0
        elif cur is not None and "HMMA" in line:
            out[cur] += 1
    return out


def build_report(build) -> dict:
    """Registers, spills and HMMA count of each kernel of the flash library;
    fails unless all N_TC_KERNELS tensor-core kernels are there, each with
    HMMA instructions and no spill."""
    lib = build.library_path("flash_attention")
    regs = ptxas_report(lib.with_suffix(".log").read_text())
    sass = subprocess.run([build.tool("cuobjdump"), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    hmma = sass_hmma(sass)
    report = {name: {**regs.get(name, {}), "hmma": n} for name, n in sorted(hmma.items())}
    tc = {name: r for name, r in report.items() if "_tc<" in name}
    check(len(tc) == N_TC_KERNELS and all(r["hmma"] > 0 and r.get("spill_stores") == 0
                                          and r.get("spill_loads") == 0 for r in tc.values()),
          f"want {N_TC_KERNELS} tensor-core kernels, each with HMMA and no spill: {tc}")
    return report


# ----------------------------------------------------------------- phase 2

def kernel_cases(fa, dev, gen) -> None:
    """Every kernel against its plain version on the listed cases. Prints
    each case's max abs error and worst error-to-limit ratio (F32_ATOL,
    BF16_RTOL, BF16_ATOL) per kernel."""
    worst = {key: {"max_abs_err": 0.0, "err_to_limit": 0.0} for _, key, _ in KERNELS}
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for D in (64, 128):
            for T in (192, 1000, 1024):
                for causal in (True, False):
                    q, k, v, do = (torch.randn(4, T, D, device=dev, generator=gen).to(dtype)
                                   for _ in range(4))
                    scale = D ** -0.5
                    ref_o, ref_lse = fa._flash_fwd_ref(q, k, v, causal, scale, True)
                    o, lse = fa.flash_fwd(q, k, v, causal=causal, scale=scale, with_lse=True)
                    o1 = fa.flash_fwd(q, k, v, causal=causal, scale=scale)
                    delta = (do.float() * ref_o.float()).sum(-1)
                    dq = fa.flash_bwd_dq(q, k, v, do, ref_lse, delta, causal=causal, scale=scale)
                    dk, dv = fa.flash_bwd_dkv(q, k, v, do, ref_lse, delta, causal=causal, scale=scale)
                    ref_dq = fa._flash_bwd_dq_ref(q, k, v, do, ref_lse, delta, causal, scale)
                    ref_dk, ref_dv = fa._flash_bwd_dkv_ref(q, k, v, do, ref_lse, delta, causal, scale)
                    errs, ratios = compare({
                        "fwd": [(o1, ref_o)],
                        "fwd_lse": [(o, ref_o), (lse, ref_lse)],
                        "bwd_dq": [(dq, ref_dq)],
                        "bwd_dkv": [(dk, ref_dk), (dv, ref_dv)],
                    })
                    case = dict(dtype=str(dtype).split(".")[-1], D=D, T=T, causal=causal,
                                max_abs_err=errs, err_to_limit=ratios)
                    emit({"phase": "kernels", "case": case})
                    check_ratios(ratios, case)
                    for key in errs:
                        w = worst[key]
                        w["max_abs_err"] = max(w["max_abs_err"], errs[key])
                        w["err_to_limit"] = max(w["err_to_limit"], ratios[key])
                    cases += 1
    for dtype in (torch.float32, torch.bfloat16):
        gqa_case(fa, dev, gen, dtype)
        cases += 1
    emit({"phase": "kernels", "cases": cases, "worst": worst,
          "limits": {"f32_atol": F32_ATOL, "bf16_rtol": BF16_RTOL, "bf16_atol": BF16_ATOL}})


def gqa_case(fa, dev, gen, dtype) -> None:
    """GQA through `mha` (8 query heads on 2 kv heads): forward and
    gradients of the autograd function around the kernels.

    f32: against autograd through the plain attention, another formulation
    of the same function. bf16: against the kernels' plain versions,
    composed as the autograd function composes them, on kv heads this
    script expands itself in jnp.repeat's order. Both take delta =
    rowsum(do * o) from the kernel path's bf16 o: where two o's are an ulp
    apart, delta moves dq by more than an ulp where dq is near 0, which is
    also why autograd through the plain attention (no rounded o at all) is
    no reference in bf16. Each head's bf16 dk and dv is rounded before the
    heads that share a kv head are summed, so those sums get the rounded
    terms' magnitudes as slack."""
    B, T, H, Hk, D = 2, 1000, 8, 2, 64
    rep, scale = H // Hk, D ** -0.5
    q, do = (torch.randn(B, T, H, D, device=dev, generator=gen).to(dtype) for _ in range(2))
    k, v = (torch.randn(B, T, Hk, D, device=dev, generator=gen).to(dtype) for _ in range(2))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = fa.mha(*leaves, causal=True, impl="kernel")
    got = (o, *torch.autograd.grad(o, leaves, do))
    if dtype == torch.float32:
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = fa.mha(*leaves, causal=True, impl="torch")
        want = (o, *torch.autograd.grad(o, leaves, do))
        slack = (None,) * 4
    else:
        def bhtd(x):  # [B, T, h, D] -> [B*h, T, D]
            return x.transpose(1, 2).reshape(-1, T, D)

        def bthd(x):  # [B*h, T, D] -> [B, T, h, D]
            return x.reshape(B, -1, T, D).transpose(1, 2)

        qf, kf, vf, dof = (bhtd(t) for t in (q, k.repeat_interleave(rep, dim=2),
                                             v.repeat_interleave(rep, dim=2), do))
        o_ref, lse = fa._flash_fwd_ref(qf, kf, vf, True, scale, True)
        delta = (dof.float() * bhtd(got[0].detach()).float()).sum(-1)
        dq = fa._flash_bwd_dq_ref(qf, kf, vf, dof, lse, delta, True, scale).to(dtype)
        heads = [bthd(g.to(dtype)).float().reshape(B, T, Hk, rep, D)
                 for g in fa._flash_bwd_dkv_ref(qf, kf, vf, dof, lse, delta, True, scale)]
        want = (bthd(o_ref), bthd(dq), *(h.sum(3).to(dtype) for h in heads))
        slack = (None, None, *(h.abs().sum(3) for h in heads))
    names = ("o", "dq", "dk", "dv")
    errs = {n: max_err(a, b) for n, a, b in zip(names, got, want)}
    ratios = {n: err_ratio(a, b, s) for n, a, b, s in zip(names, got, want, slack)}
    case = {"dtype": str(dtype).split(".")[-1], "B_T_H_Hk_D": [B, T, H, Hk, D],
            "max_abs_err": errs, "err_to_limit": ratios}
    emit({"phase": "kernels", "gqa": case})
    check_ratios(ratios, {"gqa": case})


def kernel_timings(fa, dev, gen, cfg) -> dict:
    """Each kernel at the shapes the train step gives it (bf16, causal,
    [B*H, T, D]): its time, its plain version's, the library call's and its
    bound. Returns {key: row}."""
    BH, T, D = BATCH * cfg.n_heads, SEQ, cfg.head_dim
    dt = cfg.dtype
    q, k, v, do = (torch.randn(BH, T, D, device=dev, generator=gen).to(dt) for _ in range(4))
    scale = D ** -0.5
    o, lse = fa.flash_fwd(q, k, v, causal=True, scale=scale, with_lse=True)
    delta = (do.float() * o.float()).sum(-1)

    ref_o, ref_lse = fa._flash_fwd_ref(q, k, v, True, scale, True)
    errs, ratios = compare({
        "fwd": [(fa.flash_fwd(q, k, v, causal=True, scale=scale), ref_o)],
        "fwd_lse": [(o, ref_o), (lse, ref_lse)],
        "bwd_dq": [(fa.flash_bwd_dq(q, k, v, do, lse, delta, causal=True, scale=scale),
                    fa._flash_bwd_dq_ref(q, k, v, do, lse, delta, True, scale))],
        "bwd_dkv": list(zip(fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal=True, scale=scale),
                            fa._flash_bwd_dkv_ref(q, k, v, do, lse, delta, True, scale))),
    })
    del ref_o, ref_lse
    check_ratios(ratios, "the slice's shape")

    kernel_fns = {
        "fwd": lambda: fa.flash_fwd(q, k, v, causal=True, scale=scale),
        "fwd_lse": lambda: fa.flash_fwd(q, k, v, causal=True, scale=scale, with_lse=True),
        "bwd_dq": lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, causal=True, scale=scale),
        "bwd_dkv": lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal=True, scale=scale),
    }
    plain_fns = {
        "fwd": lambda: fa._flash_fwd_ref(q, k, v, True, scale),
        "fwd_lse": lambda: fa._flash_fwd_ref(q, k, v, True, scale, True),
        "bwd_dq": lambda: fa._flash_bwd_dq_ref(q, k, v, do, lse, delta, True, scale),
        "bwd_dkv": lambda: fa._flash_bwd_dkv_ref(q, k, v, do, lse, delta, True, scale),
    }
    # Yardstick: PyTorch's fused attention on the same inputs, [B, H, T, D].
    sq, sk, sv = (t.view(BATCH, cfg.n_heads, T, D).detach().requires_grad_(True) for t in (q, k, v))
    sdo = do.view(BATCH, cfg.n_heads, T, D)
    with torch.no_grad():
        sdpa_fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(sq, sk, sv, is_causal=True))
    so = F.scaled_dot_product_attention(sq, sk, sv, is_causal=True)
    sdpa_bwd_ms = time_ms(lambda: torch.autograd.grad(so, (sq, sk, sv), sdo, retain_graph=True))
    sdpa_fwd_bwd_ms = time_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(sq, sk, sv, is_causal=True), (sq, sk, sv), sdo))
    # The port's forward and backward through its autograd function, the same work.
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    port_fwd_bwd_ms = time_ms(lambda: torch.autograd.grad(
        fa._FlashAttention.apply(*leaves, True, scale), leaves, do))
    library = {"fwd": sdpa_fwd_ms, "fwd_lse": sdpa_fwd_ms,
               "bwd_dq": sdpa_bwd_ms, "bwd_dkv": sdpa_bwd_ms}

    pairs = BH * T * (T + 1) / 2  # (query, key) pairs under the causal mask
    elt = q.element_size()
    mat = BH * T * D  # elements of one [BH, T, D] operand
    work = {  # (flops, bytes): each input read once, each output written once
        "fwd": (4 * D * pairs, 4 * mat * elt),
        "fwd_lse": (4 * D * pairs, 4 * mat * elt + BH * T * 4),
        "bwd_dq": (6 * D * pairs, 4 * mat * elt + 2 * BH * T * 4 + mat * 4),
        "bwd_dkv": (8 * D * pairs, 4 * mat * elt + 2 * BH * T * 4 + 2 * mat * 4),
    }
    peak = PEAK_BF16 if dt == torch.bfloat16 else PEAK_F32
    rows = {}
    for _, key, _ in KERNELS:
        flops, nbytes = work[key]
        t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        ms = time_ms(kernel_fns[key])
        rows[key] = {
            "max_abs_err": errs[key],
            "err_to_limit": ratios[key],
            "ms": ms,
            "plain_ms": time_ms(plain_fns[key], reps=5),
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library[key],
            "tflops": flops / ms * 1e-9,  # useful flops, no recompute, no hi/lo split
            "bound_share": max(t_ops, t_bytes) / ms,
        }
    emit({"phase": "kernels", "shape": [BH, T, D], "dtype": str(dt).split(".")[-1], "causal": True,
          "timings": rows, "sdpa_fwd_ms": sdpa_fwd_ms, "sdpa_bwd_ms": sdpa_bwd_ms,
          "sdpa_fwd_bwd_ms": sdpa_fwd_bwd_ms, "port_fwd_bwd_ms": port_fwd_bwd_ms})
    return rows


# ------------------------------------------------------------- phases 3, 4

def forward_phase(tr, fa, cfg, dev, gen, tokens) -> dict:
    model = tr.transformer_init(cfg, gen, device=dev)
    plain = tr.Transformer(dataclasses.replace(cfg, attention_impl="torch"), dev)
    plain.load_state_dict(model.state_dict())
    fa.reset_launches()
    with torch.no_grad():
        logits = tr.transformer_apply(model, tokens)
        torch.cuda.synchronize()
        launches = dict(fa.launches)
        ref = tr.transformer_apply(plain, tokens)
        f32 = tr.Transformer(dataclasses.replace(cfg, attention_impl="torch", dtype=torch.float32), dev)
        f32.load_state_dict(model.state_dict())
        truth = tr.transformer_apply(f32, tokens)
    errs = {name: {"max_abs_err": max_err(x, truth),
                   "mean_abs_err": float((x - truth).abs().mean())}
            for name, x in (("kernel_bf16", logits), ("plain_bf16", ref))}
    line = {"phase": "forward", "shape": list(logits.shape), "vs_f32": errs,
            "kernel_vs_plain_max_abs_err": max_err(logits, ref),
            "f32_max_abs": float(truth.abs().max()),
            "f32_mean_abs": float(truth.abs().mean()),
            "ratio_bounds": [LOGITS_MEAN_RATIO, LOGITS_MAX_RATIO], "launches": launches}
    emit(line)
    check(tuple(logits.shape) == (BATCH, SEQ, cfg.vocab_size), "logits have the wrong shape")
    check(bool(torch.isfinite(logits).all()), "logits are not finite")
    k, p = errs["kernel_bf16"], errs["plain_bf16"]
    check(k["mean_abs_err"] <= LOGITS_MEAN_RATIO * p["mean_abs_err"]
          and k["max_abs_err"] <= LOGITS_MAX_RATIO * p["max_abs_err"],
          f"kernel-path logits further from f32 than the plain path's: {errs}")
    return launches


def first_grads(tr, model, batch) -> tuple:
    """(loss, {name: gradient}) of one forward and backward."""
    loss = tr.transformer_loss(model, batch)
    loss.backward()
    grads = {name: p.grad for name, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def grads_check(tr, cfg, dev, model, batch) -> None:
    """The first step's loss and every parameter's gradient through the
    kernels, against the plain path in bf16 and in f32 on the same weights."""
    loss, grads = first_grads(tr, model, batch)
    ref = {}
    for name, c in (("plain_bf16", dataclasses.replace(cfg, attention_impl="torch")),
                    ("plain_f32", dataclasses.replace(cfg, attention_impl="torch",
                                                      dtype=torch.float32))):
        m = tr.Transformer(c, dev)
        m.load_state_dict(model.state_dict())
        ref[name] = first_grads(tr, m, batch)
        del m
    truth = ref["plain_f32"][1]

    def rel(g, n):
        return float(torch.linalg.vector_norm(g[n] - truth[n]) / torch.linalg.vector_norm(truth[n]))

    ratios = {n: rel(grads, n) / max(rel(ref["plain_bf16"][1], n), 1e-12) for n in truth}
    worst = sorted(ratios, key=ratios.get)[-3:]
    emit({"phase": "train", "first_step": {
        "loss": loss, "loss_plain_bf16": ref["plain_bf16"][0], "loss_plain_f32": ref["plain_f32"][0],
        "loss_bound": LOSS_BOUND, "grad_ratio_bound": GRAD_RATIO,
        "worst_grad_ratio": {n: ratios[n] for n in worst},
        "rel_err_vs_f32": {n: {"kernel_bf16": rel(grads, n), "plain_bf16": rel(ref["plain_bf16"][1], n)}
                           for n in ("embed", "blocks.0.wq", "blocks.0.wk", "blocks.0.wv",
                                     f"blocks.{cfg.n_layers - 1}.wk", worst[-1])},
    }})
    check(abs(loss - ref["plain_bf16"][0]) <= LOSS_BOUND, "first loss off the plain path")
    check(all(math.isfinite(r) and r <= GRAD_RATIO for r in ratios.values()),
          f"gradients through the kernels further from f32 than the plain path's: {worst}")


def train_phase(tr, fa, cfg, dev, gen) -> tuple:
    raw = torch.randint(0, cfg.vocab_size, (BATCH, SEQ + 1), device=dev, generator=gen)
    batch = {"tokens": raw[:, :-1].contiguous(), "targets": raw[:, 1:].contiguous()}
    model = tr.transformer_init(cfg, gen, device=dev)
    grads_check(tr, cfg, dev, model, batch)
    init_state, step = tr.make_train_step(cfg, dev)
    state = init_state(model=model)

    fa.reset_launches()
    state, m = step(state, batch)  # warm-up
    losses = [float(m["loss"])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, m = step(state, batch)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(fa.launches)
    losses = [losses[0]] + [float(x) for x in losses[1:]]

    tokens_per_s = BATCH * SEQ * TRAIN_STEPS / dt
    peak = peak_bf16_for(torch.cuda.get_device_name(0))
    useful = tr.flops_per_token(cfg, SEQ)
    hardware = tr.hardware_flops_per_token(cfg, SEQ)
    line = {
        "phase": "train", "batch": BATCH, "seq": SEQ, "steps": TRAIN_STEPS,
        "losses": losses, "step_ms": dt / TRAIN_STEPS * 1e3, "tokens_per_s": tokens_per_s,
        "useful_mfu": useful * tokens_per_s / peak,
        "hardware_mfu": hardware * tokens_per_s / peak,
        "useful_flops_per_token": useful, "hardware_flops_per_token": hardware,
        "peak_flops": peak, "grad_norm": float(m["grad_norm"]),
        "max_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": launches,
    }
    emit(line)
    check(all(math.isfinite(x) for x in losses), "a loss is not finite")
    check(losses[-1] < losses[0], "the loss did not fall")
    check(line["hardware_mfu"] < 1.0, "hardware-MFU is not below 1")
    return launches, lambda: step(state, batch), line["step_ms"]


def profile_phase(run_step, step_ms: float) -> None:
    """Where the device time of two train steps goes, by kernel family
    (torch.profiler), each flash kernel's share, and the device's idle share
    in the unprofiled steps of phase 4: 1 - device time per step / step time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    steps = 2
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            run_step()
        torch.cuda.synchronize()
    # Device-side user annotations (Optimizer.step#...) span kernels already counted.
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    by_name, flash = {}, {}
    families, counts = {}, {}
    for e in kernels:
        name, ms = e.name, e.time_range.elapsed_us() / 1e3 / steps
        by_name[name] = by_name.get(name, 0.0) + ms
        if any(s in name for s in ("fwd_kernel", "bwd_dq_kernel", "bwd_dkv_kernel")):
            fam = "flash (this repo)"
            m = re.search(r"\w+_kernel(?:_tc)?<[^>]*>", name)  # demangled: drop the arguments
            key = m.group(0) if m else kernel_label(name)
            flash[key] = flash.get(key, 0.0) + ms
        elif any(s in name.lower() for s in ("gemm", "cutlass", "xmma", "nvjet", "sm90")):
            fam = "matmul (cuBLAS)"
        elif "multi_tensor" in name or "adam" in name.lower():
            fam = "optimizer"
        else:
            fam = "other"
        families[fam] = families.get(fam, 0.0) + ms
        counts[fam] = counts.get(fam, 0) + 1
    device_ms = sum(families.values())
    top = sorted(((ms, name) for name, ms in by_name.items()), reverse=True)[:8]
    emit({"phase": "profile", "per_step": True, "device_ms": device_ms, "step_ms": step_ms,
          "idle_share": 1 - device_ms / step_ms if device_ms else None,
          "ms_by_family": families,
          "launches_by_family": {k: v // steps for k, v in counts.items()},
          "flash_ms_by_kernel": flash,
          "top_kernels_ms": [[n[:80], ms] for ms, n in top]})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # The package comes from the checkout this script sits in, and nowhere else.
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ray_tpu_torch.ops import _build

    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    tr = importlib.import_module("ray_tpu_torch.models.transformer")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    info = card()
    emit({"phase": "card", **info})

    t0 = time.perf_counter()
    for name in _build.sources():
        _build.build(name)
    emit({"phase": "build", "sources": _build.sources(), "seconds": time.perf_counter() - t0,
          "kernels": build_report(_build)})

    cfg = tr.TransformerConfig(**GPT2_SMALL)
    kernel_cases(fa, dev, gen)
    rows = kernel_timings(fa, dev, gen, cfg)

    tokens = torch.randint(0, cfg.vocab_size, (BATCH, SEQ), device=dev, generator=gen)
    fwd_launches = forward_phase(tr, fa, cfg, dev, gen, tokens)
    train_launches, run_step, step_ms = train_phase(tr, fa, cfg, dev, gen)
    profile_phase(run_step, step_ms)

    kernels = []
    for name, key, replaces in KERNELS:
        n = fwd_launches[key] + train_launches[key]
        kernels.append({"name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
                        "launches": n, **rows[key]})
        check(n > 0, f"{name} was not launched on the main path")
    print(info["nvidia_smi"], flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"], "count": info["count"]}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
