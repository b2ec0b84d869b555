"""Blocked (flash) attention: hand-written CUDA kernels for Hopper.

Port of ray_tpu/ops/flash_attention.py. The four Pallas TPU kernels there
become the CUDA kernels of `csrc/flash_attention.cu`, bound with ctypes:

  flash_fwd(with_lse=False)  <- _attn_fwd_kernel      (B1)
  flash_fwd(with_lse=True)   <- _attn_fwd_kernel_lse  (B2)
  flash_bwd_dq               <- _attn_bwd_dq_kernel   (B3)
  flash_bwd_dkv              <- _attn_bwd_dkv_kernel  (B4)

For bf16 inputs (the train step's) all four run on the tensor cores; f32
inputs run on the f32 CUDA cores. Either way every sum is f32 and the plain
versions below are what they compute.

Each wrapper launches its kernel for a CUDA tensor and raises on anything
the kernel does not take; for a CPU tensor it runs its plain PyTorch
version (`_flash_*_ref`), which repeats the kernel's arithmetic densely and
is what the CPU tests hold against the JAX package. `launches` counts the
kernel launches of each wrapper.

`_FlashAttention` is the autograd function around them, mirroring the
reference's custom_vjp: the forward saves (q, k, v, o, lse); the backward
forms delta = rowsum(do * o) in f32 and calls the dq and dk/dv kernels.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

_BIG_NEG = -1e30

launches: Dict[str, int] = {"fwd": 0, "fwd_lse": 0, "bwd_dq": 0, "bwd_dkv": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the signatures of a loaded flash_attention library's C entry points."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rt_flash_fwd.argtypes = [P, P, P, P, P, I, I, I, I, F, I, I, P]
    lib.rt_flash_bwd_dq.argtypes = [P, P, P, P, P, P, P, I, I, I, I, F, I, I, P]
    lib.rt_flash_bwd_dkv.argtypes = [P, P, P, P, P, P, P, P, I, I, I, I, F, I, I, P]
    for fn in (lib.rt_flash_fwd, lib.rt_flash_bwd_dq, lib.rt_flash_bwd_dkv):
        fn.restype = ctypes.c_int
    lib.rt_error_string.argtypes = [ctypes.c_int]
    lib.rt_error_string.restype = ctypes.c_char_p
    return lib


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from ray_tpu_torch.ops import _build

        _lib = _bind(_build.load("flash_attention"))
    return _lib


def _check_err(err: int, what: str) -> None:
    if err:
        msg = _kernels().rt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")


def _check_inputs(q, k, v, *rest) -> None:
    """Raise unless the kernels take these [BH, T, D] / [BH, S, D] tensors."""
    for t in (q, k, v, *rest):
        if t.device.type != "cuda":
            raise ValueError(f"flash kernels need CUDA tensors, got {t.device}")
        if t.device != q.device:
            raise ValueError("flash kernels need all tensors on one device")
        if t.dtype != q.dtype:
            raise ValueError(f"flash kernels need one dtype, got {q.dtype} and {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("flash kernels need contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError("flash kernels load rows 16 bytes at a time: tensors must be 16-byte aligned")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash kernels take float32 or bfloat16, got {q.dtype}")
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3:
        raise ValueError(f"flash kernels take q [BH,T,D], k/v [BH,S,D]; got {q.shape}, {k.shape}, {v.shape}")
    BH, T, D = q.shape
    if k.shape[0] != BH or k.shape[2] != D:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash kernels take head_dim in {_HEAD_DIMS}, got {D}")
    if not 0 < BH <= 65535 or T == 0 or k.shape[1] == 0:
        raise ValueError(f"flash kernels need 0 < BH <= 65535 and T, S > 0; got {q.shape}, {k.shape}")


def _check_stats(q, *stats) -> None:
    for t in stats:
        if t.dtype != torch.float32 or t.shape != q.shape[:2] or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"lse/delta must be contiguous float32 {tuple(q.shape[:2])} on {q.device}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ------------------------------------------------------------ plain versions

def _causal_mask(T: int, S: int, device) -> torch.Tensor:
    return torch.arange(T, device=device)[:, None] >= torch.arange(S, device=device)[None, :]


def _flash_fwd_ref(q, k, v, causal: bool, scale: float, with_lse: bool = False):
    """Plain version of B1/B2: o in q's dtype and, with_lse, lse [BH, T] f32."""
    s = torch.einsum("btd,bsd->bts", q.float(), k.float()) * scale
    if causal:
        mask = _causal_mask(q.shape[1], k.shape[1], q.device)
        s = s.masked_fill(~mask, _BIG_NEG)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    if causal:
        p = p.masked_fill(~mask, 0.0)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = (torch.einsum("bts,bsd->btd", p, v.float()) / l).to(q.dtype)
    if not with_lse:
        return o
    return o, (m + torch.log(l)).squeeze(-1)


def _bwd_tile_ref(q, k, v, do, lse, delta, causal: bool, scale: float):
    """Shared recompute of both backward plain versions (as _bwd_tile):
    returns (p, ds), both [BH, T, S] f32."""
    s = torch.einsum("btd,bsd->bts", q.float(), k.float()) * scale
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("btd,bsd->bts", do.float(), v.float())
    ds = p * (dp - delta[..., None]) * scale
    if causal:
        mask = _causal_mask(q.shape[1], k.shape[1], q.device)
        p = p.masked_fill(~mask, 0.0)
        ds = ds.masked_fill(~mask, 0.0)
    return p, ds


def _flash_bwd_dq_ref(q, k, v, do, lse, delta, causal: bool, scale: float):
    """Plain version of B3: dq [BH, T, D] f32."""
    _, ds = _bwd_tile_ref(q, k, v, do, lse, delta, causal, scale)
    return torch.einsum("bts,bsd->btd", ds, k.float())


def _flash_bwd_dkv_ref(q, k, v, do, lse, delta, causal: bool, scale: float):
    """Plain version of B4: (dk, dv), each [BH, S, D] f32."""
    p, ds = _bwd_tile_ref(q, k, v, do, lse, delta, causal, scale)
    dk = torch.einsum("bts,btd->bsd", ds, q.float())
    dv = torch.einsum("bts,btd->bsd", p, do.float())
    return dk, dv


def _torch_attention_bhtd(q, k, v, *, causal: bool, scale: float):
    """Plain attention on [BH, T, D] (mirrors _xla_attention_bhtd); autograd
    differentiates it, so it needs none of the kernels."""
    s = torch.einsum("btd,bsd->bts", q.float(), k.float()) * scale
    if causal:
        s = s.masked_fill(~_causal_mask(q.shape[1], k.shape[1], q.device), _BIG_NEG)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / p.sum(-1, keepdim=True)
    return torch.einsum("bts,bsd->btd", p, v.float()).to(q.dtype)


# ------------------------------------------------------------------ wrappers

def flash_fwd(q, k, v, *, causal: bool, scale: float, with_lse: bool = False):
    """Attention forward on [BH, T, D]: o, or (o, lse [BH, T] f32) with_lse."""
    if q.device.type == "cpu":
        return _flash_fwd_ref(q, k, v, causal, scale, with_lse)
    _check_inputs(q, k, v)
    if not scale > 0:  # the kernel takes the row max before it scales
        raise ValueError(f"flash_fwd needs scale > 0, got {scale}")
    BH, T, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((BH, T), dtype=torch.float32, device=q.device) if with_lse else None
    with torch.cuda.device(q.device):
        err = _kernels().rt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if with_lse else None, BH, T, k.shape[1], D, scale,
            int(causal), _DTYPES[q.dtype], _stream(q.device),
        )
    _check_err(err, "flash_fwd")
    launches["fwd_lse" if with_lse else "fwd"] += 1
    return (o, lse) if with_lse else o


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool, scale: float):
    """dq [BH, T, D] f32 from the saved forward and delta = rowsum(do * o)."""
    if q.device.type == "cpu":
        return _flash_bwd_dq_ref(q, k, v, do, lse, delta, causal, scale)
    _check_inputs(q, k, v, do)
    _check_stats(q, lse, delta)
    BH, T, D = q.shape
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _kernels().rt_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), BH, T, k.shape[1], D, scale, int(causal),
            _DTYPES[q.dtype], _stream(q.device),
        )
    _check_err(err, "flash_bwd_dq")
    launches["bwd_dq"] += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool, scale: float):
    """(dk, dv), each [BH, S, D] f32."""
    if q.device.type == "cpu":
        return _flash_bwd_dkv_ref(q, k, v, do, lse, delta, causal, scale)
    _check_inputs(q, k, v, do)
    _check_stats(q, lse, delta)
    BH, T, D = q.shape
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _kernels().rt_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), BH, T, k.shape[1], D, scale,
            int(causal), _DTYPES[q.dtype], _stream(q.device),
        )
    _check_err(err, "flash_bwd_dkv")
    launches["bwd_dkv"] += 1
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    """Flash attention on [BH, T, D] with the tiled recompute backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        o, lse = flash_fwd(q, k, v, causal=causal, scale=scale, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(-1)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, causal=ctx.causal, scale=ctx.scale)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal=ctx.causal, scale=ctx.scale)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def _to_bhtd(x, rep: int):
    """[B, T, Hk, D] -> [B*Hk*rep, T, D], each kv head repeated `rep` times in
    a row (jnp.repeat on the head axis)."""
    if rep > 1:
        x = x.repeat_interleave(rep, dim=2)
    B, T, H, D = x.shape
    return x.transpose(1, 2).reshape(B * H, T, D)


def flash_attention(q, k, v, *, causal: bool = False, scale: Optional[float] = None):
    """Flash attention on [B, T, H, D] inputs (grouped-query: H_kv may divide H)
    through the kernels (their plain versions for CPU tensors)."""
    B, T, H, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    rep = H // k.shape[2]
    qf, kf, vf = _to_bhtd(q, 1), _to_bhtd(k, rep), _to_bhtd(v, rep)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        of = _FlashAttention.apply(qf, kf, vf, causal, scale)
    else:
        of = flash_fwd(qf, kf, vf, causal=causal, scale=scale)
    return of.reshape(B, H, T, D).transpose(1, 2)


def mha(q, k, v, *, causal: bool = False, scale: Optional[float] = None,
        impl: str = "auto"):
    """Multi-head attention dispatch on [B, T, H, D].

    impl: 'auto' (the kernels for CUDA tensors, plain torch for CPU ones) |
    'kernel' | 'torch'.
    """
    if impl == "auto":
        impl = "kernel" if q.device.type == "cuda" else "torch"
    if impl == "kernel":
        return flash_attention(q, k, v, causal=causal, scale=scale)
    if impl != "torch":
        raise ValueError(f"unknown attention impl {impl!r}")
    B, T, H, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    rep = H // k.shape[2]
    of = _torch_attention_bhtd(
        _to_bhtd(q, 1), _to_bhtd(k, rep), _to_bhtd(v, rep), causal=causal, scale=scale
    )
    return of.reshape(B, H, T, D).transpose(1, 2)
