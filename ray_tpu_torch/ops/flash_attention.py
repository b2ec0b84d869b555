"""Blocked (flash) attention: hand-written CUDA kernels for Hopper.

Port of ray_tpu/ops/flash_attention.py. The four Pallas TPU kernels there
become the CUDA kernels of `csrc/flash_attention.cu`, bound with ctypes:

  flash_fwd(with_lse=False)  <- _attn_fwd_kernel      (B1)
  flash_fwd(with_lse=True)   <- _attn_fwd_kernel_lse  (B2)
  flash_bwd_dq               <- _attn_bwd_dq_kernel   (B3)
  flash_bwd_dkv              <- _attn_bwd_dkv_kernel  (B4)

Every kernel runs on the tensor cores. bf16 inputs (the train step's) go
to them as they are. For f32 inputs a split pass (`split_parts`, which
replaces no TPU kernel) writes each f32 operand as two bf16 parts, hi =
bf16(x) and lo = bf16(x - hi), and the kernels sum three bf16 products for
each f32 one (hi.hi + hi.lo + lo.hi), within chip_smoke.py's f32 limit of
the f32 plain version. The `*_parts` wrappers take those parts; the f32
wrappers split their operands and call them. Every sum is f32 and the
plain versions below are what the kernels compute.

One width rule (`kernel_width`), for the forward and the backward alike,
on the card and on the CPU. The kernels are built for head dims 32, 64,
96, 128, 256 and 512 (`WIDTHS`), and any other head dim up to 512 runs at
the next of those widths (1-31 at 32), its q, k, v (and do) zero-padded:
q.k^T, the softmax, lse and delta = rowsum(do * o) are unchanged by zero
columns, and the padded columns of o, dq, dk and dv are zero and cut away.
The scale stays the caller's (1/sqrt of the unpadded width). Past 512 any
head dim runs at the next multiple of 512 (`STREAM_SLICE`) on the streamed
kernels (`stream_route`: fwd_kernel_sm90_stream, bwd_dq_kernel_sm90_stream
and bwd_dkv_kernel_sm90_stream, their contraction over D streamed in
chunks, their output columns in slices), which also take f32 at 512; so the
autograd function, `flash_attention` with gradients and ring attention
train at any head dim, as the TPU kernels do. `flash_attention`, the
autograd function and ring attention pad once a call, in the copy to [BH,
T, D] they make anyway; the wrappers pad what they are given directly.
The CPU path pads too, so the CPU tests run the route the card runs. Any
number of heads BH is taken, as the TPU kernels' grid takes any.

Any finite scale is taken, as the TPU kernels take any. The kernels take
the row max of the raw scores before they scale them, so they launch at a
scale > 0 only, and each wrapper routes a finite scale <= 0 before its
CPU dispatch and any launch (`_route_q`): below 0 it calls with -q and
|scale| (o, lse, dk and dv as they come, dq negated), at 0 with a zero q
and scale 1 (every score 0: o, lse and dv as they come, dk zero by
itself, dq zero without a launch). A non-finite scale raises at the launch.

Each wrapper launches its kernel for a CUDA tensor and raises on anything
the kernel does not take; for a CPU tensor it runs its plain PyTorch
version (`_flash_*_ref`), which repeats the kernel's arithmetic densely and
is what the CPU tests hold against the JAX package. `launches` counts the
kernel launches of each wrapper, `launches_by_width` the same launches by
the width the kernel ran at ("fwd@256"), and `f32_launches` the f32
tensor-core route: its split passes ("split") and its kernels ("fwd",
"fwd_lse", "bwd_dq", "bwd_dkv"), which `launches` counts too.

`_FlashAttention` is the autograd function around them, mirroring the
reference's custom_vjp: the forward saves (q, k, v, o, lse), or on the f32
route the parts of q, k and v in their place (the same bytes, split once a
forward and backward); the backward forms delta = rowsum(do * o) in f32
and calls the dq and dk/dv kernels.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

_BIG_NEG = -1e30

launches: Dict[str, int] = {"fwd": 0, "fwd_lse": 0, "bwd_dq": 0, "bwd_dkv": 0}
launches_by_width: Dict[str, int] = {}
f32_launches: Dict[str, int] = {"split": 0, "fwd": 0, "fwd_lse": 0, "bwd_dq": 0, "bwd_dkv": 0}

_DTYPES = (torch.float32, torch.bfloat16)
_BF16, _PARTS = 1, 2  # the kernels' dtype codes: bf16 operands, f32 operands as split_parts' parts
WIDTHS = (32, 64, 96, 128, 256, 512)  # the head dims the kernels are built for
SPLIT_WIDTHS = (32, 64, 96, 128, 256)  # where the f32 parts run the per-width kernels
# The streamed kernels (B1-B4) take any multiple of STREAM_SLICE: past 512 a
# head dim is padded to the next one; f32 runs them at 512 too, as parts.
STREAM_SLICE = 512
_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for counts in (launches, f32_launches):
        for name in counts:
            counts[name] = 0
    launches_by_width.clear()


def _count(key: str, width: int) -> None:
    """One launch of `key`'s kernel at `width`."""
    launches[key] += 1
    at = f"{key}@{width}"
    launches_by_width[at] = launches_by_width.get(at, 0) + 1


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the signatures of a loaded flash_attention library's C entry points."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rt_flash_fwd.argtypes = [P, P, P, P, P, I, I, I, I, F, I, I, P]
    lib.rt_flash_bwd_dq.argtypes = [P, P, P, P, P, P, P, I, I, I, I, F, I, I, P]
    lib.rt_flash_bwd_dkv.argtypes = [P, P, P, P, P, P, P, P, I, I, I, I, F, I, I, P]
    L = ctypes.c_longlong
    fns = [lib.rt_flash_fwd, lib.rt_flash_bwd_dq, lib.rt_flash_bwd_dkv]
    if hasattr(lib, "rt_split4"):
        lib.rt_split4.argtypes = [P, P, P, P, P, L, L, L, L, P]
        fns.append(lib.rt_split4)
    if hasattr(lib, "rt_flash_fwd_stream"):  # older builds have no streamed forward (kernel_ab times them)
        lib.rt_flash_fwd_stream.argtypes = lib.rt_flash_fwd.argtypes
        fns.append(lib.rt_flash_fwd_stream)
    if hasattr(lib, "rt_flash_bwd_dq_stream"):  # nor a streamed backward
        lib.rt_flash_bwd_dq_stream.argtypes = lib.rt_flash_bwd_dq.argtypes
        lib.rt_flash_bwd_dkv_stream.argtypes = lib.rt_flash_bwd_dkv.argtypes
        fns += [lib.rt_flash_bwd_dq_stream, lib.rt_flash_bwd_dkv_stream]
    if hasattr(lib, "rt_split"):  # older builds' forward-only split (kernel_ab times them)
        lib.rt_split.argtypes = [P, P, P, P, L, L, P]
        fns.append(lib.rt_split)
    for fn in fns:
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


def kernel_width(head_dim: int) -> int:
    """The head dim an attention of `head_dim` runs at, on the card and on
    the CPU, forward and backward: the next of WIDTHS, or past them the
    next multiple of STREAM_SLICE (the streamed kernels)."""
    for width in WIDTHS:
        if head_dim <= width:
            return width
    return -(-head_dim // STREAM_SLICE) * STREAM_SLICE


def stream_route(width: int, dtype) -> bool:
    """Whether B1-B4 at kernel width `width` run the streamed kernels
    (fwd_kernel_sm90_stream, bwd_dq_kernel_sm90_stream,
    bwd_dkv_kernel_sm90_stream): past 512, and f32 (`dtype`, the operands'
    before any split) at 512."""
    return width > WIDTHS[-1] or (width == WIDTHS[-1] and dtype == torch.float32)


def _streamed(width: int, code: int) -> bool:
    """stream_route for operands of the kernels' dtype code `code`."""
    return stream_route(width, torch.float32 if code == _PARTS else torch.bfloat16)


def autograd_width(head_dim: int, dtype, device) -> int:
    """The width _FlashAttention runs an attention of `head_dim` at
    (kernel_width), checked before it launches anything. dtype: float32 or
    bfloat16 on the card."""
    if torch.device(device).type == "cuda" and dtype not in _DTYPES:
        raise ValueError(f"flash kernels take float32 or bfloat16, got {dtype}")
    return kernel_width(head_dim)


def _pad(width: int, *xs) -> list:
    """Each tensor zero-padded on its last axis to `width`."""
    return [x if x.shape[-1] == width else torch.nn.functional.pad(x, (0, width - x.shape[-1]))
            for x in xs]


def _cut(x, head_dim: int):
    """x's first head_dim columns, contiguous (x itself if it has no more)."""
    return x if x.shape[-1] == head_dim else x[..., :head_dim].contiguous()


def _check_err(err: int, what: str) -> None:
    if err:
        msg = _kernels().rt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")


def check_shapes(q_shape, k_shape, v_shape) -> None:
    """Raise unless the kernels take q [BH, T, D] and k, v [BH, S, D] of
    these shapes: any BH, T, S and D above 0."""
    if len(q_shape) != 3 or len(k_shape) != 3 or tuple(k_shape) != tuple(v_shape):
        raise ValueError(f"flash kernels take q [BH,T,D], k/v [BH,S,D]; got {q_shape}, {k_shape}, {v_shape}")
    BH, T, D = q_shape
    if k_shape[0] != BH or k_shape[2] != D:
        raise ValueError(f"q {tuple(q_shape)} and k {tuple(k_shape)} disagree")
    if D <= 0:
        raise ValueError(f"flash kernels need head_dim > 0, got {D}")
    if BH == 0 or T == 0 or k_shape[1] == 0:
        raise ValueError(f"flash kernels need BH, T, S > 0; got {tuple(q_shape)}, {tuple(k_shape)}")


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
    check_shapes(q.shape, k.shape, v.shape)


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


def _split_ref(x):
    """Plain version of the split pass on one f32 tensor: [2, *x.shape] bf16,
    hi = bf16(x) and lo = bf16(x - hi), both rounded to nearest (x - hi is
    exact in f32)."""
    hi = x.to(torch.bfloat16)
    return torch.stack([hi, (x - hi.float()).to(torch.bfloat16)])


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

def parts_route(q) -> bool:
    """Whether the kernels take `q`'s attention as split_parts' parts: f32
    on the card, at every kernel width (SPLIT_WIDTHS, then the streamed
    kernels at 512 and past)."""
    return q.device.type == "cuda" and q.dtype == torch.float32


def split_parts(*xs):
    """The f32 route's split pass: one to four f32 tensors (q, k, v; do; or
    q, k, v, do) as their bf16 parts, each [2, *x.shape] (hi, then lo), views
    of one buffer. One launch of the split kernel for CUDA tensors (contiguous,
    16-byte aligned, the last dim a multiple of 4), its plain version
    (`_split_ref`) for CPU ones."""
    if xs[0].device.type == "cpu":
        return tuple(_split_ref(x) for x in xs)
    if not 1 <= len(xs) <= 4:
        raise ValueError(f"the split pass takes one to four tensors, got {len(xs)}")
    for x in xs:
        if (x.device != xs[0].device or x.dtype != torch.float32 or not x.is_contiguous()
                or x.data_ptr() % 16 or x.shape[-1] % 4 or x.numel() == 0):
            raise ValueError("the split pass takes contiguous, 16-byte aligned f32 CUDA tensors on one "
                             f"device, the last dim a multiple of 4; got {x.dtype} {tuple(x.shape)} on {x.device}")
    parts = torch.empty(2 * sum(x.numel() for x in xs), dtype=torch.bfloat16, device=xs[0].device)
    pad = 4 - len(xs)
    with torch.cuda.device(parts.device):
        err = _kernels().rt_split4(*(x.data_ptr() for x in xs), *(None,) * pad, parts.data_ptr(),
                                   *(x.numel() for x in xs), *(0,) * pad, _stream(parts.device))
    _check_err(err, "split_parts")
    f32_launches["split"] += 1
    return tuple(p.view(2, *x.shape) for p, x in zip(parts.split([2 * x.numel() for x in xs]), xs))


def _check_parts(parts, n: int) -> tuple:
    """Raise unless `parts` are n of split_parts' outputs the kernels take:
    contiguous bf16 [2, BH, rows, D] CUDA tensors of one device, D in
    SPLIT_WIDTHS (32-256) or a multiple of STREAM_SLICE, q's (and do's)
    [BH, T, D] and k's, v's [BH, S, D] by the shape rules. Returns the
    parts."""
    if len(parts) != n:
        raise ValueError(f"want the parts of {n} operands, got {len(parts)}")
    for p in parts:
        if (p.device.type != "cuda" or p.device != parts[0].device or p.dtype != torch.bfloat16
                or not p.is_contiguous() or p.data_ptr() % 16 or p.dim() != 4 or p.shape[0] != 2):
            raise ValueError("the kernels take split_parts' parts: contiguous, 16-byte aligned bf16 "
                             f"[2, BH, rows, D] CUDA tensors on one device; got {p.dtype} "
                             f"{tuple(p.shape)} on {p.device}")
    pq, pk, pv = parts[:3]
    check_shapes(pq.shape[1:], pk.shape[1:], pv.shape[1:])
    if n == 4 and parts[3].shape != pq.shape:
        raise ValueError(f"do's parts {tuple(parts[3].shape)} and q's {tuple(pq.shape)} disagree")
    D = pq.shape[-1]
    if not (D in SPLIT_WIDTHS or D % STREAM_SLICE == 0):
        raise ValueError(f"the f32 kernels take parts at head dims {SPLIT_WIDTHS} or a multiple of "
                         f"{STREAM_SLICE} (pad others first: kernel_width), got {D}")
    return parts


def _routed(scale: float) -> bool:
    """Whether a wrapper routes this scale before any launch: the kernels
    take the row max of the raw scores before they scale them, which is the
    max of the scaled ones only for a scale > 0. A finite scale <= 0 goes
    through _route_q."""
    return math.isfinite(scale) and scale <= 0


def _route_q(q, scale: float):
    """The q and the positive scale that give the scores q·kᵀ·scale for a
    finite scale <= 0: -q and |scale| (negating is exact, for parts as for
    one tensor), or for 0 a zero q and 1, whose scores are all 0."""
    return (-q, -scale) if scale < 0 else (torch.zeros_like(q), 1.0)


def _launch_fwd(q, k, v, o, lse, causal: bool, scale: float, dtype: int) -> None:
    """B1 (B2 with lse) into o [BH, T, D] (and lse [BH, T]): the streamed
    forward where stream_route says so (o's dtype is the inputs'), else the
    kernel of width D. The scale must be finite and > 0: the wrappers route
    any finite scale <= 0 (_route_q) before they launch, and a non-finite
    scale raises here."""
    if not (math.isfinite(scale) and scale > 0):  # the kernel takes the row max before it scales
        raise ValueError(f"flash_fwd launches at a finite scale > 0 (the wrappers route a "
                         f"finite scale <= 0 before a launch), got {scale}")
    BH, T, D = o.shape
    lib = _kernels()
    fn = lib.rt_flash_fwd_stream if _streamed(D, dtype) else lib.rt_flash_fwd
    with torch.cuda.device(o.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), BH, T, k.shape[-2], D, scale,
            int(causal), dtype, _stream(o.device),
        )
    _check_err(err, "flash_fwd")
    _count("fwd" if lse is None else "fwd_lse", D)


def flash_fwd(q, k, v, *, causal: bool, scale: float, with_lse: bool = False):
    """Attention forward on [BH, T, D]: o, or (o, lse [BH, T] f32) with_lse,
    at any D (kernel_width). f32 CUDA tensors go through split_parts, then
    flash_fwd_parts. Any finite scale: one <= 0 is routed (_route_q)."""
    if q.device.type != "cpu":
        _check_inputs(q, k, v)
    if _routed(scale):
        q, scale = _route_q(q, scale)
    D = q.shape[-1]
    width = kernel_width(D)
    if width != D:
        out = flash_fwd(*_pad(width, q, k, v), causal=causal, scale=scale, with_lse=with_lse)
        return (_cut(out[0], D), out[1]) if with_lse else _cut(out, D)
    if q.device.type == "cpu":
        return _flash_fwd_ref(q, k, v, causal, scale, with_lse)
    if parts_route(q):
        return flash_fwd_parts(split_parts(q, k, v), causal=causal, scale=scale, with_lse=with_lse)
    BH, T, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((BH, T), dtype=torch.float32, device=q.device) if with_lse else None
    _launch_fwd(q, k, v, o, lse, causal, scale, _BF16)
    return (o, lse) if with_lse else o


def flash_fwd_parts(parts, *, causal: bool, scale: float, with_lse: bool = False):
    """flash_fwd on f32 q, k, v given as split_parts(q, k, v): o [BH, T, D]
    f32, or (o, lse) with_lse, from the f32 Hopper kernel (the streamed one
    at 512 and past)."""
    pq, pk, pv = _check_parts(parts, 3)
    if _routed(scale):
        pq, scale = _route_q(pq, scale)
    BH, T, D = pq.shape[1:]
    o = torch.empty((BH, T, D), dtype=torch.float32, device=pq.device)
    lse = torch.empty((BH, T), dtype=torch.float32, device=pq.device) if with_lse else None
    _launch_fwd(pq, pk, pv, o, lse, causal, scale, _PARTS)
    f32_launches["fwd_lse" if with_lse else "fwd"] += 1
    return (o, lse) if with_lse else o


def _launch_bwd_dq(q, k, v, do, lse, delta, dq, causal: bool, scale: float, dtype: int) -> None:
    """B3 into dq [BH, T, D]: the streamed kernel where stream_route says
    so, else the kernel of width D."""
    BH, T, D = dq.shape
    lib = _kernels()
    fn = lib.rt_flash_bwd_dq_stream if _streamed(D, dtype) else lib.rt_flash_bwd_dq
    with torch.cuda.device(dq.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), BH, T, k.shape[-2], D, scale, int(causal),
            dtype, _stream(dq.device),
        )
    _check_err(err, "flash_bwd_dq")
    _count("bwd_dq", D)


def _launch_bwd_dkv(q, k, v, do, lse, delta, dk, dv, causal: bool, scale: float, dtype: int) -> None:
    """B4 into dk and dv [BH, S, D], as _launch_bwd_dq."""
    BH, S, D = dk.shape
    lib = _kernels()
    fn = lib.rt_flash_bwd_dkv_stream if _streamed(D, dtype) else lib.rt_flash_bwd_dkv
    with torch.cuda.device(dk.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), BH, q.shape[-2], S, D, scale,
            int(causal), dtype, _stream(dk.device),
        )
    _check_err(err, "flash_bwd_dkv")
    _count("bwd_dkv", D)


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool, scale: float):
    """dq [BH, T, D] f32 from the saved forward and delta = rowsum(do * o),
    at any D (kernel_width). f32 CUDA tensors go through split_parts (q, k,
    v and do in one launch), then flash_bwd_dq_parts. At a finite scale
    <= 0, dq is the routed call's negated (scale < 0) or zero, unlaunched."""
    if q.device.type != "cpu":
        _check_inputs(q, k, v, do)
        _check_stats(q, lse, delta)
    if _routed(scale):
        if scale == 0:
            return torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        return -flash_bwd_dq(-q, k, v, do, lse, delta, causal=causal, scale=-scale)
    D = q.shape[-1]
    width = kernel_width(D)
    if width != D:
        return _cut(flash_bwd_dq(*_pad(width, q, k, v, do), lse, delta, causal=causal, scale=scale), D)
    if q.device.type == "cpu":
        return _flash_bwd_dq_ref(q, k, v, do, lse, delta, causal, scale)
    if parts_route(q):
        return flash_bwd_dq_parts(split_parts(q, k, v, do), lse, delta, causal=causal, scale=scale)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _launch_bwd_dq(q, k, v, do, lse, delta, dq, causal, scale, _BF16)
    return dq


def flash_bwd_dq_parts(parts, lse, delta, *, causal: bool, scale: float):
    """flash_bwd_dq on f32 q, k, v and do given as their split_parts parts
    (one tuple of four), from the f32 Hopper kernel (the streamed one at 512
    and past). At a finite scale <= 0 as flash_bwd_dq."""
    pq, pk, pv, pdo = _check_parts(parts, 4)
    _check_stats(pq[0], lse, delta)
    if _routed(scale):
        if scale == 0:
            return torch.zeros(pq.shape[1:], dtype=torch.float32, device=pq.device)
        return -flash_bwd_dq_parts((-pq, pk, pv, pdo), lse, delta, causal=causal, scale=-scale)
    dq = torch.empty(pq.shape[1:], dtype=torch.float32, device=pq.device)
    _launch_bwd_dq(pq, pk, pv, pdo, lse, delta, dq, causal, scale, _PARTS)
    f32_launches["bwd_dq"] += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool, scale: float):
    """(dk, dv), each [BH, S, D] f32, at any D (kernel_width). f32 CUDA
    tensors go through split_parts, then flash_bwd_dkv_parts. A finite
    scale <= 0 is routed (_route_q): dk and dv are the routed call's."""
    if q.device.type != "cpu":
        _check_inputs(q, k, v, do)
        _check_stats(q, lse, delta)
    if _routed(scale):
        q, scale = _route_q(q, scale)
    D = q.shape[-1]
    width = kernel_width(D)
    if width != D:
        dk, dv = flash_bwd_dkv(*_pad(width, q, k, v, do), lse, delta, causal=causal, scale=scale)
        return _cut(dk, D), _cut(dv, D)
    if q.device.type == "cpu":
        return _flash_bwd_dkv_ref(q, k, v, do, lse, delta, causal, scale)
    if parts_route(q):
        return flash_bwd_dkv_parts(split_parts(q, k, v, do), lse, delta, causal=causal, scale=scale)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=q.device)
    _launch_bwd_dkv(q, k, v, do, lse, delta, dk, dv, causal, scale, _BF16)
    return dk, dv


def flash_bwd_dkv_parts(parts, lse, delta, *, causal: bool, scale: float):
    """flash_bwd_dkv on f32 q, k, v and do given as their split_parts parts,
    from the f32 Hopper kernel (the streamed one at 512 and past). At a
    finite scale <= 0 as flash_bwd_dkv."""
    pq, pk, pv, pdo = _check_parts(parts, 4)
    _check_stats(pq[0], lse, delta)
    if _routed(scale):
        pq, scale = _route_q(pq, scale)
    dk, dv = (torch.empty(pk.shape[1:], dtype=torch.float32, device=pk.device) for _ in range(2))
    _launch_bwd_dkv(pq, pk, pv, pdo, lse, delta, dk, dv, causal, scale, _PARTS)
    f32_launches["bwd_dkv"] += 1
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    """Flash attention on [BH, T, D] with the tiled recompute backward, at
    any head dim. A head dim off the kernels' widths is padded once
    (autograd_width): the padded q, k, v and o are saved, and do is padded
    once in the backward. On the f32 route (parts_route) the forward's parts
    of q, k and v are saved in their place, so the backward splits do
    alone."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        D = q.shape[-1]
        q, k, v = _pad(autograd_width(D, q.dtype, q.device), q, k, v)
        ctx.causal, ctx.scale, ctx.head_dim = causal, scale, D
        ctx.dtypes, ctx.parts = (q.dtype, k.dtype, v.dtype), parts_route(q)
        if ctx.parts:
            _check_inputs(q, k, v)
            q, k, v = split_parts(q, k, v)
            o, lse = flash_fwd_parts((q, k, v), causal=causal, scale=scale, with_lse=True)
        else:
            o, lse = flash_fwd(q, k, v, causal=causal, scale=scale, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        return _cut(o, D)

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        (do,) = _pad(o.shape[-1], do.contiguous())
        delta = (do.float() * o.float()).sum(-1)
        kw = dict(causal=ctx.causal, scale=ctx.scale)
        if ctx.parts:
            parts = (q, k, v, *split_parts(do))
            dq = flash_bwd_dq_parts(parts, lse, delta, **kw)
            dk, dv = flash_bwd_dkv_parts(parts, lse, delta, **kw)
        else:
            dq = flash_bwd_dq(q, k, v, do, lse, delta, **kw)
            dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
        D = ctx.head_dim
        return (*(_cut(g.to(t), D) for g, t in zip((dq, dk, dv), ctx.dtypes)), None, None)


def _to_bhtd(x, rep: int, width: Optional[int] = None):
    """[B, T, Hk, D] -> [B*Hk*rep, T, width], contiguous, each kv head
    repeated `rep` times in a row (jnp.repeat on the head axis) and zero
    columns past D up to `width` (default D), in the one copy the transpose
    takes. With B = 1 the reshape alone is a strided view, which the
    kernels refuse."""
    if rep > 1:
        x = x.repeat_interleave(rep, dim=2)
    B, T, H, D = x.shape
    (x,) = _pad(width or D, x.transpose(1, 2))
    return x.reshape(B * H, T, x.shape[-1]).contiguous()


def flash_attention(q, k, v, *, causal: bool = False, scale: Optional[float] = None):
    """Flash attention on [B, T, H, D] inputs (grouped-query: H_kv may divide H)
    through the kernels (their plain versions for CPU tensors), at the
    kernels' next width up from D (kernel_width), with or without
    gradients."""
    B, T, H, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    rep = H // k.shape[2]
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)
    width = autograd_width(D, q.dtype, q.device) if grad else kernel_width(D)
    qf, kf, vf = _to_bhtd(q, 1, width), _to_bhtd(k, rep, width), _to_bhtd(v, rep, width)
    if grad:
        of = _FlashAttention.apply(qf, kf, vf, causal, scale)
    else:
        of = flash_fwd(qf, kf, vf, causal=causal, scale=scale)
    return of[..., :D].reshape(B, H, T, D).transpose(1, 2)


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
