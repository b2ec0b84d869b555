"""Time the flash kernels (B1-B4) of other builds of
`csrc/flash_attention.cu` against this checkout's, in turns on one card; or
show where this checkout's kernels spend a tile (`--timeline`).

    git archive <rev> ray_tpu_torch/ops/csrc | tar -x -C build/parent
    python -m ray_tpu_torch.ops.kernel_ab build/parent/ray_tpu_torch/ops/csrc/flash_attention.cu
    python -m ray_tpu_torch.ops.kernel_ab --timeline
    python -m ray_tpu_torch.ops.kernel_ab --head-dim 256 build/parent/.../flash_attention.cu
    python -m ray_tpu_torch.ops.kernel_ab --dtype float32 build/parent/.../flash_attention.cu
    python -m ray_tpu_torch.ops.kernel_ab --dtype float32 --head-dim 512 --timeline

Every source (this checkout's first) is built with the package's nvcc flags,
all at once, into `build/ray_tpu_torch/ab/`, and each build's forward and
backward are checked against the plain versions at the first shape (the
backward on the plain forward's lse and delta). Then each is timed in
turns, this checkout's build, the others, the others again in reverse and
this one's again, so a drift of the card's clock falls on every side
alike. bf16 (or `--dtype float32`), causal, on [B*H, T, D] inputs from a seed, at the shapes of
`--head-dim` (SHAPES: 64, the default, GPT-2 small's; 32, 96 and 256 the
JAX package's example's, Phi-3-mini's and Gemma-2B's attention widths; 512
chip_smoke.py's 18a's; 1024 and 2048 the streamed kernels' past 512; any
other D at [96, 1024, D]), scale 1/sqrt(D). At f32 the forward is timed
with its split pass and the backward kernels on q, k, v and do split
beforehand (the f32 kernels alone). Older builds run their own routes: a
build without the backward's split pass (rt_split4) runs its f32 backward
on its CUDA-core kernels at every width, and its forward through its own
split pass (rt_split) or, without one, its CUDA-core kernel; a build
without the streamed forward (rt_flash_fwd_stream) runs f32 B1 and B2 at
512 on its CUDA-core forward, and one without the streamed backward
(rt_flash_bwd_dq_stream) f32 B3 and B4 at 512 on its CUDA-core kernels
(on the f32 operands), and has no B3 or B4 past 512 (not timed there); a
build without the kernels at 32 runs a head dim of 32 padded to 64, as its
wrappers did (the backward on parts padded once beforehand, as its
autograd function saved them, its outputs cut).
Prints one JSON line: the card, each build's worst error-to-limit ratio,
the host's us to queue a call of each kernel at the first shape, and its
ms per shape and kernel (the mean of its two turns, each a mean of
`--reps` calls, and both turns).

`--timeline` builds this checkout's source with RT_TIMELINE, which stamps
the SM's cycle counter in block 0's two consumer warpgroups at each step of
every streamed tile after an item's first, runs B1, B3 and B4 once each at
each shape, and prints the median cycles a tile spends in each step (on
the streamed kernels' steps where the width takes them: f32 at 512, any
dtype past 512).
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ray_tpu_torch.ops import _build

# The module, not the package's `flash_attention` function of the same name.
fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

# [B*H, T, D] by head dim: GPT-2 small at batch 8 and 32 (64), the JAX
# package's example at batch 8 and, at batch 16, T 2048 (32), Phi-3-mini's
# and Gemma-2B's widths at batch 4 and T 2048 (96, 256), and the
# head-dim-512 configuration of chip_smoke.py's phase 18 at batch 4 (512).
SHAPES_BY_HEAD_DIM = {
    64: ((96, 1024, 64), (384, 1024, 64)),
    32: ((64, 256, 32), (128, 2048, 32)),
    96: ((128, 2048, 96),),
    256: ((32, 2048, 256),),
    512: ((16, 2048, 512),),
    1024: ((8, 2048, 1024),),
    2048: ((4, 2048, 2048),),
}
SHAPES = SHAPES_BY_HEAD_DIM[64]
SCALE = 64 ** -0.5
DTYPE = torch.bfloat16


def set_head_dim(head_dim: int) -> None:
    """Time and check at `head_dim`'s shapes (SHAPES_BY_HEAD_DIM, else
    [96, 1024, head_dim]) with scale 1/sqrt(head_dim)."""
    global SHAPES, SCALE
    SHAPES = SHAPES_BY_HEAD_DIM.get(head_dim, ((96, 1024, head_dim),))
    SCALE = head_dim ** -0.5
# chip_smoke.py's limits: a bf16 o within BF16_RTOL * |plain| + BF16_ATOL of
# the plain version, an f32 lse, dq, dk or dv within F32_ATOL.
BF16_RTOL, BF16_ATOL, F32_ATOL = 2.0 ** -7, 1e-4, 2e-4
# The kernels' stamps (timeline in the source): [kernel][consumer][tile][event],
# the steps between a tile's events, by kernel, and each dtype's stamped
# kernels by their index in the stamps.
TIMELINE_SHAPE = (9, 2, 64, 6)
_BWD_STEPS = ("issue S, dP and the previous products", "S and dP in", "P and dS",
              "previous products in", "split")
TIMELINE_STEPS = {
    "fwd": ("issue S and P.V", "S in", "softmax", "P.V in", "rescale and split P"),
    "bwd_dq": _BWD_STEPS,
    "bwd_dkv": _BWD_STEPS,
    "fwd_stream": ("issue S chunk by chunk", "P.V issued", "S in", "softmax", "P.V in, rescale and split P"),
    "bwd_dq_stream": ("issue S and dP chunk by chunk", "previous products issued", "S and dP in", "P and dS",
                      "previous products in, split"),
}
TIMELINE_STEPS["bwd_dkv_stream"] = TIMELINE_STEPS["bwd_dq_stream"]
TIMELINE_KERNELS = {torch.bfloat16: {"fwd": 0, "bwd_dq": 1, "bwd_dkv": 2},
                    torch.float32: {"fwd": 3, "bwd_dq": 4, "bwd_dkv": 5}}
# The streamed kernels' stamps, either dtype.
STREAM_TIMELINE_KERNELS = {"fwd": 6, "bwd_dq": 7, "bwd_dkv": 8}


def _err_to_limit(o, lse, ref_o, ref_lse) -> float:
    if o.dtype == torch.float32:
        return max(_f32_err_to_limit(o, ref_o), _f32_err_to_limit(lse, ref_lse))
    o_err = ((o.float() - ref_o.float()).abs() / (BF16_RTOL * ref_o.float().abs() + BF16_ATOL)).max()
    return max(float(o_err), _f32_err_to_limit(lse, ref_lse))


def _f32_err_to_limit(x, ref) -> float:
    return float((x - ref).abs().max()) / F32_ATOL


def _library(src: Path, tag: str = "") -> Path:
    return _build.BUILD_DIR / "ab" / f"{src.stem}{tag}-{_build.digest(src)}.so"


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def _inputs(dev, dtype=None):
    """{shape: (q, k, v, do, lse, delta, parts)}: q, k, v and do (DTYPE) from
    a seed, the backward's lse and delta from the plain forward, and, for
    f32 at SPLIT_WIDTHS, the four's bf16 parts (the split pass's plain
    version, bitwise the kernel's), else None."""
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for shape in SHAPES:
        q, k, v, do = (torch.randn(shape, device=dev, generator=gen).to(dtype or DTYPE) for _ in range(4))
        o, lse = fa._flash_fwd_ref(q, k, v, True, SCALE, True)
        parts = tuple(fa._split_ref(x) for x in (q, k, v, do)) if fa.parts_route(q) else None
        out[shape] = (q, k, v, do, lse, (do.float() * o.float()).sum(-1), parts)
    return out


# This checkout's widths, which _use narrows for an older build.
WIDTHS, SPLIT_WIDTHS = fa.WIDTHS, fa.SPLIT_WIDTHS


def build_widths(lib) -> tuple:
    """The per-width kernels' head dims (WIDTHS) that the build `lib` takes:
    a build before the kernels at 32 refuses a call at 32 before any launch
    (cudaErrorInvalidValue), so one call on a [1, 1, 32] bf16 q, k, v
    tells them apart."""
    x = torch.zeros(1, 1, 32, dtype=torch.bfloat16, device="cuda")
    o = torch.empty_like(x)
    err = lib.rt_flash_fwd(x.data_ptr(), x.data_ptr(), x.data_ptr(), o.data_ptr(), None, 1, 1, 1, 32, 1.0, 1,
                           fa._BF16, fa._stream(x.device))
    torch.cuda.synchronize()
    return WIDTHS if err == 0 else tuple(w for w in WIDTHS if w != 32)


def _use(lib) -> None:
    """Make `lib` the wrappers' build, with the widths it takes
    (build_widths): a head dim it lacks runs padded, as its own wrappers
    ran it."""
    fa._lib = lib
    fa.WIDTHS = lib.rt_widths
    fa.SPLIT_WIDTHS = tuple(w for w in SPLIT_WIDTHS if w in lib.rt_widths)


_PADDED: dict = {}


def _parts_at_width(parts):
    """`parts` at the width the loaded build runs them (fa.kernel_width):
    where that is wider, zero-padded once (cached), as the autograd
    function of a build without their own width saved them."""
    D = parts[0].shape[-1]
    width = fa.kernel_width(D)
    if width == D:
        return parts
    key = (id(parts[0]), width)
    if key not in _PADDED:
        _PADDED[key] = tuple(torch.nn.functional.pad(p, (0, width - D)) for p in parts)
    return _PADDED[key]


def _older_f32(q) -> bool:
    """Whether the loaded build predates the f32 backward on parts (no
    rt_split4) and q is f32: its own f32 routes are taken."""
    return q.dtype == torch.float32 and not hasattr(fa._lib, "rt_split4")


def _streamed(q) -> bool:
    """Whether this checkout's wrappers run q's attention on the streamed
    kernels (fa.stream_route)."""
    return fa.stream_route(fa.kernel_width(q.shape[-1]), q.dtype)


def _older_fwd(q) -> bool:
    """Whether the loaded build takes its own forward route for q: it
    predates the f32 backward on parts, or q's forward is the streamed one
    and the build has none (f32 at 512 then runs its CUDA-core forward)."""
    return _older_f32(q) or (_streamed(q) and not hasattr(fa._lib, "rt_flash_fwd_stream"))


def _older_bwd(q) -> bool:
    """Whether q's backward is a streamed one and the loaded build has
    none: f32 at 512 then runs its CUDA-core kernels; bf16 or f32 past
    512, nothing."""
    return _streamed(q) and not hasattr(fa._lib, "rt_flash_bwd_dq_stream")


def kernels_at(q) -> tuple:
    """The kernels the loaded build runs on q: B1-B4, or B1 and B2 on a
    build without a backward at q's width (past 512, before the streamed
    backward)."""
    if _older_bwd(q) and fa.kernel_width(q.shape[-1]) > fa.WIDTHS[-1]:
        return ("fwd", "fwd_lse")
    return tuple(CALLS)


def _fwd(q, k, v, with_lse: bool = False):
    """B1 (B2 with_lse) through the loaded build: the wrapper's route, or, on
    an older build (_older_fwd), its own: for f32 its split pass (rt_split)
    and f32 Hopper forward, or without one its f32 kernel (the CUDA-core
    one at 512)."""
    if not _older_fwd(q):
        return fa.flash_fwd(q, k, v, causal=True, scale=SCALE, with_lse=with_lse)
    if q.dtype != torch.float32:
        raise ValueError(f"this build has no forward at head dim {q.shape[-1]}")
    BH, T, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((BH, T), dtype=torch.float32, device=q.device) if with_lse else None
    operands, dtype = (q, k, v), 0
    if hasattr(fa._lib, "rt_split") and D in fa.SPLIT_WIDTHS:
        parts = torch.empty(2 * (q.numel() + 2 * k.numel()), dtype=torch.bfloat16, device=q.device)
        fa._check_err(fa._lib.rt_split(q.data_ptr(), k.data_ptr(), v.data_ptr(), parts.data_ptr(),
                                       q.numel(), k.numel(), fa._stream(q.device)), "rt_split")
        operands, dtype = parts.split([2 * q.numel(), 2 * k.numel(), 2 * v.numel()]), fa._PARTS
    err = fa._lib.rt_flash_fwd(*(x.data_ptr() for x in operands), o.data_ptr(),
                               lse.data_ptr() if with_lse else None, BH, T, k.shape[1], D, SCALE, 1, dtype,
                               fa._stream(q.device))
    fa._check_err(err, "flash_fwd (f32, an older build)")
    return (o, lse) if with_lse else o


def _older_f32_bwd(q) -> bool:
    """Whether the loaded build runs q's backward on its f32 CUDA-core
    kernels (_older_f32, or f32 at 512 on a build without the streamed
    backward)."""
    return _older_f32(q) or (_older_bwd(q) and q.dtype == torch.float32)


def _bwd_dq(q, k, v, do, lse, delta, parts):
    """B3 through the loaded build: the f32 kernel on `parts` where they are
    given, an older build's f32 CUDA-core kernel, or the wrapper."""
    if parts is not None and not _older_f32_bwd(q):
        return fa._cut(fa.flash_bwd_dq_parts(_parts_at_width(parts), lse, delta, causal=True, scale=SCALE),
                       q.shape[-1])
    if not _older_f32_bwd(q):
        return fa.flash_bwd_dq(q, k, v, do, lse, delta, causal=True, scale=SCALE)
    dq = torch.empty_like(q)
    fa._launch_bwd_dq(q, k, v, do, lse, delta, dq, True, SCALE, 0)
    return dq


def _bwd_dkv(q, k, v, do, lse, delta, parts):
    """B4 through the loaded build, as _bwd_dq."""
    if parts is not None and not _older_f32_bwd(q):
        dk, dv = fa.flash_bwd_dkv_parts(_parts_at_width(parts), lse, delta, causal=True, scale=SCALE)
        return fa._cut(dk, q.shape[-1]), fa._cut(dv, q.shape[-1])
    if not _older_f32_bwd(q):
        return fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal=True, scale=SCALE)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fa._launch_bwd_dkv(q, k, v, do, lse, delta, dk, dv, True, SCALE, 0)
    return dk, dv


# Each kernel's call on (q, k, v, do, lse, delta, parts).
CALLS = {
    "fwd": lambda q, k, v, *rest: _fwd(q, k, v),
    "fwd_lse": lambda q, k, v, *rest: _fwd(q, k, v, with_lse=True),
    "bwd_dq": _bwd_dq,
    "bwd_dkv": _bwd_dkv,
}


def err_to_limit(args) -> float:
    """The loaded build's worst error-to-limit ratio over the kernels it
    runs (kernels_at) on `args`, against the plain versions."""
    q, k, v = args[:3]
    plain = args[:6]
    ref_o, ref_lse = fa._flash_fwd_ref(q, k, v, True, SCALE, True)
    o, lse = CALLS["fwd_lse"](*args)
    ratio = max(_err_to_limit(o, lse, ref_o, ref_lse),
                _err_to_limit(CALLS["fwd"](*args), lse, ref_o, ref_lse))
    if "bwd_dq" not in kernels_at(q):
        return ratio
    ratio = max(ratio, _f32_err_to_limit(CALLS["bwd_dq"](*args), fa._flash_bwd_dq_ref(*plain, True, SCALE)))
    for got, want in zip(CALLS["bwd_dkv"](*args), fa._flash_bwd_dkv_ref(*plain, True, SCALE)):
        ratio = max(ratio, _f32_err_to_limit(got, want))
    return ratio


def _time_ms(fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` back-to-back calls, the stream
    held busy until all are queued (so the host's pace does not enter)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    if start.query():
        raise RuntimeError("the host could not queue the timed calls ahead of the card")
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, calls: int = 200) -> float:
    """The host's time to queue one call of fn, in us: calls back to back,
    the card left to finish them after the clock stops."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def timeline_library() -> Path:
    """This checkout's flash library built with the kernels' cycle stamps."""
    src = _build.CSRC / "flash_attention.cu"
    return _build.compile_source(src, _library(src, "-timeline"), ("-DRT_TIMELINE",))


def timeline(dev, dtype=torch.bfloat16) -> dict:
    """{kernel: {shape: {step: median cycles a tile spends in it}}} from the
    stamps of B1, B3 and B4 (bf16, or f32 on the tensor cores; as
    "fwd_stream", "bwd_dq_stream" and "bwd_dkv_stream" where the streamed
    kernels take them)."""
    import numpy as np

    lib = fa._bind(ctypes.CDLL(str(timeline_library())))
    lib.rt_timeline.argtypes = [ctypes.c_void_p]
    lib.rt_timeline.restype = ctypes.c_int
    lib.rt_widths = WIDTHS
    saved = fa._lib
    _use(lib)
    out = {}
    try:
        stamps = np.zeros(TIMELINE_SHAPE, dtype=np.int64)
        for shape, args in _inputs(dev, dtype).items():
            for key in kernels_at(args[0]):
                if key == "fwd_lse":
                    continue
                call, kernel = CALLS[key], TIMELINE_KERNELS[dtype][key]
                if _streamed(args[0]):
                    key, kernel = f"{key}_stream", STREAM_TIMELINE_KERNELS[key]
                out.setdefault(key, {})
                lib.rt_timeline(stamps.ctypes.data)  # clears what an earlier run left
                call(*args)
                torch.cuda.synchronize()
                if lib.rt_timeline(stamps.ctypes.data):
                    raise RuntimeError("could not read the timeline")
                steps, periods = [], []
                for consumer in stamps[kernel]:
                    full = (consumer[:-1] > 0).all(axis=1)  # the last slot takes the overflow
                    idx = np.flatnonzero(full)
                    steps.append(np.diff(consumer[idx], axis=1))
                    run = np.diff(idx) == 1  # from a tile's landing to the next one's
                    periods.append(np.diff(consumer[idx, 0])[run])
                steps, periods = np.concatenate(steps), np.concatenate(periods)
                if not len(steps):  # a kernel with no stamps at this width (B4 in turn, D > 64)
                    out[key]["x".join(map(str, shape))] = {"tiles": 0}
                    continue
                out[key]["x".join(map(str, shape))] = {
                    "tiles": len(steps),
                    **{name: float(statistics.median(steps[:, i]))
                       for i, name in enumerate(TIMELINE_STEPS[key])},
                    "tile": float(statistics.median(periods)) if len(periods) else None,
                }
    finally:
        fa._lib, fa.WIDTHS, fa.SPLIT_WIDTHS = saved, WIDTHS, SPLIT_WIDTHS
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="*", type=Path, help="other flash_attention.cu files")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--timeline", action="store_true", help="where this checkout's kernels spend a tile")
    ap.add_argument("--head-dim", type=int, default=64, help="the shapes' head dim (SHAPES_BY_HEAD_DIM)")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    global DTYPE
    set_head_dim(args.head_dim)
    DTYPE = getattr(torch, args.dtype)
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in f32, as chip_smoke.py runs them
    dev = torch.device("cuda")
    if args.timeline:
        print(json.dumps({"card": _card(), "dtype": args.dtype, "cycles": timeline(dev, DTYPE)}), flush=True)
        return 0
    sources = [_build.CSRC / "flash_attention.cu", *args.sources]
    names = ["this", *(str(s) for s in args.sources)]
    with ThreadPoolExecutor(len(sources)) as pool:
        paths = list(pool.map(lambda s: _build.compile_source(s, _library(s)), sources))
    libs = {name: fa._bind(ctypes.CDLL(str(p))) for name, p in zip(names, paths)}
    for lib in libs.values():
        lib.rt_widths = build_widths(lib)
    inputs = _inputs(dev)
    first = inputs[SHAPES[0]]
    out = {"card": _card(), "dtype": args.dtype, "shapes": [list(s) for s in SHAPES], "builds": {}}
    turns = {name: {} for name in names}
    saved = fa._lib
    try:
        for name, src in zip(names, sources):
            _use(libs[name])
            queue_us = {key: host_us(lambda: CALLS[key](*first)) for key in kernels_at(first[0])}
            out["builds"][name] = {"source": str(src), "err_to_limit": err_to_limit(first),
                                   "host_us": queue_us, "widths": list(libs[name].rt_widths)}
        for name in names + names[::-1]:
            _use(libs[name])
            for shape, args_ in inputs.items():
                for key in kernels_at(args_[0]):
                    turns[name].setdefault(f"{key}@{'x'.join(map(str, shape))}", []).append(
                        _time_ms(lambda: CALLS[key](*args_), args.reps))
    finally:
        fa._lib, fa.WIDTHS, fa.SPLIT_WIDTHS = saved, WIDTHS, SPLIT_WIDTHS
    for name in names:
        out["builds"][name]["ms"] = {key: sum(t) / len(t) for key, t in turns[name].items()}
        out["builds"][name]["turns_ms"] = turns[name]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
