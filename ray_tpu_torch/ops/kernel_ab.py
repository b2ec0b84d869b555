"""Time the bf16 flash kernels (B1-B4) of other builds of
`csrc/flash_attention.cu` against this checkout's, in turns on one card; or
show where this checkout's forward spends a tile (`--timeline`).

    git archive <rev> ray_tpu_torch/ops/csrc | tar -x -C build/parent
    python -m ray_tpu_torch.ops.kernel_ab build/parent/ray_tpu_torch/ops/csrc/flash_attention.cu
    python -m ray_tpu_torch.ops.kernel_ab --timeline
    python -m ray_tpu_torch.ops.kernel_ab --head-dim 256 build/parent/.../flash_attention.cu

Every source (this checkout's first) is built with the package's nvcc flags,
all at once, into `build/ray_tpu_torch/ab/`, and each build's forward and
backward are checked against the plain versions at the first shape (the
backward on the plain forward's lse and delta). Then each is timed in
turns, this checkout's build, the others, the others again in reverse and
this one's again, so a drift of the card's clock falls on every side
alike. bf16, causal, on [B*H, T, D] inputs from a seed, at the shapes of
`--head-dim` (SHAPES: 64, the default, GPT-2 small's; 32, 96 and 256 the
JAX package's example's, Phi-3-mini's and Gemma-2B's attention widths; 512
chip_smoke.py's 18a's; any other D at [96, 1024, D]), scale 1/sqrt(D). Prints one JSON
line: the card, each build's worst error-to-limit ratio, the host's us to
queue a call of each kernel at the first shape, and its ms per shape and
kernel (the mean of its two turns, each a mean of `--reps` calls, and both
turns).

`--timeline` builds this checkout's source with RT_TIMELINE, which stamps
the SM's cycle counter in block 0's two consumer warpgroups at each step of
every streamed tile after an item's first, runs B1, B3 and B4 once each at
each shape, and prints the median cycles a tile spends in each step.
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
# package's example at batch 8 (32), Phi-3-mini's and Gemma-2B's widths at
# batch 4 and T 2048 (96, 256), and the head-dim-512 configuration of
# chip_smoke.py's phase 18 at batch 4 (512).
SHAPES_BY_HEAD_DIM = {
    64: ((96, 1024, 64), (384, 1024, 64)),
    32: ((64, 256, 32),),
    96: ((128, 2048, 96),),
    256: ((32, 2048, 256),),
    512: ((16, 2048, 512),),
}
SHAPES = SHAPES_BY_HEAD_DIM[64]
SCALE = 64 ** -0.5


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
# and the steps between a tile's events, by kernel.
TIMELINE_SHAPE = (3, 2, 64, 6)
_BWD_STEPS = ("issue S, dP and the previous products", "S and dP in", "P and dS",
              "previous products in", "split")
TIMELINE_STEPS = {
    "fwd": ("issue S and P.V", "S in", "softmax", "P.V in", "rescale and split P"),
    "bwd_dq": _BWD_STEPS,
    "bwd_dkv": _BWD_STEPS,
}


def _err_to_limit(o, lse, ref_o, ref_lse) -> float:
    o_err = ((o.float() - ref_o.float()).abs() / (BF16_RTOL * ref_o.float().abs() + BF16_ATOL)).max()
    return max(float(o_err), _f32_err_to_limit(lse, ref_lse))


def _f32_err_to_limit(x, ref) -> float:
    return float((x - ref).abs().max()) / F32_ATOL


def _library(src: Path, tag: str = "") -> Path:
    return _build.BUILD_DIR / "ab" / f"{src.stem}{tag}-{_build.digest(src)}.so"


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def _inputs(dev):
    """{shape: (q, k, v, do, lse, delta)}: bf16 q, k, v and do from a seed,
    and the backward's lse and delta from the plain forward."""
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for shape in SHAPES:
        q, k, v, do = (torch.randn(shape, device=dev, generator=gen).bfloat16() for _ in range(4))
        o, lse = fa._flash_fwd_ref(q, k, v, True, SCALE, True)
        out[shape] = (q, k, v, do, lse, (do.float() * o.float()).sum(-1))
    return out


# Each kernel's call on (q, k, v, do, lse, delta).
CALLS = {
    "fwd": lambda q, k, v, do, lse, delta: fa.flash_fwd(q, k, v, causal=True, scale=SCALE),
    "fwd_lse": lambda q, k, v, do, lse, delta: fa.flash_fwd(q, k, v, causal=True, scale=SCALE,
                                                            with_lse=True),
    "bwd_dq": lambda *a: fa.flash_bwd_dq(*a, causal=True, scale=SCALE),
    "bwd_dkv": lambda *a: fa.flash_bwd_dkv(*a, causal=True, scale=SCALE),
}


def err_to_limit(args) -> float:
    """The loaded build's worst error-to-limit ratio over the four kernels
    on `args`, against the plain versions."""
    q, k, v = args[:3]
    ref_o, ref_lse = fa._flash_fwd_ref(q, k, v, True, SCALE, True)
    o, lse = CALLS["fwd_lse"](*args)
    ratio = max(_err_to_limit(o, lse, ref_o, ref_lse),
                _err_to_limit(CALLS["fwd"](*args), lse, ref_o, ref_lse))
    ratio = max(ratio, _f32_err_to_limit(CALLS["bwd_dq"](*args), fa._flash_bwd_dq_ref(*args, True, SCALE)))
    for got, want in zip(CALLS["bwd_dkv"](*args), fa._flash_bwd_dkv_ref(*args, True, SCALE)):
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


def timeline(dev) -> dict:
    """{kernel: {shape: {step: median cycles a tile spends in it}}} from the
    stamps of B1, B3 and B4."""
    import numpy as np

    lib = fa._bind(ctypes.CDLL(str(timeline_library())))
    lib.rt_timeline.argtypes = [ctypes.c_void_p]
    lib.rt_timeline.restype = ctypes.c_int
    saved, fa._lib = fa._lib, lib
    out = {key: {} for key in TIMELINE_STEPS}
    try:
        stamps = np.zeros(TIMELINE_SHAPE, dtype=np.int64)
        for shape, args in _inputs(dev).items():
            for kernel, key in enumerate(TIMELINE_STEPS):
                lib.rt_timeline(stamps.ctypes.data)  # clears what an earlier run left
                CALLS[key](*args)
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
        fa._lib = saved
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="*", type=Path, help="other flash_attention.cu files")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--timeline", action="store_true", help="where this checkout's kernels spend a tile")
    ap.add_argument("--head-dim", type=int, default=64, help="the shapes' head dim (SHAPES_BY_HEAD_DIM)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    set_head_dim(args.head_dim)
    dev = torch.device("cuda")
    if args.timeline:
        print(json.dumps({"card": _card(), "cycles": timeline(dev)}), flush=True)
        return 0
    sources = [_build.CSRC / "flash_attention.cu", *args.sources]
    names = ["this", *(str(s) for s in args.sources)]
    with ThreadPoolExecutor(len(sources)) as pool:
        paths = list(pool.map(lambda s: _build.compile_source(s, _library(s)), sources))
    libs = {name: fa._bind(ctypes.CDLL(str(p))) for name, p in zip(names, paths)}
    inputs = _inputs(dev)
    first = inputs[SHAPES[0]]
    out = {"card": _card(), "shapes": [list(s) for s in SHAPES], "builds": {}}
    turns = {name: {} for name in names}
    saved = fa._lib
    try:
        for name, src in zip(names, sources):
            fa._lib = libs[name]
            queue_us = {key: host_us(lambda: call(*first)) for key, call in CALLS.items()}
            out["builds"][name] = {"source": str(src), "err_to_limit": err_to_limit(first),
                                   "host_us": queue_us}
        for name in names + names[::-1]:
            fa._lib = libs[name]
            for shape, args_ in inputs.items():
                for key, call in CALLS.items():
                    turns[name].setdefault(f"{key}@{'x'.join(map(str, shape))}", []).append(
                        _time_ms(lambda: call(*args_), args.reps))
    finally:
        fa._lib = saved
    for name in names:
        out["builds"][name]["ms"] = {key: sum(t) / len(t) for key, t in turns[name].items()}
        out["builds"][name]["turns_ms"] = turns[name]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
