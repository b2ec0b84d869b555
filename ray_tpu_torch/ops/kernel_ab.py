"""Time the flash forward kernels (B1, B2) of other builds of
`csrc/flash_attention.cu` against this checkout's, in turns on one card; or
show where this checkout's forward spends a tile (`--timeline`).

    git archive <rev> ray_tpu_torch/ops/csrc | tar -x -C build/parent
    python -m ray_tpu_torch.ops.kernel_ab build/parent/ray_tpu_torch/ops/csrc/flash_attention.cu
    python -m ray_tpu_torch.ops.kernel_ab --timeline

Every source (this checkout's first) is built with the package's nvcc flags,
all at once, into `build/ray_tpu_torch/ab/`, and checked against the plain
version at the first shape. Then each is timed in turns, this checkout's
build, the others, the others again in reverse and this one's again, so a
drift of the card's clock falls on every side alike. bf16, causal, on
[B*H, T, D] inputs from a seed. Prints one JSON line: the card, each build's
worst error-to-limit ratio, the host's us to queue a call at the first
shape, and its ms per shape and kernel (the mean of its two turns, each a
mean of `--reps` calls, and both turns).

`--timeline` builds this checkout's source with RT_FWD_TIMELINE, which
stamps the SM's cycle counter in block 0's two consumer warpgroups at each
step of every K/V tile after an item's first, runs B1 once at each shape,
and prints the median cycles a tile spends in each step.
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

SHAPES = ((96, 1024, 64), (384, 1024, 64))  # GPT-2 small at batch 8 and 32: [B*H, T, D]
SCALE = 64 ** -0.5
# chip_smoke.py's limits: a bf16 o within BF16_RTOL * |plain| + BF16_ATOL of
# the plain version, an f32 lse within F32_ATOL.
BF16_RTOL, BF16_ATOL, F32_ATOL = 2.0 ** -7, 1e-4, 2e-4
# The kernel's stamps (fwd_timeline in the source): [consumer][tile][event].
TIMELINE_SHAPE = (2, 64, 6)
TIMELINE_STEPS = ("issue S and P.V", "S in", "softmax", "P.V in", "rescale and split P")


def _err_to_limit(o, lse, ref_o, ref_lse) -> float:
    o_err = ((o.float() - ref_o.float()).abs() / (BF16_RTOL * ref_o.float().abs() + BF16_ATOL)).max()
    return max(float(o_err), float((lse - ref_lse).abs().max()) / F32_ATOL)


def _library(src: Path, tag: str = "") -> Path:
    return _build.BUILD_DIR / "ab" / f"{src.stem}{tag}-{_build.digest(src)}.so"


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def _inputs(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    return {shape: [torch.randn(shape, device=dev, generator=gen).bfloat16() for _ in range(3)]
            for shape in SHAPES}


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
    """This checkout's flash library built with the forward's cycle stamps."""
    src = _build.CSRC / "flash_attention.cu"
    return _build.compile_source(src, _library(src, "-timeline"), ("-DRT_FWD_TIMELINE",))


def timeline(dev) -> dict:
    """{shape: {step: median cycles a tile spends in it}} from the stamps."""
    import numpy as np

    lib = fa._bind(ctypes.CDLL(str(timeline_library())))
    lib.rt_fwd_timeline.argtypes = [ctypes.c_void_p]
    lib.rt_fwd_timeline.restype = ctypes.c_int
    saved, fa._lib = fa._lib, lib
    out = {}
    try:
        stamps = np.zeros(TIMELINE_SHAPE, dtype=np.int64)
        for shape, (q, k, v) in _inputs(dev).items():
            lib.rt_fwd_timeline(stamps.ctypes.data)  # clears what an earlier run left
            fa.flash_fwd(q, k, v, causal=True, scale=SCALE)
            torch.cuda.synchronize()
            if lib.rt_fwd_timeline(stamps.ctypes.data):
                raise RuntimeError("could not read the timeline")
            steps, periods = [], []
            for consumer in stamps:
                full = (consumer[:-1] > 0).all(axis=1)  # the last slot takes the overflow
                idx = np.flatnonzero(full)
                steps.append(np.diff(consumer[idx], axis=1))
                run = np.diff(idx) == 1  # from a tile's K/V landing to the next one's
                periods.append(np.diff(consumer[idx, 0])[run])
            steps, periods = np.concatenate(steps), np.concatenate(periods)
            out["x".join(map(str, shape))] = {
                "tiles": len(steps),
                **{name: float(statistics.median(steps[:, i])) for i, name in enumerate(TIMELINE_STEPS)},
                "tile": float(statistics.median(periods)) if len(periods) else None,
            }
    finally:
        fa._lib = saved
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="*", type=Path, help="other flash_attention.cu files")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--timeline", action="store_true", help="where this checkout's forward spends a tile")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
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
    calls = {
        "fwd": lambda q, k, v: fa.flash_fwd(q, k, v, causal=True, scale=SCALE),
        "fwd_lse": lambda q, k, v: fa.flash_fwd(q, k, v, causal=True, scale=SCALE, with_lse=True),
    }
    q, k, v = inputs[SHAPES[0]]
    ref_o, ref_lse = fa._flash_fwd_ref(q, k, v, True, SCALE, True)
    out = {"card": _card(), "shapes": [list(s) for s in SHAPES], "builds": {}}
    turns = {name: {} for name in names}
    saved = fa._lib
    try:
        for name, src in zip(names, sources):
            fa._lib = libs[name]
            o, lse = calls["fwd_lse"](q, k, v)
            ratio = max(_err_to_limit(o, lse, ref_o, ref_lse),
                        _err_to_limit(calls["fwd"](q, k, v), lse, ref_o, ref_lse))
            queue_us = {key: host_us(lambda: call(q, k, v)) for key, call in calls.items()}
            out["builds"][name] = {"source": str(src), "err_to_limit": ratio, "host_us": queue_us}
        for name in names + names[::-1]:
            fa._lib = libs[name]
            for shape, (q, k, v) in inputs.items():
                for key, call in calls.items():
                    turns[name].setdefault(f"{key}@{'x'.join(map(str, shape))}", []).append(
                        _time_ms(lambda: call(q, k, v), args.reps))
    finally:
        fa._lib = saved
    for name in names:
        out["builds"][name]["ms"] = {key: sum(t) / len(t) for key, t in turns[name].items()}
        out["builds"][name]["turns_ms"] = turns[name]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
