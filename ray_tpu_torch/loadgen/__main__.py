"""CLI: ``python -m ray_tpu_torch.loadgen --smoke [--json /tmp/serve_load.json]``.

Runs the self-contained Serve load harness (local cluster, HTTP off) and
prints/writes results in the perf-gate JSON shape. Exits nonzero if any
admitted request overran its deadline — that is the no-silent-overrun
invariant, enforced here the same way the chaos serve suite enforces it.
"""

from __future__ import annotations

import argparse
import sys

from ray_tpu_torch.loadgen import run_smoke


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m ray_tpu_torch.loadgen")
    parser.add_argument(
        "--smoke",
        action="store_true",
        help="short calibrate + 5x-overload run sized for CI",
    )
    parser.add_argument("--json", default=None, help="write results JSON here")
    parser.add_argument("--concurrency", type=int, default=16)
    parser.add_argument("--duration-s", type=float, default=2.0)
    parser.add_argument("--open-duration-s", type=float, default=2.0)
    parser.add_argument(
        "--overload-factor",
        type=float,
        default=5.0,
        help="open-loop rate as a multiple of the calibrated closed-loop rate",
    )
    parser.add_argument("--timeout-s", type=float, default=1.0)
    parser.add_argument("--replicas", type=int, default=2)
    parser.add_argument("--max-batch-size", type=int, default=4)
    args = parser.parse_args(argv)

    if args.smoke:
        args.duration_s = min(args.duration_s, 2.0)
        args.open_duration_s = min(args.open_duration_s, 2.0)

    out = run_smoke(
        args.json,
        closed_concurrency=args.concurrency,
        closed_duration_s=args.duration_s,
        open_duration_s=args.open_duration_s,
        overload_factor=args.overload_factor,
        timeout_s=args.timeout_s,
        num_replicas=args.replicas,
        max_batch_size=args.max_batch_size,
    )
    if out["serve_overruns"] > 0:
        print(
            f"FAIL: {out['serve_overruns']} admitted request(s) overran "
            "their deadline",
            file=sys.stderr,
        )
        return 1
    if out["serve_errors"] > 0:
        print(
            f"FAIL: {out['serve_errors']} request(s) failed with untyped "
            "errors: "
            + "; ".join(out["phases"]["open"].get("error_samples", []) or []),
            file=sys.stderr,
        )
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
