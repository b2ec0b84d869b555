"""Native-wire A/B gate: prove the `_fastpath` codec wins, and that the
end-to-end lease path does not regress when it is enabled.

Run: python -m ray_tpu_torch._native.native_ab [--codec-only] [--json PATH]

Two legs (the default runs both; ``--codec-only`` runs the first):

**Codec leg** — packs/decodes representative lease-path frames
(RequestWorkerLease, an 8-entry LeaseBatch, grant replies) through
``_fastpath.pack_frame``/``_fastpath.Decoder`` and through msgpack's C
extension, and asserts the native codec strictly wins (pack >= 1.2x,
decode >= 1.02x; ~1.7x / ~1.25x on the JAX package's 1-core box). This is
the honest form of "native wins": both codecs are C, and the native one
is faster because it is specialized (no Packer object churn, no ext-type
dispatch, frame-shaped fast paths).

**End-to-end leg** — runs the scheduler bench (`ray_perf._bench_sched`)
in two fresh subprocesses, native enabled vs ``RAY_TPU_NATIVE_WIRE=0``,
and asserts native is not a regression beyond run-to-run noise
(native >= 0.85x fallback). End-to-end the two are within noise on the
1-core box: the lease cycle spends ~65us in asyncio callback machinery
and ~4us in codec work, so a 1.7x codec win moves the total by ~2%.

Exit 0 = both assertions hold; exit 1 with a diff report otherwise. With
``--json PATH`` the measured ratios and rates are written there too. On
an H100 machine's shared 8-core host the decode ratio read 0.74-1.91x
and the end-to-end one 0.73-2.00x between runs (chip_smoke.py phase
15a): a single run there is data, not a verdict.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import msgpack

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PACK_MIN_RATIO = 1.2
DECODE_MIN_RATIO = 1.02
E2E_MIN_RATIO = 0.85

_LEASE_PAYLOAD = {
    "bundle_index": -1,
    "job_id": "job-000001",
    "lease_id": "6f1d9c2ab34e5f60718293a4b5c6d7e8",
    "locality": {},
    "pg_id": "",
    "resources": {"CPU": 10000},
    "spilled_from": "",
    "strategy": "DEFAULT",
}


def _frames():
    req = [17, 0, "RequestWorkerLease", _LEASE_PAYLOAD, 5.0]
    batch = [
        0,
        3,
        "LeaseBatch",
        {
            "entries": [
                [100 + i, "RequestWorkerLease", dict(_LEASE_PAYLOAD), 5.0, None]
                for i in range(8)
            ]
        },
    ]
    grant = [
        17,
        1,
        "RequestWorkerLease",
        {
            "granted": True,
            "lease_id": _LEASE_PAYLOAD["lease_id"],
            "worker": {"addr": ["127.0.0.1", 43210], "worker_id": "w" * 32},
            "retry_at_raylet": None,
        },
    ]
    return [req, batch, grant]


def bench_codec(rounds: int = 30000):
    from ray_tpu_torch._native import _fastpath

    frames = _frames()
    packer = msgpack.Packer(use_bin_type=True, autoreset=True)

    # -- pack --
    t0 = time.perf_counter()
    for _ in range(rounds):
        for f in frames:
            packer.pack(f)
    t_msgpack_pack = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(rounds):
        for f in frames:
            _fastpath.pack_frame(f)
    t_native_pack = time.perf_counter() - t0

    # -- decode (streaming, like Connection.data_received) --
    blob = b"".join(packer.pack(f) for f in frames) * 64
    n_frames = 3 * 64
    dec_rounds = max(1, rounds // 64)

    t0 = time.perf_counter()
    for _ in range(dec_rounds):
        u = msgpack.Unpacker(use_list=True, raw=False, strict_map_key=False)
        u.feed(blob)
        n = sum(1 for _ in u)
        assert n == n_frames
    t_msgpack_dec = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(dec_rounds):
        d = _fastpath.Decoder()
        d.feed(blob)
        n = sum(1 for _ in d)
        assert n == n_frames
    t_native_dec = time.perf_counter() - t0

    return {
        "pack_ratio": t_msgpack_pack / t_native_pack,
        "decode_ratio": t_msgpack_dec / t_native_dec,
        "native_pack_us": t_native_pack / (rounds * 3) * 1e6,
        "msgpack_pack_us": t_msgpack_pack / (rounds * 3) * 1e6,
        "native_decode_us": t_native_dec / (dec_rounds * n_frames) * 1e6,
        "msgpack_decode_us": t_msgpack_dec / (dec_rounds * n_frames) * 1e6,
    }


_E2E_CHILD = """\
import json, sys
from ray_tpu_torch._private import ray_perf
print(json.dumps(ray_perf._bench_sched()))
"""


def bench_e2e(tasks: int):
    rates = {}
    for label, native in (("native", "1"), ("fallback", "0")):
        env = dict(os.environ)
        env.update(
            RAY_TPU_NATIVE_WIRE=native,
            RAY_TPU_SCHED_BENCH_TASKS=str(tasks),
        )
        out = subprocess.run(
            [sys.executable, "-c", _E2E_CHILD],
            env=env,
            cwd=REPO,
            capture_output=True,
            text=True,
            timeout=600,
        )
        if out.returncode != 0:
            print(out.stdout, file=sys.stderr)
            print(out.stderr, file=sys.stderr)
            raise RuntimeError(f"{label} bench child failed")
        rates[label] = json.loads(out.stdout.strip().splitlines()[-1])
    return rates


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "--codec-only",
        action="store_true",
        help="skip the end-to-end subprocess A/B (CI runners are too noisy "
        "for a throughput comparison; the codec leg is load-independent)",
    )
    parser.add_argument("--tasks", type=int, default=4000)
    parser.add_argument("--json", default="", help="write the measured numbers here")
    args = parser.parse_args(argv)

    failures = []

    codec = bench_codec()
    report = {"codec": codec}
    print(
        f"codec pack:   native {codec['native_pack_us']:.2f}us/frame vs "
        f"msgpack {codec['msgpack_pack_us']:.2f}us/frame "
        f"-> {codec['pack_ratio']:.2f}x (min {PACK_MIN_RATIO}x)"
    )
    print(
        f"codec decode: native {codec['native_decode_us']:.2f}us/frame vs "
        f"msgpack {codec['msgpack_decode_us']:.2f}us/frame "
        f"-> {codec['decode_ratio']:.2f}x (min {DECODE_MIN_RATIO}x)"
    )
    if codec["pack_ratio"] < PACK_MIN_RATIO:
        failures.append(
            f"native pack ratio {codec['pack_ratio']:.2f}x "
            f"below {PACK_MIN_RATIO}x"
        )
    if codec["decode_ratio"] < DECODE_MIN_RATIO:
        failures.append(
            f"native decode ratio {codec['decode_ratio']:.2f}x "
            f"below {DECODE_MIN_RATIO}x"
        )

    if not args.codec_only:
        rates = bench_e2e(args.tasks)
        nat = rates["native"]["leases_per_s"]
        fb = rates["fallback"]["leases_per_s"]
        ratio = nat / fb
        report["e2e"] = {"native_leases_per_s": nat, "fallback_leases_per_s": fb,
                         "ratio": ratio}
        print(
            f"e2e sched:    native {nat:.0f} leases/s vs "
            f"fallback (RAY_TPU_NATIVE_WIRE=0) {fb:.0f} leases/s "
            f"-> {ratio:.2f}x (min {E2E_MIN_RATIO}x; within-noise expected, "
            f"see this module's docstring)"
        )
        if ratio < E2E_MIN_RATIO:
            failures.append(
                f"end-to-end lease rate with native wire ({nat:.0f}/s) "
                f"regressed below {E2E_MIN_RATIO:.0%} of the msgpack "
                f"fallback ({fb:.0f}/s)"
            )

    report["failures"] = failures
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
    if failures:
        print("\nnative A/B FAILED:", file=sys.stderr)
        for line in failures:
            print(f"  {line}", file=sys.stderr)
        return 1
    print("\nnative A/B passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
