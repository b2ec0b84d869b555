"""Unified static-analysis gate: ``python -m ray_tpu_torch.devtools.lint``.

Runs every static pass over the package and exits non-zero on any finding:
the asyncio hazard linter (aio_lint), the RPC wire cross-checker
(rpc_check), the whole-program blocking-graph pass (rpc_flow: distributed
wait cycles, deadline propagation, task supervision), the
exception-propagation pass (exc_flow: wire error declarations, swallowed
control errors, retry-unsafe mutations, ack-before-persist), the
paired-resource lifecycle pass (lifecycle), the protocol FSM checker
(protocols), the
telemetry-registry pass (telemetry_lint, no ad-hoc stats dicts in runtime
code), and the stale-suppression audit (a ``disable=``/``allow-`` comment
that no longer masks any finding is itself a finding — dead waivers rot
into false confidence). This is the CI lint job's entry point; ``make
lint`` wraps it.

The gate also times itself: each pass's wall time is printed, and the
total is capped (``--budget-s``, or ``RAY_TPU_LINT_BUDGET_S``; default
120 s). A pass that grows superlinearly fails the gate before it quietly
turns the pre-merge loop into a coffee break.
"""

from __future__ import annotations

import argparse
import io
import os
import sys
import time
import tokenize
from typing import Callable, Dict, List, Optional, Set, Tuple

from ray_tpu_torch.devtools import (
    aio_lint,
    exc_flow,
    lifecycle,
    protocols,
    rpc_check,
    rpc_flow,
    telemetry_lint,
)

_PASSES = (
    "aio-lint + rpc-check + rpc-flow + exc-flow + lifecycle + protocols"
    " + telemetry-lint + suppression-audit"
)

RULE_STALE = "stale-suppression"
RULE_BUDGET = "lint-over-budget"

_DEFAULT_BUDGET_S = 120.0


def audit_suppressions(paths: List[str]) -> List[aio_lint.Finding]:
    """Flag suppression comments that no longer mask any raw finding.

    Re-runs every pass with ``apply_suppressions=False`` and checks each
    ``# aio-lint: disable=`` / ``# rpc-flow: disable=`` /
    ``# lifecycle: disable=`` / ``# protocol: disable=`` /
    ``# telemetry: allow-adhoc-stats`` comment against the raw findings of
    its own family on the line it covers (the comment's line and the line
    below, mirroring the passes' scoping). The ``aio-lint`` syntax is
    shared by rpc_check, so its comments are validated against both
    passes' findings.
    """
    files: List[str] = []
    for path in paths:
        if os.path.isdir(path):
            files.extend(aio_lint.iter_py_files(path))
        else:
            files.append(path)

    raw = {
        "aio-lint": (
            aio_lint.lint_paths(paths, apply_suppressions=False)
            + rpc_check.check(paths, apply_suppressions=False)
        ),
        "rpc-flow": rpc_flow.check(paths, apply_suppressions=False),
        "exc-flow": exc_flow.check(paths, apply_suppressions=False),
        "lifecycle": lifecycle.lint_paths(paths, apply_suppressions=False),
        "protocol": protocols.check(paths, apply_suppressions=False),
        "telemetry": telemetry_lint.lint_paths(paths, apply_suppressions=False),
    }
    # family -> abspath -> line -> rules found there without suppression
    idx: Dict[str, Dict[str, Dict[int, Set[str]]]] = {}
    for family, findings in raw.items():
        fam = idx.setdefault(family, {})
        for f in findings:
            fam.setdefault(os.path.abspath(f.path), {}).setdefault(
                f.line, set()
            ).add(f.rule)

    regexes = {
        "aio-lint": aio_lint._SUPPRESS_RE,
        "rpc-flow": rpc_flow._SUPPRESS_RE,
        "exc-flow": exc_flow._SUPPRESS_RE,
        "lifecycle": lifecycle._SUPPRESS_RE,
        "protocol": protocols._SUPPRESS_RE,
        "telemetry": telemetry_lint._ALLOW_RE,
    }
    out: List[aio_lint.Finding] = []
    for fpath in files:
        try:
            with open(fpath, "r", encoding="utf-8") as fh:
                source = fh.read()
        except OSError:
            continue
        apath = os.path.abspath(fpath)
        # Only genuine comment tokens: the suppression syntax also appears
        # in docstrings and message strings (this file included), which are
        # not waivers.
        comments: List = []
        try:
            for tok in tokenize.generate_tokens(io.StringIO(source).readline):
                if tok.type == tokenize.COMMENT:
                    comments.append((tok.start[0], tok.string))
        except (tokenize.TokenError, IndentationError, SyntaxError):
            continue
        for lineno, text in comments:
            for family, rex in regexes.items():
                m = rex.search(text)
                if not m:
                    continue
                rules: Optional[Set[str]] = None
                if m.groups():
                    rules = {
                        r.strip() for r in m.group(1).split(",") if r.strip()
                    }
                by_line = idx.get(family, {}).get(apath, {})
                used = False
                for covered in (lineno, lineno + 1):
                    found = by_line.get(covered)
                    if not found:
                        continue
                    if rules is None or "all" in rules or (found & rules):
                        used = True
                        break
                if not used:
                    out.append(
                        aio_lint.Finding(
                            fpath,
                            lineno,
                            0,
                            RULE_STALE,
                            f"{family} suppression masks no finding any "
                            "more — the code it waived was fixed or moved; "
                            "delete the comment",
                        )
                    )
    return out


def run_timed(
    paths: List[str],
) -> Tuple[List[aio_lint.Finding], List[Tuple[str, float]]]:
    """All passes + audit, with per-pass wall times."""
    stages: List[Tuple[str, Callable[[], List[aio_lint.Finding]]]] = [
        ("aio-lint", lambda: list(aio_lint.lint_paths(paths))),
        ("rpc-check", lambda: rpc_check.check(paths)),
        ("rpc-flow", lambda: rpc_flow.check(paths)),
        ("exc-flow", lambda: exc_flow.check(paths)),
        ("lifecycle", lambda: lifecycle.lint_paths(paths)),
        ("protocols", lambda: protocols.check(paths)),
        ("telemetry-lint", lambda: telemetry_lint.lint_paths(paths)),
        ("suppression-audit", lambda: audit_suppressions(paths)),
    ]
    findings: List[aio_lint.Finding] = []
    timings: List[Tuple[str, float]] = []
    for name, fn in stages:
        t0 = time.monotonic()
        findings.extend(fn())
        timings.append((name, time.monotonic() - t0))
    return findings, timings


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.devtools.lint",
        description="run all ray_tpu_torch static-analysis passes",
    )
    parser.add_argument("paths", nargs="*", default=None)
    parser.add_argument(
        "--budget-s",
        type=float,
        default=float(
            os.environ.get("RAY_TPU_LINT_BUDGET_S", _DEFAULT_BUDGET_S)
        ),
        help="fail if the whole gate takes longer than this many seconds "
        "(env RAY_TPU_LINT_BUDGET_S; <= 0 disables)",
    )
    args = parser.parse_args(argv)
    paths = args.paths or [aio_lint._default_root()]

    findings, timings = run_timed(paths)
    findings.sort(key=lambda f: (f.path, f.line, f.col))
    for f in findings:
        print(f)
    total = sum(dt for _, dt in timings)
    passes = ", ".join(
        f"{name} {dt:.2f}s" for name, dt in sorted(timings, key=lambda t: -t[1])
    )
    print(f"lint: {total:.2f}s wall ({passes})")
    over_budget = 0.0 < args.budget_s < total
    if over_budget:
        print(
            f"lint: {RULE_BUDGET}: gate took {total:.2f}s, budget is "
            f"{args.budget_s:g}s — profile the slowest pass above or raise "
            "RAY_TPU_LINT_BUDGET_S deliberately"
        )
    if findings or over_budget:
        if findings:
            print(f"lint: {len(findings)} finding(s) across {_PASSES}")
        return 1
    print(f"lint: clean ({_PASSES})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
