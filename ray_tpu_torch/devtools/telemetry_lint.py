"""telemetry-unregistered-stat: no new ad-hoc stats dicts in runtime code.

introduced ``ray_tpu_torch._private.telemetry`` as the single registry for
runtime counters/gauges/histograms: cells registered there are flushed to
the GCS aggregate, exported on the dashboard's ``/metrics``, and visible to
the chaos flight recorder. A bare ``self.stats = {...}`` dict in runtime
code is invisible to all of that — it works in the one code path that
reads it and silently disappears from cluster-wide observability.

This pass flags dict-literal assignments to ``*stats``-named targets inside
``_private`` packages (``ray_tpu_torch/_private/``, ``ray_tpu_torch/serve/_private/``)
and the instrumented data layer (``ray_tpu_torch/data/`` — runtime code since the
ingest pipeline gained telemetry families).
Legacy dicts that intentionally stay (they back an existing ``stats()``
surface consumed by loadgen/chaos) carry an explicit waiver:

    self.stats = {...}  # telemetry: allow-adhoc-stats

on the flagged line or the line directly above it. New code should register
a telemetry family instead (``telemetry.counter/gauge/histogram``).

Run: ``python -m ray_tpu_torch.devtools.telemetry_lint [paths]``.
"""

from __future__ import annotations

import argparse
import ast
import os
import re
import sys
from typing import Dict, Iterable, List, Optional, Set

from ray_tpu_torch.devtools.aio_lint import Finding, iter_py_files

RULE = "telemetry-unregistered-stat"

_ALLOW_RE = re.compile(r"#\s*telemetry:\s*allow-adhoc-stats")
_STATS_NAME_RE = re.compile(r"(^|_)stats$")


def _allowed_lines(source: str) -> Set[int]:
    out: Set[int] = set()
    for i, text in enumerate(source.splitlines(), start=1):
        if _ALLOW_RE.search(text):
            out.add(i)
    return out


def _target_name(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _in_private_pkg(path: str) -> bool:
    parts = os.path.normpath(path).split(os.sep)
    if "_private" in parts:
        return True
    # The data layer is runtime code with registered telemetry families;
    # hold it to the same no-ad-hoc-stats bar.
    for i, p in enumerate(parts[:-1]):
        if p == "ray_tpu_torch" and parts[i + 1] == "data":
            return True
    return False


def lint_file(path: str, apply_suppressions: bool = True) -> List[Finding]:
    if not _in_private_pkg(path):
        return []
    with open(path, encoding="utf-8") as f:
        source = f.read()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError:
        return []  # other passes report parse failures
    allowed = _allowed_lines(source) if apply_suppressions else set()
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        else:
            continue
        if not isinstance(value, ast.Dict):
            continue
        for tgt in targets:
            name = _target_name(tgt)
            if name is None or not _STATS_NAME_RE.search(name):
                continue
            if node.lineno in allowed or (node.lineno - 1) in allowed:
                continue
            findings.append(
                Finding(
                    path=path,
                    line=node.lineno,
                    col=node.col_offset,
                    rule=RULE,
                    message=(
                        f"ad-hoc stats dict {name!r} in runtime code: "
                        "register a ray_tpu_torch._private.telemetry family "
                        "(counter/gauge/histogram) so it reaches /metrics "
                        "and the flight recorder, or waive with "
                        "'# telemetry: allow-adhoc-stats'"
                    ),
                )
            )
    return findings


def lint_paths(
    paths: Iterable[str], apply_suppressions: bool = True
) -> List[Finding]:
    findings: List[Finding] = []
    for path in paths:
        if os.path.isdir(path):
            for f in iter_py_files(path):
                findings.extend(lint_file(f, apply_suppressions=apply_suppressions))
        else:
            findings.extend(lint_file(path, apply_suppressions=apply_suppressions))
    return findings


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.devtools.telemetry_lint",
        description="flag ad-hoc stats dicts outside the telemetry registry",
    )
    parser.add_argument("paths", nargs="*", default=None)
    args = parser.parse_args(argv)
    if not args.paths:
        from ray_tpu_torch.devtools.aio_lint import _default_root

        args.paths = [_default_root()]
    findings = lint_paths(args.paths)
    for f in findings:
        print(f)
    if findings:
        print(f"telemetry-lint: {len(findings)} finding(s)")
        return 1
    print("telemetry-lint: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
