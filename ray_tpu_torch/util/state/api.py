"""State API: list/summarize live cluster state.

Analog of python/ray/util/state/api.py (list_actors/tasks/objects/nodes/
workers/placement_groups/jobs at :788-1112, summarize_* at :1382-1450), fed
by the GCS (actors/nodes/PGs/jobs/task events) and per-raylet detail queries
(workers/objects — the reference's GetTasksInfo/GetObjectsInfo path).
"""

from __future__ import annotations

import collections
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch._private.common import ResourceSet


def _call_gcs(method: str, payload: Optional[dict] = None) -> dict:
    core = worker_mod._core()
    return worker_mod.global_worker.run_async(core.gcs.call(method, payload or {}))


def _filter(rows: List[dict], filters) -> List[dict]:
    """filters: list of (key, op, value) with op in ("=", "!=")."""
    for key, op, value in filters or []:
        if op == "=":
            rows = [r for r in rows if str(r.get(key)) == str(value)]
        elif op == "!=":
            rows = [r for r in rows if str(r.get(key)) != str(value)]
        else:
            raise ValueError(f"unsupported filter op {op!r}")
    return rows


def list_nodes(filters=None, limit: int = 10000) -> List[dict]:
    rows = _call_gcs("GetAllNodes")["nodes"]
    return _filter(rows, filters)[:limit]


def list_cluster_events(
    severity: Optional[str] = None,
    label: Optional[str] = None,
    limit: int = 1000,
) -> List[dict]:
    """Structured cluster events (reference: python/ray/_private/event/ +
    `ray list cluster-events`): node membership, actor failures/restarts,
    emitted by the GCS event logger and durably appended to
    <session>/logs/events/event_GCS.log."""
    return _call_gcs(
        "ListEvents",
        {"severity": severity, "label": label, "limit": limit},
    )["events"]


def list_actors(filters=None, limit: int = 10000) -> List[dict]:
    rows = _call_gcs("ListActors")["actors"]
    return _filter(rows, filters)[:limit]


def list_placement_groups(filters=None, limit: int = 10000) -> List[dict]:
    rows = _call_gcs("ListPlacementGroups")["pgs"]
    return _filter(rows, filters)[:limit]


def list_jobs(filters=None, limit: int = 10000) -> List[dict]:
    rows = _call_gcs("ListJobs")["jobs"]
    return _filter(rows, filters)[:limit]


def list_tasks(filters=None, limit: int = 10000, job_id: Optional[str] = None) -> List[dict]:
    """Latest state per task, derived from the task-event log."""
    events = _call_gcs("ListTaskEvents", {"job_id": job_id, "limit": 100000})["events"]
    latest: Dict[str, dict] = {}
    first_ts: Dict[str, float] = {}
    resources: Dict[str, dict] = {}  # the lease's, from the PENDING event
    for e in events:
        if e.get("state") in ("PROFILE", "SPAN"):
            continue  # phase/trace records, not lifecycle states
        tid = e["task_id"]
        first_ts.setdefault(tid, e["time"])
        if e.get("resources"):
            resources[tid] = e["resources"]
        cur = latest.get(tid)
        if cur is None or e["time"] >= cur["time"]:
            latest[tid] = e
    rows = [
        {
            "task_id": tid,
            "name": e.get("name"),
            "state": e.get("state"),
            "job_id": e.get("job_id"),
            "worker_id": e.get("worker_id"),
            "node_id": e.get("node_id"),
            "start_time": first_ts[tid],
            "end_time": e["time"] if e.get("state") in ("FINISHED", "FAILED") else None,
            "error": e.get("error"),
            "resources": ResourceSet.from_units(resources.get(tid, {})).to_dict(),
        }
        for tid, e in latest.items()
    ]
    rows.sort(key=lambda r: r["start_time"])
    return _filter(rows, filters)[:limit]


def _each_raylet(payload: dict) -> List[dict]:
    core = worker_mod._core()

    async def _collect():
        out = []
        for n in (await core.gcs.call("GetAllNodes"))["nodes"]:
            if n["state"] != "ALIVE":
                continue
            try:
                conn = await core.connect_to(tuple(n["addr"]))
                out.append(await conn.call("GetNodeStats", payload))
            except Exception:
                pass
        return out

    return worker_mod.global_worker.run_async(_collect())


def list_logs(node_id: Optional[str] = None) -> Dict[str, List[str]]:
    """Log files captured per node (reference: ray.util.state.list_logs)."""
    core = worker_mod._core()

    async def _collect():
        out = {}
        for n in (await core.gcs.call("GetAllNodes"))["nodes"]:
            if n["state"] != "ALIVE":
                continue
            if node_id is not None and n["node_id"] != node_id:
                continue
            try:
                conn = await core.connect_to(tuple(n["addr"]))
                reply = await conn.call("ListLogs", {})
                out[n["node_id"]] = reply["files"]
            except Exception:
                pass
        return out

    return worker_mod.global_worker.run_async(_collect())


def get_log(
    node_id: Optional[str] = None,
    filename: Optional[str] = None,
    worker_id: Optional[str] = None,
    stream: str = "stderr",
    tail: int = 1000,
) -> List[str]:
    """Tail of a captured worker log (reference: ray.util.state.get_log,
    python/ray/util/state/api.py:1183). Identify the log by filename (from
    list_logs) or worker_id; with no node_id every node is asked."""
    core = worker_mod._core()

    async def _collect():
        payload = {
            "filename": filename,
            "worker_id": worker_id,
            "stream": stream,
            "tail": tail,
        }
        for n in (await core.gcs.call("GetAllNodes"))["nodes"]:
            if n["state"] != "ALIVE":
                continue
            if node_id is not None and n["node_id"] != node_id:
                continue
            try:
                conn = await core.connect_to(tuple(n["addr"]))
                reply = await conn.call("GetLog", payload)
            except Exception:
                continue
            if reply.get("found"):
                return reply["lines"]
        return []

    return worker_mod.global_worker.run_async(_collect())


def list_workers(filters=None, limit: int = 10000) -> List[dict]:
    rows: List[dict] = []
    for stats in _each_raylet({"include_workers": True}):
        rows.extend(stats.get("workers", []))
    return _filter(rows, filters)[:limit]


def list_objects(filters=None, limit: int = 10000) -> List[dict]:
    rows: List[dict] = []
    for stats in _each_raylet({"include_objects": True}):
        rows.extend(stats.get("objects", []))
    return _filter(rows, filters)[:limit]


# -- summaries ----------------------------------------------------------------


def summarize_tasks(job_id: Optional[str] = None) -> Dict[str, Any]:
    per_name: Dict[str, collections.Counter] = collections.defaultdict(
        collections.Counter
    )
    for t in list_tasks(job_id=job_id):
        per_name[t["name"] or "?"][t["state"]] += 1
    return {
        "summary": {
            name: dict(states) for name, states in sorted(per_name.items())
        },
        "total_tasks": sum(sum(c.values()) for c in per_name.values()),
    }


def summarize_actors() -> Dict[str, Any]:
    per_class: Dict[str, collections.Counter] = collections.defaultdict(
        collections.Counter
    )
    for a in list_actors():
        per_class[a.get("name") or a.get("class_name") or "?"][a["state"]] += 1
    return {
        "summary": {cls: dict(states) for cls, states in sorted(per_class.items())},
        "total_actors": sum(sum(c.values()) for c in per_class.values()),
    }


def summarize_objects() -> Dict[str, Any]:
    objs = list_objects()
    total = sum(o["size"] for o in objs)
    return {
        "total_objects": len(objs),
        "total_size_bytes": total,
        "pinned": sum(1 for o in objs if o["pinned"]),
        "sealed": sum(1 for o in objs if o["sealed"]),
    }


# -- timeline (reference: ray.timeline, _private/state.py:922) ----------------


def list_spans(trace_id: Optional[str] = None, limit: int = 10000) -> List[dict]:
    """Tracing spans (reference: the OTel spans tracing_helper.py emits),
    task-level (kind submit|execute) and runtime-internal (lease, object,
    serve, data, collective kinds) alike. Each: {span_id, parent_span_id,
    trace_id, kind, name, task_id?, start, duration, ...attrs}. The
    trace_id filter and limit run GCS-side (ListSpans), so this never
    ships the whole span ring. Requires tracing to be on
    (RAY_TPU_TASK_TRACE_SPANS=1 or RAY_TPU_TRACE_SAMPLE_RATE>0)."""
    events = _call_gcs("ListSpans", {"trace_id": trace_id, "limit": limit})[
        "spans"
    ]
    spans = []
    for e in events:
        row = dict(e)
        row.pop("state", None)
        row.setdefault("task_id", None)
        spans.append(row)
    return sorted(spans, key=lambda s: s.get("start") or 0)


def _span_timeline_events(spans: List[dict]) -> List[dict]:
    """Chrome X events for trace spans, with the trace linkage in args so
    chrome://tracing / Perfetto flows can be reconstructed."""
    out = []
    for e in spans:
        out.append(
            {
                "name": f"{e.get('name') or 'task'}::{e.get('kind')}",
                "cat": "span",
                "ph": "X",
                "ts": (e.get("start") or e.get("time") or 0.0) * 1e6,
                "dur": max(0.0, (e.get("duration") or 0.0) * 1e6),
                "pid": e.get("node_id", "node"),
                "tid": e.get("worker_id", "worker"),
                "args": {
                    "task_id": e.get("task_id"),
                    "span_id": e.get("span_id"),
                    "parent_span_id": e.get("parent_span_id"),
                    "trace_id": e.get("trace_id"),
                },
            }
        )
    return out


def timeline(filename: Optional[str] = None) -> List[dict]:
    """Chrome-tracing events derived from the task-event log (one complete
    ("X") event per RUNNING->FINISHED/FAILED task) merged with the trace
    spans from the GCS span ring."""
    events = _call_gcs("ListTaskEvents", {"limit": 100000})["events"]
    spans: Dict[str, dict] = {}
    out: List[dict] = _span_timeline_events(
        _call_gcs("ListSpans", {"limit": 100000})["spans"]
    )
    for e in sorted(events, key=lambda x: x["time"]):
        tid = e["task_id"]
        if e["state"] == "PROFILE":
            # Worker-side phase spans (deserialize/execute/store): one X
            # event per phase, laid back-to-back from the recorded start
            # (reference: profile events in ray.timeline).
            ts = e.get("start", e["time"]) * 1e6
            for phase, dur_s in (e.get("phases") or {}).items():
                out.append(
                    {
                        "name": f"{e.get('name') or 'task'}::{phase}",
                        "cat": "profile",
                        "ph": "X",
                        "ts": ts,
                        "dur": max(0.0, dur_s * 1e6),
                        "pid": e.get("node_id", "node"),
                        "tid": e.get("worker_id", "worker"),
                        "args": {"task_id": tid},
                    }
                )
                ts += dur_s * 1e6
            continue
        if e["state"] == "RUNNING":
            spans[tid] = e
        elif e["state"] in ("FINISHED", "FAILED") and tid in spans:
            start = spans.pop(tid)
            out.append(
                {
                    "name": e.get("name") or "task",
                    "cat": "task",
                    "ph": "X",
                    "ts": start["time"] * 1e6,
                    "dur": max(0.0, (e["time"] - start["time"]) * 1e6),
                    "pid": e.get("node_id", "node"),
                    "tid": e.get("worker_id", "worker"),
                    "args": {"task_id": tid, "state": e["state"]},
                }
            )
    if filename:
        import json

        with open(filename, "w") as f:
            json.dump(out, f)
    return out


def critical_path(trace_id: Optional[str] = None) -> Dict[str, Any]:
    """Walk a trace's span DAG and report the chain of spans that bounds
    its end-to-end latency, with per-segment *self time* (duration minus
    the on-path child's overlap) so the dominant segment is named rather
    than inferred from a timeline by eye.

    With no trace_id, the longest recorded trace (largest start->finish
    extent) is analyzed. Returns ``{trace_id, total_s, path, segments,
    dominant}`` — ``path`` in causal order, ``segments`` sorted by self
    time descending, ``dominant`` the name of the top segment."""
    spans = list_spans(trace_id=trace_id, limit=100000)
    if not spans:
        return {
            "trace_id": trace_id,
            "total_s": 0.0,
            "path": [],
            "segments": [],
            "dominant": None,
        }

    def _start(s: dict) -> float:
        return s.get("start") or 0.0

    def _end(s: dict) -> float:
        return _start(s) + (s.get("duration") or 0.0)

    by_trace: Dict[str, List[dict]] = collections.defaultdict(list)
    for s in spans:
        if s.get("trace_id"):
            by_trace[s["trace_id"]].append(s)
    if not by_trace:
        return {
            "trace_id": trace_id,
            "total_s": 0.0,
            "path": [],
            "segments": [],
            "dominant": None,
        }
    if trace_id is None:
        trace_id = max(
            by_trace,
            key=lambda t: max(_end(s) for s in by_trace[t])
            - min(_start(s) for s in by_trace[t]),
        )
    trace = by_trace[trace_id]
    ids = {s["span_id"]: s for s in trace if s.get("span_id")}
    children: Dict[str, List[dict]] = collections.defaultdict(list)
    for s in trace:
        parent = s.get("parent_span_id")
        if parent in ids and parent != s.get("span_id"):
            children[parent].append(s)
    roots = [s for s in trace if s.get("parent_span_id") not in ids]
    # The root whose subtree finishes last bounds the trace.
    root = max(roots, key=_end)

    path = [root]
    seen = {root.get("span_id")}
    cur = root
    while True:
        kids = [
            k for k in children.get(cur.get("span_id"), []) if k["span_id"] not in seen
        ]
        if not kids:
            break
        cur = max(kids, key=_end)  # the last-finishing child gates the parent
        seen.add(cur["span_id"])
        path.append(cur)

    total = max(_end(s) for s in path) - _start(root)
    segments = []
    for i, s in enumerate(path):
        dur = s.get("duration") or 0.0
        if i + 1 < len(path):
            child = path[i + 1]
            overlap = max(
                0.0, min(_end(s), _end(child)) - max(_start(s), _start(child))
            )
            self_s = max(0.0, dur - overlap)
        else:
            self_s = dur
        segments.append(
            {
                "name": s.get("name"),
                "kind": s.get("kind"),
                "span_id": s.get("span_id"),
                "duration_s": dur,
                "self_s": self_s,
            }
        )
    ranked = sorted(segments, key=lambda seg: seg["self_s"], reverse=True)
    return {
        "trace_id": trace_id,
        "total_s": total,
        "path": segments,
        "segments": ranked,
        "dominant": ranked[0]["name"] if ranked else None,
    }
