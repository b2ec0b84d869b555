"""Dashboard: aiohttp server exposing cluster state as JSON + a SPA UI.

Analog of the reference's dashboard/ (head.py:81 + modules + the React
client under dashboard/client): a self-contained single-page app (no build
step, no CDN — it must work on air-gapped TPU pods) served over the same
JSON endpoints the state API uses — overview, nodes, actors, placement
groups, jobs, tasks, structured events, logs, and Prometheus metrics.
"""

from __future__ import annotations

import asyncio
import json
from typing import Any, Dict, Optional, Tuple

INDEX_HTML = """<!doctype html>
<html><head><title>ray_tpu_torch dashboard</title>
<style>
 :root { --fg:#1a1d21; --muted:#667; --line:#e3e6ea; --bg:#fff;
         --accent:#2563eb; --ok:#16a34a; --warn:#d97706; --err:#dc2626; }
 body { font-family: system-ui, sans-serif; margin:0; color:var(--fg);
        background:var(--bg); }
 header { display:flex; align-items:center; gap:1.2rem; padding:.7rem 1.4rem;
          border-bottom:1px solid var(--line); }
 header b { font-size:1.05rem; }
 nav a { margin-right:.9rem; text-decoration:none; color:var(--muted);
         font-size:.92rem; padding:.25rem 0; }
 nav a.active { color:var(--accent); border-bottom:2px solid var(--accent); }
 main { padding:1rem 1.4rem; }
 h2 { font-size:1rem; margin:1.1rem 0 .5rem; }
 table { border-collapse:collapse; width:100%; font-size:.82rem; }
 th,td { border:1px solid var(--line); padding:.28rem .5rem; text-align:left;
         vertical-align:top; max-width:26rem; overflow-wrap:anywhere; }
 th { background:#f6f7f9; position:sticky; top:0; cursor:pointer; }
 .mono { font-family:ui-monospace, monospace; }
 .pill { display:inline-block; padding:.05rem .45rem; border-radius:.6rem;
         font-size:.75rem; color:#fff; }
 .ALIVE,.READY,.SUCCEEDED,.CREATED,.RUNNING_ok { background:var(--ok); }
 .PENDING,.RESTARTING,.PENDING_CREATION,.RUNNING { background:var(--warn); }
 .DEAD,.FAILED,.ERROR,.STOPPED { background:var(--err); }
 .cards { display:flex; gap:1rem; flex-wrap:wrap; margin:.6rem 0 1rem; }
 .card { border:1px solid var(--line); border-radius:.5rem;
         padding:.7rem 1.1rem; min-width:9rem; }
 .card .n { font-size:1.5rem; font-weight:600; }
 .card .l { color:var(--muted); font-size:.8rem; }
 .bar { height:.5rem; background:#eef1f4; border-radius:.3rem;
        overflow:hidden; margin-top:.3rem; }
 .bar i { display:block; height:100%; background:var(--accent); }
 input[type=search] { padding:.3rem .5rem; border:1px solid var(--line);
        border-radius:.3rem; min-width:16rem; margin:.2rem 0 .6rem; }
 pre.log { background:#0f1115; color:#d6d9de; padding:.8rem; font-size:.78rem;
        border-radius:.4rem; max-height:32rem; overflow:auto; }
 .muted { color:var(--muted); }
</style></head>
<body>
<header>
 <b>ray_tpu_torch</b>
 <nav id="nav"></nav>
 <span class="muted" id="stamp" style="margin-left:auto"></span>
</header>
<main id="root">loading…</main>
<script>
const TABS = ["overview","nodes","actors","placement_groups","jobs","tasks",
              "events","logs","metrics"];
const j = async (u) => (await fetch(u)).json();
const esc = (s) => String(s).replaceAll("&","&amp;").replaceAll("<","&lt;")
  .replaceAll(">","&gt;").replaceAll('"',"&quot;").replaceAll("'","&#39;");
const fmt = (o) => o === null || o === undefined ? "" :
  esc(typeof o === "object" ? JSON.stringify(o) : String(o));
// Pill class names come from server data: only known state tokens may
// become CSS classes (everything is escaped before it hits innerHTML).
const pill = (s) => s ? `<span class="pill ${
  /^[A-Z_]+$/.test(s) ? s : ""}">${esc(s)}</span>` : "";
let filterText = "";

function table(rows, cols, opts) {
  opts = opts || {};
  if (!rows || !rows.length) return "<i class=muted>none</i>";
  cols = cols || Object.keys(rows[0]);
  const ft = filterText.toLowerCase();
  if (ft) rows = rows.filter(r => JSON.stringify(r).toLowerCase().includes(ft));
  let h = "<table><tr>" + cols.map(c => `<th>${c}</th>`).join("") + "</tr>";
  for (const r of rows) {
    h += "<tr>" + cols.map(c => {
      let v = r[c];
      if (opts.pills && opts.pills.includes(c)) return `<td>${pill(v)}</td>`;
      return `<td class=mono>${fmt(v)}</td>`;
    }).join("") + "</tr>";
  }
  return h + `</table><div class=muted>${rows.length} rows</div>`;
}
function searchBox() {
  return `<input id=filt type=search placeholder="filter…" ` +
         `value="${esc(filterText)}" oninput="onFilt(this)">`;
}
function onFilt(el) {
  filterText = el.value;
  render();
  const f = document.getElementById("filt");
  if (f) { f.focus(); f.setSelectionRange(f.value.length, f.value.length); }
}

let cache = {};
async function load(tab) {
  if (tab === "overview") {
    const [nodes, actors, ev] = await Promise.all([
      j("/api/nodes"), j("/api/actors"), j("/api/events?limit=15")]);
    return {nodes: nodes.nodes, actors: actors.actors, events: ev.events};
  }
  if (tab === "nodes") return j("/api/nodes");
  if (tab === "actors") return j("/api/actors");
  if (tab === "placement_groups") return j("/api/placement_groups");
  if (tab === "jobs") return j("/api/jobs");
  if (tab === "tasks") return j("/api/tasks/summary");
  if (tab === "events") return j("/api/events?limit=500");
  if (tab === "logs") return j("/api/logs");
  return {};
}
function overview(d) {
  const alive = d.nodes.filter(n => n.state === "ALIVE");
  const byState = {};
  for (const a of d.actors) byState[a.state] = (byState[a.state] || 0) + 1;
  const res = {};
  for (const n of alive) {
    for (const [k, v] of Object.entries(n.total || {})) {
      res[k] = res[k] || {total: 0, avail: 0};
      res[k].total += v; res[k].avail += (n.available || {})[k] ?? 0;
    }
  }
  let cards = `<div class=cards>
    <div class=card><div class=n>${alive.length}</div><div class=l>alive nodes</div></div>
    <div class=card><div class=n>${d.actors.length}</div><div class=l>actors</div></div>`;
  for (const [s, c] of Object.entries(byState))
    cards += `<div class=card><div class=n>${c}</div><div class=l>${pill(s)}</div></div>`;
  cards += "</div><h2>Resources</h2><div class=cards>";
  for (const [k, v] of Object.entries(res)) {
    const used = v.total - v.avail, pct = v.total ? 100 * used / v.total : 0;
    cards += `<div class=card style="min-width:14rem">
      <div class=l>${esc(k)}</div><div class=n>${(used/1e4).toFixed(1)} / ${(v.total/1e4).toFixed(1)}</div>
      <div class=bar><i style="width:${pct}%"></i></div></div>`;
  }
  cards += "</div><h2>Recent events</h2>" + table(
    (d.events || []).slice().reverse(),
    ["timestamp","severity","label","message"], {pills:["severity"]});
  return cards;
}
function render() {
  const tab = location.hash.replace("#", "") || "overview";
  document.getElementById("nav").innerHTML = TABS.map(t =>
    `<a href="#${t}" class="${t === tab ? 'active' : ''}">${t.replace("_"," ")}</a>`
  ).join("");
  const d = cache[tab];
  const root = document.getElementById("root");
  if (!d) { root.innerHTML = "loading…"; return; }
  if (tab === "overview") root.innerHTML = overview(d);
  else if (tab === "nodes") root.innerHTML = searchBox() + table(d.nodes, null, {pills:["state"]});
  else if (tab === "actors") root.innerHTML = searchBox() + table(d.actors,
    ["actor_id","class_name","name","state","node_id","worker_id","num_restarts"],
    {pills:["state"]});
  else if (tab === "placement_groups") root.innerHTML = searchBox() +
    table(d.pgs, null, {pills:["state"]});
  else if (tab === "jobs") root.innerHTML = searchBox() + table(d.jobs, null, {pills:["status"]});
  else if (tab === "tasks") root.innerHTML = "<h2>Task summary</h2><pre class=log>" +
    esc(JSON.stringify(d, null, 2)) + "</pre>";
  else if (tab === "events") root.innerHTML = searchBox() + table(
    (d.events || []).slice().reverse(),
    ["timestamp","severity","label","message","source_type"], {pills:["severity"]});
  else if (tab === "logs") {
    let h = "<h2>Session logs</h2>";
    for (const [node, reply] of Object.entries(d)) {
      const files = (reply && reply.files) || [];
      h += `<h2 class=mono>${esc(node)}</h2><ul>` + files.map(f =>
        `<li><a href="#" class="mono loglink" data-node="${esc(node)}" ` +
        `data-file="${esc(f)}">${esc(f)}</a></li>`
      ).join("") + "</ul>";
    }
    root.innerHTML = h + '<div id=logview></div>';
    for (const a of root.querySelectorAll("a.loglink"))
      a.addEventListener("click", (e) => {
        e.preventDefault();
        showLog(a.dataset.node, a.dataset.file);
      });
  }
  else if (tab === "metrics") root.innerHTML =
    '<p>Prometheus exposition at <a href="/metrics">/metrics</a>; file-SD + ' +
    'generated Grafana dashboard JSON live under the session dir ' +
    '(see util/metrics_export.py).</p>';
  document.getElementById("stamp").textContent =
    "updated " + new Date().toLocaleTimeString();
}
async function showLog(node, file) {
  const r = await j(`/api/logs?node_id=${encodeURIComponent(node)}` +
                    `&filename=${encodeURIComponent(file)}`);
  const reply = r[node] || {};
  const text = (reply.lines || []).join("\n");
  document.getElementById("logview").innerHTML =
    `<h2 class=mono>${esc(file)}</h2><pre class=log>${esc(text)}</pre>`;
}
let lastError = null;
async function refresh() {
  const tab = location.hash.replace("#", "") || "overview";
  try { cache[tab] = await load(tab); lastError = null; }
  catch (e) { lastError = e; }
  render();
  if (lastError) {
    document.getElementById("stamp").textContent =
      "backend unreachable: " + lastError;
  }
}
window.addEventListener("hashchange", refresh);
refresh(); setInterval(refresh, 5000);
</script></body></html>
"""


class Dashboard:
    def __init__(
        self,
        gcs_addr: Tuple[str, int],
        host: str = "127.0.0.1",
        port: int = 8265,
        session_name: str = "",
    ):
        self.gcs_addr = gcs_addr
        self.host = host
        self.port = port
        self.session_name = session_name
        self._conn = None
        self._runner = None
        self._sd_writer = None

    async def _gcs(self, method: str, payload: Optional[dict] = None):
        from ray_tpu_torch._private import rpc

        if self._conn is None or self._conn.closed:
            self._conn = await rpc.connect(*self.gcs_addr)
        return await self._conn.call(method, payload or {})

    async def start(self) -> Tuple[str, int]:
        from aiohttp import web

        app = web.Application()
        app.router.add_get("/", self._index)
        app.router.add_get("/api/cluster_status", self._cluster_status)
        app.router.add_get("/api/nodes", self._nodes)
        app.router.add_get("/api/actors", self._actors)
        app.router.add_get("/api/jobs", self._jobs)
        app.router.add_get("/api/placement_groups", self._pgs)
        app.router.add_get("/api/tasks", self._tasks)
        app.router.add_get("/api/logs", self._logs)
        app.router.add_get("/api/tasks/summary", self._task_summary)
        app.router.add_get("/api/events", self._events)
        app.router.add_get("/metrics", self._metrics)
        app.router.add_get("/-/healthz", self._healthz)
        self._runner = web.AppRunner(app, access_log=None)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.host, self.port)
        await site.start()
        if self.port == 0:
            self.port = site._server.sockets[0].getsockname()[1]
        # Observability side outputs (reference: metrics_agent.py:595 file-SD
        # + dashboard/modules/metrics generated Grafana dashboards): a stock
        # Prometheus file_sd_config pointed at the session dir scrapes this
        # dashboard's /metrics; the Grafana JSON is provisioning-ready.
        try:
            import os
            import tempfile

            from ray_tpu_torch.util.metrics_export import (
                PrometheusServiceDiscoveryWriter,
                write_grafana_dashboards,
            )

            session_dir = os.path.join(
                tempfile.gettempdir(),
                f"ray_tpu_torch_{self.session_name or 'default'}",
            )
            self._sd_writer = PrometheusServiceDiscoveryWriter(
                lambda: [f"{self.host}:{self.port}"], session_dir
            )
            self._sd_writer.start()
            write_grafana_dashboards(session_dir)
        except Exception:
            pass
        return self.host, self.port

    async def stop(self) -> None:
        if self._sd_writer is not None:
            self._sd_writer.stop()
            self._sd_writer = None
        if self._runner is not None:
            await self._runner.cleanup()
        if self._conn is not None:
            await self._conn.close()

    # -- handlers ------------------------------------------------------------

    async def _index(self, request):
        from aiohttp import web

        return web.Response(text=INDEX_HTML, content_type="text/html")

    async def _healthz(self, request):
        from aiohttp import web

        return web.Response(text="success")

    async def _cluster_status(self, request):
        from aiohttp import web

        return web.json_response(await self._gcs("GetClusterStatus"))

    async def _nodes(self, request):
        from aiohttp import web

        return web.json_response(await self._gcs("GetAllNodes"))

    async def _actors(self, request):
        from aiohttp import web

        return web.json_response(await self._gcs("ListActors"))

    async def _jobs(self, request):
        from aiohttp import web
        from ray_tpu_torch.job.job_manager import JOB_INFO_NS

        reply = await self._gcs("KVKeys", {"ns": JOB_INFO_NS, "prefix": ""})
        jobs = []
        for key in reply.get("keys", []):
            blob = (await self._gcs("KVGet", {"ns": JOB_INFO_NS, "key": key})).get(
                "value"
            )
            if blob:
                jobs.append(json.loads(blob))
        return web.json_response({"jobs": jobs})

    async def _pgs(self, request):
        from aiohttp import web

        return web.json_response(await self._gcs("ListPlacementGroups"))

    async def _events(self, request):
        """Structured cluster events (reference: dashboard event module over
        the event framework)."""
        from aiohttp import web

        q = request.query
        try:
            limit = min(int(q.get("limit", 500)), 10000)
        except ValueError:
            return web.json_response({"error": "limit must be int"}, status=400)
        return web.json_response(
            await self._gcs(
                "ListEvents",
                {
                    "severity": q.get("severity"),
                    "label": q.get("label"),
                    "limit": limit,
                },
            )
        )

    async def _tasks(self, request):
        from aiohttp import web

        reply = await self._gcs("ListTaskEvents", {"limit": 5000})
        return web.json_response(reply)

    async def _logs(self, request):
        """Log viewer endpoint: ?node_id=&filename=&worker_id=&tail= —
        proxies the raylet GetLog/ListLogs RPCs (reference: dashboard log
        module + state API get_log)."""
        from aiohttp import web

        from ray_tpu_torch._private import rpc

        q = request.query
        nodes = (await self._gcs("GetAllNodes"))["nodes"]
        out = {}
        for n in nodes:
            if n["state"] != "ALIVE":
                continue
            if q.get("node_id") and n["node_id"] != q["node_id"]:
                continue
            try:
                conn = await rpc.connect(*n["addr"], retry=2)
            except rpc.RpcError:
                continue
            try:
                if q.get("filename") or q.get("worker_id"):
                    try:
                        tail = min(int(q.get("tail", 1000)), 100000)
                    except ValueError:
                        return web.json_response(
                            {"error": "tail must be an integer"}, status=400
                        )
                    reply = await conn.call(
                        "GetLog",
                        {
                            "filename": q.get("filename"),
                            "worker_id": q.get("worker_id"),
                            "stream": q.get("stream", "stderr"),
                            "tail": tail,
                        },
                    )
                else:
                    reply = await conn.call("ListLogs", {})
                out[n["node_id"]] = reply
            finally:
                await conn.close()
        return web.json_response(out)

    async def _metrics(self, request):
        """Prometheus text exposition: application metrics merged across all
        workers (the reference MetricsAgent role) followed by the runtime
        telemetry aggregate pulled from the GCS (GetTelemetry)."""
        import time as _time

        from aiohttp import web

        from ray_tpu_torch._private import telemetry
        from ray_tpu_torch._private.common import config
        from ray_tpu_torch.util.metrics import METRICS_NS, render_prometheus

        keys = (await self._gcs("KVKeys", {"ns": METRICS_NS, "prefix": ""})).get(
            "keys", []
        )
        now = _time.time()
        stale_after = config.metrics_stale_after_s
        per_worker = {}
        for key in keys:
            blob = (await self._gcs("KVGet", {"ns": METRICS_NS, "key": key})).get(
                "value"
            )
            if not blob:
                continue
            snap = json.loads(blob)
            # Age out snapshots from workers that stopped flushing (dead
            # worker must not serve its last values forever). Unstamped
            # snapshots predate the _ts field and are kept.
            ts = snap.get("_ts")
            if ts is not None and now - ts > stale_after:
                await self._gcs("KVDel", {"ns": METRICS_NS, "key": key})
                continue
            per_worker[key] = snap
        text = render_prometheus(per_worker)
        try:
            reply = await self._gcs("GetTelemetry", {})
        except Exception:
            reply = None
        if reply:
            text += telemetry.render_runtime_prometheus(
                reply["telemetry"],
                worker_deadline_stats=reply.get("worker_deadline_stats"),
            )
        return web.Response(text=text, content_type="text/plain")

    async def _task_summary(self, request):
        from aiohttp import web

        reply = await self._gcs("ListTaskEvents", {"limit": 100000})
        latest: Dict[str, dict] = {}
        for e in reply["events"]:
            if e.get("state") in ("PROFILE", "SPAN"):
                continue  # phase/trace records, not lifecycle states
            cur = latest.get(e["task_id"])
            if cur is None or e["time"] >= cur["time"]:
                latest[e["task_id"]] = e
        summary: Dict[str, Dict[str, int]] = {}
        for e in latest.values():
            name = e.get("name") or "?"
            summary.setdefault(name, {})
            summary[name][e["state"]] = summary[name].get(e["state"], 0) + 1
        return web.json_response({"summary": summary, "total": len(latest)})


async def run_dashboard(gcs_addr, host="127.0.0.1", port=8265):
    dash = Dashboard(tuple(gcs_addr), host, port)
    bound = await dash.start()
    print(f"dashboard at http://{bound[0]}:{bound[1]}")
    while True:
        await asyncio.sleep(3600)
