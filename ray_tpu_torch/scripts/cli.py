"""`ray-tpu` CLI: cluster lifecycle, jobs, state, dashboard.

Analog of python/ray/scripts/scripts.py (ray start/stop/status/submit at
:568,1044,1990,1355) + the job CLI (dashboard/modules/job/cli.py) + state
CLI (util/state/state_cli.py). argparse-based; also runnable as
`python -m ray_tpu_torch.scripts.cli`.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time
from typing import Optional

from ray_tpu_torch._private.worker import cluster_state_file

STATE_FILE = cluster_state_file()


def _write_state(address: str, dashboard: Optional[str] = None) -> None:
    with open(STATE_FILE, "w") as f:
        json.dump(
            {"address": address, "pid": os.getpid(), "dashboard": dashboard}, f
        )


def _read_state() -> Optional[dict]:
    try:
        with open(STATE_FILE) as f:
            return json.load(f)
    except Exception:
        return None


def _resolve_address(args) -> str:
    if getattr(args, "address", None):
        return args.address
    env = os.environ.get("RAY_TPU_TORCH_ADDRESS")
    if env:
        return env
    state = _read_state()
    if state:
        return state["address"]
    print("error: no running cluster found (pass --address)", file=sys.stderr)
    sys.exit(1)


# -- ray-tpu start / stop ------------------------------------------------------


def cmd_start(args) -> None:
    import asyncio

    from ray_tpu_torch._private.node import Node

    if not args.head:
        print("error: worker-node mode needs --address; use ray-tpu start --head "
              "or connect raylets via `python -m ray_tpu_torch._private.raylet`",
              file=sys.stderr)
        sys.exit(1)

    async def main():
        node = Node(
            head=True,
            num_cpus=args.num_cpus,
            num_gpus=args.num_gpus,
            object_store_memory=args.object_store_memory,
        )
        await node.start()
        address = f"{node.gcs_addr[0]}:{node.gcs_addr[1]}"
        dash_addr = None
        dash = None
        if not args.no_dashboard:
            from ray_tpu_torch.dashboard.dashboard import Dashboard

            dash = Dashboard(
                node.gcs_addr,
                port=args.dashboard_port,
                session_name=node.session_name,
            )
            host, port = await dash.start()
            dash_addr = f"http://{host}:{port}"
        client_srv = None
        if args.client_server_port >= 0:
            from ray_tpu_torch.util.client.server import ClientServer

            client_srv = ClientServer(
                node.gcs_addr,
                host=args.client_server_host,
                port=args.client_server_port,
            )
            chost, cport = await client_srv.start()
        _write_state(address, dash_addr)
        print(f"ray_tpu_torch head started at {address}")
        if dash_addr:
            print(f"dashboard: {dash_addr}")
        print(f"connect with ray_tpu_torch.init(address='{address}') or address='auto'")
        if client_srv is not None:
            print(
                "remote drivers: "
                f"ray_tpu_torch.init(address='ray-tpu://{chost}:{cport}')"
            )
            if chost in ("127.0.0.1", "localhost"):
                print(
                    "  (bound to loopback; pass --client-server-host 0.0.0.0 "
                    "and firewall the port to accept off-host drivers)"
                )
        stop_event = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop_event.set)
        await stop_event.wait()
        if client_srv is not None:
            await client_srv.stop()
        if dash is not None:
            await dash.stop()
        await node.stop()

    from ray_tpu_torch._private import rpc

    rpc.install_event_loop()
    asyncio.run(main())


def cmd_stop(args) -> None:
    state = _read_state()
    if state is None:
        print("no running cluster")
        return
    try:
        os.kill(state["pid"], signal.SIGTERM)
        print(f"sent SIGTERM to head process {state['pid']}")
    except ProcessLookupError:
        print("head process already gone")
    try:
        os.unlink(STATE_FILE)
    except OSError:
        pass


# -- ray-tpu status ------------------------------------------------------------


def cmd_status(args) -> None:
    import ray_tpu_torch

    ray_tpu_torch.init(address=_resolve_address(args))
    nodes = ray_tpu_torch.nodes()
    total = ray_tpu_torch.cluster_resources()
    avail = ray_tpu_torch.available_resources()
    print(f"nodes: {sum(1 for n in nodes if n['state'] == 'ALIVE')} alive / {len(nodes)}")
    for k in sorted(total):
        print(f"  {k}: {avail.get(k, 0):g} / {total[k]:g} available")
    from ray_tpu_torch.util.state import summarize_actors

    s = summarize_actors()
    print(f"actors: {s['total_actors']}")
    ray_tpu_torch.shutdown()


# -- ray-tpu job ... -----------------------------------------------------------


def cmd_job(args) -> None:
    from ray_tpu_torch.job import JobSubmissionClient

    client = JobSubmissionClient(address=_resolve_address(args))
    if args.job_cmd == "submit":
        entrypoint = " ".join(args.entrypoint)
        sid = client.submit_job(entrypoint=entrypoint)
        print(f"submitted job {sid}")
        if args.wait:
            status = client.wait_until_finish(sid, timeout_s=args.timeout)
            print(client.get_job_logs(sid), end="")
            print(f"job {sid}: {status}")
            sys.exit(0 if status == "SUCCEEDED" else 1)
    elif args.job_cmd == "status":
        print(client.get_job_status(args.id))
    elif args.job_cmd == "logs":
        print(client.get_job_logs(args.id), end="")
    elif args.job_cmd == "list":
        for info in client.list_jobs():
            print(f"{info.submission_id}  {info.status:10s}  {info.entrypoint}")
    elif args.job_cmd == "stop":
        ok = client.stop_job(args.id)
        print("stopped" if ok else "not found")


# -- ray-tpu summary / timeline ------------------------------------------------


def _needs_launcher(command: str):
    raise NotImplementedError(
        f"`ray-tpu {command}` needs the cluster launcher and autoscaler, which "
        "ray_tpu_torch does not have yet (queued in ROADMAP.md, item A17b)"
    )


def cmd_up(args) -> None:
    """Boot a cluster from a YAML (reference: `ray up`, scripts.py:1279)."""
    _needs_launcher("up")


def cmd_down(args) -> None:
    """Tear down a cluster (reference: `ray down`, scripts.py:1355)."""
    _needs_launcher("down")


def cmd_submit(args) -> None:
    """Submit an entrypoint against a cluster booted with `up`."""
    _needs_launcher("submit")


def cmd_summary(args) -> None:
    import ray_tpu_torch
    from ray_tpu_torch.util import state as state_api

    ray_tpu_torch.init(address=_resolve_address(args))
    fn = {
        "tasks": state_api.summarize_tasks,
        "actors": state_api.summarize_actors,
        "objects": state_api.summarize_objects,
    }[args.kind]
    print(json.dumps(fn(), indent=2))
    ray_tpu_torch.shutdown()


def cmd_list(args) -> None:
    import ray_tpu_torch
    from ray_tpu_torch.util import state as state_api

    ray_tpu_torch.init(address=_resolve_address(args))
    fn = getattr(state_api, f"list_{args.kind}")
    print(json.dumps(fn(limit=args.limit), indent=2, default=str))
    ray_tpu_torch.shutdown()


def cmd_timeline(args) -> None:
    import ray_tpu_torch
    from ray_tpu_torch.util.state import critical_path, timeline

    ray_tpu_torch.init(address=_resolve_address(args))
    if args.critical_path:
        report = critical_path(trace_id=args.trace_id)
        if not report["path"]:
            print("no trace spans recorded (enable RAY_TPU_TASK_TRACE_SPANS=1 "
                  "or RAY_TPU_TRACE_SAMPLE_RATE)")
        else:
            print(f"trace {report['trace_id']}  total {report['total_s']*1e3:.2f} ms")
            for seg in report["path"]:
                print(
                    f"  {seg['name']:<32} {seg['kind']:<12} "
                    f"dur {seg['duration_s']*1e3:8.2f} ms  "
                    f"self {seg['self_s']*1e3:8.2f} ms"
                )
            print(f"dominant segment: {report['dominant']}")
    else:
        events = timeline(args.output)
        print(f"wrote {len(events)} events to {args.output}")
    ray_tpu_torch.shutdown()


def cmd_dashboard(args) -> None:
    import asyncio

    from ray_tpu_torch.dashboard.dashboard import run_dashboard

    host, port = _resolve_address(args).rsplit(":", 1)
    asyncio.run(run_dashboard((host, int(port)), port=args.port))


# -- parser --------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ray-tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("start", help="start a head node (blocking)")
    sp.add_argument("--head", action="store_true")
    sp.add_argument("--num-cpus", type=float, default=None)
    sp.add_argument("--num-gpus", type=float, default=None)
    sp.add_argument("--object-store-memory", type=int, default=None)
    sp.add_argument("--no-dashboard", action="store_true")
    sp.add_argument("--dashboard-port", type=int, default=8265)
    # Remote-driver proxy (reference: Ray Client, default port 10001).
    # 0 = ephemeral port, negative = disabled.
    sp.add_argument("--client-server-port", type=int, default=10001)
    # The client protocol executes pickled code with no authentication, so
    # bind loopback by default; exposing it (0.0.0.0) is an explicit opt-in
    # and the port must then be firewalled (matches reference Ray Client
    # guidance).
    sp.add_argument("--client-server-host", default="127.0.0.1")
    sp.set_defaults(fn=cmd_start)

    sp = sub.add_parser("stop", help="stop the head started on this machine")
    sp.set_defaults(fn=cmd_stop)

    sp = sub.add_parser("status", help="cluster resource summary")
    sp.add_argument("--address", default=None)
    sp.set_defaults(fn=cmd_status)

    sp = sub.add_parser("job", help="job submission")
    sp.add_argument("--address", default=None)
    jsub = sp.add_subparsers(dest="job_cmd", required=True)
    j = jsub.add_parser("submit")
    j.add_argument("--wait", action="store_true")
    j.add_argument("--timeout", type=float, default=600.0)
    j.add_argument("entrypoint", nargs=argparse.REMAINDER)
    for name in ("status", "logs", "stop"):
        j = jsub.add_parser(name)
        j.add_argument("id")
    jsub.add_parser("list")
    sp.set_defaults(fn=cmd_job)

    sp = sub.add_parser("up", help="boot a cluster from a YAML config")
    sp.add_argument("config", help="cluster YAML (see autoscaler/launcher.py)")
    sp.add_argument(
        "--monitor", action="store_true",
        help="keep running the autoscaler loop after bring-up",
    )
    sp.set_defaults(fn=cmd_up)

    sp = sub.add_parser("down", help="tear down a cluster booted with `up`")
    sp.add_argument("config", help="cluster YAML used for `up`")
    sp.set_defaults(fn=cmd_down)

    sp = sub.add_parser("submit", help="submit an entrypoint to a cluster")
    sp.add_argument("config", help="cluster YAML used for `up`")
    sp.add_argument("--no-wait", action="store_true")
    sp.add_argument("entrypoint", nargs=argparse.REMAINDER)
    sp.set_defaults(fn=cmd_submit)

    sp = sub.add_parser("summary", help="summarize tasks/actors/objects")
    sp.add_argument("kind", choices=["tasks", "actors", "objects"])
    sp.add_argument("--address", default=None)
    sp.set_defaults(fn=cmd_summary)

    sp = sub.add_parser("list", help="list cluster entities")
    sp.add_argument(
        "kind",
        choices=[
            "nodes",
            "actors",
            "tasks",
            "workers",
            "objects",
            "jobs",
            "placement_groups",
        ],
    )
    sp.add_argument("--limit", type=int, default=100)
    sp.add_argument("--address", default=None)
    sp.set_defaults(fn=cmd_list)

    sp = sub.add_parser("timeline", help="dump chrome://tracing timeline")
    sp.add_argument("--output", default="timeline.json")
    sp.add_argument("--address", default=None)
    sp.add_argument(
        "--critical-path",
        action="store_true",
        help="print the dominant span chain of a trace instead of dumping",
    )
    sp.add_argument(
        "--trace-id",
        default=None,
        help="trace to analyze with --critical-path (default: longest)",
    )
    sp.set_defaults(fn=cmd_timeline)

    sp = sub.add_parser("dashboard", help="run the dashboard against a cluster")
    sp.add_argument("--address", default=None)
    sp.add_argument("--port", type=int, default=8265)
    sp.set_defaults(fn=cmd_dashboard)

    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
