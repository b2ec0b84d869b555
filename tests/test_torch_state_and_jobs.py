"""The state API, jobs, the dashboard, metrics export, logs and the CLI on
the port (ray_tpu_torch.util.state, .job, .dashboard, .util.metrics_export,
.scripts.cli), on the CPU: the cases of tests/test_state_and_jobs.py,
tests/test_observability.py and tests/test_logs.py on the port's runtime;
then the CLI's parser against the reference's (the same subcommands and
options, --num-gpus for --num-tpus), and both packages' heads side by side
on one machine: each CLI keeps its own state file and status, and a port
job's init(address="auto") attaches to the port cluster that runs it, never
to another head."""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import pytest

import ray_tpu_torch
from ray_tpu_torch.testing import torch_cluster  # noqa: F401
from ray_tpu_torch.util.metrics_export import (
    PrometheusServiceDiscoveryWriter,
    generate_grafana_dashboard,
    write_grafana_dashboards,
)
from ray_tpu_torch.util.state import get_log, list_logs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def shutdown_only():
    yield None
    ray_tpu_torch.shutdown()


def test_state_api_lists(torch_cluster):  # noqa: F811
    import ray_tpu_torch
    from ray_tpu_torch.util import state as state_api

    @ray_tpu_torch.remote
    def f(x):
        return x + 1

    @ray_tpu_torch.remote
    class A:
        def ping(self):
            return "pong"

    a = A.options(name="state_test_actor").remote()
    assert ray_tpu_torch.get(a.ping.remote()) == "pong"
    refs = [f.remote(i) for i in range(5)]
    assert ray_tpu_torch.get(refs) == [1, 2, 3, 4, 5]
    time.sleep(1.5)  # task-event flush interval

    nodes = state_api.list_nodes()
    assert len(nodes) == 1 and nodes[0]["state"] == "ALIVE"

    actors = state_api.list_actors()
    assert any(x["name"] == "state_test_actor" for x in actors)
    alive = state_api.list_actors(filters=[("state", "=", "ALIVE")])
    assert all(x["state"] == "ALIVE" for x in alive)

    tasks = state_api.list_tasks()
    f_tasks = [t for t in tasks if t["name"] == "f"]
    assert len(f_tasks) == 5
    assert all(t["state"] == "FINISHED" for t in f_tasks)

    workers = state_api.list_workers()
    assert len(workers) >= 1
    assert all(w["pid"] for w in workers)

    summary = state_api.summarize_tasks()
    assert summary["summary"]["f"]["FINISHED"] == 5

    a_sum = state_api.summarize_actors()
    assert a_sum["total_actors"] >= 1


def test_timeline(torch_cluster, tmp_path):  # noqa: F811
    import ray_tpu_torch
    from ray_tpu_torch.util.state import timeline

    @ray_tpu_torch.remote
    def work():
        time.sleep(0.05)
        return 1

    ray_tpu_torch.get([work.remote() for _ in range(3)])
    time.sleep(1.5)
    out = tmp_path / "timeline.json"
    events = timeline(str(out))
    spans = [e for e in events if e["name"] == "work"]
    assert len(spans) == 3
    assert all(e["ph"] == "X" and e["dur"] > 0 for e in spans)
    assert json.loads(out.read_text())


def test_timeline_profile_events(shutdown_only, monkeypatch):
    """With profiling on, worker-side phase spans (deserialize/execute/
    store) appear in the chrome timeline (reference: RAY_PROFILING)."""
    monkeypatch.setenv("RAY_TPU_TASK_PROFILE_EVENTS", "1")
    import ray_tpu_torch
    from ray_tpu_torch.util.state import timeline

    ray_tpu_torch.init(num_cpus=2)

    @ray_tpu_torch.remote
    def work():
        time.sleep(0.03)
        return 1

    ray_tpu_torch.get([work.remote() for _ in range(2)])
    time.sleep(1.5)
    events = timeline()
    phases = [e for e in events if e["cat"] == "profile"]
    names = {e["name"] for e in phases}
    assert "work::execute" in names, names
    ex = [e for e in phases if e["name"] == "work::execute"]
    assert all(e["dur"] >= 0.02 * 1e6 for e in ex)


def test_job_submission(torch_cluster):  # noqa: F811
    from ray_tpu_torch.job import JobStatus, JobSubmissionClient

    client = JobSubmissionClient()
    sid = client.submit_job(
        entrypoint=f"{sys.executable} -c \"print('hello from job')\""
    )
    status = client.wait_until_finish(sid, timeout_s=60)
    assert status == JobStatus.SUCCEEDED
    assert "hello from job" in client.get_job_logs(sid)
    jobs = client.list_jobs()
    assert any(j.submission_id == sid for j in jobs)


def test_job_failure_and_env(torch_cluster):  # noqa: F811
    from ray_tpu_torch.job import JobStatus, JobSubmissionClient

    client = JobSubmissionClient()
    sid = client.submit_job(
        entrypoint=f"{sys.executable} -c \"import os;print(os.environ['MY_VAR']);raise SystemExit(3)\"",
        runtime_env={"env_vars": {"MY_VAR": "xyz123"}},
    )
    status = client.wait_until_finish(sid, timeout_s=60)
    assert status == JobStatus.FAILED
    info = client.get_job_info(sid)
    assert "exit code 3" in info.message
    assert "xyz123" in client.get_job_logs(sid)


def test_job_runs_cluster_workload(torch_cluster):  # noqa: F811
    """A submitted job connects back to the same cluster via RAY_TPU_ADDRESS."""
    from ray_tpu_torch.job import JobStatus, JobSubmissionClient

    script = (
        "import ray_tpu_torch; ray_tpu_torch.init(address='auto'); "
        "f = ray_tpu_torch.remote(lambda x: x * 3); "
        "print('job-result', ray_tpu_torch.get(f.remote(14))); ray_tpu_torch.shutdown()"
    )
    client = JobSubmissionClient()
    sid = client.submit_job(entrypoint=f"{sys.executable} -c \"{script}\"")
    status = client.wait_until_finish(sid, timeout_s=120)
    logs = client.get_job_logs(sid)
    assert status == JobStatus.SUCCEEDED, logs
    assert "job-result 42" in logs


def test_dashboard_endpoints(torch_cluster):  # noqa: F811
    import ray_tpu_torch
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch.dashboard.dashboard import Dashboard

    @ray_tpu_torch.remote
    def g():
        return 1

    ray_tpu_torch.get(g.remote())
    time.sleep(1.5)

    gcs_addr = worker_mod.global_worker.node.gcs_addr
    dash = Dashboard(gcs_addr, port=0)
    host, port = worker_mod.global_worker.run_async(dash.start())
    base = f"http://{host}:{port}"
    try:
        assert urllib.request.urlopen(f"{base}/-/healthz").read() == b"success"
        index = urllib.request.urlopen(base).read().decode()
        assert "ray_tpu_torch dashboard" in index
        nodes = json.loads(urllib.request.urlopen(f"{base}/api/nodes").read())
        assert len(nodes["nodes"]) == 1
        summary = json.loads(
            urllib.request.urlopen(f"{base}/api/tasks/summary").read()
        )
        assert summary["summary"].get("g", {}).get("FINISHED") == 1
        status = json.loads(
            urllib.request.urlopen(f"{base}/api/cluster_status").read()
        )
        assert "nodes" in status
        events = json.loads(
            urllib.request.urlopen(f"{base}/api/events?limit=50").read()
        )
        assert any(e["label"] == "NODE_ADDED" for e in events["events"])
        sev = json.loads(
            urllib.request.urlopen(
                f"{base}/api/events?severity=ERROR"
            ).read()
        )
        assert all(e["severity"] == "ERROR" for e in sev["events"])
        pgs = json.loads(
            urllib.request.urlopen(f"{base}/api/placement_groups").read()
        )
        assert "pgs" in pgs
    finally:
        worker_mod.global_worker.run_async(dash.stop())


def test_cli_parser():
    from ray_tpu_torch.scripts.cli import build_parser

    p = build_parser()
    args = p.parse_args(["job", "submit", "--wait", "echo", "hi"])
    assert args.job_cmd == "submit" and args.wait
    args = p.parse_args(["list", "actors", "--limit", "5"])
    assert args.kind == "actors" and args.limit == 5
    args = p.parse_args(["start", "--head", "--num-cpus", "4"])
    assert args.head and args.num_cpus == 4.0


def test_file_sd_output_matches_prometheus_schema(tmp_path):
    """The written JSON is exactly what a stock Prometheus file_sd_config
    consumes: a list of {targets: [str], labels: {str: str}} groups."""
    targets = ["127.0.0.1:8265", "10.0.0.2:8265"]
    w = PrometheusServiceDiscoveryWriter(
        lambda: list(targets), str(tmp_path), labels={"cluster": "test"}
    )
    path = w.write_once()
    groups = json.loads(open(path).read())
    assert isinstance(groups, list) and len(groups) == 1
    g = groups[0]
    assert set(g) == {"targets", "labels"}
    assert g["targets"] == sorted(targets)
    assert g["labels"]["job"] == "ray_tpu_torch"
    assert g["labels"]["cluster"] == "test"
    assert all(isinstance(t, str) for t in g["targets"])
    assert all(
        isinstance(k, str) and isinstance(v, str)
        for k, v in g["labels"].items()
    )
    # Background refresh picks up target changes.
    w.interval_s = 0.05
    w.start()
    targets.append("10.0.0.3:8265")
    deadline = time.time() + 5
    while time.time() < deadline:
        if "10.0.0.3:8265" in json.loads(open(path).read())[0]["targets"]:
            break
        time.sleep(0.05)
    w.stop()
    assert "10.0.0.3:8265" in json.loads(open(path).read())[0]["targets"]


def test_grafana_dashboard_generation(tmp_path):
    dash = generate_grafana_dashboard(extra_metrics=["my_app_qps"])
    assert dash["uid"] == "ray-tpu-core"
    assert dash["panels"], "dashboard must have panels"
    exprs = [p["targets"][0]["expr"] for p in dash["panels"]]
    assert "my_app_qps" in exprs
    for p in dash["panels"]:
        assert p["type"] == "timeseries"
        assert p["targets"][0]["refId"] == "A"
    out = write_grafana_dashboards(str(tmp_path), ["my_app_qps"])
    written = json.loads(open(out).read())
    assert written["title"] == "Ray TPU Core"


def test_structured_events_emitted_and_queryable(shutdown_only):
    """Node membership and actor failure produce events, queryable via the
    state API and durably appended to the session's event log file."""
    from ray_tpu_torch.util.state.api import list_cluster_events

    ray_tpu_torch.init(num_cpus=2)

    events = list_cluster_events()
    labels = [e["label"] for e in events]
    assert "NODE_ADDED" in labels

    @ray_tpu_torch.remote(max_restarts=0)
    class Doomed:
        def die(self):
            import os

            os._exit(1)

    a = Doomed.remote()
    with pytest.raises(Exception):
        ray_tpu_torch.get(a.die.remote())
    deadline = time.time() + 30
    while time.time() < deadline:
        dead = list_cluster_events(label="ACTOR_DEAD")
        if dead:
            break
        time.sleep(0.2)
    assert dead and dead[-1]["severity"] == "ERROR"
    assert "custom_fields" in dead[-1] and dead[-1]["custom_fields"]["actor_id"]

    # Severity filter works.
    assert all(
        e["severity"] == "ERROR" for e in list_cluster_events(severity="ERROR")
    )

    # Durable JSONL file parses back to the same events.
    from ray_tpu_torch._private.events import read_event_log
    from ray_tpu_torch._private.worker import global_worker

    session = global_worker.node.session_name
    on_disk = read_event_log(session, "GCS")
    assert any(e["label"] == "NODE_ADDED" for e in on_disk)


@pytest.fixture
def ray2(shutdown_only):
    ray_tpu_torch.init(num_cpus=2)
    yield


def _wait_for(pred, timeout=15):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.25)
    return False


def test_task_print_streams_to_driver(ray2, capfd):
    @ray_tpu_torch.remote
    def shouty():
        print("hello-from-task-xyzzy")
        return 1

    assert ray_tpu_torch.get(shouty.remote()) == 1

    def seen():
        return "hello-from-task-xyzzy" in capfd.readouterr().err

    # Lines ride the 0.2s pubsub batch flush.
    deadline = time.monotonic() + 10
    found = False
    while time.monotonic() < deadline and not found:
        time.sleep(0.3)
        out = capfd.readouterr()
        found = "hello-from-task-xyzzy" in out.err or "hello-from-task-xyzzy" in out.out
    assert found


def test_get_log_returns_worker_output(ray2):
    @ray_tpu_torch.remote
    class Chatty:
        def speak(self):
            print("actor-line-plugh")
            return "ok"

    c = Chatty.remote()
    assert ray_tpu_torch.get(c.speak.remote()) == "ok"

    def has_line():
        logs = list_logs()
        for node_id, files in logs.items():
            for fname in files:
                if fname.endswith(".out"):
                    lines = get_log(node_id=node_id, filename=fname)
                    if any("actor-line-plugh" in ln for ln in lines):
                        return True
        return False

    assert _wait_for(has_line)


def test_list_logs_has_worker_files(ray2):
    @ray_tpu_torch.remote
    def noop():
        return 1

    ray_tpu_torch.get(noop.remote())
    logs = list_logs()
    files = [f for fl in logs.values() for f in fl]
    assert any(f.startswith("worker-") for f in files)


# -- the CLI against the reference's, and two packages on one machine ----------


def _parser_shape(parser) -> dict:
    """{subcommand path: sorted option strings and positional names}."""
    import argparse

    shape = {}

    def walk(p, path):
        opts = []
        for action in p._actions:
            if isinstance(action, argparse._SubParsersAction):
                for name, sub in action.choices.items():
                    walk(sub, path + (name,))
            elif action.option_strings:
                opts += action.option_strings
            else:
                opts.append(action.dest)
        shape[" ".join(path)] = sorted(opts)

    walk(parser, ())
    return shape


def test_cli_parser_matches_reference():
    from ray_tpu.scripts.cli import build_parser as ref_parser
    from ray_tpu_torch.scripts.cli import build_parser

    ref = _parser_shape(ref_parser())
    port = _parser_shape(build_parser())
    assert "--num-tpus" in ref["start"] and "--num-gpus" in port["start"]
    ref["start"] = sorted("--num-gpus" if o == "--num-tpus" else o for o in ref["start"])
    assert port == ref
    args = build_parser().parse_args(["start", "--head", "--num-gpus", "2"])
    assert args.num_gpus == 2.0


def _cli(pkg: str, env: dict, *argv, timeout: float = 60) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", f"{pkg}.scripts.cli", *argv], env=env,
                          cwd=REPO, capture_output=True, text=True, timeout=timeout)


def _start_head(pkg: str, env: dict, log_dir, *argv):
    """A head through pkg's CLI, its ports ephemeral; returns the process
    and its state file's contents once the head has written it."""
    log = open(os.path.join(log_dir, f"{pkg}_head.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{pkg}.scripts.cli", "start", "--head", "--num-cpus", "1",
         "--dashboard-port", "0", "--client-server-port", "0", *argv],
        env=env, cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
    state_file = os.path.join(env["TMPDIR"], f"{pkg}_cluster.json")
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and proc.poll() is None:
        try:
            with open(state_file) as f:
                state = json.load(f)
            if state["pid"] == proc.pid:
                return proc, state
        except (OSError, ValueError, KeyError):
            pass
        time.sleep(0.1)
    proc.kill()
    with open(log.name) as f:
        raise AssertionError(f"{pkg} head did not start: {f.read()[-3000:]}")


# The job's driver: attaches with address="auto" and names its cluster's nodes.
ATTACH = ("import ray_tpu_torch as rt; rt.init(address='auto'); "
          "print('NODES', sorted(n['node_id'] for n in rt.nodes())); rt.shutdown()")


def _job_nodes(logs: str) -> list:
    line = [x for x in logs.splitlines() if x.startswith("NODES ")]
    assert line, logs[-3000:]
    return json.loads(line[-1][len("NODES "):].replace("'", '"'))


@pytest.mark.timeout(150)
def test_two_packages_heads_side_by_side(tmp_path, monkeypatch):
    """A ray_tpu head and a port head, each started by its own CLI on one
    machine (one TMPDIR), keep their own state files, and each CLI's status
    reads its own head (the port's shows GPU 1). A job the port's CLI submits
    attaches to the port's head. A job submitted to a third, in-process
    port cluster attaches to that cluster with address="auto", though the
    environment holds ray_tpu's address and the port's state file names the
    port's CLI head: the job manager hands it RAY_TPU_TORCH_ADDRESS."""
    from ray_tpu_torch.job import JobStatus, JobSubmissionClient

    tmp = tmp_path / "t"
    tmp.mkdir()
    env = {**os.environ, "TMPDIR": str(tmp)}
    env.pop("RAY_TPU_ADDRESS", None)
    env.pop("RAY_TPU_TORCH_ADDRESS", None)
    heads = {}
    try:
        heads["ray_tpu"] = _start_head("ray_tpu", env, tmp_path, "--num-tpus", "0")
        heads["ray_tpu_torch"] = _start_head("ray_tpu_torch", env, tmp_path, "--num-gpus", "1")
        ref_addr = heads["ray_tpu"][1]["address"]
        port_addr = heads["ray_tpu_torch"][1]["address"]
        assert ref_addr != port_addr

        status = _cli("ray_tpu_torch", env, "status")
        assert status.returncode == 0, status.stderr[-3000:]
        assert "GPU: 1 / 1 available" in status.stdout and "TPU" not in status.stdout
        ref_status = _cli("ray_tpu", env, "status")
        assert ref_status.returncode == 0, ref_status.stderr[-3000:]
        assert "GPU" not in ref_status.stdout

        listed = _cli("ray_tpu_torch", env, "list", "nodes")
        assert listed.returncode == 0, listed.stderr[-3000:]
        port_head_nodes = sorted(n["node_id"] for n in json.loads(listed.stdout))
        submitted = _cli("ray_tpu_torch", env, "job", "submit", "--wait", "--timeout", "90",
                         sys.executable, "-c", f'"{ATTACH}"', timeout=120)
        assert submitted.returncode == 0, (submitted.stdout[-3000:], submitted.stderr[-3000:])
        assert _job_nodes(submitted.stdout) == port_head_nodes

        monkeypatch.setenv("TMPDIR", str(tmp))
        monkeypatch.setenv("RAY_TPU_ADDRESS", ref_addr)  # a ray_tpu job's variable
        monkeypatch.delenv("RAY_TPU_TORCH_ADDRESS", raising=False)
        ray_tpu_torch.init(num_cpus=2)
        try:
            own_nodes = sorted(n["node_id"] for n in ray_tpu_torch.nodes())
            client = JobSubmissionClient()
            sid = client.submit_job(entrypoint=f'{sys.executable} -c "{ATTACH}"')
            job_status = client.wait_until_finish(sid, timeout_s=90)
            logs = client.get_job_logs(sid)
        finally:
            ray_tpu_torch.shutdown()
        assert job_status == JobStatus.SUCCEEDED, logs[-3000:]
        assert _job_nodes(logs) == own_nodes
        assert own_nodes != port_head_nodes

        for pkg in heads:
            stopped = _cli(pkg, env, "stop")
            assert stopped.returncode == 0 and "SIGTERM" in stopped.stdout, stopped
        for pkg, (proc, _) in heads.items():
            assert proc.wait(timeout=30) is not None, pkg
            assert not os.path.exists(tmp / f"{pkg}_cluster.json")
    finally:
        for proc, _ in heads.values():
            if proc.poll() is None:
                proc.send_signal(signal.SIGKILL)
                proc.wait(timeout=10)
