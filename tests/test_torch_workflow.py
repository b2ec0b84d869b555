"""Workflows, metrics and the queue on the port (ray_tpu_torch.workflow,
util.metrics, util.queue), on the CPU: the workflow cases of
tests/test_dag_workflow.py (run and resume, a failure and a partial
resume, continuations, retries and caught failures, a parallel fan-out),
its test_metrics_render and test_core_extras.py's test_queue, run on the
port's runtime; then the same workflow through both packages, each in a
process of its own (equal outputs, equal step records), both packages'
render_prometheus on one snapshot (equal text after the rename), a step's
num_gpus reaching its task's lease, and torch tensors checkpointed by a
step and resumed bitwise, as CPU tensors on disk. Last,
tests/test_dag_workflow.py's two runtime-env cases (env_vars, working_dir)
and its autoscaler case (a fake provider scales up under queued leases and
back down when idle), case for case after the rename."""

import json
import os
import pickle
import subprocess
import sys
import time

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.testing import torch_cluster, torch_shutdown_only  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- the cases of tests/test_dag_workflow.py -----------------------------------


def test_workflow_run_and_resume(torch_cluster, tmp_path):  # noqa: F811
    from ray_tpu_torch import workflow

    calls_file = tmp_path / "calls.txt"

    @ray_tpu_torch.remote
    def add(a, b):
        with open(calls_file, "a") as f:
            f.write("x")
        return a + b

    node = add.bind(add.bind(1, 2), add.bind(3, 4))
    out = workflow.run(node, workflow_id="wf-test", storage=str(tmp_path))
    assert out == 10
    assert len(calls_file.read_text()) == 3
    assert workflow.get_output("wf-test", storage=str(tmp_path)) == 10
    meta = workflow.get_metadata("wf-test", storage=str(tmp_path))
    assert meta["status"] == "SUCCESSFUL"

    # Resume: everything checkpointed -> no re-execution.
    assert workflow.resume("wf-test", storage=str(tmp_path)) == 10
    assert len(calls_file.read_text()) == 3
    assert ("wf-test", "SUCCESSFUL") in workflow.list_all(str(tmp_path))


def test_workflow_failure_and_partial_resume(torch_cluster, tmp_path):  # noqa: F811
    from ray_tpu_torch import workflow

    flag = tmp_path / "fail_once"
    flag.write_text("1")
    count_file = tmp_path / "count"
    count_file.write_text("")

    @ray_tpu_torch.remote
    def step_a():
        with open(count_file, "a") as f:
            f.write("a")
        return 5

    @ray_tpu_torch.remote
    def step_b(x, fail_path):
        if os.path.exists(fail_path):
            os.unlink(fail_path)
            raise RuntimeError("transient")
        return x * 2

    node = step_b.bind(step_a.bind(), str(flag))
    with pytest.raises(Exception):
        workflow.run(node, workflow_id="wf-fail", storage=str(tmp_path))
    assert workflow.get_metadata("wf-fail", storage=str(tmp_path))["status"] == "FAILED"
    # Resume skips step_a (checkpointed) and completes.
    assert workflow.resume("wf-fail", storage=str(tmp_path)) == 10
    assert count_file.read_text() == "a"


def test_workflow_continuation_recursion(torch_cluster, tmp_path):  # noqa: F811
    from ray_tpu_torch import workflow

    @ray_tpu_torch.remote
    def fact(n, acc=1):
        if n <= 1:
            return acc
        return workflow.continuation(fact.bind(n - 1, acc * n))

    out = workflow.run(fact.bind(5), workflow_id="wf-cont", storage=str(tmp_path))
    assert out == 120
    steps = workflow.get_step_metadata("wf-cont", storage=str(tmp_path))
    fact_steps = [s for s in steps if "fact" in s]
    assert len(fact_steps) == 5
    chain = [s for s in fact_steps if "." in s]
    assert len(chain) == 4
    assert all(steps[s]["status"] == "SUCCESSFUL" for s in fact_steps)


def test_workflow_step_retries_and_catch(torch_cluster, tmp_path):  # noqa: F811
    from ray_tpu_torch import workflow

    marker = tmp_path / "flaky_attempts"

    @ray_tpu_torch.remote
    def flaky():
        n = int(marker.read_text()) if marker.exists() else 0
        marker.write_text(str(n + 1))
        if n < 2:
            raise ValueError(f"attempt {n} fails")
        return "ok"

    node = flaky.bind().options(max_retries=3)
    assert workflow.run(node, workflow_id="wf-retry", storage=str(tmp_path)) == "ok"
    steps = workflow.get_step_metadata("wf-retry", storage=str(tmp_path))
    (sid,) = [s for s in steps if "flaky" in s]
    assert steps[sid]["attempts"] == 3
    assert steps[sid]["status"] == "SUCCESSFUL"

    @ray_tpu_torch.remote
    def always_fails():
        raise RuntimeError("nope")

    result, err = workflow.run(always_fails.bind().options(catch_exceptions=True),
                               workflow_id="wf-catch", storage=str(tmp_path))
    assert result is None
    assert isinstance(err, Exception)


def test_workflow_parallel_fanout(torch_cluster, tmp_path):  # noqa: F811
    """Independent branches execute concurrently, and the join sees both
    checkpointed values."""
    from ray_tpu_torch import workflow

    @ray_tpu_torch.remote
    def slow(x):
        import time as _t

        _t.sleep(0.5)
        return x

    @ray_tpu_torch.remote
    def join(a, b):
        return a + b

    # Warm two workers so spawn cost is outside the timed window.
    ray_tpu_torch.get([slow.remote(0), slow.remote(0)])
    t0 = time.time()
    out = workflow.run(join.bind(slow.bind(1), slow.bind(2)), workflow_id="wf-par",
                       storage=str(tmp_path))
    dt = time.time() - t0
    assert out == 3
    # Serial would be >=1.0s of sleeps; the executor overlaps them.
    assert dt < 0.95, f"branches did not run concurrently ({dt:.2f}s)"


# -- metrics and the queue -----------------------------------------------------


def _record_metrics(M):
    c = M.Counter("test_requests", "reqs", tag_keys=("route",))
    c.inc(2, tags={"route": "/a"})
    c.inc(1, tags={"route": "/b"})
    g = M.Gauge("test_temp", "", tag_keys=())
    g.set(42.5)
    h = M.Histogram("test_lat", "", boundaries=[1, 10], tag_keys=())
    h.observe(0.5)
    h.observe(5)
    h.observe(50)
    return M._collect_local()


def test_metrics_render():
    from ray_tpu_torch.util import metrics as M

    text = M.render_prometheus({"w1": _record_metrics(M)})
    assert 'test_requests{route="/a"} 2.0' in text
    assert "test_temp 42.5" in text
    assert 'test_lat_bucket{le="1"} 1' in text
    assert 'test_lat_bucket{le="+Inf"} 3' in text
    assert "test_lat_count 3" in text


# Records _record_metrics' three metrics through {pkg}'s registry in a fresh
# process and prints the snapshot and its render for two workers. The
# registry is module-global: in the test's own process it holds whatever
# earlier tests registered (tests/test_telemetry.py registers a counter in
# ray_tpu's alone), so each package's snapshot is taken where only this
# test has recorded.
METRICS_SCRIPT = r'''
import json, sys
sys.path.insert(0, {repo!r})
sys.path.insert(0, {tests!r})
from test_torch_workflow import _record_metrics
from {pkg}.util import metrics as M

snap = _record_metrics(M)
print("RESULT " + json.dumps({{"snap": snap,
                              "text": M.render_prometheus({{"w1": snap, "w2": snap}})}}))
'''


def _metrics_in_fresh_process(pkg: str) -> dict:
    code = METRICS_SCRIPT.format(repo=REPO, tests=os.path.dirname(os.path.abspath(__file__)),
                                 pkg=pkg)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=60, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-4000:]
    line = [x for x in out.stdout.splitlines() if x.startswith("RESULT ")]
    assert line, (out.stdout[-2000:], out.stderr[-2000:])
    return json.loads(line[-1][len("RESULT "):])


def _assert_metrics_parity():
    ref = _metrics_in_fresh_process("ray_tpu")
    port = _metrics_in_fresh_process("ray_tpu_torch")
    assert json.dumps(ref["snap"], sort_keys=True) == json.dumps(port["snap"], sort_keys=True)
    assert port["text"] == ref["text"].replace("ray_tpu", "ray_tpu_torch")
    assert 'test_requests{route="/a"} 4.0' in port["text"]  # two workers' 2.0


@pytest.mark.timeout(120)
def test_render_prometheus_matches_reference():
    """Both packages' render_prometheus give the same text for one snapshot
    (after the rename), and the same metrics recorded through each package
    give the same snapshot; each package records in a process of its own."""
    _assert_metrics_parity()


@pytest.mark.timeout(120)
def test_render_prometheus_parity_ignores_metrics_registered_here():
    """A metric registered in ray_tpu's registry in this process (as an
    earlier test on the same xdist worker may do) does not reach either
    package's snapshot: the parity holds all the same."""
    from ray_tpu.util import metrics as ref

    ref.Counter("t11_only_in_this_process", "", tag_keys=()).inc(1)
    assert "t11_only_in_this_process" in ref._collect_local()
    _assert_metrics_parity()


def test_queue(torch_cluster):  # noqa: F811
    from ray_tpu_torch.util.queue import Empty, Full, Queue

    q = Queue(maxsize=2)
    q.put("a")
    q.put("b")
    with pytest.raises(Full):
        q.put("c", block=False)
    assert q.qsize() == 2 and q.full()
    assert q.get() == "a"
    assert q.get() == "b"
    with pytest.raises(Empty):
        q.get(block=False)

    @ray_tpu_torch.remote
    def producer(queue):
        for i in range(3):
            queue.put(i)
        return True

    # Drain while the producer runs: the third put blocks until the driver
    # frees a slot, so waiting on the task before draining would deadlock.
    ref = producer.remote(q)
    assert [q.get(timeout=10) for _ in range(3)] == [0, 1, 2]
    assert ray_tpu_torch.get(ref)
    q.shutdown()


# -- the port against the JAX package ------------------------------------------

# One workflow (a fan-out and join, a continuation chain, a step that fails
# twice and is retried, a caught failure, then a failure that stops the run
# and a resume) on {pkg}; prints its outputs and its step records without
# their times.
WORKFLOW_SCRIPT = r'''
import json, os, sys
sys.path.insert(0, {repo!r})
import {pkg} as rt
from {pkg} import workflow

store, marks = sys.argv[1], sys.argv[2]
rt.init(num_cpus=2)

@rt.remote
def leaf(x):
    return {{"x": x, "sq": x * x}}

@rt.remote
def join(a, b, scale=1):
    return (a["sq"] + b["sq"]) * scale

@rt.remote
def fact(n, acc=1):
    if n <= 1:
        return acc
    return workflow.continuation(fact.bind(n - 1, acc * n))

@rt.remote
def flaky(total, tag):
    path = os.path.join(marks, tag)
    n = int(open(path).read()) if os.path.exists(path) else 0
    open(path, "w").write(str(n + 1))
    if n < 2:
        raise ValueError("attempt %d fails" % n)
    return [total, n]

@rt.remote
def fails():
    raise RuntimeError("nope")

@rt.remote
def stop_once(v):
    path = os.path.join(marks, "stop")
    if not os.path.exists(path):
        open(path, "w").write("1")
        raise RuntimeError("stopped once")
    return {{"final": v}}

outputs = {{}}
graph = flaky.bind(join.bind(leaf.bind(2), leaf.bind(3), scale=fact.bind(4)), "a").options(
    max_retries=2)
outputs["main"] = workflow.run(graph, workflow_id="wf-main", storage=store)
res, err = workflow.run(fails.bind().options(catch_exceptions=True), workflow_id="wf-catch",
                        storage=store)
outputs["catch"] = [res, type(err).__name__]
node = stop_once.bind(join.bind(leaf.bind(1), leaf.bind(5)))
try:
    workflow.run(node, workflow_id="wf-resume", storage=store)
    outputs["first_run"] = "finished"
except Exception as e:
    outputs["first_run"] = "raised"
outputs["resumed"] = workflow.resume("wf-resume", storage=store)
steps = {{}}
for wid in ("wf-main", "wf-catch", "wf-resume"):
    steps[wid] = {{sid: {{k: m.get(k) for k in ("name", "status", "attempts")}}
                 for sid, m in workflow.get_step_metadata(wid, storage=store).items()}}
meta = {{wid: workflow.get_metadata(wid, storage=store)["status"]
        for wid in ("wf-main", "wf-catch", "wf-resume")}}
rt.shutdown()
print("RESULT " + json.dumps({{"outputs": outputs, "steps": steps, "meta": meta,
                              "listed": workflow.list_all(store)}}))
'''


def _run_workflow(pkg: str, tmp_path) -> dict:
    store, marks = tmp_path / f"{pkg}_store", tmp_path / f"{pkg}_marks"
    marks.mkdir()
    code = WORKFLOW_SCRIPT.format(repo=REPO, pkg=pkg)
    out = subprocess.run([sys.executable, "-c", code, str(store), str(marks)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-4000:]
    line = [x for x in out.stdout.splitlines() if x.startswith("RESULT ")]
    assert line, (out.stdout[-2000:], out.stderr[-2000:])
    return json.loads(line[-1][len("RESULT "):])


@pytest.mark.timeout(150)
def test_workflow_matches_reference(tmp_path):
    """The same workflow on both packages: equal outputs, step ids and step
    records (name, status, attempts), and equal workflow statuses."""
    ref = _run_workflow("ray_tpu", tmp_path)
    port = _run_workflow("ray_tpu_torch", tmp_path)
    assert port == ref
    assert port["outputs"]["main"] == [(4 + 9) * 24, 2]
    assert port["outputs"]["first_run"] == "raised"
    assert port["outputs"]["resumed"] == {"final": 26}
    assert port["meta"] == {"wf-main": "SUCCESSFUL", "wf-catch": "SUCCESSFUL",
                            "wf-resume": "SUCCESSFUL"}


def test_storage_defaults_to_the_ports_own_directory():
    """The two packages never resume each other's workflows: the port's
    default store is its own."""
    from ray_tpu.workflow import api as ref_api
    from ray_tpu_torch.workflow import api

    assert api.DEFAULT_STORAGE == os.path.expanduser("~/ray_tpu_torch_workflows")
    assert api.DEFAULT_STORAGE != ref_api.DEFAULT_STORAGE


@pytest.mark.timeout(90)
def test_step_options_reach_the_lease_and_tensors_resume_bitwise(tmp_path):
    """A step's fn.options(num_gpus=1).bind(...) asks its task's lease for a
    GPU (the state API shows it); steps that return torch tensors (bf16 and
    f32) checkpoint them as CPU tensors, and a workflow stopped by a failing
    step resumes to the uninterrupted run's output, bitwise, without
    re-running its first step."""
    from ray_tpu_torch import workflow
    from ray_tpu_torch.util import state

    counter, flag = tmp_path / "init_runs", tmp_path / "fail_once"

    @ray_tpu_torch.remote
    def init(seed):
        with open(counter, "a") as f:
            f.write("x")
        g = torch.Generator().manual_seed(seed)
        return {"w": torch.randn(64, 32, generator=g).to(torch.bfloat16),
                "b": torch.randn(32, generator=g)}

    @ray_tpu_torch.remote
    def train(params, steps, fail_path):
        if fail_path and os.path.exists(fail_path):
            os.unlink(fail_path)
            raise RuntimeError("transient")
        w, b = params["w"].float(), params["b"]
        for _ in range(steps):
            w = w - 0.1 * torch.tanh(w + b)
        return {"w": w.to(torch.bfloat16), "b": b * 0.5}

    @ray_tpu_torch.remote
    def evaluate(params):
        return (params["w"].float() @ params["b"]).sum().reshape(1), params["w"]

    def graph(fail_path):
        gpu = {"num_gpus": 1}
        p = init.options(**gpu).bind(3)
        p = train.options(**gpu).bind(p, 3, fail_path)
        return evaluate.options(**gpu).bind(p)

    flag.write_text("1")
    storage = str(tmp_path / "store")
    ray_tpu_torch.init(num_cpus=2, num_gpus=1)
    try:
        with pytest.raises(Exception, match="transient"):
            workflow.run(graph(str(flag)), workflow_id="wf-gpu", storage=storage)
        resumed = workflow.resume("wf-gpu", storage=storage)
        whole = workflow.run(graph(None), workflow_id="wf-whole", storage=storage)
        time.sleep(1.5)  # task-event flush interval
        leases = {t["name"]: t["resources"] for t in state.list_tasks()}
    finally:
        ray_tpu_torch.shutdown()
    assert counter.read_text() == "xx"  # once for wf-gpu, once for wf-whole
    for got, want in zip(resumed, whole):
        assert got.dtype == want.dtype and torch.equal(got, want)
    steps = sorted(os.listdir(os.path.join(storage, "wf-gpu", "steps")))
    init_pkl = [s for s in steps if "_init_" in s and s.endswith(".pkl")]
    with open(os.path.join(storage, "wf-gpu", "steps", init_pkl[0]), "rb") as f:
        saved = pickle.load(f)
    assert all(t.device.type == "cpu" for t in saved.values())
    assert saved["w"].dtype == torch.bfloat16
    assert {name: leases[name].get("GPU") for name in ("init", "train", "evaluate")} == \
        {"init": 1.0, "train": 1.0, "evaluate": 1.0}


# -- tests/test_dag_workflow.py's runtime-env and autoscaler cases, case for case --


def test_runtime_env_env_vars(torch_cluster):
    import ray_tpu_torch

    @ray_tpu_torch.remote
    class EnvReader:
        def read(self, key):
            return os.environ.get(key)

    a = EnvReader.options(
        runtime_env={"env_vars": {"MY_RT_ENV": "hello42"}}
    ).remote()
    assert ray_tpu_torch.get(a.read.remote("MY_RT_ENV")) == "hello42"


def test_runtime_env_working_dir(torch_cluster, tmp_path):
    import ray_tpu_torch

    pkg = tmp_path / "mypkg"
    pkg.mkdir()
    (pkg / "my_rt_module.py").write_text("VALUE = 1234\n")

    @ray_tpu_torch.remote
    class Importer:
        def go(self):
            import my_rt_module

            return my_rt_module.VALUE

    a = Importer.options(runtime_env={"working_dir": str(pkg)}).remote()
    assert ray_tpu_torch.get(a.go.remote()) == 1234


def test_autoscaler_up_down(torch_shutdown_only):
    import ray_tpu_torch
    from ray_tpu_torch.autoscaler import Autoscaler, AutoscalerConfig, FakeNodeProvider
    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(initialize_head=True, head_node_args={"num_cpus": 1})
    ray_tpu_torch.init(address=cluster.address)

    provider = FakeNodeProvider(
        cluster,
        node_types={
            "worker": {"resources": {"CPU": 2.0}, "min_workers": 0, "max_workers": 2}
        },
    )
    scaler = Autoscaler(
        provider,
        AutoscalerConfig(upscale_delay_s=0.2, idle_timeout_s=2.0),
    )

    # Saturate the 1-CPU head so leases queue up.
    @ray_tpu_torch.remote
    def slow():
        time.sleep(4)
        return 1

    refs = [slow.options(num_cpus=1).remote() for _ in range(4)]
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline and not provider.non_terminated_nodes():
        scaler.update()
        time.sleep(0.3)
    assert provider.non_terminated_nodes(), "autoscaler never launched a node"

    assert ray_tpu_torch.get(refs, timeout=60) == [1] * 4

    # After the work drains, idle nodes are reclaimed.
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and provider.non_terminated_nodes():
        scaler.update()
        time.sleep(0.5)
    assert not provider.non_terminated_nodes(), "idle node was not terminated"
    cluster.shutdown()
