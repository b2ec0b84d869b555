"""The port's autoscaler, GPU node provider and cluster launcher
(ray_tpu_torch.autoscaler), on the CPU and without a cloud: the cases of
tests/test_gce_provider.py and tests/test_cluster_launcher.py over a fake
gcloud that models GCE's GPU-VM lifecycle, the autoscaler cases of
tests/test_accelerators.py as their GPU counterparts (command shapes, an
infeasible GPU demand that does not block feasible work, one GPU node per
demand) with its registry lookup on the GPU manager, and the CLI's up,
submit and down on the fake provider. The TPU-only cases of
tests/test_accelerators.py stay out: GCE metadata detection, the pod's
non-zero worker, the pod worker-count heuristics and the whole pod slice
(the one-GPU-node-per-demand case is the port's counterpart of the last);
so does tests/test_gce_provider.py's slice-gang case, whose GPU
counterpart is the scale-up and scale-down over the fake gcloud here."""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch._private.common import RESOURCE_UNIT
from ray_tpu_torch.autoscaler import Autoscaler, AutoscalerConfig, FakeNodeProvider
from ray_tpu_torch.autoscaler import launcher as launcher_mod
from ray_tpu_torch.autoscaler.launcher import (
    ClusterConfig,
    ClusterConfigError,
    ClusterLauncher,
    read_cluster_state,
)
from ray_tpu_torch.autoscaler.node_provider import (
    FAILED,
    PROVISIONING,
    READY,
    REQUESTED,
    TERMINATING,
    GCEGPUNodeProvider,
    NodeCreateError,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def shutdown_only():
    yield None
    ray_tpu_torch.shutdown()


@pytest.fixture
def state_dir(tmp_path, monkeypatch):
    """The launcher's state files go to a directory of the test's own."""
    d = tmp_path / "state"
    monkeypatch.setattr(launcher_mod, "_STATE_DIR", str(d))
    return d


class FakeGcloud:
    """Models `gcloud compute instances`: async creates take
    `provision_polls` describes (PROVISIONING, then STAGING) to reach
    RUNNING; deletes answer STOPPING once, then NOT_FOUND; creates can be
    told to fail N times (transient) or specific nodes can be made to
    vanish mid-provision."""

    def __init__(self, provision_polls: int = 2):
        self.provision_polls = provision_polls
        self.nodes = {}  # name -> {"status", "polls_left"}
        self.calls = []
        self.fail_next_creates = 0

    def __call__(self, cmd):
        self.calls.append(cmd)
        if cmd[2] == "ssh":  # gcloud compute ssh <name> ...
            return "started"
        verb = cmd[3]  # gcloud compute instances <verb> <name> ...
        name = cmd[4]
        if verb == "create":
            if self.fail_next_creates > 0:
                self.fail_next_creates -= 1
                raise subprocess.CalledProcessError(1, cmd, "quota exceeded")
            self.nodes[name] = {"status": "PROVISIONING", "polls_left": self.provision_polls}
            return ""
        if verb == "delete":
            if name in self.nodes:
                self.nodes[name] = {"status": "STOPPING", "polls_left": 1}
            return ""
        if verb == "describe":
            info = self.nodes.get(name)
            if info is None:
                raise subprocess.CalledProcessError(1, cmd, "ERROR: NOT_FOUND")
            if info["status"] == "STOPPING":
                info["polls_left"] -= 1
                if info["polls_left"] < 0:
                    del self.nodes[name]
                    raise subprocess.CalledProcessError(1, cmd, "ERROR: NOT_FOUND")
                return json.dumps({"name": name, "status": "STOPPING"})
            if info["status"] in ("PROVISIONING", "STAGING"):
                info["polls_left"] -= 1
                if info["polls_left"] <= 0:
                    info["status"] = "RUNNING"
                elif info["polls_left"] == 1:
                    info["status"] = "STAGING"
            return json.dumps({"name": name, "status": info["status"]})
        raise AssertionError(f"unexpected gcloud verb {verb}")

    def vanish(self, name):
        self.nodes.pop(name, None)


def _provider(gcloud, **node_types):
    return GCEGPUNodeProvider(
        project="proj",
        zone="us-central1-a",
        node_types=node_types or None,
        runner=gcloud,
    )


# -- tests/test_gce_provider.py on the GPU provider ---------------------------


def test_state_machine_provision_and_terminate():
    g = FakeGcloud(provision_polls=2)
    p = _provider(g)
    pid = p.create_node("worker")
    assert p.node_state(pid) == REQUESTED
    p.poll()
    assert p.node_state(pid) == PROVISIONING
    p.poll()
    assert p.node_state(pid) == READY
    assert p.ready_nodes() == [pid]
    p.terminate_node(pid)
    assert p.node_state(pid) == TERMINATING
    assert p.non_terminated_nodes() == []
    p.poll()  # STOPPING still answering
    p.poll()  # NOT_FOUND -> dropped
    assert p.node_state(pid) is None


def test_create_retries_transient_failures():
    g = FakeGcloud()
    g.fail_next_creates = 2
    p = _provider(g)
    pid = p.create_node("worker")  # third attempt succeeds
    assert p._nodes[pid]["create_attempts"] == 3
    create_calls = [c for c in g.calls if c[3] == "create"]
    assert len(create_calls) == 3
    # All retries reuse the SAME name (no duplicate half-created nodes).
    assert len({c[4] for c in create_calls}) == 1


def test_create_fails_after_exhausting_retries():
    g = FakeGcloud()
    g.fail_next_creates = 99
    p = _provider(g)
    with pytest.raises(NodeCreateError):
        p.create_node("worker")
    assert p.non_terminated_nodes() == []


def test_vanished_node_marked_failed_after_grace():
    g = FakeGcloud(provision_polls=10)
    p = _provider(g)
    pid = p.create_node("worker")
    p.poll()
    g.vanish(pid)
    # --async creates may lag visibility: a few describe misses are
    # tolerated before the node is declared lost.
    for _ in range(3):
        p.poll()
        assert p.node_state(pid) == PROVISIONING
    p.poll()
    assert p.node_state(pid) == FAILED
    assert p.failed_nodes() == [pid]
    assert pid not in p.non_terminated_nodes()
    # FAILED is terminal: no more gcloud describes are spent on it.
    before = len([c for c in g.calls if c[3] == "describe"])
    p.poll()
    after = len([c for c in g.calls if c[3] == "describe"])
    assert before == after


def test_create_adopts_already_exists():
    g = FakeGcloud()

    real = g.__call__

    def flaky(cmd):
        if cmd[3] == "create":
            real(cmd)  # server-side acceptance...
            raise subprocess.CalledProcessError(
                1, cmd, "ERROR: resource already exists"
            )  # ...but the client errors
        return real(cmd)

    p = GCEGPUNodeProvider(project="p", zone="z", runner=flaky, create_retries=3)
    pid = p.create_node("worker")
    assert p.node_state(pid) == REQUESTED  # adopted, not failed
    assert len([c for c in g.calls if c[3] == "create"]) == 1


def test_terminate_failure_keeps_tracker_for_retry():
    g = FakeGcloud(provision_polls=0)
    p = _provider(g)
    pid = p.create_node("worker")
    p.poll()
    real = g.__call__
    fail_delete = {"on": True}

    def flaky(cmd):
        if cmd[3] == "delete" and fail_delete["on"]:
            raise subprocess.CalledProcessError(1, cmd, "backend error")
        return real(cmd)

    p._runner = flaky
    assert p.terminate_node(pid) is False
    assert p.node_state(pid) == READY  # unchanged; still tracked
    fail_delete["on"] = False
    assert p.terminate_node(pid) is True
    assert p.node_state(pid) == TERMINATING
    # Idempotent retry while deleting is a cheap no-op success.
    assert p.terminate_node(pid) is True


def test_stopped_vm_fails_and_is_replaced():
    """GCE's TERMINATED (a stopped or preempted VM) is a lost node: the
    provider marks it FAILED and the autoscaler replaces it."""
    g = FakeGcloud(provision_polls=0)
    p = _provider(g, gpu={"resources": {"CPU": 8.0, "GPU": 1.0}, "max_workers": 2})
    scaler = Autoscaler(p, AutoscalerConfig(upscale_delay_s=0.0, idle_timeout_s=3600),
                        state_fn=lambda: [])
    scaler._launch("gpu")
    (pid,) = p.non_terminated_nodes()
    p.poll()
    assert p.node_state(pid) == READY
    g.nodes[pid]["status"] = "TERMINATED"
    p._nodes[pid]["state"] = PROVISIONING  # describe it again
    scaler.update()
    assert pid not in p.non_terminated_nodes()
    (new,) = p.non_terminated_nodes()
    assert list(scaler._tracked) == [new]


def test_autoscaler_scales_gpu_hosts_up_and_down(monkeypatch):
    """E2E against the fake gcloud: two pending GPU leases launch two GPU
    hosts, one per demand; a host lost mid-provision is replaced alone, both
    reach READY, and the idle timeout terminates each host."""
    g = FakeGcloud(provision_polls=1)
    p = _provider(
        g,
        gpu={"resources": {"CPU": 8.0, "GPU": 1.0}, "min_workers": 0, "max_workers": 4},
    )
    scaler = Autoscaler(p, AutoscalerConfig(upscale_delay_s=0.0, idle_timeout_s=0.05))

    demand = {"pending": 0, "demands": []}

    def fake_state(self):
        stats = [
            {
                "node_id": "head",
                "pending_leases": demand["pending"],
                "pending_demand": demand["demands"],
                "num_workers": 0,
                "num_idle": 0,
            }
        ]
        return demand["pending"], stats

    monkeypatch.setattr(Autoscaler, "_cluster_state", fake_state)

    demand["pending"] = 2
    demand["demands"] = [{"CPU": 1 * RESOURCE_UNIT, "GPU": 1 * RESOURCE_UNIT}] * 2
    # Demand must be sustained past the upscale delay: round 1 records it,
    # round 2 launches.
    launched_total = scaler.update()["launched"] + scaler.update()["launched"]
    assert launched_total == 2, "one GPU host per pending GPU lease"
    launched = p.non_terminated_nodes()
    assert len(launched) == 2
    assert all(len(t.provider_node_id) > 0 for t in scaler._tracked.values())

    # One host dies mid-provision; after the describe-miss grace period a
    # later round replaces it, the other host untouched.
    g.vanish(launched[0])
    demand["pending"] = 0
    demand["demands"] = []
    for _ in range(5):  # 4 misses to FAILED + 1 repair round
        scaler.update()
    tracked = sorted(t.provider_node_id for t in scaler._tracked.values())
    assert len(tracked) == 2
    assert launched[0] not in tracked
    assert launched[1] in tracked

    for _ in range(4):
        p.poll()
    assert len(p.ready_nodes()) == 2

    # Idle long enough -> each host terminates.
    time.sleep(0.1)
    out = scaler.update()
    assert out["terminated"] == 2
    for _ in range(4):
        p.poll()
    assert p.non_terminated_nodes() == []
    assert not g.nodes, "fake gcloud still holds nodes after scale-down"


# -- tests/test_accelerators.py's autoscaler cases, for GPUs ------------------


def test_gce_provider_command_shapes():
    """GCE GPU VMs: an a3 machine type carries its GPUs; a general-purpose
    type is given the accelerator flag (count from the type's GPU resource)
    and the TERMINATE maintenance policy GPU VMs need; describe is JSON;
    delete and ssh name the same scope."""
    commands = []
    provider = GCEGPUNodeProvider(
        project="proj-x",
        zone="us-central1-a",
        node_types={
            "h100": {"resources": {"CPU": 26.0, "GPU": 1.0}, "machine_type": "a3-highgpu-1g"},
            "l4x2": {"resources": {"CPU": 8.0, "GPU": 2.0}, "machine_type": "g2-standard-24",
                     "accelerator": {"type": "nvidia-l4"}},
            "cpu": {"resources": {"CPU": 4.0}, "machine_type": "n2-standard-4"},
        },
        runner=lambda cmd: commands.append(cmd) or "",
    )
    pids = [provider.create_node(t) for t in ("h100", "l4x2", "cpu")]
    assert provider.non_terminated_nodes() == pids
    for create in commands:
        assert create[:4] == ["gcloud", "compute", "instances", "create"]
        assert "--project=proj-x" in create and "--zone=us-central1-a" in create
        assert "--async" in create
    h100, l4x2, cpu = commands
    assert "--machine-type=a3-highgpu-1g" in h100
    assert not any(a.startswith("--accelerator") for a in h100)
    assert "--machine-type=g2-standard-24" in l4x2
    assert "--accelerator=type=nvidia-l4,count=2" in l4x2
    assert "--maintenance-policy=TERMINATE" in l4x2
    assert "--machine-type=n2-standard-4" in cpu
    assert not any(a.startswith(("--accelerator", "--maintenance")) for a in cpu)
    provider.poll()
    assert commands[3][:4] == ["gcloud", "compute", "instances", "describe"]
    assert "--format=json" in commands[3]
    provider.terminate_node(pids[0])
    assert commands[-1][:5] == ["gcloud", "compute", "instances", "delete", pids[0]]
    provider.run_on_node(pids[1], "nvidia-smi")
    assert commands[-1][:4] == ["gcloud", "compute", "ssh", pids[1]]
    assert commands[-1][-2:] == ["--command", "nvidia-smi"]
    assert provider.non_terminated_nodes() == pids[1:]


def test_manager_registry_lookup():
    """The registry resolves a resource to its manager: on the port "GPU"
    to GPUAcceleratorManager and "TPU" to none (ray_tpu's: "TPU" to its
    TPU manager and "GPU" to none)."""
    from ray_tpu_torch._private.accelerators import (
        GPUAcceleratorManager,
        get_accelerator_manager_for_resource,
    )

    assert get_accelerator_manager_for_resource("GPU") is GPUAcceleratorManager
    assert get_accelerator_manager_for_resource("TPU") is None


def test_infeasible_task_does_not_block_feasible(shutdown_only):
    """A cluster-wide-infeasible demand parks on the side queue; feasible
    tasks behind it still schedule (no FIFO head-of-line blocking). The
    demand is named as a custom resource, as the reference names its TPUs;
    the case after it asks through num_gpus."""
    ray_tpu_torch.init(num_cpus=2, num_gpus=0)

    @ray_tpu_torch.remote(num_cpus=0, resources={"GPU": 8})
    def needs_gpus():
        return 1

    @ray_tpu_torch.remote
    def plain():
        return 42

    stuck = needs_gpus.remote()  # queues forever (no GPU node ever joins)
    assert ray_tpu_torch.get(plain.remote(), timeout=60) == 42
    ready, pending = ray_tpu_torch.wait([stuck], num_returns=1, timeout=1)
    assert not ready and pending


def test_infeasible_gpu_task_does_not_block_feasible(shutdown_only):
    """A GPU demand no node can meet parks on the side queue; feasible
    tasks behind it still schedule (no FIFO head-of-line blocking)."""
    ray_tpu_torch.init(num_cpus=2, num_gpus=0)

    @ray_tpu_torch.remote(num_cpus=0, num_gpus=8)
    def needs_gpus():
        return 1

    @ray_tpu_torch.remote
    def plain():
        return 42

    stuck = needs_gpus.remote()  # queues forever (no GPU node ever joins)
    assert ray_tpu_torch.get(plain.remote(), timeout=60) == 42
    ready, pending = ray_tpu_torch.wait([stuck], num_returns=1, timeout=1)
    assert not ready and pending


def test_autoscaler_launches_one_gpu_node_per_demand(shutdown_only):
    """A GPU node type scales by hosts: one pending GPU task launches one
    node of the type (never a gang), the task runs on it, and idle
    scale-down removes it. A GPU count no type has launches nothing."""
    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(initialize_head=True, head_node_args={"num_cpus": 1, "num_gpus": 0})
    ray_tpu_torch.init(address=cluster.address)
    provider = FakeNodeProvider(
        cluster,
        node_types={
            "gpu": {"resources": {"CPU": 1.0, "GPU": 1.0}, "min_workers": 0, "max_workers": 2},
        },
    )
    scaler = Autoscaler(provider, AutoscalerConfig(upscale_delay_s=0.1, idle_timeout_s=2.0))

    @ray_tpu_torch.remote(num_cpus=0, num_gpus=1)
    def gpu_task():
        time.sleep(3)
        return os.environ.get("RAY_TPU_NODE_ID")

    @ray_tpu_torch.remote(num_cpus=0, num_gpus=2)
    def two_gpus():
        return 2

    never = two_gpus.remote()
    ref = gpu_task.remote()
    deadline = time.monotonic() + 20
    launched = 0
    while time.monotonic() < deadline and not launched:
        launched = scaler.update()["launched"]
        time.sleep(0.2)
    assert launched == 1, "one host for the GPU:1 demand, none for GPU:2"
    (pid,) = provider.non_terminated_nodes()
    assert ray_tpu_torch.get(ref, timeout=60) == provider.raylet_node_id(pid)
    ready, _ = ray_tpu_torch.wait([never], num_returns=1, timeout=0.1)
    assert not ready
    ray_tpu_torch.cancel(never)

    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and provider.non_terminated_nodes():
        scaler.update()
        time.sleep(0.5)
    assert not provider.non_terminated_nodes(), "the GPU node was not reclaimed"
    cluster.shutdown()


# -- tests/test_cluster_launcher.py on the port -------------------------------


FAKE_YAML = """
cluster_name: lctest
max_workers: 4
idle_timeout_minutes: 0.01
provider:
  type: fake
head_node_type: head
available_node_types:
  head:
    resources: {CPU: 2}
    min_workers: 0
    max_workers: 0
  worker:
    resources: {CPU: 2}
    min_workers: 2
    max_workers: 4
"""


def _write_yaml(tmp_path, text=FAKE_YAML):
    p = tmp_path / "cluster.yaml"
    p.write_text(text)
    return str(p)


def test_config_validation(tmp_path):
    cfg = ClusterConfig.from_yaml(_write_yaml(tmp_path))
    assert cfg.cluster_name == "lctest"
    assert set(cfg.worker_types()) == {"worker"}
    with pytest.raises(ClusterConfigError):
        ClusterConfig.from_dict({"cluster_name": "x"})
    with pytest.raises(ClusterConfigError):
        ClusterConfig.from_dict(
            {
                "cluster_name": "x",
                "provider": {"type": "nope"},
                "head_node_type": "h",
                "available_node_types": {"h": {"resources": {}}},
            }
        )
    with pytest.raises(ClusterConfigError):
        ClusterConfig.from_dict(
            {
                "cluster_name": "x",
                "provider": {"type": "fake"},
                "head_node_type": "missing",
                "available_node_types": {"h": {"resources": {}}},
            }
        )


@pytest.mark.timeout(120)
def test_up_job_scale_down(tmp_path, shutdown_only, state_dir):
    """A YAML boots head + min_workers in-process, runs a job through the
    job manager, the autoscaler can scale, and down() tears it all away.
    The head and the CPU workers advertise no GPU."""
    launcher = ClusterLauncher(ClusterConfig.from_yaml(_write_yaml(tmp_path)))
    addr = launcher.up()
    assert addr and ":" in addr
    assert len(launcher._worker_pids) == 2  # min_workers honored
    assert read_cluster_state("lctest")["head_address"] == addr
    assert os.path.dirname(launcher_mod._state_path("lctest")) == str(state_dir)

    # The cluster is usable: run a job end-to-end via the job manager.
    marker = tmp_path / "job_ran.txt"
    entry = f"{sys.executable} -c \"open(r'{marker}', 'w').write('done')\""
    sid, info = launcher.submit(entry, wait=True, timeout=120.0)
    assert info.status == "SUCCEEDED", info
    assert marker.read_text() == "done"
    assert ray_tpu_torch.cluster_resources().get("GPU", 0.0) == 0.0

    # Autoscaler round runs against the provider (no demand -> idle nodes
    # past the tiny idle timeout get reclaimed down to min_workers=2,
    # i.e. nothing is terminated below the floor).
    result = launcher.update()
    assert set(result) == {"launched", "terminated"}
    assert len(launcher.provider.non_terminated_nodes()) >= 2

    launcher.down()
    assert launcher.provider.non_terminated_nodes() == []
    assert read_cluster_state("lctest") is None


def test_gce_bootstrap_over_fake_gcloud(tmp_path, state_dir):
    """GCE path: the head VM is created, polled to RUNNING, and
    bootstrapped over ssh with the port's CLI; GPU workers reach READY
    before up() returns."""
    gce_yaml = """
cluster_name: lcgce
provider:
  type: gce
  project: proj
  zone: us-central1-a
  poll_interval_s: 0.0
head_node_type: head
available_node_types:
  head:
    resources: {CPU: 8}
    machine_type: n2-standard-8
    min_workers: 0
    max_workers: 0
  worker:
    resources: {CPU: 26, GPU: 1}
    machine_type: a3-highgpu-1g
    min_workers: 1
    max_workers: 2
"""
    g = FakeGcloud(provision_polls=1)
    p = tmp_path / "gce.yaml"
    p.write_text(gce_yaml)
    launcher = ClusterLauncher(ClusterConfig.from_yaml(str(p)), runner=g)
    addr = launcher.up()
    assert addr.endswith(":6379")
    ssh_calls = [c for c in g.calls if c[2] == "ssh"]
    assert len(ssh_calls) == 1
    assert "ray-tpu-torch start --head" in " ".join(ssh_calls[0])
    creates = {c[4]: c for c in g.calls if c[2] == "instances" and c[3] == "create"}
    assert sorted("--machine-type=a3-highgpu-1g" in c for c in creates.values()) == [False, True]
    # head + 1 min worker exist and are READY
    states = [
        launcher.provider.node_state(pid)
        for pid in launcher.provider.non_terminated_nodes()
    ]
    assert len(states) == 2 and all(s == "READY" for s in states)
    launcher.down()
    deletes = [c for c in g.calls if c[2] == "instances" and c[3] == "delete"]
    assert len(deletes) == 2  # head + worker


# -- the CLI ------------------------------------------------------------------


def _cli(*argv, env, timeout=120):
    return subprocess.run([sys.executable, "-m", "ray_tpu_torch.scripts.cli", *argv],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)


@pytest.mark.timeout(180)
def test_cli_up_submit_down_on_the_fake_provider(tmp_path):
    """`up --monitor` boots the fake cluster and keeps its autoscaler
    running; `submit` runs a job on it from another process (found through
    the state file under ~/.ray_tpu_torch); `down` removes the state file,
    and the monitor ends on SIGINT with no process of its cluster left."""
    home = tmp_path / "home"
    home.mkdir()
    env = {**os.environ, "HOME": str(home), "PYTHONUNBUFFERED": "1"}
    cfg = _write_yaml(tmp_path)
    log = tmp_path / "up.log"
    with open(log, "w") as f:
        up = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.scripts.cli", "up", "--monitor", cfg],
            cwd=REPO, env=env, stdout=f, stderr=subprocess.STDOUT, start_new_session=True)
    try:
        deadline = time.monotonic() + 60
        while "head address:" not in log.read_text():
            assert up.poll() is None, log.read_text()[-3000:]
            assert time.monotonic() < deadline, log.read_text()[-3000:]
            time.sleep(0.2)
        addr = log.read_text().split("head address:")[1].split()[0]
        state = json.loads((home / ".ray_tpu_torch" / "cluster-lctest.json").read_text())
        assert state["head_address"] == addr and len(state["worker_pids"]) == 2

        # The entrypoint's words are joined with spaces, as ray_tpu's are:
        # a script path keeps it free of quoting.
        marker = tmp_path / "job_ran.txt"
        script = tmp_path / "job.py"
        script.write_text(f"open(r'{marker}', 'w').write('done')\n")
        sub = _cli("submit", cfg, "--", sys.executable, str(script), env=env)
        assert sub.returncode == 0, sub.stderr[-3000:]
        assert "SUCCEEDED" in sub.stdout, sub.stdout
        assert marker.read_text() == "done"

        down = _cli("down", cfg, env=env)
        assert down.returncode == 0, down.stderr[-3000:]
        assert "cluster lctest down" in down.stdout
        assert not (home / ".ray_tpu_torch" / "cluster-lctest.json").exists()
        os.killpg(up.pid, signal.SIGINT)
        assert up.wait(timeout=60) == 0, log.read_text()[-3000:]
    finally:
        if up.poll() is None:
            os.killpg(up.pid, signal.SIGKILL)
            up.wait(timeout=30)
    # The cluster's workers see their raylet go and exit.
    deadline = time.monotonic() + 30
    while True:
        left = subprocess.run(["pgrep", "-s", str(up.pid)], capture_output=True, text=True)
        if not left.stdout.strip() or time.monotonic() > deadline:
            break
        time.sleep(0.5)
    assert left.stdout.strip() == "", left.stdout


@pytest.mark.timeout(120)
def test_job_supervisor_ends_with_its_job_and_frees_its_node(shutdown_only):
    """A job's supervisor actor is DEAD within a few seconds of SUCCEEDED,
    stop_job on the finished job returns False as for an unknown one, and the
    fake-provider node that hosted the supervisor is terminated after its idle
    timeout (a supervisor left ALIVE kept its node busy for good)."""
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.job import JobStatus, JobSubmissionClient
    from ray_tpu_torch.util.state import list_actors

    # The head has no CPU: a task's demand brings up a worker node, and the
    # supervisor (0.1 CPU) can only land there.
    cluster = Cluster(initialize_head=True, head_node_args={"num_cpus": 0, "num_gpus": 0})
    ray_tpu_torch.init(address=cluster.address)
    provider = FakeNodeProvider(
        cluster,
        node_types={"cpu": {"resources": {"CPU": 1.0}, "min_workers": 0, "max_workers": 1}},
    )
    scaler = Autoscaler(provider, AutoscalerConfig(upscale_delay_s=0.0, idle_timeout_s=2.0))

    @ray_tpu_torch.remote(num_cpus=1)
    def where():
        return os.environ.get("RAY_TPU_NODE_ID")

    try:
        ref = where.remote()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not provider.non_terminated_nodes():
            scaler.update()
            time.sleep(0.2)
        (pid,) = provider.non_terminated_nodes()
        assert ray_tpu_torch.get(ref, timeout=60) == provider.raylet_node_id(pid)
        client = JobSubmissionClient()
        sid = client.submit_job(entrypoint=f"{sys.executable} -c \"print('job done')\"")
        assert client.wait_until_finish(sid, timeout_s=60) == JobStatus.SUCCEEDED
        assert "job done" in client.get_job_logs(sid)

        def supervisor_state():
            rows = [a for a in list_actors() if a.get("name") == f"_job_supervisor:{sid}"]
            assert len(rows) == 1, rows
            return rows[0]["state"]

        ended = time.monotonic()
        while time.monotonic() < ended + 10 and supervisor_state() != "DEAD":
            time.sleep(0.1)
        assert supervisor_state() == "DEAD"
        assert client.stop_job(sid) is False
        assert client.stop_job("no-such-job") is False
        with pytest.raises(ValueError):
            ray_tpu_torch.get_actor(f"_job_supervisor:{sid}", namespace="_job")

        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and provider.non_terminated_nodes():
            scaler.update()
            time.sleep(0.5)
        assert provider.non_terminated_nodes() == [], f"node {pid} was kept busy"
    finally:
        cluster.shutdown()
