"""The port's runtime copy (ray_tpu_torch's core, placement groups, train,
data, dag, collective, the jax-free rllib modules, Serve, loadgen and
Tune) against ray_tpu's: the same core drive through both packages, no jax
and no ray_tpu module in the port's processes, GPUs as a cluster resource,
and a drift test that holds each copied module to its ray_tpu
counterpart's text after the rename."""

import json
import os
import re
import subprocess
import sys
import tempfile

import pytest

import ray_tpu_torch
from ray_tpu_torch._private import accelerators, rpc
from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch._private.node import Node
from ray_tpu_torch.testing import torch_cluster  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "optax", "ray_tpu")

# The core drive of the verify skill (a task, an 8 MB put, an actor), plus
# what each process of the run has imported. {pkg} is the package's name.
DRIVE = """
import json, sys
sys.path.insert(0, {repo!r})
import numpy as np
import {pkg} as rt
import {pkg}.dag, {pkg}.util.collective  # jax-free in both packages

def bad():
    import sys
    return sorted(m for m in sys.modules if m.split(".")[0] in {forbidden!r})

rt.init(num_cpus=4)

@rt.remote
def sq(x):
    return x * x

@rt.remote
def worker_modules():
    return bad()

@rt.remote
class C:
    def __init__(self):
        self.n = 0

    def inc(self):
        self.n += 1
        return self.n

    def modules(self):
        import {pkg}.dag, {pkg}.util.collective
        return bad()

big = rt.put(np.arange(1_000_000, dtype=np.float64))  # 8 MB: the shm path
c = C.remote()
out = {{
    "sq": rt.get(sq.remote(3)),
    "big": [list(rt.get(big).shape), float(rt.get(big).sum())],
    "inc": [rt.get(c.inc.remote()), rt.get(c.inc.remote())],
    "task_modules": rt.get(worker_modules.remote()),
    "actor_modules": rt.get(c.modules.remote()),
    "driver_modules": bad(),
}}
rt.shutdown()
print("RESULT " + json.dumps(out))
"""


def _drive(pkg: str, cwd) -> dict:
    code = DRIVE.format(repo=REPO, pkg=pkg, forbidden=FORBIDDEN)
    out = subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-4000:]
    line = [x for x in out.stdout.splitlines() if x.startswith("RESULT ")]
    assert line, (out.stdout[-2000:], out.stderr[-2000:])
    return json.loads(line[-1][len("RESULT "):])


@pytest.mark.timeout(150)
@pytest.mark.parametrize("pkg", ["ray_tpu", "ray_tpu_torch"])
def test_core_drive_same_results_through_both_packages(pkg, tmp_path):
    """(a) and (b): run from a cwd outside the repo, so workers find the
    package through the PYTHONPATH their raylet gives them. The port's
    driver and workers hold no jax and no ray_tpu module; its workers fork
    from the zygote, so the zygote held none either."""
    got = _drive(pkg, tmp_path)
    assert got["sq"] == 9
    assert got["big"] == [[1_000_000], float(sum(range(1_000_000)))]
    assert got["inc"] == [1, 2]
    jax_family = [m for key in ("driver_modules", "task_modules", "actor_modules")
                  for m in got[key] if m.split(".")[0] != "ray_tpu"]
    assert jax_family == []
    if pkg == "ray_tpu_torch":
        assert got["driver_modules"] == got["task_modules"] == got["actor_modules"] == []


@pytest.mark.timeout(90)
def test_init_num_gpus_maps_to_gpu_resource():
    """(c) init(num_gpus=2) advertises GPU: 2, and a task asking for a GPU
    is placed."""
    ray_tpu_torch.init(num_cpus=2, num_gpus=2)
    try:
        assert ray_tpu_torch.cluster_resources()["GPU"] == 2.0

        @ray_tpu_torch.remote(num_gpus=1)
        def on_gpu_slot(x):
            return x + 1

        assert ray_tpu_torch.get(on_gpu_slot.remote(1), timeout=60) == 2
        spill_dir = worker_mod.global_worker.node.raylet.spill_dir
        assert spill_dir.startswith(os.path.join(tempfile.gettempdir(), "ray_tpu_torch_spill"))
    finally:
        ray_tpu_torch.shutdown()


def test_gpu_detection_order(monkeypatch):
    """(c) CUDA_VISIBLE_DEVICES first (empty hides every card, CUDA stops at
    the first invalid entry), then torch.cuda.device_count(), then the
    /dev/nvidia<N> files when torch is missing."""
    import glob

    import torch

    detect = accelerators.GPUAcceleratorManager.detect_count
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 5)
    for visible, want in (("0,1,2", 3), ("3", 1), ("", 0), ("0,-1,2", 1)):
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
        assert detect() == want, visible
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    assert detect() == 5
    monkeypatch.setitem(sys.modules, "torch", None)  # import torch raises
    monkeypatch.setattr(glob, "glob", lambda pattern: [
        "/dev/nvidia0", "/dev/nvidia1", "/dev/nvidiactl", "/dev/nvidia-uvm"])
    assert detect() == 2
    assert accelerators.get_accelerator_manager_for_resource("GPU") is \
        accelerators.GPUAcceleratorManager
    assert accelerators.get_accelerator_manager_for_resource("TPU") is None


def test_node_advertises_detected_gpus(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1")
    assert Node(num_cpus=1)._resources == {"CPU": 1.0, "GPU": 2.0}
    assert Node(num_cpus=1, num_gpus=1)._resources == {"CPU": 1.0, "GPU": 1.0}
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert Node(num_cpus=1)._resources == {"CPU": 1.0}


def test_port_keeps_its_own_names_on_disk(monkeypatch, tmp_path):
    """A port driver never attaches to, spawns into or reads the files of a
    ray_tpu cluster: its state file, sockets, session, spill and runtime-env
    directories and its address variable are its own, and its directories
    lie under the temp dir (TMPDIR), as ray_tpu's sessions do."""
    import ray_tpu._private.worker as jax_worker
    from ray_tpu_torch.runtime_env import context

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    assert os.path.basename(worker_mod.cluster_state_file()) == "ray_tpu_torch_cluster.json"
    assert worker_mod.cluster_state_file() != jax_worker.cluster_state_file()
    assert os.path.basename(rpc._uds_path(1234)) == "ray_tpu_torch_uds_1234.sock"
    assert "ray_tpu_torch_" in Node(num_cpus=1, num_gpus=0).gcs_persist_path()
    assert context.EXTRACT_ROOT == os.path.join(tempfile.gettempdir(),
                                                "ray_tpu_torch_runtime_env")
    with open(jax_worker.cluster_state_file(), "w") as f:
        json.dump({"address": "127.0.0.1:1"}, f)  # a ray_tpu cluster's file
    monkeypatch.setenv("RAY_TPU_ADDRESS", "127.0.0.1:1")
    with pytest.raises(ray_tpu_torch.RayTpuError, match="no running cluster"):
        ray_tpu_torch.init(address="auto")


@pytest.mark.timeout(60)
def test_collective_and_dag_load_without_jax():
    """ray_tpu_torch.util.collective, ray_tpu_torch.dag and the parallel
    package's group entry points load with no jax and no ray_tpu module."""
    code = ("import sys; import ray_tpu_torch.util.collective, ray_tpu_torch.dag; "
            "from ray_tpu_torch.parallel import ring_attention_on_group, "
            "ulysses_attention_on_group; "
            f"print(sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.timeout(60)
def test_rllib_loads_without_jax_or_gymnasium():
    """import ray_tpu_torch.rllib loads no jax, optax or ray_tpu module, and
    not gymnasium either: only a runner of a named env imports it."""
    code = ("import sys; import ray_tpu_torch.rllib; "
            f"print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN + ('gymnasium',)!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.timeout(60)
def test_yardsticks_and_scale_out_load_without_jax():
    """ray_perf, sim_cluster, the autoscaler and the native extensions load
    with no jax and no ray_tpu module."""
    code = ("import sys; import ray_tpu_torch._private.ray_perf, "
            "ray_tpu_torch._private.sim_cluster, ray_tpu_torch.autoscaler, "
            "ray_tpu_torch.autoscaler.launcher, ray_tpu_torch._native.native_ab; "
            "from ray_tpu_torch._native import _fastpath, _shm, _store; "
            f"print(sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


# The modules of the cluster surface: the CLI, jobs, the state API, metrics
# and their export, the dashboard, client mode, workflows, the queue and
# cluster_utils.
CLUSTER_SURFACE = (
    "scripts.cli", "job", "job.job_manager", "util.state", "util.state.api", "util.metrics",
    "util.metrics_export", "dashboard.dashboard", "util.client", "util.client.server",
    "util.client.common", "workflow", "workflow.api", "util.queue", "cluster_utils")


def test_unported_branches_raise_not_implemented():
    """No stub that names a ROADMAP item is left: the CLI's up, down and
    submit run the cluster launcher (A17b), as workflows (fn.bind) and
    client mode (ray-tpu://) run theirs; each command reads its cluster
    YAML, so a missing one is the error, not a missing port."""
    from ray_tpu_torch.scripts.cli import build_parser

    parser = build_parser()
    missing = os.path.join(tempfile.mkdtemp(), "missing.yaml")
    for argv in (["up", missing], ["down", missing], ["submit", missing, "echo", "hi"]):
        args = parser.parse_args(argv)
        with pytest.raises(FileNotFoundError, match="missing.yaml"):
            args.fn(args)
    stubs = []
    for root, _, files in os.walk(os.path.join(REPO, "ray_tpu_torch")):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as f:
                    text = f.read()
                stubs += [(name, m) for m in re.findall(r"item (A\d+\w*)", text)]
    assert stubs == [], stubs


@pytest.mark.timeout(60)
def test_chaos_and_devtools_load_without_jax_and_devtools_without_torch():
    """ray_tpu_torch.chaos (every module) loads with no jax and no ray_tpu
    module; ray_tpu_torch.devtools (every pass and the explorer) loads without
    torch as well, so the lint gate runs on a host without PyTorch."""
    chaos = ", ".join(f"ray_tpu_torch.chaos.{m}" for m in (
        "schedule", "interceptors", "invariants", "nemesis", "runner", "scenarios_explore"))
    devtools = ", ".join(f"ray_tpu_torch.devtools.{m}" for m in (
        "aio_lint", "rpc_check", "rpc_flow", "exc_flow", "lifecycle", "protocols",
        "telemetry_lint", "lint", "explore"))
    for mods, forbidden in ((chaos, FORBIDDEN), (devtools, FORBIDDEN + ("torch",))):
        code = (f"import sys; import {mods}; "
                f"print(sorted(m for m in sys.modules if m.split('.')[0] in {forbidden!r}))")
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                             text=True, timeout=60)
        assert out.returncode == 0, out.stderr[-2000:]
        assert out.stdout.strip().splitlines()[-1] == "[]", mods


@pytest.mark.timeout(60)
def test_cluster_surface_loads_without_jax_or_torch():
    """Every module of the cluster surface loads with no jax, no ray_tpu and
    no torch module at all (so no CUDA state): the CLI, the job manager and
    the client server start on a machine without a card or nvcc."""
    mods = ", ".join(f"ray_tpu_torch.{m}" for m in CLUSTER_SURFACE)
    code = (f"import sys; import {mods}; "
            f"print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN + ('torch',)!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


# -- drift -------------------------------------------------------------------

# The rename that turns a ray_tpu module into its copy. It also gives the
# port its own names on disk (ray_tpu_torch_cluster.json,
# ray_tpu_torch_uds_<port>.sock, ray_tpu_torch_<session>/,
# ray_tpu_torch_spill/, ray_tpu_torch_runtime_env/) and makes its raylet spawn
# `-m ray_tpu_torch._private.worker_main` and the port's zygote, with the
# port's checkout on the workers' PYTHONPATH.
RENAME = ("ray_tpu", "ray_tpu_torch")
# Some comments and docstrings of ray_tpu name the change behind them by its
# number; the copies describe the change alone.
CHANGE_NUMBER = re.compile(r" \(?PR \d+\)?|(?<=[\"\n])PR \d+ ")

COPIED = [
    "__init__.py", "actor.py", "remote_function.py",
    "_native/__init__.py",
    *(f"_private/{m}.py" for m in (
        "__init__", "common", "ids", "rpc", "wire", "serialization", "shm",
        "store_core", "object_store", "pull_manager", "push_manager", "pubsub",
        "external_storage", "telemetry", "aiocheck", "events", "gcs",
        "gcs_store", "gcs_ha", "node", "raylet", "core_worker", "worker",
        "worker_main", "worker_zygote", "accelerators")),
    "air/__init__.py", "air/config.py",
    *(f"dag/{m}.py" for m in (
        "__init__", "channel", "compiled", "exec_loop", "nodes", "tensor_channel")),
    *(f"util/collective/{m}.py" for m in ("__init__", "collective", "mesh_ops")),
    *(f"util/{m}.py" for m in (
        "__init__", "actor_pool", "placement_group", "scheduling_strategies", "tracing")),
    "runtime_env/__init__.py", "runtime_env/context.py", "runtime_env/container.py",
    *(f"train/{m}.py" for m in (
        "__init__", "_backend_executor", "_checkpoint", "_session",
        "_worker_group", "base_trainer")),
    *(f"data/{m}.py" for m in (
        "__init__", "_execution", "block", "dataset", "datasource", "iterator",
        "tensor_extension")),
    *(f"rllib/{m}.py" for m in (
        "__init__", "core/__init__", "env/__init__", "algorithms/__init__", "utils/__init__",
        "env/env_runner_group", "env/multi_agent_env", "utils/actor_manager",
        "utils/replay_buffer", "utils/offline", "algorithms/algorithm_config",
        "algorithms/algorithm")),
    *(f"serve/{m}.py" for m in (
        "__init__", "schema", "handle", "api", "_private/__init__", "_private/common",
        "_private/long_poll", "_private/router", "_private/replica", "_private/controller",
        "_private/proxy", "protobuf/__init__", "protobuf/serve_pb2")),
    "loadgen/__init__.py", "loadgen/__main__.py",
    *(f"tune/{m}.py" for m in (
        "__init__", "trainable", "search", "suggest", "schedulers", "tuner",
        "tune_controller")),
    *(f"util/{m}.py" for m in (
        "queue", "metrics", "metrics_export", "state/__init__", "state/api",
        "client/common", "client/__init__", "client/server")),
    "job/__init__.py", "job/job_manager.py",
    "dashboard/__init__.py", "dashboard/dashboard.py",
    "cluster_utils.py",
    "workflow/__init__.py", "workflow/api.py",
    "scripts/__init__.py", "scripts/cli.py",
    "_private/sim_cluster.py", "_private/ray_perf.py",
    *(f"autoscaler/{m}.py" for m in ("__init__", "autoscaler", "node_provider", "launcher")),
    # The native extensions' sources, copied from src/ (see _renamed).
    *(f"_native/csrc/{m}.cc" for m in ("fastpath", "shm_buffer", "store_core")),
    *(f"chaos/{m}.py" for m in (
        "__init__", "__main__", "schedule", "interceptors", "invariants", "nemesis", "runner",
        "scenarios_explore")),
    *(f"devtools/{m}.py" for m in (
        "__init__", "aio_lint", "rpc_check", "rpc_flow", "exc_flow", "lifecycle", "protocols",
        "telemetry_lint", "lint", "explore")),
]

# The modules of the copy that differ from ray_tpu's after the rename, and
# why. Editing this list is how a later slice lets them drift on purpose.
DIFFERS = {
    "_private/sim_cluster.py": "an HA sim arms its standby once every node has registered "
                               "(ray_tpu arms it before the boot, where a stall of the shared "
                               "loop past the lease promotes it and fails a raylet's first "
                               "registration)",
    "__init__.py": "the runtime API merged beside `models` and `ops`, which load lazily",
    "remote_function.py": "num_gpus maps to 'GPU' (num_tpus to 'TPU' in ray_tpu)",
    "_private/serialization.py": "a torch-tensor reducer (CUDA tensors come back as CPU "
                                 "tensors, out of band) in place of the jax-array one; "
                                 "deserialize(on_release=...) hands zero-copy buffers over as "
                                 "_RegionBuffer exporters and reports when the last is collected",
    "_private/core_worker.py": "a zero-copy value's store hold follows the value's out-of-band "
                               "buffers (deserialize's on_release): ray_tpu drops it with the "
                               "ObjectRef, so an array held in a tuple or dict, or taken out of "
                               "a value, is overwritten once the ref is gone; a task's PENDING "
                               "event carries its lease's resources for the state API; the "
                               "native fast path gets its args as bytes (ray_tpu passes the "
                               "bytearray of args with out-of-band buffers, which the C "
                               "submit refuses with a TypeError); a closed worker starts no "
                               "lineage reconstruction on a node's removal (a stopping "
                               "cluster's removals set off tasks that failed, attempt after "
                               "attempt); a streaming generator that fails keeps the "
                               "generator it published (ray_tpu overwrites it with the error, "
                               "so a get after the failure raises and the produced items are "
                               "lost to it); a push to an actor's address that another "
                               "process now serves (no PushActorTask handler: the worker "
                               "died and its port was taken before the GCS heard) fails as "
                               "ActorUnavailableError, which callers retry (ray_tpu stores "
                               "the bare RpcError as the task's result)",
    "_private/rpc.py": "a connection accepted while its server stops is closed once its "
                       "transport exists (ray_tpu leaves it open when stop() tears it down "
                       "before connection_made, or when the accept finishes after stop(): "
                       "its peer then waits forever on replies that never come)",
    "_private/gcs_store.py": "ReplicatedStoreClient.flush returns once every reachable member "
                             "holds the tick, and the event loop's group commit (flush(False)) "
                             "still acks on the quorum (ray_tpu's flush acks on the quorum too, so a "
                             "standby tailing follower0 misses what was flushed, the "
                             "leadership lease included, whenever follower1 acked first); "
                             "crash lands the ships already on a lane before the buffered "
                             "tick (ray_tpu cancels them, so a follower behind the quorum "
                             "loses acknowledged commits); ReplicaTailer.poll checks for a rewrite "
                             "and reads through one open file (ray_tpu opens the path again "
                             "to read, so a compaction renamed in between hands it the new "
                             "file at the old file's offset)",
    "_private/object_store.py": "release_many keeps the holds that follow values "
                                "(hold_for_value, release_value_holds)",
    "_private/node.py": "num_gpus, and the registry's GPU detection when no GPU count is given",
    "_private/worker.py": "init(num_gpus=...); address='auto' reads RAY_TPU_TORCH_ADDRESS; "
                          "the driver's farewell and close are close_driver, which "
                          "Cluster.shutdown calls first, and which does nothing for a "
                          "driver already closed",
    "_private/raylet.py": "the spill directory lies under the temp dir (TMPDIR), not a fixed "
                          "/tmp, so two checkouts with their own TMPDIR never share it",
    "_private/accelerators.py": "GPUAcceleratorManager registered; no TPU manager and no "
                                "instance-metadata probe",
    "air/config.py": "ScalingConfig(use_gpu=True, gpus_per_worker) replaces use_tpu and topology",
    "runtime_env/context.py": "EXTRACT_ROOT lies under the temp dir (TMPDIR), not a fixed "
                              "/tmp: it is keyed by the package's hash, so two checkouts "
                              "sharing it would read each other's extractions",
    "train/__init__.py": "no JaxConfig",
    "train/_backend_executor.py": "no JaxConfig/_JaxBackend: train/torch's TorchConfig sets up "
                                  "the gang's process group and its collective group "
                                  "(collective_backend)",
    "train/_session.py": "the collective-group docstring names TorchConfig's option",
    "train/_worker_group.py": "node_info returns the node address for the rendezvous; poll "
                              "returns as soon as the loop has finished with nothing queued "
                              "(ray_tpu waits out the whole poll timeout, ~10 s a fit)",
    "util/collective/collective.py": "nccl and gloo backends on torch.distributed (GCS-KV "
                                     "rendezvous, a death watch over async work handles) in "
                                     "place of the xla backend; ops take torch tensors too",
    "util/collective/mesh_ops.py": "MeshCollectives runs each op on the group's process group "
                                   "in place of compiled shard_map programs over a jax mesh",
    "data/iterator.py": "the _finalize_fn docstring names the torch host->device copy, "
                        "not jax.device_put; blocks are fetched in order on one thread "
                        "(ray_tpu fetches `lookahead` at once: with holds that follow "
                        "values, later blocks fetched first held the arena room the "
                        "next block needed, and its create timed out)",
    "rllib/__init__.py": "the docstring describes torch modules and learners on the card",
    "rllib/algorithms/algorithm_config.py": "num_gpus_per_learner replaces num_tpus_per_learner; "
                                            "learners(device=...) sets learner_device "
                                            "(None means cuda)",
    "rllib/algorithms/algorithm.py": "every learner group gets num_gpus_per_learner and the "
                                     "learners' device; a learner builder is a function of "
                                     "the device",
    "serve/_private/controller.py": "ray_actor_options['num_gpus'] leases 'GPU' (num_tpus "
                                    "leases 'TPU' in ray_tpu)",
    "serve/protobuf/serve_pb2.py": "the descriptor's package is ray_tpu_torch.serve and its file "
                                   "ray_tpu_torch/serve/protobuf/serve.proto (protoc's output), "
                                   "so both packages' messages load in one process; the rename "
                                   "alone breaks the descriptor's length prefixes",
    "loadgen/__init__.py": "run_smoke starts its cluster with num_gpus=0 (num_tpus=0 in ray_tpu)",
    "tune/tune_controller.py": "a trial's 'GPU' resource goes to its actor's num_gpus ('TPU' to "
                               "num_tpus in ray_tpu); its TrainWorker is the port's",
    "dag/channel.py": "read takes a sealed header shorter than any frame (length 0: a fresh "
                      "segment) for a write not yet visible and polls on, and validates "
                      "both header fields; create no longer stores a header into the "
                      "segment (ray_tpu parsed an empty frame once, in a compiled DAG's "
                      "shm edge)",
    "dag/tensor_channel.py": "torch tensors on the shm wire (the torch dtype's name in the header, "
                             "bf16 included) in place of jax arrays; DeviceTensorChannel moves "
                             "CUDA tensors by CUDA IPC, the group's send/recv or a device copy "
                             "(loopback) in place of a compiled ppermute; make_cuda_hop in "
                             "place of make_ici_transfer; MIN_FRAME is the array header's size",
    "util/state/api.py": "list_tasks rows carry the lease's resources (a GPU task shows "
                         "'GPU'), from the PENDING event the core worker records",
    "job/job_manager.py": "the job's entrypoint gets RAY_TPU_TORCH_ADDRESS, which the port's "
                          "init(address='auto') reads (ray_tpu sets RAY_TPU_ADDRESS, which the "
                          "port never reads); the supervisor actor ends itself once the job's "
                          "status and logs are in the KV, and stop_job on an ended job returns "
                          "False (ray_tpu's supervisor stays ALIVE and keeps its node busy for "
                          "the autoscaler)",
    "cluster_utils.py": "add_node(num_gpus=...) leases 'GPU' (num_tpus leases 'TPU' in "
                        "ray_tpu); without a count the node advertises the GPUs it detects; "
                        "shutdown closes its driver before it stops the daemons (ray_tpu "
                        "stops them first, and the driver's farewell then redials the "
                        "stopped GCS for 5 s, a task-event flush for 30 s)",
    "chaos/runner.py": "the session's head is built with num_gpus=0 (num_tpus=0 in ray_tpu)",
    "devtools/lint.py": "the gate prints every pass's wall time, as its docstring says "
                        "(ray_tpu prints the three slowest)",
    "scripts/cli.py": "start --num-gpus (--num-tpus in ray_tpu); the address variable is "
                      "RAY_TPU_TORCH_ADDRESS",
    "_private/ray_perf.py": "the collective child runs MeshCollectives on 8 gloo processes "
                           "(a jax psum over a forced 8-device CPU mesh in ray_tpu); the DAG "
                           "edge carries a torch tensor; init(num_gpus=0); on a card, "
                           "main(device='cuda') adds the NCCL group's and the CUDA IPC "
                           "edge's keys",
    "_native/__init__.py": "builds the extensions from _native/csrc/ at first import and "
                           "loads them under their module names (ray_tpu's is empty: "
                           "setup.py build_ext builds its extensions in place)",
    "autoscaler/__init__.py": "exports GCEGPUNodeProvider in place of GCETPUNodeProvider",
    "autoscaler/autoscaler.py": "every scaling unit is one host: a GPU count is per host like "
                                "any resource, so there is no TPU-{pod}-head gang branch in "
                                "_covers, no pod-slice gang in _launch, and a FAILED node is "
                                "replaced alone",
    "autoscaler/node_provider.py": "FakeNodeProvider passes the type's GPU count to add_node "
                                   "(0 for a CPU type: no count would advertise the host's "
                                   "cards); GCEGPUNodeProvider creates GCE GPU VMs (gcloud "
                                   "compute instances, JSON describe, GCE's instance states) "
                                   "in place of TPU VMs",
    "autoscaler/launcher.py": "the head's GPU count (num_tpus in ray_tpu), the gce provider "
                              "is GCEGPUNodeProvider, the head starts ray-tpu-torch, the "
                              "state directory is ~/.ray_tpu_torch, and update() attaches a "
                              "driver to the head when none is connected (ray_tpu's `up "
                              "--monitor` raised 'not initialized' on its first round)",
}


def _renamed(rel: str) -> str:
    ref = rel.replace("_native/csrc/", os.path.join("..", "src") + os.sep)
    with open(os.path.join(REPO, "ray_tpu", ref)) as f:
        return CHANGE_NUMBER.sub("", f.read().replace(*RENAME))


def _port(rel: str) -> str:
    with open(os.path.join(REPO, "ray_tpu_torch", rel)) as f:
        return f.read()


@pytest.mark.parametrize("rel", COPIED)
def test_copy_matches_ray_tpu_after_rename(rel):
    if rel in DIFFERS:
        assert _port(rel) != _renamed(rel), f"{rel} no longer differs: drop it from DIFFERS"
    else:
        assert _port(rel) == _renamed(rel), f"{rel} drifted from ray_tpu/{rel}"


def test_drift_list_names_only_copied_modules():
    assert set(DIFFERS) <= set(COPIED)
    assert all(reason for reason in DIFFERS.values())


@pytest.mark.timeout(120)
def test_zero_copy_values_outlive_their_refs(monkeypatch):
    """A value read zero-copy from the object store stays intact while
    anything built on its buffers lives, though its ObjectRef is gone and
    later objects reuse the arena (ray_tpu ties the store hold to the ref,
    so an array held in a tuple, a dict or a view taken out of a value is
    overwritten); once those are collected the holds go back."""
    import gc
    import time

    import numpy as np

    from ray_tpu_torch._private import worker as worker_mod

    monkeypatch.setenv("RAY_TPU_OBJECT_STORE_EVICTION_GRACE_S", "0.2")  # reuse comes soon
    ray_tpu_torch.init(num_cpus=2)
    try:
        @ray_tpu_torch.remote
        class Maker:
            def make(self, i, kind):
                arr = np.full(50_304, float(i), np.float32)  # 201 KB: the shm store
                return {"tuple": (arr, i), "dict": {"x": arr}, "array": arr}[kind]

        maker = Maker.remote()
        held = {"tuple": [], "dict": [], "view": []}
        for i in range(8):
            held["tuple"].append(ray_tpu_torch.get(maker.make.remote(i, "tuple"))[0])
            held["dict"].append(ray_tpu_torch.get(maker.make.remote(i, "dict"))["x"])
            held["view"].append(ray_tpu_torch.get(maker.make.remote(i, "array"))[100:200])
        time.sleep(0.5)
        for j in range(200):
            ray_tpu_torch.get(maker.make.remote(1000 + j, ("tuple", "dict", "array")[j % 3]))
        changed = {kind: [i for i, a in enumerate(arrs) if not (a == float(i)).all()]
                   for kind, arrs in held.items()}
        assert changed == {"tuple": [], "dict": [], "view": []}, changed

        plasma = worker_mod._core().plasma
        assert sum(plasma.value_held.values()) >= 24
        del held
        gc.collect()
        deadline = time.monotonic() + 10
        while plasma.value_held and time.monotonic() < deadline:
            ray_tpu_torch.get(maker.make.remote(0, "array"))  # wakes the release flush
            gc.collect()
        assert sum(plasma.value_held.values()) <= 1, plasma.value_held
    finally:
        ray_tpu_torch.shutdown()


def test_actor_push_to_an_address_another_process_serves_is_unavailable():
    """An actor's worker died and another process's server took its port
    before the GCS heard: the GCS still names the old address, and a push
    there is answered with "no handler for method 'PushActorTask'". The
    submitter fails the task as ActorUnavailableError (which callers and
    retries treat as a lost actor) and drops the connection, so the next
    submit resolves the actor again; it never stores the bare RpcError."""
    import asyncio

    from ray_tpu_torch._private.common import ActorUnavailableError
    from ray_tpu_torch._private.core_worker import ActorSubmitter

    async def run():
        other = rpc.Server()  # another process's server, on the dead worker's port
        addr = await other.start()
        resolved = []

        class Gcs:
            async def call(self, method, payload):
                resolved.append(method)
                return {"actor": {"state": "ALIVE", "num_restarts": 0, "addr": list(addr)}}

        class Core:
            gcs = Gcs()

            async def connect_to(self, at):
                return await rpc.connect(*at)

        sub = ActorSubmitter(Core(), "a" * 32)
        try:
            for _ in range(2):
                with pytest.raises(ActorUnavailableError, match="served by another process"):
                    await sub.submit({"name": "pid", "actor_id": "a" * 32})
                assert sub.conn is None
        finally:
            await other.stop()
        assert resolved == ["GetActor", "GetActor"]  # each submit resolved anew

    asyncio.run(run())


def test_a_connection_accepted_while_its_server_stops_is_closed():
    """A server stopping while the loop accepts a connection: the accept has
    made the connection's protocol but not yet its transport when stop()
    tears the server's connections down, or makes the protocol after that.
    Either way the connection's socket is closed once its transport exists,
    so its peer sees the loss and redials; left open, it waits forever on
    replies a stopped server never sends (a raylet re-registering with a
    demoted GCS leader held its reconnect lock so, and never joined the new
    leader)."""
    import asyncio

    class Transport:
        closed = False

        def close(self):
            self.closed = True

    async def run():
        server = rpc.Server()
        await server.start()
        mid_accept = server._make_protocol()  # the accept's first step, before stop()
        await server.stop()
        after_stop = server._make_protocol()  # an accept the loop finishes after stop()
        for proto in (mid_accept, after_stop):
            transport = Transport()
            proto.connection_made(transport)
            assert transport.closed
        assert not server.connections
        await server.start()  # a restarted server serves again
        kept = server._make_protocol()
        transport = Transport()
        kept.connection_made(transport)
        assert not transport.closed and len(server.connections) == 1
        await server.stop()

    asyncio.run(run())
