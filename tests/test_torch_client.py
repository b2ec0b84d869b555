"""Client mode on the port (ray_tpu_torch.util.client), on the CPU: the
cases of tests/test_client.py (put/get, tasks, errors, wait, actors through
the proxy, and a subprocess driver on init("ray-tpu://...")) on the port's
runtime; then torch tensors through the proxy (a task's tensor reaches the
client as the CPU tensor the reducer makes, bitwise, bf16 too), and a client
process that imports no jax, no ray_tpu and makes no CUDA state while its
GPU task runs in the cluster."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch.util.client import ClientContext
from ray_tpu_torch.util.client.server import ClientServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def client_setup():
    """Cluster + proxy in this process; a ClientContext on its own loop."""
    info = ray_tpu_torch.init(num_cpus=4)
    w = worker_mod.global_worker
    gcs_addr = w.node.gcs_addr

    async def _start():
        srv = ClientServer(gcs_addr, host="127.0.0.1")
        await srv.start()
        return srv

    srv = w.run_async(_start(), timeout=30)
    ctx = ClientContext("127.0.0.1", srv.addr[1])
    yield ctx, srv
    ctx.disconnect()

    async def _stop():
        await srv.stop()

    w.run_async(_stop(), timeout=30)
    ray_tpu_torch.shutdown()


def test_client_put_get_roundtrip(client_setup):
    ctx, _ = client_setup
    ref = ctx.put({"a": 1, "b": [1, 2, 3]})
    assert ctx.get(ref) == {"a": 1, "b": [1, 2, 3]}
    big = np.arange(1 << 20, dtype=np.float32)  # 4 MB -> plasma path
    bref = ctx.put(big)
    out = ctx.get(bref)
    assert out.shape == big.shape and out[-1] == big[-1]


def test_client_task_submission(client_setup):
    ctx, _ = client_setup

    @ray_tpu_torch.remote
    def add(a, b):
        return a + b

    refs = ctx.submit_remote_function(add, (2, 3), {})
    assert ctx.get(refs[0]) == 5
    # Ref args: a client ref passed as a task arg resolves cluster-side.
    xref = ctx.put(10)
    refs2 = ctx.submit_remote_function(add, (xref, 5), {})
    assert ctx.get(refs2[0]) == 15


def test_client_task_error_propagates(client_setup):
    ctx, _ = client_setup

    @ray_tpu_torch.remote(max_retries=0)
    def boom():
        raise ValueError("kaboom")

    refs = ctx.submit_remote_function(boom, (), {})
    with pytest.raises(Exception, match="kaboom"):
        ctx.get(refs[0], timeout=60)


def test_client_wait(client_setup):
    ctx, _ = client_setup

    @ray_tpu_torch.remote
    def fast():
        return 1

    @ray_tpu_torch.remote
    def slow():
        import time

        time.sleep(30)
        return 2

    r1 = ctx.submit_remote_function(fast, (), {})[0]
    r2 = ctx.submit_remote_function(slow, (), {})[0]
    ready, not_ready = ctx.wait([r1, r2], num_returns=1, timeout=30)
    assert [r.hex() for r in ready] == [r1.hex()]
    assert [r.hex() for r in not_ready] == [r2.hex()]


def test_client_actor_lifecycle(client_setup):
    ctx, _ = client_setup

    @ray_tpu_torch.remote
    class Counter:
        def __init__(self, start):
            self.n = start

        def inc(self, k=1):
            self.n += k
            return self.n

    handle = ctx.create_actor(Counter, (100,), {})
    r1 = ctx.call_actor_method(handle._actor_id, "inc", (), {})[0]
    assert ctx.get(r1, timeout=60) == 101
    r2 = ctx.call_actor_method(handle._actor_id, "inc", (5,), {})[0]
    assert ctx.get(r2, timeout=60) == 106
    ctx.kill(handle._actor_id)


def test_client_mode_via_public_api():
    """Full path: a subprocess driver uses ray_tpu_torch.init("ray-tpu://...") and
    the plain public API (remote/put/get/actors) end to end."""
    info = ray_tpu_torch.init(num_cpus=4)
    w = worker_mod.global_worker
    gcs_addr = w.node.gcs_addr

    async def _start():
        srv = ClientServer(gcs_addr, host="127.0.0.1")
        await srv.start()
        return srv

    srv = w.run_async(_start(), timeout=30)
    port = srv.addr[1]
    script = f"""
import ray_tpu_torch
ray_tpu_torch.init(address="ray-tpu://127.0.0.1:{port}")

@ray_tpu_torch.remote
def sq(x):
    return x * x

assert ray_tpu_torch.get(sq.remote(7)) == 49
ref = ray_tpu_torch.put(21)
assert ray_tpu_torch.get(sq.remote(ref)) == 441

@ray_tpu_torch.remote
class Acc:
    def __init__(self):
        self.total = 0
    def add(self, v):
        self.total += v
        return self.total

a = Acc.remote()
assert ray_tpu_torch.get(a.add.remote(3)) == 3
assert ray_tpu_torch.get(a.add.remote(4)) == 7
ready, pending = ray_tpu_torch.wait([sq.remote(2)], num_returns=1, timeout=30)
assert len(ready) == 1 and not pending
assert any(n["state"] == "ALIVE" for n in ray_tpu_torch.nodes())
ray_tpu_torch.shutdown()
print("CLIENT_OK")
"""
    try:
        out = subprocess.run(
            [sys.executable, "-c", script],
            capture_output=True,
            text=True,
            timeout=180,
        )
        assert "CLIENT_OK" in out.stdout, f"stdout={out.stdout}\nstderr={out.stderr}"
    finally:
        async def _stop():
            await srv.stop()

        w.run_async(_stop(), timeout=30)
        ray_tpu_torch.shutdown()


def test_client_moves_torch_tensors_bitwise(client_setup):
    """A tensor a task returns reaches the client as a CPU tensor of its
    dtype, bitwise (bf16 included), as it reaches a driver; a tensor the
    client puts reaches a task the same way."""
    ctx, _ = client_setup

    @ray_tpu_torch.remote
    def make(seed):
        g = torch.Generator().manual_seed(seed)
        x = torch.randn(257, 33, generator=g)
        return {"f32": x, "bf16": x.to(torch.bfloat16), "t": x.t()}

    @ray_tpu_torch.remote
    def checksum(t):
        return [str(t.dtype), list(t.shape), t.float().sum().item()]

    got = ctx.get(ctx.submit_remote_function(make, (5,), {})[0], timeout=60)
    want = make._fn(5)
    for key, t in want.items():
        assert isinstance(got[key], torch.Tensor) and got[key].device.type == "cpu"
        assert got[key].dtype == t.dtype and torch.equal(got[key], t), key
    ref = ctx.put(want["bf16"])
    assert ctx.get(ctx.submit_remote_function(checksum, (ref,), {})[0], timeout=60) == \
        checksum._fn(want["bf16"])


# A client driver that sees no card: its GPU task runs in the cluster, and
# the client reports what it imported and whether it made CUDA state.
GPU_CLIENT = r'''
import json, os, sys
sys.path.insert(0, {repo!r})
import torch
import ray_tpu_torch as rt
rt.init(address="ray-tpu://127.0.0.1:{port}")

@rt.remote(num_gpus=1)
def on_gpu_node():
    import torch
    return {{"node": os.environ["RAY_TPU_NODE_ID"], "x": torch.arange(6.0).reshape(2, 3)}}

out = rt.get(on_gpu_node.remote(), timeout=120)
rt.shutdown()
print("RESULT " + json.dumps({{
    "node": out["node"], "x": out["x"].tolist(), "device": str(out["x"].device),
    "cuda_initialized": torch.cuda.is_initialized(),
    "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
    "forbidden": sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "ray_tpu")),
}}))
'''


@pytest.mark.timeout(120)
def test_client_without_a_card_drives_a_gpu_task():
    """Phase 14c's client on the CPU: a driver with CUDA_VISIBLE_DEVICES=""
    runs a num_gpus=1 task on a cluster that advertises a GPU, and gets its
    tensor back as a CPU tensor; it never made CUDA state and loaded no jax
    and no ray_tpu."""
    ray_tpu_torch.init(num_cpus=2, num_gpus=1)
    w = worker_mod.global_worker

    async def _start():
        srv = ClientServer(w.node.gcs_addr, host="127.0.0.1")
        await srv.start()
        return srv

    srv = w.run_async(_start(), timeout=30)
    try:
        env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
        out = subprocess.run([sys.executable, "-c", GPU_CLIENT.format(repo=REPO, port=srv.addr[1])],
                             capture_output=True, text=True, timeout=100, env=env)
        assert out.returncode == 0, out.stderr[-4000:]
        line = [x for x in out.stdout.splitlines() if x.startswith("RESULT ")]
        assert line, (out.stdout[-2000:], out.stderr[-2000:])
        got = json.loads(line[-1][len("RESULT "):])
    finally:
        async def _stop():
            await srv.stop()

        w.run_async(_stop(), timeout=30)
        ray_tpu_torch.shutdown()
    assert got == {"node": got["node"], "x": [[0.0, 1.0, 2.0], [3.0, 4.0, 5.0]], "device": "cpu",
                   "cuda_initialized": False, "visible": "", "forbidden": []}
