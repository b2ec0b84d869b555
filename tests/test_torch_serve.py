"""Serve on the port (ray_tpu_torch.serve), on the CPU: the cases of
tests/test_serve.py on the port's runtime (deploy and handles, replicas and
status, composition, HTTP and typed gRPC ingress, streaming, multiplexed
routing, redeploy, autoscaling, recovery after a kill, SSE); GPU placement
on a CPU cluster that advertises one GPU; and the slice as a whole against
the JAX package: each package's Serve, in a process of its own, serves the
transformer at a small width in batches, and the last-position log-probs
of the same seeded prompts agree with each other and with the JAX
package's transformer_apply of each prompt alone."""


import json
import os
import pickle
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.testing import torch_cluster  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def serve_cluster(torch_cluster):  # noqa: F811
    from ray_tpu_torch import serve

    yield serve
    serve.shutdown()


def _http_get(url: str, timeout: float = 10.0) -> bytes:
    return urllib.request.urlopen(url, timeout=timeout).read()


def test_deploy_and_handle(serve_cluster):
    serve = serve_cluster

    @serve.deployment
    class Doubler:
        def __call__(self, x):
            return x * 2

        def triple(self, x):
            return x * 3

    handle = serve.run(Doubler.bind(), route_prefix=None)
    assert handle.remote(21).result(timeout_s=30) == 42
    # Method routing via attribute access.
    assert handle.triple.remote(10).result(timeout_s=30) == 30


def test_multiple_replicas_and_status(serve_cluster):
    serve = serve_cluster

    @serve.deployment(num_replicas=2)
    class Echo:
        def __call__(self, x):
            import os

            return (os.getpid(), x)

    handle = serve.run(Echo.bind(), route_prefix=None)
    pids = {handle.remote(i).result(timeout_s=30)[0] for i in range(20)}
    assert len(pids) == 2, f"expected both replicas used, saw pids {pids}"

    st = serve.status()
    app = st["default"]
    assert app["status"] == "RUNNING"
    dep = app["deployments"]["Echo"]
    assert dep["replica_states"]["RUNNING"] == 2


def test_model_composition(serve_cluster):
    serve = serve_cluster

    @serve.deployment
    class Adder:
        def __init__(self, increment):
            self.increment = increment

        def __call__(self, x):
            return x + self.increment

    @serve.deployment
    class Combiner:
        def __init__(self, a, b):
            self.a = a
            self.b = b

        async def __call__(self, x):
            ra = self.a.remote(x)
            rb = self.b.remote(x)
            return (await ra) + (await rb)

    app = Combiner.bind(Adder.bind(1), Adder.options(name="Adder2").bind(2))
    handle = serve.run(app, route_prefix=None)
    # (10+1) + (10+2) = 23
    assert handle.remote(10).result(timeout_s=30) == 23


def test_http_ingress(serve_cluster):
    serve = serve_cluster

    @serve.deployment
    class Api:
        def __call__(self, request):
            if request.path.endswith("/json"):
                return {"method": request.method, "q": request.query.get("q")}
            return f"hello {request.text() or 'world'}"

    serve.run(Api.bind(), name="app1", route_prefix="/api")
    http = serve.status()  # ensure running
    assert http["app1"]["status"] == "RUNNING"

    import ray_tpu_torch

    controller = ray_tpu_torch.get_actor("SERVE_CONTROLLER", namespace="serve")
    cfg = ray_tpu_torch.get(controller.get_http_config.remote())
    base = f"http://{cfg['host']}:{cfg['port']}"

    assert _http_get(f"{base}/-/healthz") == b"success"
    body = _http_get(f"{base}/api/json?q=5")
    assert json.loads(body) == {"method": "GET", "q": "5"}
    assert _http_get(f"{base}/api") == b"hello world"
    with pytest.raises(Exception):
        _http_get(f"{base}/nope")


def test_grpc_ingress_typed(serve_cluster):
    """Typed gRPC proxy: ServeAPIService with proto messages carrying the
    application / method routing (reference: serve.proto
    RayServeAPIService)."""
    serve = serve_cluster
    serve.start(http_options={"host": "127.0.0.1", "port": 0, "grpc_port": 0})

    @serve.deployment
    class Echo:
        def __call__(self, payload: bytes):
            return b"echo:" + payload

        def shout(self, payload: bytes):
            return payload.upper().decode()  # str -> content_type "text"

    serve.run(Echo.bind(), name="gapp", route_prefix="/gapp")
    import ray_tpu_torch

    controller = ray_tpu_torch.get_actor("SERVE_CONTROLLER", namespace="serve")
    cfg = ray_tpu_torch.get(controller.get_http_config.remote())
    assert cfg.get("grpc_port"), cfg

    import grpc

    from ray_tpu_torch.serve.protobuf import ServeAPIStub, ServeRequest

    chan = grpc.insecure_channel(f"127.0.0.1:{cfg['grpc_port']}")
    stub = ServeAPIStub(chan)
    reply = stub.Predict(
        ServeRequest(application="gapp", payload=b"hi"), timeout=30
    )
    assert reply.payload == b"echo:hi" and reply.content_type == "bytes"
    reply = stub.Predict(
        ServeRequest(application="gapp", method="shout", payload=b"hi"),
        timeout=30,
    )
    assert reply.payload == b"HI" and reply.content_type == "text"
    with pytest.raises(grpc.RpcError):
        stub.Predict(ServeRequest(application="nope", payload=b"x"), timeout=10)
    chan.close()


def test_streaming_responses_http_and_grpc(serve_cluster):
    """Generator deployments stream: chunked HTTP body and server-streaming
    gRPC, with items forwarded as the replica produces them (reference:
    StreamingResponse + serve.proto streaming rpcs)."""
    serve = serve_cluster
    serve.start(http_options={"host": "127.0.0.1", "port": 0, "grpc_port": 0})

    @serve.deployment
    class StreamEcho:
        def __call__(self, request):
            # Works for both ingresses: HTTPRequest body or raw grpc bytes.
            data = request.body if hasattr(request, "body") else request
            for i in range(3):
                yield b"chunk%d:%s;" % (i, data)

    serve.run(StreamEcho.bind(), name="sapp", route_prefix="/sapp")
    import ray_tpu_torch

    controller = ray_tpu_torch.get_actor("SERVE_CONTROLLER", namespace="serve")
    cfg = ray_tpu_torch.get(controller.get_http_config.remote())

    # HTTP chunked streaming (opt-in via header).
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{cfg['port']}/sapp",
        data=b"hi",
        headers={"serve-streaming": "1"},
    )
    body = urllib.request.urlopen(req, timeout=30).read()
    assert body == b"chunk0:hi;chunk1:hi;chunk2:hi;"

    # gRPC server-streaming.
    import grpc

    from ray_tpu_torch.serve.protobuf import ServeAPIStub, ServeRequest

    chan = grpc.insecure_channel(f"127.0.0.1:{cfg['grpc_port']}")
    stub = ServeAPIStub(chan)
    replies = list(
        stub.PredictStreaming(
            ServeRequest(application="sapp", payload=b"yo"), timeout=30
        )
    )
    assert [r.payload for r in replies] == [
        b"chunk0:yo;", b"chunk1:yo;", b"chunk2:yo;",
    ]
    assert all(r.content_type == "bytes" for r in replies)
    chan.close()


def test_multiplexed_model_routing(serve_cluster):
    """@serve.multiplexed caches per-model loads with LRU and the router
    keeps a model's requests sticky to its replica."""
    serve = serve_cluster

    @serve.deployment(num_replicas=2)
    class MM:
        def __init__(self):
            self.loads = []

        @serve.multiplexed(max_num_models_per_replica=2)
        async def load(self, model_id: str):
            self.loads.append(model_id)
            return f"model-{model_id}"

        async def __call__(self, payload):
            mid = serve.get_multiplexed_model_id()
            model = await self.load(mid)
            return {"model": model, "loads": len(self.loads)}

    serve.run(MM.bind(), name="mm", route_prefix="/mm")
    handle = serve.get_app_handle("mm")
    r1 = handle.options(multiplexed_model_id="a").remote("x").result(timeout_s=60)
    assert r1["model"] == "model-a"
    # Same model id again: cache hit on the SAME replica (loads unchanged).
    r2 = handle.options(multiplexed_model_id="a").remote("x").result(timeout_s=60)
    assert r2["model"] == "model-a" and r2["loads"] == r1["loads"]


def test_redeploy_and_delete(serve_cluster):
    serve = serve_cluster

    @serve.deployment
    class V:
        def __call__(self, _):
            return "v1"

    serve.run(V.bind(), route_prefix=None)
    h = serve.get_app_handle()
    assert h.remote(None).result(timeout_s=30) == "v1"

    @serve.deployment(name="V")
    class V2:
        def __call__(self, _):
            return "v2"

    serve.run(V2.bind(), route_prefix=None)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        if serve.get_app_handle().remote(None).result(timeout_s=30) == "v2":
            break
        time.sleep(0.2)
    assert serve.get_app_handle().remote(None).result(timeout_s=30) == "v2"

    serve.delete("default")
    assert "default" not in serve.status()


def test_autoscaling_scales_up(serve_cluster):
    serve = serve_cluster

    @serve.deployment(
        autoscaling_config=serve.AutoscalingConfig(
            min_replicas=1,
            max_replicas=3,
            target_ongoing_requests=1.0,
            upscale_delay_s=0.5,
            look_back_period_s=2.0,
            metrics_interval_s=0.2,
        ),
        max_ongoing_requests=2,
    )
    class Slow:
        async def __call__(self, _):
            import asyncio

            await asyncio.sleep(0.4)
            return "ok"

    handle = serve.run(Slow.bind(), route_prefix=None)
    # Flood with concurrent requests to trigger upscale.
    responses = [handle.remote(None) for _ in range(24)]
    for r in responses:
        assert r.result(timeout_s=60) == "ok"
    deadline = time.monotonic() + 20
    saw = 1
    while time.monotonic() < deadline:
        dep = serve.status()["default"]["deployments"]["Slow"]
        saw = max(saw, dep["target_replicas"])
        if saw > 1:
            break
        responses = [handle.remote(None) for _ in range(12)]
        for r in responses:
            r.result(timeout_s=60)
    assert saw > 1, "autoscaler never scaled up"


def test_replica_recovery_after_kill(serve_cluster):
    serve = serve_cluster
    import ray_tpu_torch

    @serve.deployment
    class Sturdy:
        def __call__(self, x):
            return x + 1

    handle = serve.run(Sturdy.bind(), route_prefix=None)
    assert handle.remote(1).result(timeout_s=30) == 2

    # Kill the replica actor out from under the controller.
    st = serve.status()
    assert st["default"]["deployments"]["Sturdy"]["replica_states"]["RUNNING"] == 1
    names = [
        a
        for a in ray_tpu_torch.get(
            ray_tpu_torch.get_actor("SERVE_CONTROLLER", namespace="serve")
            .get_serve_status.remote()
        )
    ]
    # Find replica actor by its registered name prefix.
    import ray_tpu_torch._private.worker as worker_mod

    reply = worker_mod.global_worker.run_async(
        worker_mod._core().gcs.call("ListNamedActors", {"namespace": "serve"})
    )
    replica_names = [
        n for n in reply.get("names", []) if n.startswith("SERVE_REPLICA::")
    ]
    assert replica_names, f"no replica actors registered: {reply}"
    victim = ray_tpu_torch.get_actor(replica_names[0], namespace="serve")
    ray_tpu_torch.kill(victim)

    # Controller should notice (health checks) and start a replacement.
    deadline = time.monotonic() + 60
    ok = False
    while time.monotonic() < deadline:
        try:
            if handle.remote(5).result(timeout_s=10) == 6:
                ok = True
                break
        except Exception:
            time.sleep(0.5)
    assert ok, "service did not recover after replica kill"


def test_sse_streaming_via_accept_header(serve_cluster):
    """Accept: text/event-stream negotiates standards-compliant SSE framing
    — every yielded item becomes one `data:` event an EventSource client
    can parse (reference: serve streaming + SSE integrations)."""
    serve = serve_cluster
    serve.start(http_options={"host": "127.0.0.1", "port": 0})

    @serve.deployment
    class Tokens:
        def __call__(self, request):
            yield "hello"
            yield {"k": 1}
            yield "multi\nline"

    serve.run(Tokens.bind(), name="sse", route_prefix="/sse")
    import ray_tpu_torch

    controller = ray_tpu_torch.get_actor("SERVE_CONTROLLER", namespace="serve")
    cfg = ray_tpu_torch.get(controller.get_http_config.remote())

    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{cfg['port']}/sse",
        data=b"x",
        headers={"Accept": "text/event-stream"},
    )
    resp = urllib.request.urlopen(req, timeout=30)
    assert resp.headers["Content-Type"].startswith("text/event-stream")
    body = resp.read().decode()
    # SSE framing: one event per yield, blank-line separated; the multiline
    # item becomes consecutive data: lines of ONE event.
    events = [e for e in body.split("\n\n") if e]
    assert events[0] == "data: hello"
    assert events[1] == 'data: {"k": 1}'
    assert events[2] == "data: multi\ndata: line"


# -- GPU placement, on a CPU cluster that advertises one GPU -------------------


@pytest.fixture
def one_gpu_cluster():
    """A port cluster whose node advertises one GPU (no card is touched:
    the deployments here never use CUDA)."""
    from ray_tpu_torch import serve

    ray_tpu_torch.init(num_cpus=4, num_gpus=1)
    yield serve
    serve.shutdown()
    ray_tpu_torch.shutdown()


def _replica_states(serve, app: str, dep: str) -> dict:
    return serve.status().get(app, {}).get("deployments", {}).get(dep, {}).get("replica_states", {})


@pytest.mark.timeout(150)
def test_gpu_replica_leases_gpu_and_the_next_waits(one_gpu_cluster):
    """ray_actor_options={"num_gpus": 1} leases the node's one GPU; a second
    replica asking for it stays pending until the first is gone, then
    starts and serves."""
    serve = one_gpu_cluster

    @serve.deployment(ray_actor_options={"num_gpus": 1}, health_check_timeout_s=90.0)
    class OnGpu:
        def __call__(self, _):
            return os.getpid()

    assert ray_tpu_torch.available_resources().get("GPU") == 1.0
    first = serve.run(OnGpu.bind(), name="first", route_prefix=None)
    pid = first.remote(None).result(timeout_s=30)
    assert ray_tpu_torch.available_resources().get("GPU", 0.0) == 0.0

    with pytest.raises(TimeoutError):
        serve.run(OnGpu.options(name="Second").bind(), name="second", route_prefix=None,
                  _timeout_s=3.0)
    states = _replica_states(serve, "second", "Second")
    assert states.get("RUNNING", 0) == 0 and states.get("STARTING") == 1, states

    serve.delete("first")
    deadline = time.monotonic() + 90
    while _replica_states(serve, "second", "Second").get("RUNNING") != 1:
        assert time.monotonic() < deadline, serve.status()
        time.sleep(0.2)
    second = serve.get_app_handle("second")
    assert second.remote(None).result(timeout_s=30) != pid
    assert ray_tpu_torch.available_resources().get("GPU", 0.0) == 0.0


# -- the slice against the JAX package ----------------------------------------

# The transformer both packages serve: 2 layers, d_model 64, 4 heads, vocab
# 256, f32; prompts of 5-48 tokens, batches of up to 4.
LM_CFG = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, max_seq_len=64)
N_PROMPTS, PROMPT_LENS, LM_BATCH = 8, (5, 48), 4
# Both sides run f32 through two blocks and the LM head and sum in other
# orders; log-probs are ~ -ln(256) ~ -5.5, where an f32 ulp is ~5e-7.
LOGP_ATOL = 1e-5

SERVE_LM_SCRIPT = r'''
import os, pickle, sys
sys.path.insert(0, {repo!r})
import numpy as np
import {pkg} as rt
from {pkg} import serve

PKG, CFG = {pkg!r}, {cfg!r}


class LM:
    """Each prompt's last-position log-probs, a batch right-padded to its
    longest prompt (causal: the padding never reaches a real position)."""

    def __init__(self, weights):
        if PKG == "ray_tpu":
            import jax
            import jax.numpy as jnp
            from ray_tpu.models import transformer as tr

            cfg = tr.TransformerConfig(**CFG, dtype=jnp.float32, attention_impl="xla")
            params = jax.tree.map(jnp.asarray, weights)

            def last_logp(tokens, lengths):
                logits = tr.transformer_apply(params, jnp.asarray(tokens), cfg)
                last = logits[jnp.arange(len(lengths)), jnp.asarray(lengths) - 1]
                return np.asarray(jax.nn.log_softmax(last, axis=-1))
        else:
            import torch
            from ray_tpu_torch.convert import params_from_jax
            from ray_tpu_torch.models import transformer as tr

            torch.set_num_threads(1)
            model = params_from_jax(weights, tr.TransformerConfig(**CFG, dtype=torch.float32),
                                    device="cpu")

            def last_logp(tokens, lengths):
                with torch.inference_mode():
                    logits = tr.transformer_apply(model, torch.from_numpy(tokens))
                    last = logits[torch.arange(len(lengths)), torch.as_tensor(lengths) - 1]
                    return torch.log_softmax(last, dim=-1).numpy()
        self.last_logp = last_logp
        self.sizes = []

    def __call__(self, prompts):
        self.sizes.append(len(prompts))
        lengths = [len(p) for p in prompts]
        tokens = np.zeros((len(prompts), max(lengths)), np.int32)
        for i, p in enumerate(prompts):
            tokens[i, :len(p)] = p
        logp = self.last_logp(tokens, lengths)
        return [(row, len(self.sizes)) for row in logp]

    def batch_sizes(self, batch):
        import sys
        modules = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "ray_tpu"))
        return [(self.sizes, modules)] * len(batch)  # batched too: one answer per item


with open(sys.argv[1], "rb") as f:
    weights, prompts = pickle.load(f)
rt.init(num_cpus=4, **{init!r})
serve.start(http_options={{"enabled": False}})
app = serve.deployment(max_batch_size={batch}, batch_wait_timeout_s=0.5,
                       max_ongoing_requests=8)(LM).bind(weights)
handle = serve.run(app, route_prefix=None, _timeout_s=120)
responses = [handle.remote(p) for p in prompts]
answers = [r.result(timeout_s=120) for r in responses]
sizes, modules = handle.batch_sizes.remote(None).result(timeout_s=60)
serve.shutdown()
rt.shutdown()
with open(sys.argv[2], "wb") as f:
    pickle.dump({{"logp": np.stack([a[0] for a in answers]), "batch_of": [a[1] for a in answers],
                 "sizes": sizes, "replica_modules": modules}}, f)
'''


def _serve_lm(pkg: str, inputs: str, out: str) -> subprocess.Popen:
    code = SERVE_LM_SCRIPT.format(repo=REPO, pkg=pkg, cfg=LM_CFG, batch=LM_BATCH,
                                  init={"num_tpus": 0} if pkg == "ray_tpu" else {"num_gpus": 0})
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, "-c", code, inputs, out], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


@pytest.mark.timeout(240)
def test_served_transformer_matches_jax_package(tmp_path):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import transformer as jax_tr

    jcfg = jax_tr.TransformerConfig(**LM_CFG, dtype=jnp.float32, attention_impl="xla")
    weights = jax.tree.map(np.asarray, jax_tr.transformer_init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, LM_CFG["vocab_size"], rng.randint(PROMPT_LENS[0], PROMPT_LENS[1] + 1))
               .astype(np.int32) for _ in range(N_PROMPTS)]
    inputs = tmp_path / "inputs.pkl"
    with open(inputs, "wb") as f:
        pickle.dump((weights, prompts), f)

    procs = {pkg: _serve_lm(pkg, str(inputs), str(tmp_path / f"{pkg}.pkl"))
             for pkg in ("ray_tpu", "ray_tpu_torch")}
    served = {}
    for pkg, proc in procs.items():
        log, _ = proc.communicate(timeout=200)
        assert proc.returncode == 0, f"{pkg}'s Serve failed:\n{log[-3000:]}"
        with open(tmp_path / f"{pkg}.pkl", "rb") as f:
            served[pkg] = pickle.load(f)

    alone = np.stack([np.asarray(jax.nn.log_softmax(
        jax_tr.transformer_apply(weights, jnp.asarray(p)[None], jcfg)[0, -1])) for p in prompts])
    ref, port = served["ray_tpu"], served["ray_tpu_torch"]
    assert port["logp"].shape == (N_PROMPTS, LM_CFG["vocab_size"])
    np.testing.assert_allclose(port["logp"], ref["logp"], rtol=0, atol=LOGP_ATOL)
    np.testing.assert_allclose(port["logp"], alone, rtol=0, atol=LOGP_ATOL)
    np.testing.assert_allclose(ref["logp"], alone, rtol=0, atol=LOGP_ATOL)
    # Both replicas padded real batches, and the port's imported no jax.
    for side in (ref, port):
        assert sum(side["sizes"]) == N_PROMPTS and max(side["sizes"]) > 1, side["sizes"]
    assert port["replica_modules"] == []
    assert "jax" in ref["replica_modules"]
