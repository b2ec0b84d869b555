"""ray_tpu_torch.util.collective on the CPU: the ops of tests/test_collective.py
on the port's store backend against ray_tpu's store backend on the same
seeded inputs; every op (barrier, uneven reducescatter, MIN/MAX/PRODUCT,
broadcast from rank 2, tagged FIFO send/recv too) on the port's gloo
backend against its store backend; ring and Ulysses attention on a 4-rank
gloo group against the reference's sharded attention and full attention,
forward and gradients; a rank killed mid-op; the telemetry families; and a
two-worker TorchTrainer's collective group.

Each package's ranks are actors of its own runtime. The two runtimes run in
subprocesses of their own (OPS_SCRIPT), side by side; the reference's
attention runs here, on the JAX CPU mesh.

tests/test_collective_xla.py stays out: each of its cases drives the xla
backend (compiled programs over a jax mesh, a JaxTrainer's SPMD step), which
the port replaces with nccl and gloo on torch.distributed. Their
counterparts are the gloo-against-store ops, ring and Ulysses on a gloo
group, the telemetry families and the rank killed mid-op here, and the
NCCL group on the card (tests/test_torch_cuda.py, chip_smoke.py phase 10)."""

import functools
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest

from ray_tpu.testing import force_cpu_mesh

force_cpu_mesh(8)  # before first backend use, like every jax-facing test

import jax  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")

import ray_tpu_torch  # noqa: E402
from ray_tpu import parallel as ref  # noqa: E402
from ray_tpu_torch.testing import torch_cluster  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# gloo against the store: integers exactly; f32 sums in another order.
F32_ATOL = 1e-6
# Port against JAX, both f32 on the CPU, inputs and outputs O(1)
# (tests/test_torch_parallel.py).
ATTN_ATOL = 1e-5
B, T, H, D = 4, 32, 4, 16


def _programs():
    """name -> (world, per-rank op lists), from seeded inputs. An op is
    (name, *args): allreduce(x, op), allgather(x), reducescatter(x, op),
    broadcast(x, src), barrier(), send(x, dst, tag), recv(src, tag),
    rank_info()."""
    rng = np.random.RandomState(0)

    def f32(*shape):
        return rng.randn(*shape).astype(np.float32)

    def i64(*shape):
        return rng.randint(-50, 50, shape).astype(np.int64)

    def per_rank(world, make):
        return world, [make(r) for r in range(world)]

    a, b, c = f32(3), f32(3), i64(2)
    return {
        # tests/test_collective.py's five
        "allreduce": per_rank(4, lambda r: [("allreduce", f32(4), "sum")]),
        "allgather_and_rank": per_rank(2, lambda r: [("allgather", i64(2)), ("rank_info",)]),
        "broadcast": per_rank(3, lambda r: [("broadcast", i64(3) if r == 0 else np.zeros(3, np.int64), 0)]),
        "reducescatter": per_rank(2, lambda r: [("reducescatter", f32(8), "sum")]),
        "send_recv": (2, [[("send", rng.randn(1), 1, 0)], [("recv", 0, 0)]]),
        # the rest of the surface
        "barrier": per_rank(3, lambda r: [("barrier",), ("allreduce", i64(2, 2).astype(np.int32), "sum")]),
        "reducescatter_uneven": per_rank(3, lambda r: [("reducescatter", f32(7, 2), "sum")]),
        "min": per_rank(4, lambda r: [("allreduce", f32(3, 5), "min"), ("allreduce", i64(4), "min")]),
        "max": per_rank(4, lambda r: [("allreduce", f32(3, 5), "max"), ("reducescatter", i64(4, 3), "max")]),
        "product": per_rank(3, lambda r: [
            ("allreduce", rng.uniform(0.5, 1.5, (2, 3)).astype(np.float32), "product"),
            ("allreduce", rng.randint(-3, 4, (5,)).astype(np.int32), "product")]),
        "broadcast_from_2": per_rank(3, lambda r: [("broadcast", f32(3, 4), 2)]),
        "send_recv_tagged_fifo": (2, [
            [("send", a, 1, 0), ("send", b, 1, 0), ("send", c, 1, 1)],
            [("recv", 0, 1), ("recv", 0, 0), ("recv", 0, 0)]]),
    }


PROGRAMS = _programs()
REFERENCE_CASES = ["allreduce", "allgather_and_rank", "broadcast", "reducescatter", "send_recv"]
ATTENTION = [(fn, causal) for fn in ("ring", "ulysses") for causal in (False, True)]


def _attention_inputs(i):
    rng = np.random.RandomState(100 + i)
    return tuple(rng.randn(B, T, H, D).astype(np.float32) for _ in range(4))  # q, k, v, g


# Runs in a subprocess with {pkg} as the package: every program of `args`
# on each backend of `args` through actors of that package's runtime, and,
# for the port, the attention cases on a 4-rank gloo group. Writes a pickle
# of {"ops": {(backend, program): per-rank results}, "attention": ...}.
OPS_SCRIPT = r'''
import pickle, sys
sys.path.insert(0, {repo!r})
import numpy as np
import {pkg} as rt
from {pkg}.util import collective as col

with open(sys.argv[1], "rb") as f:
    args = pickle.load(f)
rt.init(num_cpus=6)

@rt.remote(num_cpus=1)
class Rank:
    def __init__(self):
        import os
        os.environ["OMP_NUM_THREADS"] = "1"

    def join(self, world, rank, backend, name):
        col.init_collective_group(world, rank, backend=backend, group_name=name)

    def leave(self, name):
        col.destroy_collective_group(name)

    def run(self, name, ops):
        out = []
        for op, *a in ops:
            if op == "allreduce":
                out.append(col.allreduce(a[0], name, op=a[1]))
            elif op == "allgather":
                out.append(col.allgather(a[0], name))
            elif op == "reducescatter":
                out.append(col.reducescatter(a[0], name, op=a[1]))
            elif op == "broadcast":
                out.append(col.broadcast(a[0], src_rank=a[1], group_name=name))
            elif op == "barrier":
                out.append(col.barrier(name))
            elif op == "send":
                out.append(col.send(a[0], a[1], name, tag=a[2]))
            elif op == "recv":
                out.append(col.recv(a[0], name, tag=a[1]))
            elif op == "rank_info":
                out.append((col.get_rank(name), col.get_collective_group_size(name)))
        return out

    def accessors(self, name):
        mesh = col.get_group_mesh(name)
        eng = col.get_group_collectives(name)
        return (None if mesh is None else (mesh.device_type, mesh.mesh_dim_names, mesh.size()),
                None if eng is None else type(eng).__name__)

    def attention(self, name, rank, cases):
        import torch
        from {pkg}.parallel import ring_attention_on_group, ulysses_attention_on_group

        torch.set_num_threads(1)
        out = []
        for fn, causal, q, k, v, g in cases:
            leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
            f = ring_attention_on_group if fn == "ring" else ulysses_attention_on_group
            o = f(*leaves, causal=causal, group_name=name)
            grads = torch.autograd.grad(o, leaves, torch.from_numpy(g))
            out.append([t.detach().numpy() for t in (o, *grads)])
        return out

    def store_refuses_attention(self, name):
        import torch
        from {pkg}.parallel import ring_attention_on_group, ulysses_attention_on_group

        x = torch.zeros(1, 2, 1, 4)
        msgs = []
        for f in (ring_attention_on_group, ulysses_attention_on_group):
            try:
                f(x, x, x, group_name=name)
                msgs.append(None)
            except ValueError as e:
                msgs.append(str(e))
        return msgs

ranks = [Rank.remote() for _ in range(4)]
result = {{"ops": {{}}, "accessors": {{}}}}
for backend in args["backends"]:
    for prog, (world, ops) in args["programs"].items():
        name = f"{{backend}}_{{prog}}"
        rt.get([ranks[r].join.remote(world, r, backend, name) for r in range(world)], timeout=120)
        result["ops"][backend, prog] = rt.get(
            [ranks[r].run.remote(name, ops[r]) for r in range(world)], timeout=120)
        if prog == "barrier":
            result["accessors"][backend] = rt.get(ranks[0].accessors.remote(name))
            if backend == "store" and "attention" in args:
                result["store_refuses_attention"] = rt.get(
                    ranks[0].store_refuses_attention.remote(name))
        rt.get([ranks[r].leave.remote(name) for r in range(world)], timeout=120)
if "attention" in args:
    cases = args["attention"]
    rt.get([ranks[r].join.remote(4, r, "gloo", "attn") for r in range(4)], timeout=120)
    tl = cases[0][2].shape[1] // 4
    shard = lambda x, r: np.ascontiguousarray(x[:, r * tl:(r + 1) * tl])
    per_rank = rt.get([ranks[r].attention.remote(
        "attn", r, [(fn, c, *(shard(x, r) for x in xs)) for fn, c, *xs in cases])
        for r in range(4)], timeout=180)
    result["attention"] = [[np.concatenate([per_rank[r][i][j] for r in range(4)], axis=1)
                            for j in range(4)] for i in range(len(cases))]
    rt.get([ranks[r].leave.remote("attn") for r in range(4)], timeout=120)
rt.shutdown()
with open(sys.argv[2], "wb") as f:
    pickle.dump(result, f)
'''


def _start(pkg, args, tmp):
    src, dst = os.path.join(tmp, f"{pkg}_in.pkl"), os.path.join(tmp, f"{pkg}_out.pkl")
    with open(src, "wb") as f:
        pickle.dump(args, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-c", OPS_SCRIPT.format(repo=REPO, pkg=pkg), src, dst],
        cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, dst


def _finish(proc, dst):
    out, _ = proc.communicate(timeout=240)
    assert proc.returncode == 0, out[-4000:]
    with open(dst, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The programs through both packages' runtimes at once: ray_tpu's store
    backend (the five of tests/test_collective.py), and the port's store and
    gloo backends (all of them) with the attention cases."""
    tmp = str(tmp_path_factory.mktemp("collective"))
    cases = [(fn, causal, *_attention_inputs(i)) for i, (fn, causal) in enumerate(ATTENTION)]
    ref_run = _start("ray_tpu", {"backends": ["store"],
                                 "programs": {p: PROGRAMS[p] for p in REFERENCE_CASES}}, tmp)
    port_run = _start("ray_tpu_torch", {"backends": ["store", "gloo"], "programs": PROGRAMS,
                                        "attention": cases}, tmp)
    return {"ray_tpu": _finish(*ref_run), "ray_tpu_torch": _finish(*port_run)}


def _assert_same(got, want, where):
    """Op results equal: the same kind (numpy or None or a list/tuple of
    them), integers exactly, floats within F32_ATOL."""
    if want is None or isinstance(want, tuple):
        assert got == want, where
        return
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for g, w in zip(got, want):
            _assert_same(g, w, where)
        return
    assert isinstance(got, np.ndarray), (where, type(got))
    assert got.shape == want.shape, (where, got.shape, want.shape)
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=str(where))
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL, err_msg=str(where))


@pytest.mark.timeout(300)
@pytest.mark.parametrize("prog", REFERENCE_CASES)
def test_store_backend_matches_reference_store(runs, prog):
    _assert_same(runs["ray_tpu_torch"]["ops"]["store", prog],
                 runs["ray_tpu"]["ops"]["store", prog], prog)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("prog", list(PROGRAMS))
def test_gloo_backend_matches_store(runs, prog):
    port = runs["ray_tpu_torch"]["ops"]
    _assert_same(port["gloo", prog], port["store", prog], prog)


@pytest.mark.timeout(300)
def test_expected_values_of_the_reference_cases(runs):
    """The store backend's answers themselves, as tests/test_collective.py
    states them."""
    (world, ops), got = PROGRAMS["allreduce"], runs["ray_tpu_torch"]["ops"]["store", "allreduce"]
    want = np.sum([o[0][1] for o in ops], axis=0)
    for r in range(world):
        np.testing.assert_allclose(got[r][0], want, rtol=0, atol=F32_ATOL)
    gathered = runs["ray_tpu_torch"]["ops"]["gloo", "allgather_and_rank"]
    assert [info for _, info in gathered] == [(0, 2), (1, 2)]
    (_, ops), fifo = PROGRAMS["send_recv_tagged_fifo"], runs["ray_tpu_torch"]["ops"]["gloo", "send_recv_tagged_fifo"]
    a, b, c = (op[1] for op in ops[0])
    assert fifo[0] == [None, None, None]
    for x, y in zip(fifo[1], (c, a, b)):  # tag 1 first, then tag 0 in order
        np.testing.assert_array_equal(x, y)


@pytest.mark.timeout(300)
def test_group_mesh_and_engine_accessors(runs):
    acc = runs["ray_tpu_torch"]["accessors"]
    assert acc["store"] == (None, None)
    assert acc["gloo"] == (("cpu", ("world",), 3), "MeshCollectives")
    msgs = runs["ray_tpu_torch"]["store_refuses_attention"]
    assert all(m is not None and "no mesh engine" in m for m in msgs), msgs


@functools.lru_cache(maxsize=None)
def _jax_fwd_bwd(fn: str, causal: bool):
    """jit of (q, k, v, g) -> (out, dq, dk, dv) of the reference's `fn`
    ('ring' or 'ulysses' sharded over a {data: 2, sequence: 4} mesh, or
    'full')."""
    jmesh = ref.make_mesh({"data": 2, "sequence": 4})
    f = {"ring": lambda q, k, v: ref.ring_attention_sharded(q, k, v, jmesh, causal=causal),
         "ulysses": lambda q, k, v: ref.ulysses_attention_sharded(q, k, v, jmesh, causal=causal),
         "full": lambda q, k, v: ref.full_attention(q, k, v, causal=causal)}[fn]

    def fwd_bwd(q, k, v, g):
        out, vjp = jax.vjp(f, q, k, v)
        return (out, *vjp(g))

    return jax.jit(fwd_bwd)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("i", range(len(ATTENTION)),
                         ids=[f"{fn}-{'causal' if c else 'full'}" for fn, c in ATTENTION])
def test_attention_on_group_matches_reference(runs, i):
    """ring_attention_on_group / ulysses_attention_on_group on 4 gloo ranks
    against the reference's sharded entry point and its full attention:
    output and dq, dk, dv."""
    fn, causal = ATTENTION[i]
    q, k, v, g = _attention_inputs(i)
    got = runs["ray_tpu_torch"]["attention"][i]
    for want_fn in (fn, "full"):
        want = [np.asarray(x) for x in _jax_fwd_bwd(want_fn, causal)(q, k, v, g)]
        for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(a, b, rtol=0, atol=ATTN_ATOL, err_msg=f"{name} vs {want_fn}")


@pytest.mark.timeout(30)
def test_nccl_without_a_card_raises():
    """backend="nccl" never becomes gloo: without a card it raises, naming
    the choice, and leaves no group behind."""
    from ray_tpu_torch.util import collective as col

    with pytest.raises(RuntimeError, match="gloo"):
        col.init_collective_group(1, 0, backend="nccl", group_name="t_nccl")
    assert not col.is_group_initialized("t_nccl")


@pytest.mark.timeout(60)
def test_world_of_one_group_in_this_process():
    """A gloo group of one needs no cluster: every op returns its input in
    the input's kind (a tensor or numpy), a send to this rank itself comes
    back by recv in FIFO order per tag, and a recv before its send raises
    instead of waiting forever. Phase 10a runs the same at world 1 on NCCL."""
    import torch

    from ray_tpu_torch.util import collective as col

    col.init_collective_group(1, 0, backend="gloo", group_name="t_one")
    try:
        x = torch.arange(12, dtype=torch.float32).reshape(4, 3)
        for op in ("sum", "product", "min", "max"):
            assert torch.equal(col.allreduce(x, "t_one", op=op), x)
        assert torch.equal(col.allgather(x, "t_one")[0], x)
        assert torch.equal(col.reducescatter(x, "t_one"), x)
        np.testing.assert_array_equal(col.broadcast(x.numpy(), 0, "t_one"), x.numpy())
        col.barrier("t_one")
        col.send(x, 0, "t_one", tag=1)
        col.send(x.numpy() * 2, 0, "t_one", tag=1)
        col.send(x * 3, 0, "t_one", tag=2)
        assert torch.equal(col.recv(0, "t_one", tag=2), x * 3)
        assert torch.equal(col.recv(0, "t_one", tag=1), x)
        np.testing.assert_array_equal(col.recv(0, "t_one", tag=1), x.numpy() * 2)
        with pytest.raises(RuntimeError, match="before its send"):
            col.recv(0, "t_one", tag=1)
        assert x.sum().item() == 66  # no op wrote into its input
    finally:
        col.destroy_collective_group("t_one")
    assert not col.is_group_initialized("t_one")


def _rank_cls():
    @ray_tpu_torch.remote(num_cpus=1)
    class Rank:
        def __init__(self, rank, backend, name):
            from ray_tpu_torch.util import collective as col

            col.init_collective_group(2, rank, backend=backend, group_name=name)
            self.name = name

        def ready(self):
            return True

        def reduce(self):
            from ray_tpu_torch.util import collective as col

            col.allreduce(np.ones(4, dtype=np.float32), self.name)
            return "completed"

        def again(self):
            from ray_tpu_torch.util import collective as col

            try:
                col.allreduce(np.ones(4, dtype=np.float32), self.name)
            except col.CollectiveGroupDiedError as e:
                return e.group_name
            return None

    return Rank


@pytest.mark.timeout(90)
@pytest.mark.parametrize("backend", ["store", "gloo"])
def test_participant_death_raises_typed_error(torch_cluster, backend):  # noqa: F811
    """A rank dying mid-collective fails the survivor's op with
    CollectiveGroupDiedError within 10 s, on both backends; the error
    crosses the worker->driver boundary intact and pickles; a torch group
    that died refuses the next op at once."""
    from ray_tpu_torch.util.collective import CollectiveGroupDiedError

    Rank = _rank_cls()
    name = f"t_death_{backend}"
    a, b = Rank.remote(0, backend, name), Rank.remote(1, backend, name)
    assert ray_tpu_torch.get([a.ready.remote(), b.ready.remote()], timeout=60)
    ref = a.reduce.remote()  # rank 1 never contributes...
    time.sleep(1.0)
    ray_tpu_torch.kill(b)  # ...and dies mid-collective
    t0 = time.monotonic()
    with pytest.raises(CollectiveGroupDiedError) as info:
        ray_tpu_torch.get(ref, timeout=60)
    assert time.monotonic() - t0 < 10
    err = pickle.loads(pickle.dumps(info.value))
    assert (type(err), err.group_name) == (CollectiveGroupDiedError, name)
    if backend == "gloo":
        assert ray_tpu_torch.get(a.again.remote(), timeout=30) == name


def _gcs_collective_telemetry(groups, ranks: int, timeout: float = 20.0):
    """The collective families in the GCS's telemetry aggregate, once the
    latency histogram of every group of `groups` holds an allreduce of each
    of its `ranks` (each process flushes its deltas there every
    telemetry_flush_interval_s): ({family: kind}, {(op, group): bytes},
    {(op, group): observations}), summed over the ranks."""
    import json

    from ray_tpu_torch._private import worker as worker_mod

    deadline = time.monotonic() + timeout
    while True:
        agg = worker_mod.global_worker.run_async(
            worker_mod._core().gcs.call("GetTelemetry", {}))["telemetry"]
        kinds = {fam: agg["meta"].get(f"collective.{fam}", {}).get("kind")
                 for fam in ("op_latency_s", "bytes")}
        nbytes, counts = {}, {}
        for table, key, out, val in (("counters", "bytes", nbytes, lambda v: v),
                                     ("hists", "op_latency_s", counts, lambda v: v["total"])):
            for skey, v in agg[table].get(f"collective.{key}", {}).items():
                labels = dict(json.loads(skey.split("|", 1)[1]))
                k = (labels["op"], labels["group"])
                out[k] = out.get(k, 0) + val(v)
        if all(counts.get(("allreduce", g), 0) >= ranks for g in groups) \
                or time.monotonic() > deadline:
            return kinds, nbytes, counts
        time.sleep(0.5)


@pytest.mark.timeout(90)
def test_telemetry_families(torch_cluster):  # noqa: F811
    """Group ops feed the collective_op_latency_s histogram and the
    collective_bytes counter on both backends (docs/observability.md): one
    allreduce of four float32 on each rank of each group."""
    Rank = _rank_cls()
    for backend in ("store", "gloo"):
        name = f"t_tel_{backend}"
        pair = [Rank.remote(r, backend, name) for r in range(2)]  # a CPU each, of 4
        assert ray_tpu_torch.get([r.reduce.remote() for r in pair], timeout=60) == ["completed"] * 2
        # The ranks' flushes reach the GCS while they live.
        kinds, nbytes, counts = _gcs_collective_telemetry([name], ranks=2)
        for r in pair:
            ray_tpu_torch.kill(r)
        assert kinds == {"op_latency_s": "histogram", "bytes": "counter"}
        assert nbytes.get(("allreduce", name)) == 2 * 16  # two ranks, four float32 each
        assert counts.get(("allreduce", name)) == 2


@pytest.mark.timeout(120)
def test_trainer_store_group_allreduce(torch_cluster, tmp_path):  # noqa: F811
    """A two-worker CPU TorchTrainer joins a "store" collective group (the
    default) and its loop allreduces each rank's number through it."""
    from ray_tpu_torch import train
    from ray_tpu_torch.air import RunConfig, ScalingConfig
    from ray_tpu_torch.train.torch import TorchConfig, TorchTrainer

    def train_fn(config):
        from ray_tpu_torch.util import collective as col

        ctx = train.get_context()
        name = ctx.get_collective_group()
        total = col.allreduce(np.array([ctx.get_world_rank() + 1.0]), name)
        train.report({"sum": float(total[0]), "group": name,
                      "size": col.get_collective_group_size(name)})

    result = TorchTrainer(
        train_fn, backend_config=TorchConfig(collective_backend="store"),
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
        worker_env={"OMP_NUM_THREADS": "1"},
        run_config=RunConfig(name="t_group", storage_path=str(tmp_path)),
    ).fit()
    assert result.error is None
    assert result.metrics["sum"] == 3.0  # 1 + 2
    assert result.metrics["group"].startswith("train_") and result.metrics["size"] == 2
