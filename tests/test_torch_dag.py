"""ray_tpu_torch.dag on the CPU: the channel and compiled-graph cases of
tests/test_dag_workflow.py (:14-190) and the reference device-channel tests
that pass (tests/test_dag_channels.py), each held against ray_tpu's outputs
on the same inputs; torch CPU tensors, bf16 included, bitwise through
TensorChannel; and, as tests of the port alone, the counterparts of the
reference device-channel tests that fail on this JAX: the
device channel's group route between two actors of a gloo group, the exec
loop's ("ok", value) wire on it, a host payload's degradation to the
TensorChannel wire, repeated writes, and the compiled DAG with a device edge
end to end, with no group (shm) and on a gloo group.

The compiled graphs of both packages run in subprocesses of their own
(DAG_SCRIPT), side by side; the CUDA routes (IPC, loopback) are in
tests/test_torch_cuda.py."""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import dag

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Runs in a subprocess with {pkg} as the package: the compiled graphs of
# tests/test_dag_workflow.py, and for the port the device-edge graph of
# tests/test_dag_channels.py:132. Writes a pickle of {case: outputs}.
DAG_SCRIPT = r'''
import pickle, sys
sys.path.insert(0, {repo!r})
import numpy as np
import {pkg} as rt
from {pkg} import dag

rt.init(num_cpus=4)

@rt.remote
class Adder:
    def add(self, x):
        return x + 1

@rt.remote
class Doubler:
    def double(self, x):
        return x * 2

@rt.remote
class Producer:
    def make(self, seed):
        return np.full((256, 256), float(seed), dtype=np.float32)

@rt.remote
class Consumer:
    def total(self, x):
        return (type(x).__name__, str(x.dtype), float(x.sum()))

@rt.remote
class Plus:
    def __init__(self, k):
        self.k = k

    def go(self, x):
        return x + self.k

@rt.remote
class Boom:
    def go(self, x):
        if x == 3:
            raise ValueError("boom at 3")
        return x

def run(graph, inputs, actors):
    compiled = graph.experimental_compile()
    out = []
    try:
        for i in inputs:
            try:
                out.append(compiled.execute(i).get())
            except ValueError as e:
                out.append(("ValueError", str(e)))
    finally:
        compiled.teardown()
        for actor in actors:  # each holds a CPU of the four
            rt.kill(actor)
    return out

out = {{}}
a, b = Adder.remote(), Doubler.remote()
with dag.InputNode() as inp:
    out["linear"] = run(b.double.bind(a.add.bind(inp)), range(10), (a, b))
p, c = Producer.remote(), Consumer.remote()
with dag.InputNode() as inp:
    out["tensor_transport"] = run(c.total.bind(p.make.bind(inp).with_tensor_transport()),
                                  (1, 2, 3), (p, c))
p1, p2 = Plus.remote(1), Plus.remote(2)
with dag.InputNode() as inp:
    out["multi_output"] = run(dag.MultiOutputNode([p1.go.bind(inp), p2.go.bind(inp)]),
                              (10, -4), (p1, p2))
bm = Boom.remote()
with dag.InputNode() as inp:
    out["error_propagation"] = run(bm.go.bind(inp), (1, 3, 4), (bm,))
if {device_edge!r}:
    p, c = Producer.remote(), Consumer.remote()
    with dag.InputNode() as inp:
        graph = c.total.bind(p.make.bind(inp).with_tensor_transport(
            "device", group_name="dag_g", src=0, dst=1))
    out["device_edge"] = run(graph, (1, 2, 5), (p, c))
rt.shutdown()
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
'''

CASES = ["linear", "tensor_transport", "multi_output", "error_propagation"]


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    """The compiled graphs through both packages' runtimes at once."""
    tmp = str(tmp_path_factory.mktemp("dag"))
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    runs = {}
    for pkg in ("ray_tpu", "ray_tpu_torch"):
        dst = os.path.join(tmp, f"{pkg}.pkl")
        code = DAG_SCRIPT.format(repo=REPO, pkg=pkg, device_edge=pkg == "ray_tpu_torch")
        runs[pkg] = (subprocess.Popen([sys.executable, "-c", code, dst], cwd=tmp, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True), dst)
    out = {}
    for pkg, (proc, dst) in runs.items():
        log, _ = proc.communicate(timeout=240)
        assert proc.returncode == 0, log[-4000:]
        with open(dst, "rb") as f:
            out[pkg] = pickle.load(f)
    return out


@pytest.mark.timeout(300)
@pytest.mark.parametrize("case", CASES)
def test_compiled_graph_matches_reference(graphs, case):
    assert graphs["ray_tpu_torch"][case] == graphs["ray_tpu"][case]


@pytest.mark.timeout(300)
def test_compiled_graph_values(graphs):
    """What tests/test_dag_workflow.py states of each graph: the loop
    survives an executor error, and arrays cross the tensor edge as
    float32 numpy arrays."""
    got = graphs["ray_tpu_torch"]
    assert got["linear"] == [(i + 1) * 2 for i in range(10)]
    assert got["tensor_transport"] == [("ndarray", "float32", 256 * 256 * i) for i in (1, 2, 3)]
    assert got["multi_output"] == [[11, 12], [-3, -2]]
    assert got["error_propagation"] == [1, ("ValueError", "boom at 3"), 4]


@pytest.mark.timeout(300)
def test_compiled_dag_device_transport_end_to_end(graphs):
    """tests/test_dag_channels.py:132 in the port: a device edge with no
    collective group takes the shm route; values stay exact and teardown's
    STOP crosses the same channel (teardown returned)."""
    assert graphs["ray_tpu_torch"]["device_edge"] == [
        ("ndarray", "float32", 256 * 256 * i) for i in (1, 2, 5)]


# -- channels, in this process -------------------------------------------------


def _channel_pair(mod, cls, name, size=1 << 22, **kw):
    w = getattr(mod, cls)(name, size, create=True, **kw)
    return w, getattr(mod, cls)(name, size, **kw)


def _port_and_ref(module: str):
    import importlib

    return (importlib.import_module(f"ray_tpu_torch.dag.{module}"),
            importlib.import_module(f"ray_tpu.dag.{module}"))


def _roundtrip(w, r, values):
    out = []
    for v in values:
        w.write(v)
        out.append(r.read(timeout=5))
    return out


def _same(a, b):
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape and \
            np.array_equal(a, b)
    if isinstance(a, (tuple, list)):
        return type(a) is type(b) and len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.timeout(60)
def test_channel_roundtrip_matches_reference():
    values = [{"x": 1}, [1, 2, 3], ("err", "boom"), None]
    outs = []
    for k, mod in enumerate(_port_and_ref("channel")):
        w, r = _channel_pair(mod, "Channel", f"rtdag_tch1_{k}_{os.getpid()}", 1 << 20)
        try:
            outs.append(_roundtrip(w, r, values))
            with pytest.raises(TimeoutError):
                r.read(timeout=0.2)  # nothing new
        finally:
            w.close(unlink=True)
    assert outs[0] == outs[1] == values


@pytest.mark.timeout(60)
def test_tensor_channel_roundtrip_matches_reference():
    """tests/test_dag_workflow.py's TensorChannel case through both: arrays
    by raw bytes, a pickled value, the ("ok", array) wire, a 0-d array that
    keeps its shape, and a tuple headed by an array."""
    values = [np.arange(1 << 18, dtype=np.float32).reshape(512, 512), {"k": [1, 2]},
              ("ok", np.ones(4, dtype=np.int64)), np.array(3.5), (np.arange(3), "tail"),
              np.zeros((0, 3), dtype=np.int16)]
    outs = []
    for k, mod in enumerate(_port_and_ref("tensor_channel")):
        w, r = _channel_pair(mod, "TensorChannel", f"rtdag_tch2_{k}_{os.getpid()}")
        try:
            outs.append(_roundtrip(w, r, values))
        finally:
            w.close(unlink=True)
    assert _same(outs[0], outs[1]) and _same(outs[0], values)
    assert outs[0][3].shape == ()


@pytest.mark.timeout(60)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16, torch.int64,
                                   torch.bool, torch.uint8])
def test_tensor_channel_carries_torch_tensors_bitwise(dtype):
    """A CPU tensor goes by raw bytes and comes back a CPU tensor of its
    dtype (bf16 too, which numpy lacks), bitwise; so does the ("ok", tensor)
    wire, a 0-d tensor and a non-contiguous one."""
    from ray_tpu_torch.dag.tensor_channel import TensorChannel

    g = torch.Generator().manual_seed(7)
    x = (torch.randn(33, 17, generator=g) * 100).to(dtype)
    values = [x, ("ok", x), x[0, 0].clone(), x.t(), x[:0]]
    w = TensorChannel(f"rtdag_tch3_{os.getpid()}", 1 << 20, create=True)
    try:
        r = TensorChannel(w.name, 1 << 20)
        for v, got in zip(values, _roundtrip(w, r, values)):
            want = v[1] if isinstance(v, tuple) else v
            if isinstance(v, tuple):
                assert got[0] == "ok"
                got = got[1]
            assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
            assert got.dtype == want.dtype and got.shape == want.shape
            assert torch.equal(got.view(-1).view(torch.uint8) if got.numel() else got,
                               want.contiguous().view(-1).view(torch.uint8) if want.numel() else want)
    finally:
        w.close(unlink=True)


def _frame(kind: str, i: int):
    return np.full(8, float(i), np.float32) if kind == "tensor" else {"i": i}


@pytest.mark.timeout(60)
@pytest.mark.parametrize("kind", ["chan", "tensor"])
def test_sealed_empty_header_is_read_as_not_yet_written(kind):
    """A sealed header of length 0, the header a fresh segment holds (a
    compiled DAG's shm edge once parsed it as a frame and raised
    struct.error in TensorChannel._parse), is no message: the reader polls
    on and returns the frame written after it."""
    import threading

    from ray_tpu_torch.dag.channel import HEADER, make_channel

    spec = (f"rtdag_tch_empty_{kind}_{os.getpid()}", 1 << 20, kind)
    w = make_channel(spec, create=True)
    try:
        r = make_channel(spec)
        HEADER.pack_into(w._seg.view, 0, 2, 0)  # sealed sequence, empty frame
        writer = threading.Timer(0.2, w.write, (_frame(kind, 7),))
        writer.start()
        got = r.read(timeout=10)
        writer.join()
        assert _same(got, _frame(kind, 7))
        r.close()
    finally:
        w.close(unlink=True)


def _poll_each_channel(names, results) -> None:
    """Reader process: opens each channel once its name arrives, says it is
    polling, and reads one frame."""
    from ray_tpu_torch.dag.channel import make_channel

    while True:
        spec = names.get(timeout=60)
        if spec is None:
            return
        ch = make_channel(spec)
        results.put(("polling", spec[0]))
        try:
            results.put(("read", ch.read(timeout=30)))
        except BaseException as exc:  # reported to the test, which fails
            results.put(("error", f"{type(exc).__name__}: {exc}"))
        ch.close()


@pytest.mark.timeout(120)
def test_fresh_channels_read_by_a_reader_polling_before_the_first_write():
    """Many fresh channels of both kinds, each read in another process by a
    reader that is already polling when the writer makes its first write,
    half of them at once and half after a short wait: every read returns its
    channel's frame."""
    import multiprocessing as mp
    import random
    import time

    from ray_tpu_torch.dag.channel import make_channel

    ctx = mp.get_context("spawn")
    names, results = ctx.Queue(), ctx.Queue()
    reader = ctx.Process(target=_poll_each_channel, args=(names, results), daemon=True)
    reader.start()
    rng = random.Random(0)
    got = []
    try:
        for i in range(200):
            kind = ("chan", "tensor")[i % 2]
            spec = (f"rtdag_tch_fresh_{os.getpid()}_{i}", 1 << 16, kind)
            w = make_channel(spec, create=True)
            try:
                names.put(spec)
                assert results.get(timeout=60) == ("polling", spec[0])
                if i % 4 >= 2:
                    time.sleep(rng.uniform(0, 2e-3))
                w.write(_frame(kind, i))
                status, value = results.get(timeout=60)
            finally:
                w.close(unlink=True)
            assert status == "read", value
            got.append(_same(value, _frame(kind, i)))
        names.put(None)
        reader.join(timeout=30)
    finally:
        if reader.is_alive():
            reader.kill()
    assert all(got)


@pytest.mark.timeout(60)
def test_device_channel_nonarray_falls_back_to_shm():
    """STOP sentinels, dicts and error wires ride the inherited pickle path
    in every mode, in both packages alike."""
    outs = []
    for k, mod in enumerate(_port_and_ref("tensor_channel")):
        stop = __import__(mod.__name__.replace("tensor_channel", "exec_loop"),
                          fromlist=["STOP"]).STOP
        w, r = _channel_pair(mod, "DeviceTensorChannel", f"rtdag_dev3_{k}_{os.getpid()}",
                             meta={"src": 0, "dst": 2})
        try:
            outs.append(_roundtrip(w, r, [{"cfg": [1, 2]}, ("err", "boom"), stop]))
        finally:
            w.close(unlink=True)
    assert outs[0] == outs[1] == [{"cfg": [1, 2]}, ("err", "boom"), "__RT_DAG_STOP__"]


@pytest.mark.timeout(60)
def test_make_channel_dispatches_device_kind():
    for k, (chan, tc) in enumerate(zip(_port_and_ref("channel"), _port_and_ref("tensor_channel"))):
        spec = (f"rtdag_dev5_{k}_{os.getpid()}", 1 << 20, "device",
                {"group": "g1", "src": 2, "dst": 6})
        ch = chan.make_channel(spec, create=True)
        try:
            assert isinstance(ch, tc.DeviceTensorChannel)
            assert (ch.group_name, ch.src, ch.dst) == ("g1", 2, 6)
        finally:
            ch.close(unlink=True)
    # No group, no pair of cards here: the shm mode.
    ch = _port_and_ref("channel")[0].make_channel(spec, create=True)
    try:
        assert ch.mode == "shm"
    finally:
        ch.close(unlink=True)


@pytest.mark.timeout(60)
def test_device_edge_spec_kind():
    """bind() marks producer-annotated edges "device" with the group/src/dst
    meta, in both packages alike."""
    metas = []
    for pkg in ("ray_tpu_torch", "ray_tpu"):
        nodes = __import__(f"{pkg}.dag.nodes", fromlist=["ClassMethodNode"])

        class _FakeHandle:
            _actor_id = "a1"

        node = nodes.ClassMethodNode(_FakeHandle(), "m", (), {})
        node.with_tensor_transport("device", group_name="g", src=1, dst=2)
        inp = nodes.InputNode()
        inp.with_tensor_transport("device")
        metas.append((node._tensor_transport, node._transport_meta, inp._tensor_transport))
    assert metas[0] == metas[1] == ("device", {"group": "g", "src": 1, "dst": 2}, "device")


@pytest.mark.timeout(60)
def test_cuda_hop_refuses_a_tensor_off_its_source():
    """make_cuda_hop (the counterpart of make_ici_transfer) moves a tensor
    on cuda:src only; the hop itself runs in tests/test_torch_cuda.py."""
    from ray_tpu_torch.dag.tensor_channel import make_cuda_hop

    with pytest.raises(ValueError, match="cuda:0"):
        make_cuda_hop(0, 1)(torch.zeros(2))


@pytest.mark.timeout(60)
def test_method_bind_builds_a_class_method_node(cluster):
    @ray_tpu_torch.remote
    class A:
        def m(self, x):
            return x

    a = A.remote()
    node = a.m.bind(1, k=2)
    assert isinstance(node, dag.ClassMethodNode)
    assert (node.method_name, node.args, node.kwargs) == ("m", (1,), {"k": 2})
    ray_tpu_torch.kill(a)


# -- the device channel's group route between two actors ----------------------


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=8)
    yield
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote
class _End:
    """One end of a device channel, in a process of its own."""

    def join(self, rank, name):
        from ray_tpu_torch.util import collective as col

        col.init_collective_group(2, rank, backend="gloo", group_name=name)
        return col.get_group_collectives(name).device.type

    def open(self, spec):
        from ray_tpu_torch.dag.channel import make_channel

        self.ch = make_channel(spec)
        return self.ch.mode

    def write(self, value):
        self.ch.write(value)

    def read(self):
        return self.ch.read(timeout=30)

    def close(self):
        self.ch.close()


@pytest.fixture(scope="module")
def ends(cluster):
    """A writer (rank 0) and a reader (rank 1) in a gloo group."""
    w, r = _End.remote(), _End.remote()
    assert ray_tpu_torch.get([w.join.remote(0, "chan_g"), r.join.remote(1, "chan_g")],
                             timeout=60) == ["cpu", "cpu"]
    yield w, r
    for a in (w, r):
        ray_tpu_torch.kill(a)


def _open(ends, name):
    from ray_tpu_torch.dag.channel import make_channel

    spec = (f"{name}_{os.getpid()}", 1 << 22, "device", {"group": "chan_g", "src": 0, "dst": 1})
    driver_side = make_channel(spec, create=True)
    modes = ray_tpu_torch.get([e.open.remote(spec) for e in ends], timeout=30)
    return driver_side, modes


def _send(ends, value):
    w, r = ends
    got = r.read.remote()
    ray_tpu_torch.get(w.write.remote(value), timeout=30)
    return ray_tpu_torch.get(got, timeout=30)


@pytest.mark.timeout(120)
def test_device_channel_group_hop(ends):
    """Counterpart of the reference's loopback hop: both ranks of the group
    sit on this host, and a tensor of the group's device (the CPU, on
    gloo) goes by the group's send/recv, bitwise, bf16 included."""
    ch, modes = _open(ends, "rtdag_dev1")
    try:
        assert modes == ["ipc", "ipc"]  # one host; CUDA tensors would go by IPC
        x = torch.randn(64, 64, generator=torch.Generator().manual_seed(3)).to(torch.bfloat16)
        got = _send(ends, x)
        assert got.dtype == torch.bfloat16 and torch.equal(got.view(torch.int16),
                                                           x.view(torch.int16))
    finally:
        ray_tpu_torch.get([e.close.remote() for e in ends], timeout=30)
        ch.close(unlink=True)


@pytest.mark.timeout(120)
def test_device_channel_ok_wire_tuple(ends):
    """The exec-loop ("ok", value) wire survives the device route."""
    ch, _ = _open(ends, "rtdag_dev2")
    try:
        x = torch.full((16, 16), 2.5)
        kind, val = _send(ends, ("ok", x))
        assert kind == "ok" and torch.equal(val, x)
    finally:
        ray_tpu_torch.get([e.close.remote() for e in ends], timeout=30)
        ch.close(unlink=True)


@pytest.mark.timeout(120)
def test_device_channel_host_payload_degrades(ends):
    """A payload that is no device tensor (here a numpy array) takes the
    frame body, the TensorChannel wire, as the reference's cross-process
    reader does."""
    ch, _ = _open(ends, "rtdag_dev4")
    try:
        arr = np.arange(100, dtype=np.int64).reshape(10, 10)
        out = _send(ends, arr)
        assert isinstance(out, np.ndarray) and out.dtype == np.int64
        np.testing.assert_array_equal(out, arr)
    finally:
        ray_tpu_torch.get([e.close.remote() for e in ends], timeout=30)
        ch.close(unlink=True)


@pytest.mark.timeout(120)
def test_device_channel_repeated_writes(ends):
    """Repeat writes of one shape reuse the route: each read gets its own
    write's value, in order."""
    ch, _ = _open(ends, "rtdag_dev6")
    try:
        for i in range(3):
            out = _send(ends, torch.full((32, 32), float(i)))
            assert float(out[0, 0]) == float(i) and torch.all(out == float(i))
    finally:
        ray_tpu_torch.get([e.close.remote() for e in ends], timeout=30)
        ch.close(unlink=True)


@ray_tpu_torch.remote
class _Producer:
    def join(self, name):
        from ray_tpu_torch.util import collective as col

        col.init_collective_group(2, 0, backend="gloo", group_name=name)

    def make(self, seed):
        g = torch.Generator().manual_seed(seed)
        return torch.randn(128, 64, generator=g).to(torch.bfloat16)


@ray_tpu_torch.remote
class _Consumer:
    def join(self, name):
        from ray_tpu_torch.util import collective as col

        col.init_collective_group(2, 1, backend="gloo", group_name=name)

    def total(self, x):
        return str(x.dtype), x.view(torch.int16).long().sum().item()


@pytest.mark.timeout(120)
def test_compiled_dag_device_edge_on_a_gloo_group(cluster):
    """A compiled DAG whose device edge rides a gloo group: the producer's
    bf16 tensors reach the consumer bitwise for several seeds, and
    teardown's STOP crosses the same channel."""
    p, c = _Producer.remote(), _Consumer.remote()
    ray_tpu_torch.get([p.join.remote("dag_gloo"), c.join.remote("dag_gloo")], timeout=60)
    with dag.InputNode() as inp:
        graph = c.total.bind(p.make.bind(inp).with_tensor_transport(
            "device", group_name="dag_gloo", src=0, dst=1))
    compiled = graph.experimental_compile()
    try:
        for seed in (1, 2, 5):
            x = torch.randn(128, 64, generator=torch.Generator().manual_seed(seed))
            want = x.to(torch.bfloat16).view(torch.int16).long().sum().item()
            assert compiled.execute(seed).get() == ("torch.bfloat16", want)
    finally:
        compiled.teardown()
        for a in (p, c):
            ray_tpu_torch.kill(a)
