"""The reference's core runtime suites on the port: tests/test_basic.py
(tasks, objects, errors), tests/test_actor.py (actors) and
tests/test_core_extras.py (cancel, dynamic and streaming generators,
ActorPool, a CPU TorchTrainer, the pull manager and ids) run on
ray_tpu_torch's runtime, case for case after the rename. The extras' queue
case is in tests/test_torch_workflow.py. The port's trainer asks for a GPU
per worker unless told otherwise, so its DDP case passes use_gpu=False."""

import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.testing import torch_cluster  # noqa: F401


# ----------------------------------------------------------------------
# test_basic.py

def test_put_get(torch_cluster):
    ref = ray_tpu_torch.put(42)
    assert ray_tpu_torch.get(ref) == 42


def test_put_get_large_numpy(torch_cluster):
    arr = np.arange(1_000_000, dtype=np.float32)  # 4 MB -> shm path
    ref = ray_tpu_torch.put(arr)
    out = ray_tpu_torch.get(ref)
    np.testing.assert_array_equal(arr, out)


def test_simple_task(torch_cluster):
    @ray_tpu_torch.remote
    def f(x):
        return x + 1

    assert ray_tpu_torch.get(f.remote(1)) == 2


def test_task_with_ref_arg(torch_cluster):
    @ray_tpu_torch.remote
    def f(x):
        return x * 2

    ref = ray_tpu_torch.put(21)
    assert ray_tpu_torch.get(f.remote(ref)) == 42


def test_chained_tasks(torch_cluster):
    @ray_tpu_torch.remote
    def inc(x):
        return x + 1

    ref = inc.remote(0)
    for _ in range(4):
        ref = inc.remote(ref)
    assert ray_tpu_torch.get(ref) == 5


def test_many_parallel_tasks(torch_cluster):
    @ray_tpu_torch.remote
    def f(i):
        return i * i

    refs = [f.remote(i) for i in range(20)]
    assert ray_tpu_torch.get(refs) == [i * i for i in range(20)]


def test_multiple_returns(torch_cluster):
    @ray_tpu_torch.remote(num_returns=3)
    def f():
        return 1, 2, 3

    a, b, c = f.remote()
    assert ray_tpu_torch.get([a, b, c]) == [1, 2, 3]


def test_task_error_propagates(torch_cluster):
    @ray_tpu_torch.remote(max_retries=0)
    def boom():
        raise ValueError("broken")

    with pytest.raises(ValueError, match="broken"):
        ray_tpu_torch.get(boom.remote())


def test_large_task_result(torch_cluster):
    @ray_tpu_torch.remote
    def make():
        return np.ones((512, 1024), dtype=np.float32)  # 2 MB

    out = ray_tpu_torch.get(make.remote())
    assert out.shape == (512, 1024)
    assert out.dtype == np.float32


def test_large_task_arg(torch_cluster):
    @ray_tpu_torch.remote
    def total(x):
        return float(x.sum())

    arr = np.ones(500_000, dtype=np.float64)
    assert ray_tpu_torch.get(total.remote(arr)) == 500_000.0


def test_wait(torch_cluster):
    @ray_tpu_torch.remote
    def fast():
        return "fast"

    @ray_tpu_torch.remote
    def slow():
        time.sleep(5)
        return "slow"

    # Warm the worker pool so cold-start latency can't eat the wait window.
    assert ray_tpu_torch.get(fast.remote()) == "fast"

    f, s = fast.remote(), slow.remote()
    ready, not_ready = ray_tpu_torch.wait([f, s], num_returns=1, timeout=4)
    assert ready == [f]
    assert not_ready == [s]


def test_get_timeout(torch_cluster):
    @ray_tpu_torch.remote
    def slow():
        time.sleep(10)

    with pytest.raises(ray_tpu_torch.GetTimeoutError):
        ray_tpu_torch.get(slow.remote(), timeout=1)


def test_nested_tasks(torch_cluster):
    @ray_tpu_torch.remote
    def inner(x):
        return x + 1

    @ray_tpu_torch.remote
    def outer(x):
        return ray_tpu_torch.get(inner.remote(x)) + 10

    assert ray_tpu_torch.get(outer.remote(0)) == 11


def test_kwargs_and_defaults(torch_cluster):
    @ray_tpu_torch.remote
    def f(a, b=10, *, c=100):
        return a + b + c

    assert ray_tpu_torch.get(f.remote(1)) == 111
    assert ray_tpu_torch.get(f.remote(1, b=2, c=3)) == 6


def test_nested_object_ref_passthrough(torch_cluster):
    @ray_tpu_torch.remote
    def identity(d):
        # Nested refs arrive as refs, not values (reference semantics).
        assert isinstance(d["ref"], ray_tpu_torch.ObjectRef)
        return ray_tpu_torch.get(d["ref"])

    inner_ref = ray_tpu_torch.put(7)
    assert ray_tpu_torch.get(identity.remote({"ref": inner_ref})) == 7


def test_cluster_resources(torch_cluster):
    res = ray_tpu_torch.cluster_resources()
    assert res.get("CPU") == 4.0


# ----------------------------------------------------------------------
# test_actor.py

def test_basic_actor(torch_cluster):
    @ray_tpu_torch.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def inc(self):
            self.n += 1
            return self.n

        def value(self):
            return self.n

    c = Counter.remote()
    assert ray_tpu_torch.get(c.inc.remote()) == 1
    assert ray_tpu_torch.get(c.inc.remote()) == 2
    assert ray_tpu_torch.get(c.value.remote()) == 2


def test_actor_ordering(torch_cluster):
    @ray_tpu_torch.remote
    class Log:
        def __init__(self):
            self.items = []

        def add(self, x):
            self.items.append(x)

        def items_(self):
            return self.items

    log = Log.remote()
    for i in range(30):
        log.add.remote(i)
    assert ray_tpu_torch.get(log.items_.remote()) == list(range(30))


def test_actor_constructor_args(torch_cluster):
    @ray_tpu_torch.remote
    class A:
        def __init__(self, a, b=2):
            self.v = a + b

        def get(self):
            return self.v

    a = A.remote(1, b=10)
    assert ray_tpu_torch.get(a.get.remote()) == 11


def test_actor_error(torch_cluster):
    @ray_tpu_torch.remote
    class A:
        def boom(self):
            raise RuntimeError("actor error")

        def ok(self):
            return "fine"

    a = A.remote()
    with pytest.raises(RuntimeError, match="actor error"):
        ray_tpu_torch.get(a.boom.remote())
    # Actor survives method errors.
    assert ray_tpu_torch.get(a.ok.remote()) == "fine"


def test_named_actor(torch_cluster):
    @ray_tpu_torch.remote
    class A:
        def hello(self):
            return "world"

    A.options(name="singleton").remote()
    h = ray_tpu_torch.get_actor("singleton")
    assert ray_tpu_torch.get(h.hello.remote()) == "world"


def test_get_if_exists(torch_cluster):
    @ray_tpu_torch.remote
    class A:
        def __init__(self):
            self.t = time.time()

        def created(self):
            return self.t

    a1 = A.options(name="shared", get_if_exists=True).remote()
    t1 = ray_tpu_torch.get(a1.created.remote())
    a2 = A.options(name="shared", get_if_exists=True).remote()
    t2 = ray_tpu_torch.get(a2.created.remote())
    assert t1 == t2  # same instance


def test_actor_handle_in_task(torch_cluster):
    @ray_tpu_torch.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def inc(self):
            self.n += 1
            return self.n

    @ray_tpu_torch.remote
    def bump(counter):
        return ray_tpu_torch.get(counter.inc.remote())

    c = Counter.remote()
    assert ray_tpu_torch.get(bump.remote(c)) == 1
    assert ray_tpu_torch.get(c.inc.remote()) == 2


def test_kill_actor(torch_cluster):
    @ray_tpu_torch.remote
    class A:
        def ping(self):
            return "pong"

    a = A.remote()
    assert ray_tpu_torch.get(a.ping.remote()) == "pong"
    ray_tpu_torch.kill(a)
    time.sleep(0.5)
    with pytest.raises((ray_tpu_torch.ActorDiedError, ray_tpu_torch.RayTpuError)):
        ray_tpu_torch.get(a.ping.remote(), timeout=10)


def test_actor_restart(torch_cluster):
    @ray_tpu_torch.remote(max_restarts=1)
    class Flaky:
        def __init__(self):
            self.n = 0

        def inc(self):
            self.n += 1
            return self.n

        def die(self):
            import os

            os._exit(1)

    f = Flaky.remote()
    assert ray_tpu_torch.get(f.inc.remote()) == 1
    f.die.remote()
    time.sleep(1.0)
    # After restart, state is fresh (reconstructed from __init__).
    for _ in range(50):
        try:
            v = ray_tpu_torch.get(f.inc.remote(), timeout=30)
            break
        except ray_tpu_torch.RayTpuError:
            time.sleep(0.2)
    assert v == 1


def test_async_actor(torch_cluster):
    @ray_tpu_torch.remote
    class AsyncActor:
        async def work(self, x):
            import asyncio

            await asyncio.sleep(0.05)
            return x * 2

    a = AsyncActor.remote()
    refs = [a.work.remote(i) for i in range(5)]
    assert ray_tpu_torch.get(refs) == [0, 2, 4, 6, 8]


def test_max_concurrency(torch_cluster):
    @ray_tpu_torch.remote(max_concurrency=4)
    class Slow:
        def work(self):
            time.sleep(0.5)
            return 1

    s = Slow.remote()
    ray_tpu_torch.get(s.work.remote())  # warm up: actor spawn excluded from timing
    start = time.time()
    ray_tpu_torch.get([s.work.remote() for _ in range(4)])
    elapsed = time.time() - start
    assert elapsed < 1.9, f"expected concurrent execution, took {elapsed:.2f}s"


def test_actor_large_state_roundtrip(torch_cluster):
    import numpy as np

    @ray_tpu_torch.remote
    class Store:
        def __init__(self):
            self.data = None

        def set(self, x):
            self.data = x
            return x.nbytes

        def get(self):
            return self.data

    s = Store.remote()
    arr = np.random.rand(500, 500)  # 2 MB
    assert ray_tpu_torch.get(s.set.remote(arr)) == arr.nbytes
    out = ray_tpu_torch.get(s.get.remote())
    np.testing.assert_array_equal(arr, out)


def test_concurrency_groups(torch_cluster):
    """Per-method concurrency groups: calls in different groups never block
    each other; a group's limit bounds its concurrency (reference:
    transport/concurrency_group_manager.cc)."""
    import time as _time

    import ray_tpu_torch

    @ray_tpu_torch.remote(concurrency_groups={"io": 1, "compute": 2})
    class Grouped:
        def __init__(self):
            self.active_compute = 0
            self.peak_compute = 0

        def block_io(self):
            _time.sleep(3.0)
            return "io-done"

        def compute(self):
            self.active_compute += 1
            self.peak_compute = max(self.peak_compute, self.active_compute)
            _time.sleep(0.3)
            self.active_compute -= 1
            return "c-done"

        def peak(self):
            return self.peak_compute

    g = Grouped.remote()
    ray_tpu_torch.get(g.peak.remote())  # actor fully started before timing
    t0 = _time.monotonic()
    io_ref = g.block_io.options(concurrency_group="io").remote()
    # Compute calls must finish while the io group is still blocked.
    outs = ray_tpu_torch.get(
        [g.compute.options(concurrency_group="compute").remote() for _ in range(4)],
        timeout=30,
    )
    compute_done = _time.monotonic() - t0
    assert outs == ["c-done"] * 4
    assert compute_done < 2.5, f"compute blocked behind io group ({compute_done:.1f}s)"
    assert ray_tpu_torch.get(io_ref, timeout=30) == "io-done"
    # Group limit 2: never more than 2 compute calls in flight.
    assert ray_tpu_torch.get(g.peak.remote(), timeout=30) <= 2


# ----------------------------------------------------------------------
# test_core_extras.py

def test_cancel_running_task(torch_cluster):
    import ray_tpu_torch

    @ray_tpu_torch.remote
    def spin(seconds):
        # Pure-Python loop: interruptible by PyThreadState_SetAsyncExc.
        deadline = time.monotonic() + seconds
        x = 0
        while time.monotonic() < deadline:
            x += 1
        return x

    ref = spin.remote(60)
    time.sleep(2)  # let it start
    ray_tpu_torch.cancel(ref)
    with pytest.raises(ray_tpu_torch.TaskCancelledError):
        ray_tpu_torch.get(ref, timeout=30)


def test_cancel_queued_task(torch_cluster):
    import ray_tpu_torch

    @ray_tpu_torch.remote(num_cpus=4)
    def hog():
        time.sleep(8)
        return "hog"

    @ray_tpu_torch.remote(num_cpus=4)
    def queued():
        return "ran"

    h = hog.remote()
    time.sleep(0.5)
    q = queued.remote()  # cannot start: hog holds all CPUs
    ray_tpu_torch.cancel(q)
    with pytest.raises(ray_tpu_torch.TaskCancelledError):
        ray_tpu_torch.get(q, timeout=30)
    assert ray_tpu_torch.get(h, timeout=30) == "hog"


def test_dynamic_generators(torch_cluster):
    import ray_tpu_torch

    @ray_tpu_torch.remote(num_returns="dynamic")
    def gen(n):
        for i in range(n):
            yield i * i

    ref = gen.remote(5)
    dyn = ray_tpu_torch.get(ref)
    assert isinstance(dyn, ray_tpu_torch.ObjectRefGenerator)
    assert len(dyn) == 5
    assert [ray_tpu_torch.get(r) for r in dyn] == [0, 1, 4, 9, 16]


def test_dynamic_generator_large_items(torch_cluster):
    import ray_tpu_torch

    @ray_tpu_torch.remote(num_returns="dynamic")
    def gen():
        for i in range(3):
            yield np.full((256, 256), i)  # 0.5MB each -> plasma path

    refs = list(ray_tpu_torch.get(gen.remote()))
    for i, r in enumerate(refs):
        np.testing.assert_array_equal(ray_tpu_torch.get(r), np.full((256, 256), i))


def test_actor_pool(torch_cluster):
    import ray_tpu_torch
    from ray_tpu_torch.util import ActorPool

    @ray_tpu_torch.remote
    class Worker:
        def double(self, x):
            return x * 2

    pool = ActorPool([Worker.remote() for _ in range(2)])
    results = list(pool.map(lambda a, v: a.double.remote(v), range(8)))
    assert results == [0, 2, 4, 6, 8, 10, 12, 14]
    unordered = sorted(
        pool.map_unordered(lambda a, v: a.double.remote(v), range(8))
    )
    assert unordered == [0, 2, 4, 6, 8, 10, 12, 14]



def test_torch_trainer_ddp(torch_cluster):
    from ray_tpu_torch.air import ScalingConfig
    from ray_tpu_torch.train.torch import TorchTrainer

    def train_fn(config):
        import torch
        import torch.distributed as dist
        from torch import nn

        import ray_tpu_torch.train as train
        from ray_tpu_torch.train.torch import prepare_model

        assert dist.is_initialized() and dist.get_world_size() == 2
        rank = dist.get_rank()

        model = prepare_model(nn.Linear(4, 1))
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        torch.manual_seed(0)
        X = torch.randn(64, 4)
        y = X.sum(dim=1, keepdim=True)
        for _ in range(config["epochs"]):
            opt.zero_grad()
            loss = ((model(X) - y) ** 2).mean()
            loss.backward()  # DDP allreduces grads here
            opt.step()
        # Gradient sync means identical weights on every rank.
        w = model.module.weight.detach().clone()
        gathered = [torch.zeros_like(w) for _ in range(2)]
        dist.all_gather(gathered, w)
        assert torch.allclose(gathered[0], gathered[1])
        train.report({"loss": float(loss), "rank": rank})

    trainer = TorchTrainer(
        train_fn,
        train_loop_config={"epochs": 20},
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
    )
    result = trainer.fit()
    assert result.metrics["loss"] < 1.0


def test_streaming_generator_overlaps_producer(torch_cluster):
    """Consumer receives early items while the producer is still yielding
    (reference: ReportGeneratorItemReturns streaming)."""
    import time as _time

    import ray_tpu_torch

    @ray_tpu_torch.remote
    def warm():
        return 1

    @ray_tpu_torch.remote(num_returns="dynamic")
    def slow_gen():
        for i in range(4):
            yield i
            _time.sleep(0.8)

    ray_tpu_torch.get(warm.remote())  # spawn the worker outside the timed window

    t0 = _time.monotonic()
    gen = ray_tpu_torch.get(slow_gen.remote(), timeout=30)
    it = iter(gen)
    first = ray_tpu_torch.get(next(it))
    first_latency = _time.monotonic() - t0
    assert first == 0
    # The full run takes >= 3*0.8s; getting item 0 must not wait for it.
    assert first_latency < 2.0, f"first item took {first_latency:.1f}s (not streamed)"
    rest = [ray_tpu_torch.get(r) for r in it]
    assert rest == [1, 2, 3]


def test_streaming_generator_borrowed(torch_cluster):
    """A generator handle passed to another process iterates via the owner
    (DynNext long-poll)."""
    import ray_tpu_torch

    @ray_tpu_torch.remote(num_returns="dynamic")
    def gen():
        for i in range(3):
            yield i * 10

    @ray_tpu_torch.remote
    def consume(g):
        return [ray_tpu_torch.get(r) for r in g]

    g = ray_tpu_torch.get(gen.remote(), timeout=30)
    assert ray_tpu_torch.get(consume.remote(g), timeout=60) == [0, 10, 20]


def test_streaming_generator_failure_propagates(torch_cluster):
    """A generator that raises mid-stream terminates iteration with the
    task's error instead of hanging consumers."""
    import ray_tpu_torch

    @ray_tpu_torch.remote(num_returns="dynamic", max_retries=0)
    def bad_gen():
        yield 1
        raise ValueError("boom-mid-stream")

    gen = ray_tpu_torch.get(bad_gen.remote(), timeout=30)
    it = iter(gen)
    assert ray_tpu_torch.get(next(it), timeout=30) == 1
    with pytest.raises(Exception) as ei:
        ray_tpu_torch.get(next(it), timeout=30)
    assert "boom-mid-stream" in str(ei.value)


def test_streaming_generator_failure_read_after_the_producer_failed(torch_cluster):
    """The same stream, read only once its task has failed (the driver's
    list_tasks shows FAILED): the get still returns the generator, its item
    is readable and the next one raises the task's error. The error used to
    replace the published generator, so the get raised at once (ray_tpu's
    does)."""
    import ray_tpu_torch
    from ray_tpu_torch.util.state import list_tasks

    @ray_tpu_torch.remote(num_returns="dynamic", max_retries=0)
    def bad_gen_late():
        yield 1
        raise ValueError("boom-mid-stream")

    ref = bad_gen_late.remote()
    deadline = time.monotonic() + 30
    while not any(r["name"] == "bad_gen_late" and r["state"] == "FAILED" for r in list_tasks()):
        assert time.monotonic() < deadline, "the producer never failed"
        time.sleep(0.1)
    it = iter(ray_tpu_torch.get(ref, timeout=30))
    assert ray_tpu_torch.get(next(it), timeout=30) == 1
    with pytest.raises(Exception) as ei:
        ray_tpu_torch.get(next(it), timeout=30)
    assert "boom-mid-stream" in str(ei.value)


def test_pull_manager_priority_and_quota():
    """Prioritized bandwidth-capped pull admission (reference:
    object_manager/pull_manager.h): quota bounds bytes in flight, a
    head-of-line oversized pull is never deadlocked, and gets outrank
    task-arg prefetches regardless of arrival order."""
    import asyncio

    from ray_tpu_torch._private.pull_manager import PullManager

    async def scenario():
        pm = PullManager(100)
        order = []

        await pm.acquire(60, "get")       # admitted: 60 in flight
        await pm.acquire(30, "task_arg")  # admitted: 90 in flight

        async def queued(size, purpose, tag):
            await pm.acquire(size, purpose)
            order.append(tag)

        # Over quota now: these queue. task_arg arrives FIRST but the get
        # and wait must be admitted before it.
        t1 = asyncio.ensure_future(queued(50, "task_arg", "arg"))
        await asyncio.sleep(0.01)
        t2 = asyncio.ensure_future(queued(50, "get", "get"))
        t3 = asyncio.ensure_future(queued(50, "wait", "wait"))
        await asyncio.sleep(0.01)
        assert order == []
        assert pm.stats()["queued_pulls"] == 3

        pm.release(60)  # 30 in flight; head (get, 50) fits -> 80
        await asyncio.sleep(0.01)
        assert order == ["get"]
        pm.release(30)  # 50 in flight; wait (50) fits -> 100; arg must wait
        await asyncio.sleep(0.01)
        assert order == ["get", "wait"]
        pm.release(50)
        pm.release(50)
        await asyncio.sleep(0.01)
        assert order == ["get", "wait", "arg"]
        await asyncio.gather(t1, t2, t3)
        pm.release(50)  # the admitted task_arg pull finishes too

        # Oversized head-of-line pull: admitted alone rather than deadlocked.
        await pm.acquire(1000, "get")
        assert pm.stats()["bytes_in_flight"] == 1000
        pm.release(1000)
        assert pm.stats() == {
            "bytes_in_flight": 0, "active_pulls": 0, "queued_pulls": 0,
            "stalled_streams": 0, "rerequested_streams": 0,
            "restore_fallbacks": 0,
        }

    asyncio.run(scenario())


def test_fast_id_state_reseeds_after_fork():
    """Forked workers must not inherit the zygote's fast-id stream: shared
    prefix + counter makes two workers draw identical task ids, whose
    deterministic return-object ids then alias in the object store (the
    second task's output silently becomes the first task's bytes)."""
    import os

    from ray_tpu_torch._private import ids

    r, w = os.pipe()
    pid = os.fork()
    if pid == 0:  # child
        try:
            os.write(w, ids.fast_unique_hex().encode())
        finally:
            os._exit(0)
    os.close(w)
    _, status = os.waitpid(pid, 0)
    assert status == 0
    child = os.read(r, 64).decode()
    os.close(r)
    parent = ids.fast_unique_hex()
    assert len(child) == 32 and len(parent) == 32
    # The 20-hex-char random prefix must differ post-fork (1 in 16^20
    # chance of a false pass by collision).
    assert child[:20] != parent[:20]
