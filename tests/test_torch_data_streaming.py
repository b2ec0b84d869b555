"""The reference's tests/test_data_streaming.py on the port: the ten cases
that tests/test_torch_data.py does not already run (that file holds the
batcher's two cases, the local fast path of streaming_split(1) and the
completion-order split), case for case after the rename (ray_tpu ->
ray_tpu_torch, the conftest fixtures -> ray_tpu_torch.testing's). No case
differs.

Streaming ingest fast-path tests: metadata plumbing, bounded windows,
completion-order output, fused read->map stages and fast teardown
(reference model: python/ray/data/tests/test_streaming_*)."""

import time

import numpy as np
import pyarrow as pa

import ray_tpu_torch
import ray_tpu_torch.data as rd
from ray_tpu_torch.data import _execution as E
from ray_tpu_torch.data import block as B
from ray_tpu_torch.data.iterator import iter_blocks_pipelined
from ray_tpu_torch.testing import torch_cluster  # noqa: F401


class _SubmitSpy:
    """Record the function name of every TASK submitted through
    ray_tpu_torch.remote (actors pass through untouched)."""

    def __init__(self, monkeypatch):
        self.names = []
        orig_remote = ray_tpu_torch.remote
        spy = self

        class _Tracking:
            def __init__(self, fn_name, wrapped):
                self._fn_name = fn_name
                self._wrapped = wrapped

            def remote(self, *ta, **tk):
                spy.names.append(self._fn_name)
                return self._wrapped.remote(*ta, **tk)

            def options(self, **opts):
                return _Tracking(self._fn_name, self._wrapped.options(**opts))

        def tracking_remote(*a, **k):
            if a and callable(a[0]) and not isinstance(a[0], type):
                return _Tracking(a[0].__name__, orig_remote(*a, **k))
            if not a and k:
                # decorator-with-options form: remote(num_cpus=1)(fn_or_cls)
                def deco(obj):
                    wrapped = orig_remote(**k)(obj)
                    if isinstance(obj, type):
                        return wrapped
                    return _Tracking(obj.__name__, wrapped)

                return deco
            return orig_remote(*a, **k)

        monkeypatch.setattr(E.ray_tpu_torch, "remote", tracking_remote)

    def count(self, name):
        return sum(1 for n in self.names if n == name)


def test_metadata_rides_with_refs(torch_cluster):
    """Every stage task returns (block, meta) via num_returns=2; the meta
    matches the materialized block exactly, for map, repartition, sort and
    groupby stages alike."""
    ds = (
        rd.range(40, parallelism=4)
        .map_batches(lambda b: {"id": b["id"], "y": b["id"] * 2})
        .repartition(3)
    )
    bundles = list(ds.iter_bundles())
    assert len(bundles) == 3
    metas = E.resolve_metas(bundles)
    blocks = ray_tpu_torch.get([b.block for b in bundles])
    for meta, blk in zip(metas, blocks):
        assert meta.num_rows == blk.num_rows
        assert meta.size_bytes == blk.nbytes
    assert sum(m.num_rows for m in metas) == 40

    for ds2 in (
        rd.range(20, parallelism=3).sort("id"),
        rd.range(20, parallelism=3).groupby("id").count(),
    ):
        bundles = list(ds2.iter_bundles())
        metas = E.resolve_metas(bundles)
        blocks = ray_tpu_torch.get([b.block for b in bundles])
        for meta, blk in zip(metas, blocks):
            assert meta.num_rows == blk.num_rows


def test_resolve_metas_caches_and_batches(torch_cluster):
    """resolve_metas resolves ref-typed metas with one batched get and
    caches the concrete BlockMeta on the bundle."""
    bundles = list(rd.range(30, parallelism=3).iter_bundles())
    assert all(isinstance(b.meta, ray_tpu_torch.ObjectRef) for b in bundles)
    metas = E.resolve_metas(bundles)
    assert all(isinstance(b.meta, B.BlockMeta) for b in bundles)
    # Second resolve is a pure cache hit (no refs left to fetch).
    assert E.resolve_metas(bundles) == metas


def test_no_counter_round_trips(torch_cluster, monkeypatch):
    """Limit / zip / repartition / count dispatch on bundled metadata: the
    only tasks submitted are the data-bearing stage kernels — no per-block
    row-counting task exists anywhere in the pipeline."""
    spy = _SubmitSpy(monkeypatch)
    ds = rd.range(40, parallelism=4)
    assert ds.count() == 40
    assert ds.limit(11).count() == 11
    assert ds.repartition(3).count() == 40
    z = rd.range(8, parallelism=2).zip(
        rd.range(8, parallelism=2).map_batches(lambda b: {"o": b["id"] + 1})
    )
    assert z.count() == 8
    data_kernels = {
        "_exec_read",
        "_exec_map",
        "_slice_concat",
        "_zip_tables",
        "_partition_block",
        "_merge_sort",
        "_merge_shuffle",
        "_merge_groupby",
        "_sample_block",
    }
    assert spy.names, "spy saw no submissions"
    assert set(spy.names) <= data_kernels, set(spy.names) - data_kernels


def test_bounded_in_flight_submissions(torch_cluster, monkeypatch):
    """Pulling one block from a 64-task read submits O(parallelism) tasks,
    not the whole stage (backpressure reaches the submit window)."""
    spy = _SubmitSpy(monkeypatch)
    ds = rd.range(64, parallelism=64)
    ex = E.StreamingExecutor(4)
    it = ex.execute(ds._ops)
    next(it)
    assert 0 < spy.count("_exec_read") <= 2 * 4 + 1, spy.count("_exec_read")
    it.close()  # teardown; remaining tasks never submit
    assert spy.count("_exec_read") <= 2 * 4 + 2


def test_completion_order_yields_all_blocks(torch_cluster):
    """preserve_order=False yields every block exactly once, a slow first
    task does not stall later blocks, and preserve_order=True keeps
    submission order."""

    def make_ops(sleep_first):
        def synth(b):
            if sleep_first and int(np.asarray(b["id"]).reshape(-1)[0]) == 0:
                time.sleep(2.0)
            return {"id": b["id"]}

        return rd.range(8, parallelism=8).map_batches(synth, batch_size=1)._ops

    # Warm the worker pool so spawn latency doesn't mask completion order.
    assert rd.range(8, parallelism=8).count() == 8

    ex = E.StreamingExecutor(8, preserve_order=False)
    t0 = time.perf_counter()
    got = []
    first_yield_at = None
    for bundle in ex.execute(make_ops(sleep_first=True)):
        if first_yield_at is None:
            first_yield_at = time.perf_counter() - t0
        got.extend(ray_tpu_torch.get(bundle.block).column("id").to_pylist())
    assert sorted(got) == list(range(8))
    # The straggler (block 0, sleeping 2s) was NOT the first block out —
    # a finished block jumped the queue well before the straggler was done.
    assert got[0] != 0, got
    assert first_yield_at < 1.9, first_yield_at

    ex = E.StreamingExecutor(8, preserve_order=True)
    ordered = []
    for bundle in ex.execute(make_ops(sleep_first=False)):
        ordered.extend(ray_tpu_torch.get(bundle.block).column("id").to_pylist())
    assert ordered == list(range(8))


def test_read_map_fusion():
    """A task-pool MapBlocks directly after Read folds INTO the read task:
    one fused stage, no intermediate block."""
    ds = rd.range(8, parallelism=2).map_batches(lambda b: {"y": b["id"] * 3})
    fused = E._fuse_maps(list(ds._ops))
    assert len(fused) == 1
    assert isinstance(fused[0], E.Read)
    assert "MapBatches" in fused[0].name
    out = fused[0].read_tasks[0]()
    assert out.column("y").to_pylist() == [0, 3, 6, 9]
    # Actor-pool stages must NOT fuse (they need the pool).
    ds2 = rd.range(8, parallelism=2).map_batches(
        type("U", (), {"__call__": lambda self, b: b}), concurrency=1
    )
    fused2 = E._fuse_maps(list(ds2._ops))
    assert len(fused2) == 2


def _tables(*row_counts):
    out = []
    base = 0
    for n in row_counts:
        out.append(pa.table({"v": list(range(base, base + n))}))
        base += n
    return out


def test_iter_blocks_pipelined_order_and_close(torch_cluster):
    refs = [ray_tpu_torch.put(t) for t in _tables(2, 3, 4, 1)]
    closed = []

    def ref_gen():
        try:
            yield from refs
        finally:
            closed.append(True)

    got = list(iter_blocks_pipelined(ref_gen(), lookahead=3))
    assert [t.num_rows for t in got] == [2, 3, 4, 1]
    assert closed == [True]
    # Abandonment also closes the source generator.
    closed.clear()
    it = iter_blocks_pipelined(ref_gen(), lookahead=3)
    next(it)
    it.close()
    assert closed == [True]


def test_streaming_split_single_shipped_to_task(torch_cluster):
    """A fast-path DataIterator survives ray serialization as a task arg:
    the receiving worker drives the execution itself."""
    (it,) = rd.range(12, parallelism=3).streaming_split(1)

    @ray_tpu_torch.remote
    def consume(shard):
        return sorted(
            v for b in shard.iter_batches(batch_size=4) for v in b["id"]
        )

    assert ray_tpu_torch.get(consume.remote(it), timeout=120) == list(range(12))


def test_abandoned_actor_stage_teardown_is_fast(torch_cluster):
    """Breaking out of iteration over an actor-pool stage cancels the
    undelivered window instead of riding it out: teardown completes far
    sooner than executing every remaining (slow) block would take."""

    class SlowUdf:
        def __call__(self, batch):
            time.sleep(0.5)
            return batch

    ds = rd.range(16, parallelism=16).map_batches(
        SlowUdf, concurrency=1, batch_size=None
    )
    it = ds.iter_batches(batch_size=None, prefetch_batches=0)
    next(it)
    t0 = time.perf_counter()
    it.close()  # abandon: 14+ blocks never delivered
    dt = time.perf_counter() - t0
    # Riding out the remaining blocks serially would cost >= 5s; the
    # cancel-or-seal teardown only waits for the in-flight window.
    assert dt < 4.0, f"teardown took {dt:.1f}s"


def _family_total(family):
    return sum(c.v for c in family._cells.values())


def test_ingest_telemetry_counters_move(torch_cluster):
    before_blocks = _family_total(E._BLOCKS_PRODUCED)
    before_resolves = _family_total(E._META_RESOLVES)
    ds = rd.range(32, parallelism=4)
    assert ds.count() == 32
    list(ds.iter_batches(batch_size=8))
    assert _family_total(E._BLOCKS_PRODUCED) > before_blocks
    assert _family_total(E._META_RESOLVES) > before_resolves
