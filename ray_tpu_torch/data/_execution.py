"""Logical ops + streaming execution (reference: python/ray/data/_internal —
logical/interfaces/logical_operator.py, execution/streaming_executor.py:48,
execution/operators/*).

Execution model: each stage is a generator over RefBundles — a block
ObjectRef paired with its BlockMeta (num_rows/size_bytes), returned by the
stage task itself via ``num_returns=2`` — with a bounded in-flight window:
downstream pulling makes upstream submit, so the whole pipeline streams with
backpressure, like the reference's pull-based StreamingExecutor. Because
metadata rides alongside every ref, Limit/Zip/Repartition dispatch on a
batched inline-object get instead of submitting counter tasks per block.

Output order: stages hand refs downstream in submission order (a task's
output ref is a valid task arg before the task finishes, so interior stages
never wait). The FINAL output is resequenced by completion when
``preserve_order=False`` — a ``ray_tpu_torch.wait``-driven bounded window yields
whichever block materializes first, so one slow read task no longer stalls
the consumer behind head-of-line blocking. ``preserve_order=True`` (the
default, and what Dataset-level iteration uses) keeps submission order.

Map-chains are fused into one task per block, and a task-pool MapBlocks
following a Read fuses INTO the read task (reference: operator fusion in
plan optimization) so a read->map->filter pipeline costs one task and one
object-store round trip per block.
"""

from __future__ import annotations

import collections
import itertools
import random
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator, List, Optional, Tuple

import numpy as np
import pyarrow as pa

import ray_tpu_torch
from ray_tpu_torch import ObjectRef
from ray_tpu_torch._private import telemetry
from ray_tpu_torch.data import block as B

# -- telemetry (docs/observability.md: component "data") ---------------------

_BLOCKS_PRODUCED = telemetry.counter(
    "data", "blocks_produced", "blocks yielded per stage"
)
_BYTES_PRODUCED = telemetry.counter(
    "data", "bytes_produced", "block bytes yielded per stage (where metadata "
    "is resolved driver-side; fetch-path bytes are data.bytes_fetched)"
)
_META_RESOLVES = telemetry.counter(
    "data", "meta_resolves", "batched metadata gets (replaces counter tasks)"
)
_TEARDOWN_CANCELS = telemetry.counter(
    "data", "teardown_cancelled_refs", "undelivered actor-stage refs "
    "cancelled instead of awaited at teardown"
)

# -- logical ops -------------------------------------------------------------


@dataclass
class LogicalOp:
    pass


@dataclass
class Read(LogicalOp):
    """Each read_task() -> pa.Table; one task per input partition."""

    read_tasks: List[Callable[[], pa.Table]] = field(default_factory=list)
    name: str = "Read"


@dataclass
class FromBlocks(LogicalOp):
    blocks: List[pa.Table] = field(default_factory=list)


@dataclass
class MapBlocks(LogicalOp):
    """fn(pa.Table) -> pa.Table. Covers map/filter/flat_map/map_batches."""

    fn: Callable[[pa.Table], pa.Table] = None
    name: str = "Map"
    # Class-based UDF → actor pool (reference: ActorPoolMapOperator).
    actor_cls: Optional[bytes] = None  # cloudpickled class
    actor_args: Tuple = ()
    pool_size: int = 2


@dataclass
class Limit(LogicalOp):
    n: int = 0


@dataclass
class Union(LogicalOp):
    others: List[List[LogicalOp]] = field(default_factory=list)


@dataclass
class Zip(LogicalOp):
    other: List[LogicalOp] = field(default_factory=list)


@dataclass
class Repartition(LogicalOp):
    num_blocks: int = 1


@dataclass
class Sort(LogicalOp):
    key: str = ""
    descending: bool = False


@dataclass
class RandomShuffle(LogicalOp):
    seed: Optional[int] = None


@dataclass
class GroupByAgg(LogicalOp):
    key: str = ""
    aggs: List[Tuple[str, str]] = field(default_factory=list)  # (col, fn)


# -- ref bundles -------------------------------------------------------------


class RefBundle:
    """One block ObjectRef plus its metadata (reference: RefBundle in
    execution/interfaces/ref_bundle.py). ``meta`` is either a concrete
    BlockMeta (known driver-side, e.g. FromBlocks) or the ObjectRef of the
    task's second return value."""

    __slots__ = ("block", "meta")

    def __init__(self, block, meta):
        self.block = block
        self.meta = meta


def _from_returns(refs) -> RefBundle:
    """Bundle a ``num_returns=2`` task's [block_ref, meta_ref] pair."""
    return RefBundle(refs[0], refs[1])


def resolve_metas(bundles: List[RefBundle]) -> List[B.BlockMeta]:
    """Resolve every bundle's metadata with ONE batched get for the ref-typed
    ones (tiny inline objects — no task submissions, no block fetches)."""
    ref_idx = [i for i, b in enumerate(bundles) if isinstance(b.meta, ObjectRef)]
    out: List[Any] = [b.meta for b in bundles]
    if ref_idx:
        fetched = ray_tpu_torch.get([bundles[i].meta for i in ref_idx])
        for i, m in zip(ref_idx, fetched):
            out[i] = m
            bundles[i].meta = m  # cache: later stages reuse without a get
        _META_RESOLVES.inc()
    return out


# -- remote kernels ----------------------------------------------------------


def _remote(fn, **opts):
    return ray_tpu_torch.remote(**{"num_cpus": 1, **opts})(fn)


def _with_meta(table: pa.Table):
    return table, B.meta_for(table)


def _exec_read(task_blob):
    import cloudpickle

    return _with_meta(cloudpickle.loads(task_blob)())


def _exec_map(fn_blob, table):
    import cloudpickle

    return _with_meta(cloudpickle.loads(fn_blob)(table))


def _slice_concat(ranges, *tables):
    """ranges: list of (table_idx, start, end) over the varargs tables.

    Block refs ride as top-level varargs because only top-level ObjectRef
    args are resolved to values before execution (same contract as the
    reference's task arg resolution)."""
    from ray_tpu_torch.data import block as B

    return _with_meta(
        B.concat_blocks([B.slice_block(tables[i], s, e) for i, s, e in ranges])
    )


def _partition_block(table, key, n, seed, boundaries):
    from ray_tpu_torch.data import block as B

    if boundaries is not None:
        return tuple(B.range_partition_block(table, key, boundaries))
    return tuple(B.hash_partition_block(table, key, n, seed))


def _merge_sort(key, descending, *parts):
    from ray_tpu_torch.data import block as B

    return _with_meta(B.sort_block(B.concat_blocks(list(parts)), key, descending))


def _merge_shuffle(seed, *parts):
    from ray_tpu_torch.data import block as B

    merged = B.concat_blocks(list(parts))
    if merged.num_rows == 0:
        return _with_meta(merged)
    rng = np.random.RandomState(seed)
    return _with_meta(merged.take(pa.array(rng.permutation(merged.num_rows))))


def _merge_groupby(key, aggs, *parts):
    from ray_tpu_torch.data import block as B

    merged = B.concat_blocks(list(parts))
    if merged.num_rows == 0:
        return _with_meta(merged)
    agg_specs = [(col, fn) for col, fn in aggs]
    return _with_meta(merged.group_by(key).aggregate(agg_specs))


def _sample_block(table, key, k, seed):
    if table.num_rows == 0:
        return []
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, table.num_rows, size=min(k, table.num_rows))
    return table.take(pa.array(idx)).column(key).to_pylist()


class _MapActor:
    """Actor-pool worker hosting a stateful UDF instance
    (reference: _MapWorker in actor_pool_map_operator.py)."""

    def __init__(self, cls_blob, ctor_args):
        import cloudpickle

        self.udf = cloudpickle.loads(cls_blob)(*ctor_args)

    def apply(self, wrapper_blob, table):
        import cloudpickle

        return _with_meta(cloudpickle.loads(wrapper_blob)(self.udf, table))


# -- the executor ------------------------------------------------------------


class StreamingExecutor:
    def __init__(self, parallelism: int = 8, preserve_order: bool = True):
        self.parallelism = parallelism
        self.preserve_order = preserve_order
        self._actor_pools: List[List[Any]] = []
        # Trailing window of actor-stage outputs that were handed DOWNSTREAM
        # (a later stage may have consumed them as task args, or the
        # consumer may be fetching them): only these need sealing before the
        # pool dies. Bounded so teardown never pins a whole stage output.
        self._actor_stage_refs: collections.deque = collections.deque(
            maxlen=2 * parallelism + 8
        )
        # Actor-stage outputs submitted but NOT yet handed downstream: no
        # other task depends on them and the consumer has never seen them,
        # so teardown cancels instead of awaiting (the abandoned-iteration
        # fast path — see _teardown_pools).
        self._actor_refs_pending: dict = {}

    # Each stage: Iterator[RefBundle] -> Iterator[RefBundle]

    def execute(self, ops: List[LogicalOp]) -> Iterator[RefBundle]:
        """Yields RefBundles for the fully-applied plan."""
        from ray_tpu_torch.util import tracing

        try:
            it = self._build(ops)
            if not self.preserve_order:
                it = self._completion_order(it)
            # One span over the whole streamed execution, active while the
            # stage pumps run: every stage task submitted inside joins a
            # single trace (rooted here when none is ambient).
            yield from tracing.iter_scope(
                it, "data.execute", "data", stages=len(ops)
            )
        finally:
            self._teardown_pools()

    def _completion_order(self, it) -> Iterator[RefBundle]:
        """Bounded resequencer: keep up to ``parallelism`` final outputs
        buffered and yield whichever block ref completes first
        (``ray_tpu_torch.wait``-driven), so a straggler task delays only itself."""
        buf: List[RefBundle] = []
        it = iter(it)
        exhausted = False
        while True:
            while not exhausted and len(buf) < self.parallelism:
                try:
                    buf.append(next(it))
                except StopIteration:
                    exhausted = True
            if not buf:
                return
            pick = 0
            if len(buf) > 1:
                try:
                    ready, _ = ray_tpu_torch.wait(
                        [b.block for b in buf], num_returns=1, timeout=None
                    )
                except Exception:
                    ready = []
                if ready:
                    first = ready[0]
                    for i, b in enumerate(buf):
                        if b.block is first or b.block == first:
                            pick = i
                            break
            yield buf.pop(pick)

    def _teardown_pools(self):
        # Refs handed downstream may be task args or in-flight consumer
        # fetches — those must seal before the pool dies (a killed actor can
        # no longer seal its results and the waiter would hang). Refs the
        # consumer NEVER received (still queued in the stage window when
        # iteration was abandoned) have no waiters: cancel them instead of
        # riding out the whole trailing window's execution.
        for ref in self._actor_refs_pending.values():
            try:
                ray_tpu_torch.cancel(ref)
                _TEARDOWN_CANCELS.inc()
            except Exception:
                pass
        self._actor_refs_pending.clear()
        if self._actor_stage_refs:
            pending = list(self._actor_stage_refs)
            try:
                ray_tpu_torch.wait(pending, num_returns=len(pending), timeout=60)
            except Exception:
                pass
            self._actor_stage_refs.clear()
        for pool in self._actor_pools:
            for a in pool:
                try:
                    ray_tpu_torch.kill(a)
                except Exception:
                    pass
        self._actor_pools = []

    def _build(self, ops: List[LogicalOp]) -> Iterator[RefBundle]:
        ops = _fuse_maps(list(ops))
        it: Optional[Iterator[RefBundle]] = None
        for op in ops:
            if isinstance(op, Read):
                it = self._read_stage(op)
            elif isinstance(op, FromBlocks):
                it = iter(
                    [
                        RefBundle(ray_tpu_torch.put(b), B.meta_for(b))
                        for b in op.blocks
                    ]
                )
            elif isinstance(op, MapBlocks):
                if op.actor_cls is not None:
                    it = self._actor_map_stage(op, it)
                else:
                    it = self._map_stage(op, it)
            elif isinstance(op, Limit):
                it = self._limit_stage(op, it)
            elif isinstance(op, Union):
                it = self._union_stage(op, it)
            elif isinstance(op, Zip):
                it = self._zip_stage(op, it)
            elif isinstance(op, (Repartition, Sort, RandomShuffle, GroupByAgg)):
                it = self._all_to_all_stage(op, it)
            else:
                raise TypeError(f"unknown logical op {op}")
        return it if it is not None else iter([])

    # -- stages --------------------------------------------------------------

    def _windowed(self, submit_iter, stage: str = "") -> Iterator[RefBundle]:
        """Bounded-window pipeline: submit up to `parallelism`, hand the head
        downstream as the window fills. Yields follow submission order — a
        ref is a valid downstream task arg before its task completes, so
        interior stages never block here (final-output reordering is
        _completion_order's job)."""
        cell = _BLOCKS_PRODUCED.cell(stage=stage) if stage else None
        window: collections.deque = collections.deque()
        for bundle in submit_iter:
            window.append(bundle)
            while len(window) >= self.parallelism:
                if cell is not None:
                    cell.inc()
                yield window.popleft()
        while window:
            if cell is not None:
                cell.inc()
            yield window.popleft()

    def _read_stage(self, op: Read) -> Iterator[RefBundle]:
        import cloudpickle

        read = _remote(_exec_read, name=op.name, num_returns=2)
        return self._windowed(
            (
                _from_returns(read.remote(cloudpickle.dumps(t)))
                for t in op.read_tasks
            ),
            stage=op.name,
        )

    def _map_stage(self, op: MapBlocks, upstream) -> Iterator[RefBundle]:
        import cloudpickle

        blob = cloudpickle.dumps(op.fn)
        mapper = _remote(_exec_map, name=op.name, num_returns=2)
        return self._windowed(
            (
                _from_returns(mapper.remote(blob, b.block))
                for b in upstream
            ),
            stage=op.name,
        )

    def _actor_map_stage(self, op: MapBlocks, upstream) -> Iterator[RefBundle]:
        import cloudpickle

        cls = ray_tpu_torch.remote(_MapActor)
        pool = [
            cls.options(max_concurrency=2, num_cpus=1).remote(
                op.actor_cls, op.actor_args
            )
            for _ in range(op.pool_size)
        ]
        self._actor_pools.append(pool)
        blob = cloudpickle.dumps(op.fn)

        def submit():
            for i, bundle in enumerate(upstream):
                refs = (
                    pool[i % len(pool)]
                    .apply.options(num_returns=2)
                    .remote(blob, bundle.block)
                )
                self._actor_refs_pending[refs[0].hex()] = refs[0]
                yield _from_returns(refs)

        def delivered():
            for bundle in self._windowed(submit(), stage=op.name):
                # Leaving the stage window: downstream may now depend on it,
                # so it graduates from cancel-on-teardown to seal-before-kill.
                self._actor_refs_pending.pop(bundle.block.hex(), None)
                self._actor_stage_refs.append(bundle.block)
                yield bundle

        return delivered()

    def _limit_stage(self, op: Limit, upstream) -> Iterator[RefBundle]:
        slicer = _remote(_slice_concat, num_cpus=0.5, num_returns=2)
        remaining = op.n
        upstream = iter(upstream)
        # Geometric window ramp: small limits stop after 1-2 blocks without
        # forcing a full parallelism window of upstream work; large limits
        # amortize the (batched, inline) metadata gets.
        window = 1
        bytes_cell = _BYTES_PRODUCED.cell(stage="Limit")
        try:
            while remaining > 0:
                chunk = list(itertools.islice(upstream, window))
                window = min(self.parallelism, window * 2)
                if not chunk:
                    break
                metas = resolve_metas(chunk)
                for bundle, meta in zip(chunk, metas):
                    if remaining <= 0:
                        break
                    if meta.num_rows <= remaining:
                        remaining -= meta.num_rows
                        bytes_cell.inc(meta.size_bytes)
                        yield bundle
                    else:
                        yield _from_returns(
                            slicer.remote([(0, 0, remaining)], bundle.block)
                        )
                        remaining = 0
        finally:
            close = getattr(upstream, "close", None)
            if close is not None:  # stop upstream submission promptly
                close()

    def _union_stage(self, op: Union, upstream) -> Iterator[RefBundle]:
        yield from upstream
        for other_plan in op.others:
            sub = StreamingExecutor(self.parallelism)
            yield from sub.execute(other_plan)

    def _zip_stage(self, op: Zip, upstream) -> Iterator[RefBundle]:
        """Blockwise zip: re-slice the right side to the left side's block
        boundaries, then one zip task per left block (no global concat —
        reference: ZipOperator aligns blocks the same way). Row counts come
        from the bundled metadata — zero counter tasks."""
        left = list(upstream)
        sub = StreamingExecutor(self.parallelism)
        right = list(sub.execute(op.other))
        l_counts = [m.num_rows for m in resolve_metas(left)]
        r_counts = [m.num_rows for m in resolve_metas(right)]
        if sum(l_counts) != sum(r_counts):
            raise ValueError(
                f"zip requires equal row counts: {sum(l_counts)} vs "
                f"{sum(r_counts)}"
            )
        slicer = _remote(_slice_concat, num_cpus=0.5, num_returns=2)
        zipper = _remote(_zip_tables, num_returns=2)
        r_offsets = np.cumsum([0] + r_counts)
        lo = 0
        for l_bundle, n in zip(left, l_counts):
            hi = lo + n
            ranges, tables = [], []
            for i, r_bundle in enumerate(right):
                s = max(lo, r_offsets[i])
                e = min(hi, r_offsets[i + 1])
                if s < e:
                    ranges.append(
                        (len(tables), int(s - r_offsets[i]), int(e - r_offsets[i]))
                    )
                    tables.append(r_bundle.block)
            aligned = slicer.remote(ranges, *tables)
            yield _from_returns(zipper.remote(1, l_bundle.block, aligned[0]))
            lo = hi

    def _all_to_all_stage(self, op, upstream) -> Iterator[RefBundle]:
        bundles = list(upstream)
        if not bundles:
            return
        if isinstance(op, Repartition):
            yield from self._repartition(bundles, op.num_blocks)
            return
        refs = [b.block for b in bundles]
        n_parts = max(1, min(len(refs), self.parallelism))
        key = getattr(op, "key", None)
        seed = getattr(op, "seed", None)
        if seed is None:
            # Unseeded shuffle must differ across runs/epochs (reference
            # ray.data semantics).
            seed = random.randrange(2**31)
        boundaries = None
        if isinstance(op, Sort):
            sampler = _remote(_sample_block, num_cpus=0.5)
            samples = sorted(
                s
                for chunk in ray_tpu_torch.get(
                    [sampler.remote(r, op.key, 16, i) for i, r in enumerate(refs)]
                )
                for s in chunk
            )
            if samples and n_parts > 1:
                step = max(1, len(samples) // n_parts)
                boundaries = sorted(set(samples[step::step]))[: n_parts - 1]
            else:
                boundaries = []
            n_parts = len(boundaries) + 1
        part = _remote(_partition_block, num_returns=n_parts)
        parts_per_block = [
            part.remote(r, key, n_parts, seed + i, boundaries)
            if n_parts > 1
            else [r]
            for i, r in enumerate(refs)
        ]
        if isinstance(op, Sort):
            merge = _remote(_merge_sort, num_returns=2)
            order = range(n_parts - 1, -1, -1) if op.descending else range(n_parts)
            for p in order:
                yield _from_returns(
                    merge.remote(
                        op.key, op.descending, *[pb[p] for pb in parts_per_block]
                    )
                )
        elif isinstance(op, RandomShuffle):
            merge = _remote(_merge_shuffle, num_returns=2)
            for p in range(n_parts):
                yield _from_returns(
                    merge.remote(seed + p, *[pb[p] for pb in parts_per_block])
                )
        elif isinstance(op, GroupByAgg):
            merge = _remote(_merge_groupby, num_returns=2)
            for p in range(n_parts):
                yield _from_returns(
                    merge.remote(
                        op.key, op.aggs, *[pb[p] for pb in parts_per_block]
                    )
                )

    def _repartition(self, bundles, num_blocks: int) -> Iterator[RefBundle]:
        counts = [m.num_rows for m in resolve_metas(bundles)]
        total = sum(counts)
        slicer = _remote(_slice_concat, num_returns=2)
        # Global row offsets -> num_blocks contiguous output ranges.
        starts = [round(total * j / num_blocks) for j in range(num_blocks)]
        ends = starts[1:] + [total]
        offsets = np.cumsum([0] + counts)
        for j in range(num_blocks):
            ranges, tables = [], []
            for i, b in enumerate(bundles):
                lo = max(starts[j], offsets[i])
                hi = min(ends[j], offsets[i + 1])
                if lo < hi:
                    ranges.append(
                        (len(tables), int(lo - offsets[i]), int(hi - offsets[i]))
                    )
                    tables.append(b.block)
            yield _from_returns(slicer.remote(ranges, *tables))


def _zip_tables(n_left, *blocks):
    from ray_tpu_torch.data import block as B

    lt = B.concat_blocks(list(blocks[:n_left]))
    rt = B.concat_blocks(list(blocks[n_left:]))
    if lt.num_rows != rt.num_rows:
        raise ValueError(
            f"zip requires equal row counts: {lt.num_rows} vs {rt.num_rows}"
        )
    cols = {}
    for name in lt.column_names:
        cols[name] = lt.column(name)
    for name in rt.column_names:
        out = name
        while out in cols:
            out = out + "_1"
        cols[out] = rt.column(name)
    return _with_meta(pa.table(cols))


def _fuse_maps(ops: List[LogicalOp]) -> List[LogicalOp]:
    """Fuse consecutive task-pool MapBlocks into one task per block, then
    fuse a leading Read with the task-pool MapBlocks that follows it so
    read->map costs ONE task and one object-store round trip per block
    (reference: read->map operator fusion in plan optimization)."""
    out: List[LogicalOp] = []
    for op in ops:
        if (
            isinstance(op, MapBlocks)
            and op.actor_cls is None
            and out
            and isinstance(out[-1], MapBlocks)
            and out[-1].actor_cls is None
        ):
            prev = out.pop()
            f, g = prev.fn, op.fn
            out.append(
                MapBlocks(
                    fn=lambda t, f=f, g=g: g(f(t)),
                    name=f"{prev.name}->{op.name}",
                )
            )
        elif (
            isinstance(op, MapBlocks)
            and op.actor_cls is None
            and out
            and isinstance(out[-1], Read)
        ):
            prev = out.pop()
            g = op.fn
            out.append(
                Read(
                    read_tasks=[
                        (lambda t=t, g=g: g(t())) for t in prev.read_tasks
                    ],
                    name=f"{prev.name}->{op.name}",
                )
            )
        else:
            out.append(op)
    return out
