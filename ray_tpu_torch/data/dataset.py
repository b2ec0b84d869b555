"""Dataset: lazy logical plan + consumption APIs (reference:
python/ray/data/dataset.py:137 — same surface, executed by the streaming
executor in _execution.py)."""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional

import pyarrow as pa

import ray_tpu_torch
from ray_tpu_torch.data import block as B
from ray_tpu_torch.data._execution import (
    FromBlocks,
    GroupByAgg,
    Limit,
    LogicalOp,
    MapBlocks,
    RandomShuffle,
    Repartition,
    Sort,
    StreamingExecutor,
    Union,
    Zip,
)
from ray_tpu_torch.data.iterator import DataIterator, _SplitCoordinator, batches_from_blocks


class Dataset:
    def __init__(self, ops: List[LogicalOp], parallelism: int = 8):
        self._ops = ops
        self._parallelism = parallelism

    def _with(self, op: LogicalOp) -> "Dataset":
        return Dataset(self._ops + [op], self._parallelism)

    # -- transforms (lazy) ---------------------------------------------------

    def map(self, fn: Callable[[Any], Any]) -> "Dataset":
        def _map(t: pa.Table, fn=fn):
            return B.rows_to_block([fn(r) for r in B.block_to_rows(t)])

        return self._with(MapBlocks(fn=_map, name="Map"))

    def flat_map(self, fn: Callable[[Any], List[Any]]) -> "Dataset":
        def _fmap(t: pa.Table, fn=fn):
            out: List[Any] = []
            for r in B.block_to_rows(t):
                out.extend(fn(r))
            return B.rows_to_block(out)

        return self._with(MapBlocks(fn=_fmap, name="FlatMap"))

    def filter(self, fn: Callable[[Any], bool]) -> "Dataset":
        def _filter(t: pa.Table, fn=fn):
            return B.rows_to_block([r for r in B.block_to_rows(t) if fn(r)])

        return self._with(MapBlocks(fn=_filter, name="Filter"))

    def map_batches(
        self,
        fn,
        *,
        batch_format: str = "numpy",
        batch_size: Optional[int] = None,
        concurrency: Optional[int] = None,
        fn_constructor_args: tuple = (),
    ) -> "Dataset":
        """fn: batch -> batch, or a class (stateful UDF -> actor pool,
        reference: ActorPoolMapOperator)."""
        def _per_batch(callable_fn, t: pa.Table):
            if batch_size is None or t.num_rows <= batch_size:
                return B.batch_to_block(
                    callable_fn(B.block_to_batch(t, batch_format))
                )
            outs = []
            for lo in range(0, t.num_rows, batch_size):
                chunk = B.slice_block(t, lo, min(lo + batch_size, t.num_rows))
                outs.append(
                    B.batch_to_block(
                        callable_fn(B.block_to_batch(chunk, batch_format))
                    )
                )
            return B.concat_blocks(outs)

        if isinstance(fn, type):
            import cloudpickle

            def _apply(udf, t: pa.Table):
                return _per_batch(udf, t)

            return self._with(
                MapBlocks(
                    fn=_apply,
                    name=f"MapBatches({fn.__name__})",
                    actor_cls=cloudpickle.dumps(fn),
                    actor_args=fn_constructor_args,
                    pool_size=concurrency or 2,
                )
            )

        def _mb(t: pa.Table, fn=fn):
            return _per_batch(fn, t)

        return self._with(MapBlocks(fn=_mb, name="MapBatches"))

    def add_column(self, name: str, fn: Callable[[Dict], Any]) -> "Dataset":
        def _add(t: pa.Table, name=name, fn=fn):
            col = fn(B.block_to_batch(t, "pandas"))
            return B.batch_to_block(
                t.append_column(name, pa.array(list(col)))
            )

        return self._with(MapBlocks(fn=_add, name=f"AddColumn({name})"))

    def drop_columns(self, cols: List[str]) -> "Dataset":
        def _drop(t: pa.Table, cols=tuple(cols)):
            return t.drop_columns(list(cols))

        return self._with(MapBlocks(fn=_drop, name="DropColumns"))

    def select_columns(self, cols: List[str]) -> "Dataset":
        def _sel(t: pa.Table, cols=tuple(cols)):
            return t.select(list(cols))

        return self._with(MapBlocks(fn=_sel, name="SelectColumns"))

    def limit(self, n: int) -> "Dataset":
        return self._with(Limit(n=n))

    def union(self, *others: "Dataset") -> "Dataset":
        return self._with(Union(others=[o._ops for o in others]))

    def zip(self, other: "Dataset") -> "Dataset":
        return self._with(Zip(other=other._ops))

    def repartition(self, num_blocks: int) -> "Dataset":
        return self._with(Repartition(num_blocks=num_blocks))

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        return self._with(Sort(key=key, descending=descending))

    def random_shuffle(self, *, seed: Optional[int] = None) -> "Dataset":
        return self._with(RandomShuffle(seed=seed))

    def groupby(self, key: str) -> "GroupedData":
        return GroupedData(self, key)

    # -- execution -----------------------------------------------------------

    def _executor(self) -> StreamingExecutor:
        return StreamingExecutor(self._parallelism)

    def iter_bundles(self) -> Iterator[Any]:
        """Stream RefBundles (block ref + metadata) for the applied plan."""
        yield from self._executor().execute(self._ops)

    def iter_block_refs(self) -> Iterator[Any]:
        for b in self.iter_bundles():
            yield b.block

    def iter_blocks(self) -> Iterator[pa.Table]:
        from ray_tpu_torch.data.iterator import iter_blocks_pipelined

        # Lookahead keeps K object-store fetches in flight so pull overlaps
        # whatever the consumer does with each block.
        yield from iter_blocks_pipelined(self.iter_block_refs())

    def materialize(self) -> "Dataset":
        """Execute now; the result holds concrete blocks
        (reference: Dataset.materialize)."""
        return Dataset(
            [FromBlocks(blocks=list(self.iter_blocks()))], self._parallelism
        )

    # -- consumption ---------------------------------------------------------

    def take(self, n: int = 20) -> List[Any]:
        out: List[Any] = []
        for blk in self.limit(n).iter_blocks():
            out.extend(B.block_to_rows(blk))
            if len(out) >= n:
                break
        return out[:n]

    def take_all(self) -> List[Any]:
        out: List[Any] = []
        for blk in self.iter_blocks():
            out.extend(B.block_to_rows(blk))
        return out

    def count(self) -> int:
        """Row count without moving row data to the driver: sums the
        BlockMeta riding next to every block ref (one batched inline get —
        zero counter tasks, zero block fetches)."""
        from ray_tpu_torch.data._execution import resolve_metas

        bundles = list(self.iter_bundles())
        if not bundles:
            return 0
        return sum(m.num_rows for m in resolve_metas(bundles))

    def schema(self) -> Optional[pa.Schema]:
        for blk in self.iter_blocks():
            if blk.num_rows or blk.num_columns:
                return blk.schema
        return None

    def columns(self) -> List[str]:
        s = self.schema()
        return list(s.names) if s else []

    def show(self, n: int = 20) -> None:
        for row in self.take(n):
            print(row)

    def iter_rows(self) -> Iterator[Any]:
        for blk in self.iter_blocks():
            yield from B.block_to_rows(blk)

    def iter_batches(
        self,
        *,
        batch_size: Optional[int] = 256,
        batch_format: str = "numpy",
        drop_last: bool = False,
        prefetch_batches: int = 1,
    ) -> Iterator[Any]:
        from ray_tpu_torch.data.iterator import prefetch_iterator

        it = batches_from_blocks(
            self.iter_blocks(), batch_size, batch_format, drop_last
        )
        yield from prefetch_iterator(it, prefetch_batches)

    def to_pandas(self):
        return B.concat_blocks(list(self.iter_blocks())).to_pandas()

    def to_arrow(self) -> pa.Table:
        return B.concat_blocks(list(self.iter_blocks()))

    # -- splits --------------------------------------------------------------

    def split(self, n: int) -> List["Dataset"]:
        """Materializing split into n datasets (reference: Dataset.split)."""
        blocks = list(self.repartition(n).iter_blocks())
        return [
            Dataset([FromBlocks(blocks=blocks[i::n])], self._parallelism)
            for i in range(n)
        ]

    def streaming_split(self, n: int, *, equal: bool = False) -> List[DataIterator]:
        """N iterators backed by one shared execution (reference:
        Dataset.streaming_split, used for per-host train ingest)."""
        import cloudpickle

        ops = self._ops
        if equal:
            ops = ops + [Repartition(num_blocks=n * 4)]
        if n == 1:
            # Single consumer: no cross-consumer queueing to coordinate, so
            # skip the actor entirely — the iterator drives the executor
            # in-process (fast path; promoted to a coordinator only if the
            # iterator is pickled to a trainer worker).
            return [
                DataIterator(
                    None,
                    0,
                    _local_plan=cloudpickle.dumps(ops),
                    _parallelism=self._parallelism,
                )
            ]
        cls = ray_tpu_torch.remote(_SplitCoordinator)
        # 2 slots per split: the DataIterator keeps one next_refs RPC in
        # flight ahead, and an abandoned consumer's stale call may still be
        # blocked server-side when the split starts its next epoch.
        coord = cls.options(
            max_concurrency=max(4, 2 * n + 2), num_cpus=0.5
        ).remote(cloudpickle.dumps(ops), n, self._parallelism)
        return [DataIterator(coord, i) for i in range(n)]

    # -- writes --------------------------------------------------------------

    def _write(self, writer, path: str) -> List[str]:
        w = ray_tpu_torch.remote(writer)
        refs = [
            w.remote(ref, path, i)
            for i, ref in enumerate(self.iter_block_refs())
        ]
        return ray_tpu_torch.get(refs)

    def write_parquet(self, path: str) -> List[str]:
        from ray_tpu_torch.data.datasource import write_block_parquet

        return self._write(write_block_parquet, path)

    def write_csv(self, path: str) -> List[str]:
        from ray_tpu_torch.data.datasource import write_block_csv

        return self._write(write_block_csv, path)

    def write_json(self, path: str) -> List[str]:
        from ray_tpu_torch.data.datasource import write_block_json

        return self._write(write_block_json, path)

    def __repr__(self):
        names = [type(op).__name__ for op in self._ops]
        return f"Dataset({' -> '.join(names)})"


class GroupedData:
    """reference: python/ray/data/grouped_data.py."""

    _AGG_FNS = {"sum", "min", "max", "mean", "count"}

    def __init__(self, ds: Dataset, key: str):
        self._ds = ds
        self._key = key

    def _agg(self, fn: str, col: Optional[str]) -> Dataset:
        if fn not in self._AGG_FNS:
            raise ValueError(f"unknown aggregate {fn}")
        aggs = [(col or self._key, fn)]
        return self._ds._with(GroupByAgg(key=self._key, aggs=aggs))

    def sum(self, col: str) -> Dataset:
        return self._agg("sum", col)

    def min(self, col: str) -> Dataset:
        return self._agg("min", col)

    def max(self, col: str) -> Dataset:
        return self._agg("max", col)

    def mean(self, col: str) -> Dataset:
        return self._agg("mean", col)

    def count(self) -> Dataset:
        return self._ds._with(GroupByAgg(key=self._key, aggs=[(self._key, "count")]))

    def aggregate(self, *aggs) -> Dataset:
        """aggs: (col, fn) tuples."""
        return self._ds._with(GroupByAgg(key=self._key, aggs=list(aggs)))
