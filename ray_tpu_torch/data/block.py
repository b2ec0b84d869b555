"""Block layer: a block is a pyarrow.Table (reference: python/ray/data —
blocks are Arrow tables in plasma; block_accessor.py provides the row/batch
views). Helpers here convert between rows, batches, and tables and implement
the per-block kernels (slice, sort, hash-partition) that map tasks run."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np
import pyarrow as pa

from ray_tpu_torch.data.tensor_extension import (
    ArrowTensorArray,
    is_tensor_type,
    tensor_column_to_numpy,
)

# A batch/table column name used when the data is just values, not mappings
# (reference: ray.data uses __value__ the same way via TENSOR_COLUMN_NAME).
VALUE_COL = "__value__"


@dataclass(frozen=True)
class BlockMeta:
    """Per-block metadata that travels NEXT TO the block ref, not inside it
    (reference: BlockMetadata in block.py riding RefBundles through the
    streaming executor). Stage tasks return ``(block, meta)`` via
    ``num_returns=2`` so dispatch decisions (limit cutoffs, zip alignment,
    repartition ranges, row counts) read a tiny inline object instead of
    paying a counter-task round trip per block."""

    num_rows: int
    size_bytes: int


def meta_for(block: pa.Table) -> BlockMeta:
    return BlockMeta(num_rows=block.num_rows, size_bytes=block.nbytes)


def rows_to_block(rows: Sequence[Any]) -> pa.Table:
    """Build a block from python rows (dicts or bare values)."""
    if rows and isinstance(rows[0], dict):
        cols: Dict[str, List[Any]] = {k: [] for k in rows[0]}
        for r in rows:
            if set(r.keys()) != set(cols.keys()):
                for k in r:
                    if k not in cols:
                        cols[k] = [None] * (len(next(iter(cols.values()))) - 0)
            for k in cols:
                cols[k].append(r.get(k))
        return pa.table({k: _to_arrow_array(v) for k, v in cols.items()})
    return pa.table({VALUE_COL: _to_arrow_array(list(rows))})


def _to_arrow_array(values: List[Any]):
    if values and isinstance(values[0], np.ndarray):
        first = values[0]
        if (
            first.dtype != object
            and first.ndim >= 1
            and all(
                isinstance(v, np.ndarray)
                and v.shape == first.shape
                and v.dtype == first.dtype
                for v in values
            )
        ):
            # Uniform ndarray rows -> ONE contiguous tensor column
            # (zero-copy through serialization and back to numpy), not
            # per-row Arrow lists.
            return ArrowTensorArray.from_numpy(np.stack(values))
        try:
            return pa.array([np.asarray(v).tolist() for v in values])
        except (pa.ArrowInvalid, pa.ArrowTypeError, pa.ArrowNotImplementedError):
            # Mixed nesting depth (e.g. (H, W) grayscale next to (H, W, 3)
            # RGB) cannot become one Arrow list column; pickle per row.
            import cloudpickle

            return pa.array([cloudpickle.dumps(v) for v in values])
    try:
        return pa.array(values)
    except (pa.ArrowInvalid, pa.ArrowTypeError, pa.ArrowNotImplementedError):
        import cloudpickle

        return pa.array([cloudpickle.dumps(v) for v in values])


def block_to_rows(block: pa.Table) -> List[Any]:
    cols = block.column_names
    pydict = {}
    for c in cols:
        col = block.column(c)
        if is_tensor_type(col.type):
            stacked = tensor_column_to_numpy(col)
            pydict[c] = [stacked[i] for i in range(len(stacked))]
        else:
            pydict[c] = col.to_pylist()
    if cols == [VALUE_COL]:
        return pydict[VALUE_COL]
    return [dict(zip(cols, vals)) for vals in zip(*(pydict[c] for c in cols))]


def block_to_batch(block: pa.Table, batch_format: str = "numpy"):
    """Materialize a block in the requested batch format (reference:
    batch formats of map_batches/iter_batches)."""
    if batch_format in ("pyarrow", "arrow"):
        return block
    if batch_format == "pandas":
        return block.to_pandas()
    if batch_format in ("numpy", "dict", "default"):
        out = {}
        for name in block.column_names:
            col = block.column(name)
            if is_tensor_type(col.type):
                out[name] = tensor_column_to_numpy(col)
                continue
            try:
                out[name] = col.to_numpy(zero_copy_only=False)
            except (pa.ArrowInvalid, pa.ArrowNotImplementedError):
                out[name] = np.asarray(col.to_pylist(), dtype=object)
        return out
    raise ValueError(f"unknown batch_format {batch_format!r}")


def batch_to_block(batch: Any) -> pa.Table:
    """Accept whatever a map_batches UDF returned."""
    if isinstance(batch, pa.Table):
        return batch
    if isinstance(batch, dict):
        cols = {}
        for k, v in batch.items():
            if isinstance(v, np.ndarray) and v.ndim >= 2 and v.dtype != object:
                # Columnar fast path: a stacked array IS the tensor column.
                cols[k] = ArrowTensorArray.from_numpy(v)
            else:
                cols[k] = _to_arrow_array(_as_list(v))
        return pa.table(cols)
    try:
        import pandas as pd

        if isinstance(batch, pd.DataFrame):
            return pa.Table.from_pandas(batch, preserve_index=False)
    except ImportError:
        pass
    if isinstance(batch, (list, np.ndarray)):
        return rows_to_block(list(batch))
    raise TypeError(
        f"map_batches UDF must return dict/pyarrow.Table/pandas.DataFrame/"
        f"list, got {type(batch)}"
    )


def _as_list(v):
    if isinstance(v, np.ndarray):
        return list(v)
    return list(v)


def empty_block() -> pa.Table:
    return pa.table({})


def _detensorize(block: pa.Table) -> pa.Table:
    """Replace tensor-extension columns with plain list<...> arrays (used
    when blocks with mismatched tensor shapes/encodings must concatenate)."""
    cols = {}
    changed = False
    for name in block.column_names:
        col = block.column(name)
        if is_tensor_type(col.type):
            stacked = tensor_column_to_numpy(col)
            cols[name] = pa.array([row.tolist() for row in stacked])
            changed = True
        else:
            cols[name] = col
    return pa.table(cols) if changed else block


def concat_blocks(blocks: List[pa.Table]) -> pa.Table:
    blocks = [b for b in blocks if b.num_rows > 0]
    if not blocks:
        return empty_block()
    # Unify trivially-divergent schemas (e.g. int vs float) via promote.
    # ArrowTypeError subclasses TypeError, so it must be caught first —
    # it signals genuinely incompatible columns (e.g. one block's rows were
    # uniform ndarrays -> tensor column, another's were ragged -> list
    # column, or two tensor columns with different element shapes); those
    # concatenate after downgrading tensor columns to plain lists.
    try:
        return pa.concat_tables(blocks, promote_options="permissive")
    except pa.ArrowTypeError:
        blocks = [_detensorize(b) for b in blocks]
        return pa.concat_tables(blocks, promote_options="permissive")
    except TypeError:  # older pyarrow signature
        return pa.concat_tables(blocks, promote=True)


def slice_block(block: pa.Table, start: int, end: int) -> pa.Table:
    return block.slice(start, end - start)


def sort_block(block: pa.Table, key: str, descending: bool = False) -> pa.Table:
    order = "descending" if descending else "ascending"
    if block.num_rows == 0:
        return block
    import pyarrow.compute as pc  # submodule: not loaded by "import pyarrow"

    return block.take(pc.sort_indices(block, sort_keys=[(key, order)]))


def hash_partition_block(
    block: pa.Table, key: Optional[str], num_partitions: int, seed: int = 0
) -> List[pa.Table]:
    """Split a block into hash partitions (by key column, or uniformly at
    random when key is None — the random_shuffle/repartition path)."""
    n = block.num_rows
    if n == 0:
        return [block] * num_partitions
    if key is None:
        rng = np.random.RandomState(seed)
        assignment = rng.randint(0, num_partitions, size=n)
    else:
        # Deterministic cross-process hash: python hash() is randomized per
        # process, which would scatter one key across merge partitions.
        import zlib

        vals = block.column(key).to_pylist()
        assignment = np.array(
            [zlib.crc32(repr(v).encode()) % num_partitions for v in vals]
        )
    out = []
    for p in range(num_partitions):
        idx = np.nonzero(assignment == p)[0]
        out.append(block.take(pa.array(idx)))
    return out


def range_partition_block(
    block: pa.Table, key: str, boundaries: List[Any]
) -> List[pa.Table]:
    """Partition by sorted boundaries → len(boundaries)+1 parts."""
    vals = block.column(key).to_pylist()
    import bisect

    assignment = np.array([bisect.bisect_right(boundaries, v) for v in vals])
    out = []
    for p in range(len(boundaries) + 1):
        idx = np.nonzero(assignment == p)[0]
        out.append(block.take(pa.array(idx)))
    return out
