"""ray_tpu_torch.data — streaming distributed datasets (reference: python/ray/data).

    import ray_tpu_torch.data as rd

    ds = rd.range(1000).map_batches(lambda b: {"x": b["id"] * 2})
    for batch in ds.iter_batches(batch_size=128):
        ...
"""

from __future__ import annotations

from typing import Any, List, Optional

from ray_tpu_torch.data._execution import FromBlocks, Read
from ray_tpu_torch.data.dataset import Dataset, GroupedData
from ray_tpu_torch.data.iterator import DataIterator
from ray_tpu_torch.data import datasource as _src


def range(n: int, *, parallelism: int = 8) -> Dataset:  # noqa: A001
    return Dataset([Read(read_tasks=_src.range_tasks(n, parallelism))], parallelism)


def range_tensor(n: int, *, shape=(1,), parallelism: int = 8) -> Dataset:
    return Dataset(
        [Read(read_tasks=_src.range_tensor_tasks(n, shape, parallelism))],
        parallelism,
    )


def from_items(items: List[Any], *, parallelism: int = 8) -> Dataset:
    return Dataset(
        [Read(read_tasks=_src.items_tasks(list(items), parallelism))], parallelism
    )


def from_pandas(df) -> Dataset:
    import pyarrow as pa

    return Dataset([FromBlocks(blocks=[pa.Table.from_pandas(df, preserve_index=False)])])


def from_arrow(table) -> Dataset:
    return Dataset([FromBlocks(blocks=[table])])


def from_numpy(arr, column: str = "data") -> Dataset:
    import pyarrow as pa

    return Dataset([FromBlocks(blocks=[pa.table({column: list(arr)})])])


def read_csv(paths, *, parallelism: int = 8, **kwargs) -> Dataset:
    return Dataset([Read(read_tasks=_src.csv_read_tasks(paths, **kwargs))], parallelism)


def read_parquet(
    paths, *, columns: Optional[List[str]] = None, parallelism: int = 8
) -> Dataset:
    return Dataset(
        [Read(read_tasks=_src.parquet_read_tasks(paths, columns))], parallelism
    )


def read_json(paths, *, parallelism: int = 8) -> Dataset:
    return Dataset([Read(read_tasks=_src.json_read_tasks(paths))], parallelism)


def read_text(
    paths, *, encoding: str = "utf-8", drop_empty_lines: bool = True,
    parallelism: int = 8,
) -> Dataset:
    """One row per line across the files (reference: ray.data.read_text)."""
    return Dataset(
        [Read(read_tasks=_src.text_read_tasks(paths, encoding, drop_empty_lines))],
        parallelism,
    )


def read_binary_files(
    paths, *, include_paths: bool = False, parallelism: int = 8
) -> Dataset:
    """One row per file holding its raw bytes (reference:
    ray.data.read_binary_files)."""
    return Dataset(
        [Read(read_tasks=_src.binary_read_tasks(paths, include_paths))],
        parallelism,
    )


def read_numpy(paths, *, column: str = "data", parallelism: int = 8) -> Dataset:
    """.npy files, one block each (reference: ray.data.read_numpy)."""
    return Dataset(
        [Read(read_tasks=_src.numpy_read_tasks(paths, column))], parallelism
    )


def read_images(
    paths,
    *,
    size=None,
    mode=None,
    include_paths: bool = False,
    parallelism: int = 8,
) -> Dataset:
    """PIL-decoded images as an "image" tensor column (reference:
    ray.data.read_images). size=(H, W) resizes (required for a stacked
    fixed-shape column over mixed-size files); mode forces a PIL convert
    ("RGB", "L", ...)."""
    return Dataset(
        [
            Read(
                read_tasks=_src.image_read_tasks(
                    paths, size, mode, include_paths, parallelism
                )
            )
        ],
        parallelism,
    )


def read_webdataset(paths, *, parallelism: int = 8) -> Dataset:
    """WebDataset tar shards -> one row per sample keyed by "__key__", with
    a column per field; .txt/.cls/.json fields are decoded (reference:
    ray.data.read_webdataset)."""
    return Dataset(
        [Read(read_tasks=_src.webdataset_read_tasks(paths, parallelism))],
        parallelism,
    )


__all__ = [
    "Dataset",
    "GroupedData",
    "DataIterator",
    "range",
    "range_tensor",
    "from_items",
    "from_pandas",
    "from_arrow",
    "from_numpy",
    "read_csv",
    "read_parquet",
    "read_json",
    "read_text",
    "read_binary_files",
    "read_numpy",
    "read_images",
    "read_webdataset",
]
