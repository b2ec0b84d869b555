"""Datasources: read task construction + writers (reference:
python/ray/data/datasource/ + read_api.py)."""

from __future__ import annotations

import glob
import os
from typing import Any, Callable, List, Optional

import numpy as np
import pyarrow as pa

from ray_tpu_torch.data import block as B


def _expand_paths(paths) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(
                sorted(
                    f
                    for f in glob.glob(os.path.join(p, "**", "*"), recursive=True)
                    if os.path.isfile(f)
                )
            )
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(glob.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no files matched {paths}")
    return out


def range_tasks(n: int, parallelism: int) -> List[Callable[[], pa.Table]]:
    parallelism = max(1, min(parallelism, n or 1))
    tasks = []
    for i in range(parallelism):
        lo = n * i // parallelism
        hi = n * (i + 1) // parallelism

        def task(lo=lo, hi=hi):
            return pa.table({"id": np.arange(lo, hi, dtype=np.int64)})

        tasks.append(task)
    return tasks


def range_tensor_tasks(n: int, shape, parallelism: int):
    parallelism = max(1, min(parallelism, n or 1))
    tasks = []
    for i in range(parallelism):
        lo = n * i // parallelism
        hi = n * (i + 1) // parallelism

        def task(lo=lo, hi=hi, shape=tuple(shape)):
            data = [
                (np.ones(shape, dtype=np.int64) * j).tolist()
                for j in range(lo, hi)
            ]
            return pa.table({"data": data})

        tasks.append(task)
    return tasks


def items_tasks(items: List[Any], parallelism: int):
    parallelism = max(1, min(parallelism, len(items) or 1))
    tasks = []
    for i in range(parallelism):
        chunk = items[len(items) * i // parallelism : len(items) * (i + 1) // parallelism]

        def task(chunk=chunk):
            return B.rows_to_block(chunk)

        tasks.append(task)
    return tasks


def csv_read_tasks(paths, **read_options):
    files = _expand_paths(paths)
    tasks = []
    for f in files:

        def task(f=f, read_options=read_options):
            from pyarrow import csv as pacsv

            return pacsv.read_csv(f, **read_options)

        tasks.append(task)
    return tasks


def parquet_read_tasks(paths, columns: Optional[List[str]] = None):
    files = _expand_paths(paths)
    tasks = []
    for f in files:

        def task(f=f, columns=columns):
            import pyarrow.parquet as pq

            return pq.read_table(f, columns=columns)

        tasks.append(task)
    return tasks


def json_read_tasks(paths):
    files = _expand_paths(paths)
    tasks = []
    for f in files:

        def task(f=f):
            from pyarrow import json as pajson

            return pajson.read_json(f)

        tasks.append(task)
    return tasks


def text_read_tasks(paths, encoding: str = "utf-8", drop_empty_lines: bool = True):
    """One block per file; one row per line (reference: read_text)."""
    files = _expand_paths(paths)
    tasks = []
    for f in files:

        def task(f=f, encoding=encoding, drop=drop_empty_lines):
            with open(f, encoding=encoding) as fh:
                lines = fh.read().splitlines()
            if drop:
                lines = [ln for ln in lines if ln]
            return pa.table({"text": lines})

        tasks.append(task)
    return tasks


def binary_read_tasks(paths, include_paths: bool = False):
    """One block per file; the file's bytes as one row (reference:
    read_binary_files)."""
    files = _expand_paths(paths)
    tasks = []
    for f in files:

        def task(f=f, include_paths=include_paths):
            with open(f, "rb") as fh:
                data = fh.read()
            cols = {"bytes": pa.array([data], type=pa.binary())}
            if include_paths:
                cols["path"] = pa.array([f])
            return pa.table(cols)

        tasks.append(task)
    return tasks


def numpy_read_tasks(paths, column: str = "data"):
    """One block per .npy file (reference: read_numpy)."""
    files = _expand_paths(paths)
    tasks = []
    for f in files:

        def task(f=f, column=column):
            import numpy as np

            arr = np.load(f, allow_pickle=False)
            return pa.table({column: list(arr)})

        tasks.append(task)
    return tasks


# -- writers (run as remote tasks, one file per block) -----------------------


def write_block_parquet(table: pa.Table, path: str, idx: int) -> str:
    import pyarrow.parquet as pq

    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, f"part-{idx:05d}.parquet")
    pq.write_table(table, out)
    return out


def write_block_csv(table: pa.Table, path: str, idx: int) -> str:
    from pyarrow import csv as pacsv

    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, f"part-{idx:05d}.csv")
    pacsv.write_csv(table, out)
    return out


def write_block_json(table: pa.Table, path: str, idx: int) -> str:
    import json

    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, f"part-{idx:05d}.json")
    with open(out, "w") as f:
        for row in B.block_to_rows(table):
            f.write(json.dumps(row) + "\n")
    return out


def image_read_tasks(
    paths,
    size: Optional[tuple] = None,
    mode: Optional[str] = None,
    include_paths: bool = False,
    parallelism: int = 8,
) -> List[Callable[[], pa.Table]]:
    """PIL-decoded images, one tensor-column block per file group
    (reference: ray.data.read_images / datasource/image_datasource.py).
    size=(H, W) resizes — required for a stacked fixed-shape tensor column
    when the files vary; mode forces a PIL conversion ("RGB", "L", ...)."""
    files = [
        f
        for f in _expand_paths(paths)
        if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp", ".gif", ".webp"))
    ]
    if not files:
        raise FileNotFoundError(f"no image files matched {paths}")
    parallelism = max(1, min(parallelism, len(files)))
    tasks = []
    for i in range(parallelism):
        chunk = files[i::parallelism]

        def task(chunk=tuple(chunk), size=size, mode=mode, include=include_paths):
            from PIL import Image

            from ray_tpu_torch.data.tensor_extension import ArrowTensorArray

            arrs, names = [], []
            for path in chunk:
                with Image.open(path) as im:
                    if mode:
                        im = im.convert(mode)
                    if size:
                        im = im.resize((size[1], size[0]))  # PIL is (W, H)
                    arrs.append(np.asarray(im))
                names.append(path)
            shapes = {a.shape for a in arrs}
            if len(shapes) != 1:
                # A deterministic dataset-wide representation is impossible
                # with heterogeneous shapes (blocks would disagree on the
                # column type depending on file striping): fail loudly with
                # the fix, like the reference's image datasource.
                raise ValueError(
                    f"images have differing shapes {sorted(shapes)}; pass "
                    "size=(H, W) (and mode=) to read_images to decode into "
                    "a uniform tensor column"
                )
            col = ArrowTensorArray.from_numpy(np.stack(arrs))
            cols = {"image": col}
            if include:
                cols["path"] = pa.array(names)
            return pa.table(cols)

        tasks.append(task)
    return tasks


def webdataset_read_tasks(
    paths, parallelism: int = 8
) -> List[Callable[[], pa.Table]]:
    """WebDataset-style tar shards (reference: ray.data.read_webdataset):
    files inside each tar are grouped into samples by basename — everything
    up to the first dot is the sample key, the rest is the field name. Each
    row gets "__key__" plus one bytes column per field; .txt/.cls/.json
    fields are decoded to str/int/object like the webdataset defaults."""
    files = _expand_paths(paths)
    tars = [f for f in files if f.endswith((".tar", ".tar.gz", ".tgz"))]
    if not tars:
        raise FileNotFoundError(f"no tar shards matched {paths}")
    parallelism = max(1, min(parallelism, len(tars)))
    tasks = []
    for i in range(parallelism):
        chunk = tars[i::parallelism]

        def task(chunk=tuple(chunk)):
            import json as _json
            import tarfile

            rows: List[dict] = []
            for tar_path in chunk:
                # Samples group PER SHARD, keyed by the tar-internal path
                # stem (directory included): equal keys in different shards
                # or directories are different samples, never merged
                # (reference read_webdataset semantics).
                samples: dict = {}
                order: List[str] = []
                with tarfile.open(tar_path) as tf:
                    for member in tf:
                        if not member.isfile():
                            continue
                        base = os.path.basename(member.name)
                        if base.startswith("."):
                            continue  # AppleDouble/.DS_Store and kin
                        stem, _, field = base.partition(".")
                        if not field:
                            continue
                        key = os.path.join(os.path.dirname(member.name), stem)
                        data = tf.extractfile(member).read()
                        if key not in samples:
                            samples[key] = {"__key__": key}
                            order.append(key)
                        if field in ("txt", "text"):
                            samples[key][field] = data.decode("utf-8")
                        elif field == "cls":
                            samples[key][field] = int(data.decode().strip())
                        elif field == "json":
                            samples[key][field] = _json.loads(data)
                        else:
                            samples[key][field] = data
                rows.extend(samples[k] for k in order)
            return B.rows_to_block(rows)

        tasks.append(task)
    return tasks
