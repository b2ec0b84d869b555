"""The reference's tests/test_data.py on the port: the thirteen cases that
tests/test_torch_data.py does not already run (that file holds
range/map/filter/take, map_batches and count, the batch sizes and the
two-way streaming split), case for case after the rename (ray_tpu ->
ray_tpu_torch, the conftest fixtures -> ray_tpu_torch.testing's). They sit
in a file of their own so that the suite's workers (--dist loadfile) take
them beside test_torch_data.py's minute.

One case differs: test_streaming_split_in_trainer runs its two workers in
a TorchTrainer(use_gpu=False), where the reference runs a JaxTrainer."""

import numpy as np
import pytest

import ray_tpu_torch.data as rd
from ray_tpu_torch.testing import torch_cluster  # noqa: F401


def test_map_batches_class_actor_pool(torch_cluster):
    class AddConst:
        def __init__(self, c):
            self.c = c

        def __call__(self, batch):
            return {"y": batch["id"] + self.c}

    ds = rd.range(32, parallelism=4).map_batches(
        AddConst, fn_constructor_args=(100,), concurrency=2
    )
    rows = ds.take_all()
    assert sorted(r["y"] for r in rows) == list(range(100, 132))


def test_from_items_flat_map_union_zip(torch_cluster):
    a = rd.from_items([1, 2, 3], parallelism=2)
    doubled = a.flat_map(lambda v: [v, v])
    assert doubled.count() == 6
    u = a.union(rd.from_items([4, 5], parallelism=1))
    assert sorted(u.take_all()) == [1, 2, 3, 4, 5]
    z = rd.range(4, parallelism=2).zip(
        rd.range(4, parallelism=2).map(lambda r: {"other": r["id"] + 10})
    )
    rows = z.take_all()
    assert rows[2] == {"id": 2, "other": 12}


def test_sort_and_shuffle(torch_cluster):
    ds = rd.from_items(
        [{"k": v} for v in [5, 3, 8, 1, 9, 2, 7, 4, 6, 0]], parallelism=3
    )
    assert [r["k"] for r in ds.sort("k").take_all()] == list(range(10))
    assert [r["k"] for r in ds.sort("k", descending=True).take_all()] == list(
        reversed(range(10))
    )
    shuffled = ds.random_shuffle(seed=0).take_all()
    assert sorted(r["k"] for r in shuffled) == list(range(10))


def test_groupby_aggregate(torch_cluster):
    ds = rd.from_items(
        [{"g": i % 3, "v": i} for i in range(12)], parallelism=3
    )
    out = {r["g"]: r["v_sum"] for r in ds.groupby("g").sum("v").take_all()}
    assert out == {0: 0 + 3 + 6 + 9, 1: 1 + 4 + 7 + 10, 2: 2 + 5 + 8 + 11}
    means = {r["g"]: r["v_mean"] for r in ds.groupby("g").mean("v").take_all()}
    assert means[0] == 4.5


def test_groupby_string_keys_cross_process(torch_cluster):
    # String keys exercise the deterministic-hash path: python hash() is
    # per-process randomized and would split one key across partitions.
    ds = rd.from_items(
        [{"city": c, "x": 1} for c in ["NYC", "SF", "NYC", "LA", "SF", "NYC"]],
        parallelism=3,
    )
    out = {r["city"]: r["x_sum"] for r in ds.groupby("city").sum("x").take_all()}
    assert out == {"NYC": 3, "SF": 2, "LA": 1}


def test_repartition_limit_schema(torch_cluster):
    ds = rd.range(100, parallelism=5).repartition(3)
    blocks = list(ds.iter_blocks())
    assert len(blocks) == 3
    assert sum(b.num_rows for b in blocks) == 100
    assert ds.limit(7).count() == 7
    assert ds.schema().names == ["id"]


def test_read_write_parquet_csv(torch_cluster, tmp_path):
    ds = rd.range(20, parallelism=2).map(lambda r: {"id": r["id"], "x": r["id"] * 1.5})
    pq_dir = str(tmp_path / "pq")
    ds.write_parquet(pq_dir)
    back = rd.read_parquet(pq_dir)
    assert back.count() == 20
    assert back.sort("id").take(2) == [
        {"id": 0, "x": 0.0},
        {"id": 1, "x": 1.5},
    ]
    csv_dir = str(tmp_path / "csv")
    ds.write_csv(csv_dir)
    assert rd.read_csv(csv_dir).count() == 20


def test_read_text_binary_numpy(torch_cluster, tmp_path):
    """read_text / read_binary_files / read_numpy datasources (reference:
    ray.data.read_text / read_binary_files / read_numpy)."""
    import numpy as np

    import ray_tpu_torch.data as rd

    (tmp_path / "a.txt").write_text("alpha\n\nbeta\n")
    (tmp_path / "b.txt").write_text("gamma\n")
    ds = rd.read_text([str(tmp_path / "a.txt"), str(tmp_path / "b.txt")])
    texts = sorted(r["text"] for r in ds.take_all())
    assert texts == ["alpha", "beta", "gamma"]

    (tmp_path / "x.bin").write_bytes(b"\x00\x01payload")
    ds = rd.read_binary_files(str(tmp_path / "x.bin"), include_paths=True)
    rows = ds.take_all()
    assert rows[0]["bytes"] == b"\x00\x01payload"
    assert rows[0]["path"].endswith("x.bin")

    np.save(tmp_path / "arr.npy", np.arange(6, dtype=np.int64))
    ds = rd.read_numpy(str(tmp_path / "arr.npy"))
    vals = [r["data"] for r in ds.take_all()]
    assert vals == list(range(6))


def test_streaming_split_in_trainer(torch_cluster, tmp_path):
    from ray_tpu_torch import train
    from ray_tpu_torch.air import RunConfig, ScalingConfig
    from ray_tpu_torch.train.torch import TorchTrainer

    def train_fn(config):
        shard = train.get_dataset_shard("train")
        total = 0
        for batch in shard.iter_batches(batch_size=8):
            total += int(batch["id"].sum())
        train.report({"total": total})

    result = TorchTrainer(
        train_fn,
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
        run_config=RunConfig(name="t_data", storage_path=str(tmp_path)),
        datasets={"train": rd.range(32, parallelism=4)},
    ).fit()
    # both shards together cover 0..31; rank0 metric is its own partial sum
    assert result.metrics["total"] > 0


def test_sort_empty_and_single_block(torch_cluster):
    assert rd.from_items([], parallelism=1).count() == 0
    ds = rd.from_items([{"k": 2}, {"k": 1}], parallelism=1)
    assert [r["k"] for r in ds.sort("k").take_all()] == [1, 2]


def test_read_images(torch_cluster, tmp_path):
    """read_images decodes to an 'image' tensor column (reference:
    ray.data.read_images); size= resizes mixed-size files into one stacked
    fixed-shape column and include_paths records provenance."""
    from PIL import Image

    for i, wh in enumerate([(16, 12), (8, 8), (16, 12)]):
        Image.new("RGB", wh, color=(i * 40, 10, 200)).save(
            tmp_path / f"img_{i}.png"
        )
    ds = rd.read_images(
        str(tmp_path), size=(10, 14), mode="RGB", include_paths=True,
        parallelism=2,
    )
    rows = ds.take_all()
    assert len(rows) == 3
    batch = next(iter(ds.iter_batches(batch_size=3)))
    assert batch["image"].shape == (3, 10, 14, 3)
    assert batch["image"].dtype == np.uint8
    assert sorted(p.split("_")[-1] for p in batch["path"].tolist()) == [
        "0.png", "1.png", "2.png",
    ]


def test_read_webdataset(torch_cluster, tmp_path):
    """read_webdataset groups tar members into samples by key and decodes
    txt/cls/json fields (reference: ray.data.read_webdataset)."""
    import io
    import json as _json
    import tarfile

    shard = tmp_path / "shard-000.tar"
    with tarfile.open(shard, "w") as tf:
        for key, cls in [("s0", 3), ("s1", 7)]:
            for field, data in [
                ("jpg", b"\xff\xd8fakejpeg"),
                ("cls", str(cls).encode()),
                ("txt", f"caption {key}".encode()),
                ("json", _json.dumps({"k": key}).encode()),
            ]:
                info = tarfile.TarInfo(f"{key}.{field}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
    rows = rd.read_webdataset(str(shard)).take_all()
    assert [r["__key__"] for r in rows] == ["s0", "s1"]
    assert rows[0]["cls"] == 3 and rows[1]["cls"] == 7
    assert rows[0]["txt"] == "caption s0"
    assert rows[0]["json"]["k"] == "s0"
    assert rows[0]["jpg"].startswith(b"\xff\xd8")


def test_read_webdataset_no_cross_shard_merge(torch_cluster, tmp_path):
    """Equal sample keys in different shards stay separate rows; dotfiles
    are skipped; mixed-shape read_images without size= raises with a fix."""
    import io
    import tarfile

    for shard_i in range(2):
        with tarfile.open(tmp_path / f"s{shard_i}.tar", "w") as tf:
            for name, data in [
                ("000000.cls", str(shard_i).encode()),
                ("._000000.jpg", b"applejunk"),
                (".DS_Store", b"junk"),
            ]:
                info = tarfile.TarInfo(name)
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
    rows = rd.read_webdataset(
        [str(tmp_path / "s0.tar"), str(tmp_path / "s1.tar")], parallelism=1
    ).take_all()
    assert sorted(r["cls"] for r in rows) == [0, 1]  # two rows, not one
    assert all(set(r) == {"__key__", "cls"} for r in rows)  # dotfiles skipped

    from PIL import Image

    Image.new("L", (8, 8)).save(tmp_path / "grey.png")
    Image.new("RGB", (8, 8)).save(tmp_path / "rgb.png")
    with pytest.raises(Exception, match="size"):
        rd.read_images(
            [str(tmp_path / "grey.png"), str(tmp_path / "rgb.png")],
            parallelism=1,
        ).take_all()

