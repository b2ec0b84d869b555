"""ray_tpu_torch.data, the torch-tensor reducer and the bench's ingest ->
train loop, on the CPU.

The data cases are tests/test_data.py's and tests/test_data_streaming.py's,
run through the port's copy on the port's runtime. The reducer moves f32
and bf16 tensors bitwise. The e2e loop of ray_tpu_torch.bench runs in a
one-worker TorchTrainer(use_gpu=False) on a small ResNet fed by a uint8
dataset: every image arrives once, and the first step's loss is a bare
step's on the same batch."""

import pickle
import threading

import numpy as np
import pyarrow as pa
import pytest
import torch

import ray_tpu_torch
import ray_tpu_torch.data as rd
from ray_tpu_torch._private import serialization
from ray_tpu_torch.air import RunConfig, ScalingConfig
from ray_tpu_torch.bench import synth_block
from ray_tpu_torch.data.iterator import batches_from_blocks
from ray_tpu_torch.models import resnet
from ray_tpu_torch.testing import torch_cluster  # noqa: F401
from ray_tpu_torch.train.torch import TorchTrainer

# Train workers import torch after their actor sets this: one intra-op
# thread each, so the gang leaves the suite's other tests their cores.
ONE_THREAD = {"OMP_NUM_THREADS": "1"}
# The e2e loop's first loss against a bare step on the same batch: the same
# f32 arithmetic in two processes.
LOSS_ATOL = 1e-5


# -- the cases of tests/test_data.py and tests/test_data_streaming.py ----------


def test_range_map_filter_take(torch_cluster):  # noqa: F811
    ds = rd.range(100, parallelism=4)
    out = ds.map(lambda r: {"id": r["id"] * 2}).filter(lambda r: r["id"] % 4 == 0).take(5)
    assert out == [{"id": 0}, {"id": 4}, {"id": 8}, {"id": 12}, {"id": 16}]


def test_map_batches_and_count(torch_cluster):  # noqa: F811
    ds = rd.range(64, parallelism=4).map_batches(
        lambda b: {"sq": b["id"] ** 2}, batch_format="numpy")
    assert ds.count() == 64
    assert ds.take_all()[5] == {"sq": 25}


def test_iter_batches_sizes(torch_cluster):  # noqa: F811
    ds = rd.range(50, parallelism=4)
    batches = list(ds.iter_batches(batch_size=16, batch_format="numpy"))
    assert [len(b["id"]) for b in batches] == [16, 16, 16, 2]
    assert np.array_equal(batches[0]["id"], np.arange(16))


def _split_rows(shards):
    return sorted(v for s in shards for b in s.iter_batches(batch_size=None) for v in b["id"])


def test_streaming_split_covers_all_rows(torch_cluster):  # noqa: F811
    shards = rd.range(40, parallelism=4).streaming_split(2)
    assert _split_rows(shards) == list(range(40))
    # A second epoch re-iterates (it waits ~20 s on the epoch barrier, as
    # ray_tpu.data's does).
    assert len(_split_rows(shards[:1])) > 0


def test_streaming_split_completion_order_covers_rows(torch_cluster):  # noqa: F811
    assert _split_rows(rd.range(36, parallelism=6).streaming_split(2)) == list(range(36))


def test_streaming_split_single_is_local_fast_path(torch_cluster):  # noqa: F811
    (it,) = rd.range(24, parallelism=4).streaming_split(1)
    assert it._coord is None
    assert sorted(v for b in it.iter_batches(batch_size=5) for v in b["id"]) == list(range(24))
    clone = pickle.loads(pickle.dumps(it))
    assert clone._coord is None
    assert sorted(v for b in clone.iter_batches(batch_size=6) for v in b["id"]) == list(range(24))


def _tables(*row_counts):
    out, base = [], 0
    for n in row_counts:
        out.append(pa.table({"v": list(range(base, base + n))}))
        base += n
    return out


def test_batcher_block_boundaries_and_drop_last():
    blocks = _tables(3, 2, 4)
    batches = list(batches_from_blocks(iter(blocks), 4, "pyarrow", False))
    assert [b.num_rows for b in batches] == [4, 4, 1]
    assert [v for b in batches for v in b.column("v").to_pylist()] == list(range(9))
    assert [b.num_rows for b in batches_from_blocks(iter(blocks), 4, "pyarrow", True)] == [4, 4]
    blocks = [pa.table({"v": []}), *_tables(2, 3), pa.table({"v": []})]
    assert [b.num_rows for b in batches_from_blocks(iter(blocks), 5, "pyarrow", False)] == [5]


def test_batcher_slices_are_zero_copy():
    blk = pa.table({"v": np.arange(64, dtype=np.int64)})
    batches = list(batches_from_blocks(iter([blk]), 16, "pyarrow", False))
    assert len(batches) == 4
    src = blk.column("v").chunk(0).buffers()[1]
    for b in batches:
        addr = b.column("v").chunk(0).buffers()[1].address
        assert src.address <= addr < src.address + src.size


def test_finalize_fn_runs_in_the_prefetch_thread(torch_cluster):  # noqa: F811
    (it,) = rd.range(32, parallelism=4).streaming_split(1)
    threads = []

    def finalize(batch):
        threads.append(threading.get_ident())
        return torch.from_numpy(batch["id"].copy()) * 2

    out = list(it.iter_batches(batch_size=8, prefetch_batches=2, _finalize_fn=finalize))
    assert sorted(torch.cat(out).tolist()) == [2 * i for i in range(32)]
    assert len(threads) == 4 and threading.get_ident() not in threads


# -- the torch-tensor reducer ---------------------------------------------------


def _tensors():
    gen = torch.Generator().manual_seed(0)
    f32 = torch.randn(256, 33, generator=gen)
    return {
        "f32": f32,
        "bf16": f32.to(torch.bfloat16),
        "f32_transposed": f32.t(),
        "scalar": torch.tensor(2.5),
        "param": torch.nn.Parameter(torch.randn(64, 8, generator=gen)),
        "int64": torch.arange(1000),
    }


def _bytes(t):
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


@pytest.mark.parametrize("name", sorted(_tensors()))
def test_reducer_round_trips_bitwise(name):
    t = _tensors()[name]
    so = serialization.serialize(t)
    got, _ = serialization.deserialize(bytes(so.to_bytes()))
    assert type(got) is type(t) and got.dtype == t.dtype and got.shape == t.shape
    assert got.requires_grad == t.requires_grad
    assert torch.equal(_bytes(got), _bytes(t))
    if t.nbytes >= 512:  # the bytes travel out of band, in one buffer
        assert len(so.buffers) == 1


def test_reducer_leaves_torch_save_as_it_is():
    """The reducer is the object store's alone: after it has run, torch.save
    still writes what torch.load(weights_only=True) reads."""
    import io

    serialization.serialize(_tensors())
    buf = io.BytesIO()
    torch.save({"w": _tensors()["bf16"]}, buf)
    buf.seek(0)
    assert torch.equal(torch.load(buf, weights_only=True)["w"], _tensors()["bf16"])


def test_tensors_through_the_object_store(torch_cluster):  # noqa: F811
    sent = _tensors()
    got = ray_tpu_torch.get(ray_tpu_torch.put(sent))
    for name, t in sent.items():
        assert torch.equal(_bytes(got[name]), _bytes(t)), name

    @ray_tpu_torch.remote
    def make():
        import torch

        return torch.randn(128, 64, generator=torch.Generator().manual_seed(3)).to(torch.bfloat16)

    want = torch.randn(128, 64, generator=torch.Generator().manual_seed(3)).to(torch.bfloat16)
    assert torch.equal(ray_tpu_torch.get(make.remote()), want)


# -- the bench's e2e loop on the CPU ----------------------------------------------

E2E = dict(n_blocks=4, rows=16, size=32, batch=16, seed=0,
           model=dict(depth=18, width=8, num_classes=64, dtype=torch.float32))


def _bare_first_loss(first_labels) -> float:
    """The e2e loop's warm-up and first step, bare, on the rows the worker's
    first batch held (the labels are the rows' ids)."""
    size, rows, batch = E2E["size"], E2E["rows"], E2E["batch"]
    cfg = resnet.ResNetConfig(**E2E["model"])
    blocks = {}
    images = []
    for row in first_labels:
        blk = row // rows
        if blk not in blocks:
            blocks[blk] = synth_block({"id": np.array([blk])}, rows, size,
                                      cfg.num_classes)["image"]
        images.append(blocks[blk][row % rows])
    raw = torch.from_numpy(np.stack(images))
    init_state, step = resnet.make_train_step(cfg, device="cpu")
    state = init_state(torch.Generator().manual_seed(E2E["seed"]))
    zeros = torch.zeros(batch, size * size * 3, dtype=torch.uint8)
    state, _ = step(state, {"images": resnet.images_from_uint8(zeros, size, cfg.dtype),
                            "labels": torch.zeros(batch, dtype=torch.int64)})
    _, m = step(state, {"images": resnet.images_from_uint8(raw, size, cfg.dtype),
                        "labels": torch.tensor(first_labels)})
    return float(m["loss"])


def test_rows_diff_names_missing_and_extra_rows():
    """The e2e check's diagnostic: rows read in order against the rows
    synth_block makes. A row whose bytes belong to another block shows as
    one extra (its position, batch and the block its bytes came from) and
    one missing (its own block and row); intact reads show neither."""
    from ray_tpu_torch.bench import rows_diff, rows_intact

    n_blocks, rows, size, classes = 3, 8, 16, 10
    labels, sums = [], []
    for blk in range(n_blocks):
        b = synth_block({"id": np.array([blk])}, rows, size, classes)
        labels += b["label"].tolist()
        sums += b["image"].sum(axis=1, dtype=np.int64).tolist()
    assert rows_diff(labels[::-1], sums[::-1], n_blocks, rows, size, classes, 4) == {
        "missing": [], "extra": []}
    bad = list(sums)
    bad[5] = sums[2 * rows + 1]  # block 0's row 5 read with block 2's row 1's bytes
    diff = rows_diff(labels, bad, n_blocks, rows, size, classes, 4)
    assert diff["extra"] == [{"label": labels[5], "byte_sum": sums[2 * rows + 1], "position": 5,
                              "batch": 1, "bytes_of": (2, 1)}]
    assert diff["missing"] == [{"label": labels[5], "byte_sum": sums[5], "block": 0, "row": 5}]
    assert rows_intact(labels, sums, n_blocks, rows, size, classes)
    assert not rows_intact(labels, bad, n_blocks, rows, size, classes)


@pytest.mark.timeout(180)
def test_e2e_loop_counts_every_image_once_and_steps_as_bare(torch_cluster, tmp_path):  # noqa: F811
    from ray_tpu_torch.bench import make_dataset, rows_intact

    def train_fn(config):
        import torch

        # PyTorch 2.13's CPU oneDNN corrupts the heap on this model's 1x1
        # stride-2 convolution with 8 input channels (test_torch_resnet.py).
        torch.backends.mkldnn.enabled = False
        from ray_tpu_torch.bench import e2e_train_loop

        e2e_train_loop(config)

    n = E2E["n_blocks"] * E2E["rows"]
    result = TorchTrainer(
        train_fn,
        train_loop_config={k: E2E[k] for k in ("model", "size", "batch", "seed")},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
        worker_env=ONE_THREAD,
        run_config=RunConfig(name="t_e2e", storage_path=str(tmp_path)),
        datasets={"train": make_dataset(E2E["n_blocks"], E2E["rows"], E2E["size"],
                                        E2E["model"]["num_classes"])},
    ).fit()
    m = result.metrics
    assert m["n"] == n and m["device"] == "cpu"
    assert sorted(m["labels"]) == list(range(n))  # labels are row ids: every image once
    assert rows_intact(m["labels"], m["row_sums"], E2E["n_blocks"], E2E["rows"], E2E["size"],
                       E2E["model"]["num_classes"])
    assert m["forbidden_modules"] == []
    threads = torch.get_num_threads()
    enabled = torch.backends.mkldnn.enabled
    torch.set_num_threads(1)
    torch.backends.mkldnn.enabled = False
    try:
        bare = _bare_first_loss(m["labels"][:E2E["batch"]])
    finally:
        torch.set_num_threads(threads)
        torch.backends.mkldnn.enabled = enabled
    assert abs(m["first_loss"] - bare) <= LOSS_ATOL, (m["first_loss"], bare)


@pytest.mark.timeout(120)
def test_held_batches_keep_their_rows_past_their_blocks_refs(monkeypatch):
    """The bench's e2e rows fault, on the CPU: a pipeline's batches, held
    after the executor has dropped their blocks' refs, keep the rows
    synth_block made for them while a few hundred later objects reuse the
    store's arena (a batch is a zero-copy view of its block: the store hold
    follows the view, not the ref)."""
    import gc
    import time

    from ray_tpu_torch import bench

    monkeypatch.setenv("RAY_TPU_OBJECT_STORE_EVICTION_GRACE_S", "0.2")  # reuse comes soon
    n_blocks, rows, size, classes = 8, 16, 64, 1000  # 196 KB blocks: the shm store
    ray_tpu_torch.init(num_cpus=2)
    try:
        ds = bench.make_dataset(n_blocks, rows, size, classes)
        held = list(ds.iter_batches(batch_size=rows // 2))
        gc.collect()
        time.sleep(0.5)

        @ray_tpu_torch.remote
        def later(i):
            return np.full(rows * size * size * 3, i % 251, np.uint8)

        for i in range(300):
            ray_tpu_torch.get(later.remote(i))
        labels = [int(x) for b in held for x in b["label"]]
        sums = [int(s) for b in held for s in b["image"].sum(axis=1, dtype=np.int64)]
    finally:
        ray_tpu_torch.shutdown()
    assert len(labels) == n_blocks * rows
    diff = bench.rows_diff(labels, sums, n_blocks, rows, size, classes, batch=rows // 2)
    assert bench.rows_intact(labels, sums, n_blocks, rows, size, classes), diff


@pytest.mark.timeout(120)
def test_blocks_are_fetched_in_order_so_the_next_one_has_room(monkeypatch, tmp_path):
    """The pipelined block fetch when the arena holds two of three blocks:
    the first block's task ends after the other two are in the store.
    Fetched in order, the first block gets its room (the other two spill)
    and all three reach the consumer intact. Fetched all at once, the two
    later blocks were held (their zero-copy buffers keep their store holds,
    so they cannot spill) and the first block's create waited for room
    until it timed out."""
    import json
    import time

    from ray_tpu_torch.data.iterator import iter_blocks_pipelined

    mb = 1 << 20
    monkeypatch.setenv("RAY_TPU_OBJECT_SPILLING_CONFIG", json.dumps(
        {"type": "filesystem", "params": {"directory_path": str(tmp_path)}}))
    monkeypatch.setenv("RAY_TPU_OBJECT_STORE_CREATE_TIMEOUT_S", "10")
    ray_tpu_torch.init(num_cpus=2, object_store_memory=16 * mb)
    try:
        @ray_tpu_torch.remote
        def late(i):
            time.sleep(2)
            return np.full(6 * mb, i, np.uint8)

        first = late.remote(1)
        rest = [ray_tpu_torch.put(np.full(6 * mb, i, np.uint8)) for i in (2, 3)]
        got = [(int(b[0]), int(b[-1]), len(b))
               for b in iter_blocks_pipelined(iter([first, *rest]), lookahead=4)]
    finally:
        ray_tpu_torch.shutdown()
    assert got == [(i, i, 6 * mb) for i in (1, 2, 3)]
