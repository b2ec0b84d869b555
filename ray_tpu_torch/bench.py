"""The port's benchmark: ResNet-50 and GPT-2-small training on one GPU, and
ingest -> train through the port's Data and trainer (counterpart of the JAX
package's bench.py).

    python -m ray_tpu_torch.bench                # one CUDA card; raises without one
    python -m ray_tpu_torch.bench --device cpu   # probe shapes on the CPU

Prints ONE JSON line with bench.py's keys. Three phases, each in its own
subprocess, as bench.py runs them:

1. **step**: the ResNet-50 train step (1000 classes, bf16 on f32 master
   weights, batch 128 at 224x224, SGD(0.1, momentum 0.9)) on images resident
   on the card: one untimed warm-up, then 30 steps timed with the card
   synchronised at the ends. `flops_per_image` is what
   torch.utils.flop_counter counts over the warm-up step (convolutions and
   matrix products, 2 per multiply-add, forward and backward), cross-checked
   against the analytic count of `models.resnet.train_flops_per_image`
   (3 forwards less the stem's input gradient). It counts fewer operations
   than bench.py's XLA cost analysis, which also counts batch norm and the
   elementwise work, so the two MFUs are not the same count. bench.py's
   `hbm_gb_per_step` (XLA's bytes accessed) has no counterpart in eager
   PyTorch and is left out.
2. **transformer**: GPT-2 small (vocab 50304, d 768, 12 layers, 12 heads, seq
   1024, remat) at bench.py's batch 32, AdamW(1e-3), a warm-up and 40 timed
   steps through the hand-written flash kernels; useful- and hardware-MFU
   as bench.py defines them.
3. **e2e**: a `ray_tpu_torch.data` pipeline (16 synth-decode tasks of 256
   uint8 224x224x3 images each, 4096 images, ~616 MB through the object
   store) streamed into a one-worker GPU TorchTrainer that runs the step of
   phase 1 at batch 256 (`e2e_train_loop`), plus the breakdown
   ingest-only (the whole pipeline, no device) and iter-only (materialised
   blocks to batches). The driver also puts a bf16 CUDA tensor through the
   object store and has a GPU task return one; both must come back bitwise
   equal on the host.

MFU is against the card's dense bf16 peak by name (`device.peak_bf16_flops`);
a CPU run reports none. `vs_baseline` is the e2e rate over the reference's
one-GPU Train-ResNet e2e number, 40.7 images/s, as in bench.py.
A phase that fails makes the bench fail: no phase's error is folded into
the line.
"""

from __future__ import annotations

import argparse
import functools
import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

BASELINE_IMAGES_PER_SEC = 40.7  # reference: 1-GPU Train ResNet e2e
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _card(dev) -> dict:
    """The device's name, and its dense bf16 peak on a card (none on the CPU)."""
    import torch

    from ray_tpu_torch.device import peak_bf16_flops

    if dev.type != "cuda":
        return {"device_kind": "cpu", "peak_flops": None}
    name = torch.cuda.get_device_name(dev)
    return {"device_kind": name, "peak_flops": peak_bf16_flops(name)}


def _max_memory_gib(dev):
    import torch

    return torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None


# ---------------------------------------------------------------- phase 1


def phase_step(device: str) -> dict:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from ray_tpu_torch.device import resolve_device
    from ray_tpu_torch.models import resnet

    dev = resolve_device(device)
    on_gpu = dev.type == "cuda"
    batch, size, steps = (128, 224, 30) if on_gpu else (8, 64, 3)
    cfg = resnet.ResNetConfig(depth=50, num_classes=1000,
                              dtype=torch.bfloat16 if on_gpu else torch.float32)
    gen = torch.Generator(device=dev).manual_seed(0)
    init_state, step = resnet.make_train_step(cfg, dev)
    state = init_state(gen)
    images = torch.randn(batch, size, size, 3, generator=gen, device=dev).to(cfg.dtype)
    labels = torch.randint(0, cfg.num_classes, (batch,), generator=gen, device=dev)
    data = {"images": images.permute(0, 3, 1, 2), "labels": labels}  # channels_last

    with FlopCounterMode(display=False) as counter:  # the warm-up step
        state, m = step(state, data)
    first_loss = float(m["loss"])
    if on_gpu:
        torch.cuda.reset_peak_memory_stats(dev)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step(state, data)
    _sync(dev)
    dt = time.perf_counter() - t0

    flops_per_image = counter.get_total_flops() / batch
    images_per_sec = batch * steps / dt
    card = _card(dev)
    peak = card["peak_flops"]
    return {
        "step_images_per_sec": images_per_sec,
        "mfu": flops_per_image * images_per_sec / peak if peak else None,
        "flops_per_image": flops_per_image,
        "analytic_flops_per_image": resnet.train_flops_per_image(cfg, size),
        **card,
        "batch": batch,
        "image_size": size,
        "step_ms": dt / steps * 1e3,
        "step_loss_first": first_loss,
        "step_loss_last": float(m["loss"]),
        "step_max_memory_gib": _max_memory_gib(dev),
    }


# ---------------------------------------------------------------- phase 2


def phase_transformer(device: str) -> dict:
    import torch

    from ray_tpu_torch.device import resolve_device
    from ray_tpu_torch.models import transformer as tr

    # The module, not the function `ray_tpu_torch.ops` exports under its name.
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

    dev = resolve_device(device)
    if dev.type == "cuda":
        cfg = tr.TransformerConfig(vocab_size=50304, d_model=768, n_layers=12, n_heads=12,
                                   max_seq_len=1024, dtype=torch.bfloat16, remat=True)
        B, S, steps = 32, 1024, 40
    else:  # probe shapes, bench.py's
        cfg = tr.TransformerConfig(vocab_size=512, d_model=128, n_layers=2, n_heads=4,
                                   max_seq_len=128, dtype=torch.float32)
        B, S, steps = 4, 64, 3
    # bench.py's optax.adamw(1e-3): weight decay 1e-4 by default.
    init_state, step = tr.make_train_step(
        cfg, dev, optimizer=lambda p: tr.adamw(p, lr=1e-3, weight_decay=1e-4))
    gen = torch.Generator(device=dev).manual_seed(0)
    state = init_state(gen)
    raw = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen, device=dev)
    batch = {"tokens": raw[:, :-1].contiguous(), "targets": raw[:, 1:].contiguous()}

    fa.reset_launches()
    state, m = step(state, batch)  # warm-up
    first_loss = float(m["loss"])
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step(state, batch)
    _sync(dev)
    dt = time.perf_counter() - t0

    tokens_per_sec = B * S * steps / dt
    n_params = sum(p.numel() for p in state["model"].parameters())
    useful = tr.flops_per_token(cfg, S)
    hardware = tr.hardware_flops_per_token(cfg, S)
    peak = _card(dev)["peak_flops"]
    return {
        "transformer_tokens_per_sec": tokens_per_sec,
        "transformer_mfu": useful * tokens_per_sec / peak if peak else None,
        "transformer_hw_mfu": hardware * tokens_per_sec / peak if peak else None,
        "transformer_useful_flops_per_token": useful,
        "transformer_hw_flops_per_token": hardware,
        "transformer_remat": bool(cfg.remat),
        "transformer_params_m": n_params / 1e6,
        "transformer_batch": B,
        "transformer_seq": S,
        "transformer_step_ms": dt / steps * 1e3,
        "transformer_loss_first": first_loss,
        "transformer_loss_last": float(m["loss"]),
        "transformer_max_memory_gib": _max_memory_gib(dev),
        "transformer_flash_launches": dict(fa.launches),
    }


# ---------------------------------------------------------------- phase 3


def synth_block(batch, rows: int, size: int, num_classes: int) -> dict:
    """Stands in for read+decode: one columnar block of `rows` raw uint8
    images ([rows, size*size*3], HWC rows) drawn from a seed that is the
    block's id, so the (rows, size*size*3) array moves through the object
    store as one buffer. Labels are the rows' ids modulo the class count,
    so a consumer can tell which rows it got."""
    seed = int(np.asarray(batch["id"]).reshape(-1)[0])
    rng = np.random.default_rng(seed)
    # rng.bytes writes every byte: real per-image data, not views of one buffer.
    images = np.frombuffer(rng.bytes(rows * size * size * 3), dtype=np.uint8)
    labels = (seed * rows + np.arange(rows)) % num_classes
    return {"image": images.reshape(rows, size * size * 3), "label": labels.astype(np.int64)}


def rows_diff(labels, row_sums, n_blocks: int, rows: int, size: int, num_classes: int,
              batch: int) -> dict:
    """The (label, byte sum) pairs of the rows a consumer read, in read
    order, against those of the n_blocks blocks synth_block makes, as
    multisets: "missing" made rows not read, each with its block and row;
    "extra" read rows not made, each with its position, its batch (position
    // batch) and the (block, row) whose bytes have its byte sum, if any.
    Both empty when every row was read once with its own label and bytes."""
    made = {}
    for blk in range(n_blocks):
        b = synth_block({"id": np.array([blk])}, rows, size, num_classes)
        sums = b["image"].sum(axis=1, dtype=np.int64).tolist()
        for r, pair in enumerate(zip(b["label"].tolist(), sums)):
            made.setdefault(pair, []).append((blk, r))
    of_bytes = {pair[1]: where[0] for pair, where in made.items()}
    missing = {pair: list(where) for pair, where in made.items()}
    extra = []
    for i, pair in enumerate(zip(labels, row_sums)):
        if missing.get(pair):
            missing[pair].pop()
        else:
            extra.append({"label": pair[0], "byte_sum": pair[1], "position": i,
                          "batch": i // batch, "bytes_of": of_bytes.get(pair[1])})
    missing = [{"label": pair[0], "byte_sum": pair[1], "block": blk, "row": r}
               for pair, where in missing.items() for blk, r in where]
    return {"missing": missing, "extra": extra}


def rows_intact(labels, row_sums, n_blocks: int, rows: int, size: int,
                num_classes: int) -> bool:
    """Whether the (label, byte sum) pairs of the rows a consumer read are,
    in any order, those of the n_blocks blocks synth_block makes: every row
    once, each with its own label and bytes."""
    diff = rows_diff(labels, row_sums, n_blocks, rows, size, num_classes, batch=1)
    return not diff["missing"] and not diff["extra"]


def make_dataset(n_blocks: int, rows: int, size: int, num_classes: int):
    from ray_tpu_torch import data as rd

    return rd.range(n_blocks, parallelism=n_blocks).map_batches(
        functools.partial(synth_block, rows=rows, size=size, num_classes=num_classes),
        batch_size=1)


class HostToDevice:
    """The e2e loop's `_finalize_fn`: a numpy batch -> (uint8 images [B,
    H*W*3], int64 labels [B], the event their copy records or None) on
    `dev`. It runs in the prefetch thread, whose current CUDA device is its
    own, so every call names `dev`. On a card the batch is copied into a
    pinned buffer, then to the card on a side stream; the consumer's stream
    waits on the event before it reads. A ring of `depth` pinned buffers
    serves the batches in flight, and a buffer is written again only after
    the event of its last copy has completed."""

    def __init__(self, dev, depth: int):
        import torch

        self.dev = dev
        if dev.type == "cuda":
            self.stream = torch.cuda.Stream(device=dev)
            self.ring = [None] * depth  # (pinned images, pinned labels, event)
            self.next = 0

    def __call__(self, batch):
        import torch

        images = np.asarray(batch["image"])
        labels = np.asarray(batch["label"], dtype=np.int64)
        if self.dev.type != "cuda":
            return torch.from_numpy(images.copy()), torch.from_numpy(labels.copy()), None
        slot = self.ring[self.next]
        if slot is not None:
            slot[2].synchronize()  # its last copy has finished: the buffers are free
        if slot is None or slot[0].shape[0] < len(images):
            slot = (torch.empty(images.shape, dtype=torch.uint8, pin_memory=True),
                    torch.empty(labels.shape, dtype=torch.int64, pin_memory=True), None)
        pinned_images, pinned_labels = slot[0][:len(images)], slot[1][:len(labels)]
        np.copyto(pinned_images.numpy(), images)
        np.copyto(pinned_labels.numpy(), labels)
        with torch.cuda.stream(self.stream):
            out_images = pinned_images.to(self.dev, non_blocking=True)
            out_labels = pinned_labels.to(self.dev, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self.stream)
        self.ring[self.next] = (slot[0], slot[1], copied)
        self.next = (self.next + 1) % len(self.ring)
        return out_images, out_labels, copied


def e2e_train_loop(config) -> None:
    """The train loop of the e2e phase, run by a TorchTrainer worker: the
    ResNet step of `config["model"]` on get_device(), fed by the worker's
    "train" dataset shard through HostToDevice, with the uint8 -> [-1, 1]
    normalisation on the device. A warm-up step on a zero batch comes
    first, outside the timed window; the window covers the whole warm
    pipeline (execution, iteration, host-to-device copy and the steps).
    Reports the rate, the images seen, every row's label and the sum of
    its bytes as the step read them (for rows_intact), the first and last
    losses and the modules loaded."""
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models import resnet
    from ray_tpu_torch.train.torch import get_device

    dev = get_device()
    cfg = resnet.ResNetConfig(**config["model"])
    size, batch = config["size"], config["batch"]
    init_state, step = resnet.make_train_step(cfg, dev)
    state = init_state(torch.Generator(device=dev).manual_seed(config["seed"]))
    zeros = torch.zeros(batch, size * size * 3, dtype=torch.uint8, device=dev)
    state, _ = step(state, {"images": resnet.images_from_uint8(zeros, size, cfg.dtype),
                            "labels": torch.zeros(batch, dtype=torch.int64, device=dev)})
    _sync(dev)

    prefetch = 2
    shard = train.get_dataset_shard("train")
    losses, seen, sums = [], [], []
    n = 0
    t0 = time.perf_counter()
    for raw, labels, copied in shard.iter_batches(
            batch_size=batch, batch_format="numpy", prefetch_batches=prefetch,
            _finalize_fn=HostToDevice(dev, depth=prefetch + 2)):
        if copied is not None:
            stream = torch.cuda.current_stream(dev)
            stream.wait_event(copied)
            raw.record_stream(stream)  # allocated on the copy stream
            labels.record_stream(stream)
        sums.append(raw.sum(dim=1, dtype=torch.int64))  # on the step's stream, after the wait
        state, m = step(state, {"images": resnet.images_from_uint8(raw, size, cfg.dtype),
                                "labels": labels})
        losses.append(m["loss"])
        seen.append(labels)
        n += len(labels)
    if n == 0:
        raise RuntimeError("dataset shard yielded no batches")
    _sync(dev)
    dt = time.perf_counter() - t0
    train.report({
        "e2e_images_per_sec": n / dt,
        "n": n,
        "labels": torch.cat(seen).cpu().tolist(),
        "row_sums": torch.cat(sums).cpu().tolist(),
        "first_loss": float(losses[0]),
        "last_loss": float(losses[-1]),
        "device": str(dev),
        "max_memory_gib": _max_memory_gib(dev),
        "forbidden_modules": [m for m in sys.modules
                              if m.split(".")[0] in ("jax", "jaxlib", "optax", "ray_tpu")],
    })


def _tensor_round_trips(dev) -> dict:
    """A bf16 tensor on `dev` through put/get, and a task on the same kind
    of device returning one: both must come back to the driver as host
    tensors bitwise equal to what was sent."""
    import torch

    import ray_tpu_torch as rt

    def seeded(d):
        gen = torch.Generator(device=d).manual_seed(7)
        return torch.randn(512, 1024, generator=gen, device=d).to(torch.bfloat16)

    sent = seeded(dev)
    got = rt.get(rt.put(sent))
    task = rt.remote(num_gpus=1)(seeded) if dev.type == "cuda" else rt.remote(seeded)
    made = rt.get(task.remote(dev))
    out = {"e2e_put_get_bitwise": bool(got.device.type == "cpu"
                                       and torch.equal(got, sent.cpu())),
           "e2e_task_tensor_bitwise": bool(made.device.type == "cpu"
                                           and torch.equal(made, sent.cpu()))}
    if not all(out.values()):
        raise RuntimeError(f"a {dev.type} tensor did not come back bitwise equal: {out}")
    return out


def phase_e2e(device: str) -> dict:
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import data as rd
    from ray_tpu_torch.air import RunConfig, ScalingConfig
    from ray_tpu_torch.data.iterator import batches_from_blocks
    from ray_tpu_torch.device import resolve_device
    from ray_tpu_torch.train.torch import TorchTrainer

    dev = resolve_device(device)
    on_gpu = dev.type == "cuda"
    n_blocks, rows, size, batch = (16, 256, 224, 256) if on_gpu else (4, 16, 64, 8)
    model = dict(depth=50, num_classes=1000, dtype=torch.bfloat16 if on_gpu else torch.float32)
    make_ds = functools.partial(make_dataset, n_blocks, rows, size, model["num_classes"])

    storage = tempfile.mkdtemp(prefix="ray_tpu_torch_bench_e2e_")
    rt.init(num_cpus=4)
    try:
        round_trips = _tensor_round_trips(dev)
        # Warm the worker pool (spawn and import) with a throwaway pipeline,
        # so the measured window is steady-state ingest, as bench.py does.
        warm = rd.range(4, parallelism=4).map_batches(
            lambda b: {"x": np.zeros((2, 8), dtype=np.uint8)}, batch_size=1)
        for _ in warm.iter_batches(batch_size=None):
            pass

        result = TorchTrainer(
            e2e_train_loop,
            train_loop_config={"model": model, "size": size, "batch": batch, "seed": 0},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=on_gpu),
            run_config=RunConfig(name="bench_e2e", storage_path=storage),
            datasets={"train": make_ds()},
        ).fit()
        worker = result.metrics
        diff = rows_diff(worker["labels"], worker["row_sums"], n_blocks, rows, size,
                         model["num_classes"], batch)
        if diff["missing"] or diff["extra"]:
            # Which rows, batches and blocks: the clue to a fault seen once.
            raise RuntimeError("the e2e worker's step read rows that synth_block did not "
                               f"make: {json.dumps(diff)[:6000]}")

        # breakdown: ingest-only (the whole warm pipeline, no device work)
        shard = make_ds().streaming_split(1)[0]
        n = 0
        t0 = time.perf_counter()
        for b in shard.iter_batches(batch_size=batch, prefetch_batches=2):
            n += len(b["label"])
        ingest_only = n / (time.perf_counter() - t0)

        # breakdown: iter-only (materialised blocks -> batches)
        blocks = list(make_ds().iter_blocks())
        n = 0
        t0 = time.perf_counter()
        for b in batches_from_blocks(iter(blocks), batch, "numpy"):
            n += len(b["label"])
        iter_only = n / (time.perf_counter() - t0)
    finally:
        rt.shutdown()
        shutil.rmtree(storage, ignore_errors=True)
    return {
        "e2e_images_per_sec": worker["e2e_images_per_sec"],
        "e2e_images": worker["n"],
        "ingest_only_images_per_sec": ingest_only,
        "iter_only_images_per_sec": iter_only,
        "e2e_batch": batch,
        "e2e_dataset_images": n_blocks * rows,
        "e2e_rows_intact": True,
        "e2e_loss_first": worker["first_loss"],
        "e2e_loss_last": worker["last_loss"],
        "e2e_worker_device": worker["device"],
        "e2e_worker_max_memory_gib": worker["max_memory_gib"],
        "e2e_worker_forbidden_modules": worker["forbidden_modules"],
        **round_trips,
    }


# ------------------------------------------------------------------- main

PHASES = {"step": phase_step, "transformer": phase_transformer, "e2e": phase_e2e}


def _run_phase(name: str, device: str) -> dict:
    """Run one phase in a subprocess of its own; raises if it fails."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.bench", "--phase", name, "--device", device],
        capture_output=True, text=True, timeout=1800, env=env,
    )
    if out.returncode != 0:
        raise RuntimeError(f"phase {name} failed (exit {out.returncode}):\n"
                           f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="python -m ray_tpu_torch.bench")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--phase", choices=PHASES)
    args = parser.parse_args(argv)
    if args.phase:
        print(json.dumps(PHASES[args.phase](args.device)), flush=True)
        return
    from ray_tpu_torch.device import resolve_device

    resolve_device(args.device)  # raises here without a card
    step, tf, e2e = (_run_phase(name, args.device) for name in PHASES)
    print(json.dumps({
        "metric": "resnet50_train_images_per_sec_1chip",
        "value": step["step_images_per_sec"],
        "unit": "images/sec",
        # The baseline is the reference's e2e-with-ingest number: like with like.
        "vs_baseline": e2e["e2e_images_per_sec"] / BASELINE_IMAGES_PER_SEC,
        **{k: v for k, v in step.items() if k != "step_images_per_sec"},
        **tf,
        **e2e,
    }), flush=True)


if __name__ == "__main__":
    main()
