"""ray_tpu_torch.train on the CPU (use_gpu=False, gloo): the cases of
tests/test_train.py through the port's TorchTrainer, then the GPU trainer's
parity (ROADMAP A7): the tiny f32 train step of tests/test_torch_train_step.py
through a one-worker trainer against the bare step and the JAX package's,
a two-worker DDP step on half batches against the bare step on the whole
batch, a checkpoint resume, and a GPU gang without a card.
tests/test_train.py's test_jax_trainer_reports_and_context has its
counterpart here in test_torch_trainer_reports_and_context (a TorchTrainer
in place of the JaxTrainer); test_collective_across_train_workers runs on
the gang's collective group as in the reference, and
test_all_reduce_across_train_workers on its gloo process group.

Train loops are nested functions, so cloudpickle ships them by value: a
worker never imports this module (which imports jax)."""

import os

import numpy as np
import pytest
import torch
from test_torch_train_step import (
    GNORM_RTOL,
    LOSS_RTOL,
    LR,
    TINY,
    WD,
    _assert_params_close,
    _run_jax,
)

import jax.numpy as jnp  # noqa: E402  (test_torch_train_step set up jax)
import ray_tpu_torch
from ray_tpu.models import transformer as jax_tr
from ray_tpu_torch import train
from ray_tpu_torch.air import CheckpointConfig, FailureConfig, RunConfig, ScalingConfig
from ray_tpu_torch.convert import params_from_jax, params_to_numpy
from ray_tpu_torch.models import transformer as tr
from ray_tpu_torch.testing import torch_cluster  # noqa: F401
from ray_tpu_torch.train import Checkpoint, TrainingFailedError
from ray_tpu_torch.train.base_trainer import _CheckpointManager, _shard_datasets
from ray_tpu_torch.train.torch import TorchTrainer

CPU = dict(use_gpu=False)
# Train workers import torch after their actor sets this: one intra-op
# thread each, so the gangs leave the suite's other tests their cores.
ONE_THREAD = {"OMP_NUM_THREADS": "1"}
# DDP on half batches against the bare step on the whole batch: the same
# f32 sums, the gradient averaged across two ranks instead of taken over
# one batch; SGD, so a parameter moves by lr times its gradient.
DDP_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The bare steps here run on one intra-op thread too: the suite runs
    timing-sensitive tests of the runtime beside this file."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(tmp_path, name):
    return RunConfig(name=name, storage_path=str(tmp_path))


# -- the cases of tests/test_train.py ------------------------------------------


@pytest.mark.timeout(120)
def test_torch_trainer_reports_and_context(torch_cluster, tmp_path):  # noqa: F811
    def train_fn(config):
        ctx = train.get_context()
        for i in range(config["steps"]):
            train.report({"step": i, "rank": ctx.get_world_rank(),
                          "world": ctx.get_world_size()})

    result = TorchTrainer(
        train_fn,
        train_loop_config={"steps": 3},
        scaling_config=ScalingConfig(num_workers=2, **CPU), worker_env=ONE_THREAD,
        run_config=_cfg(tmp_path, "t_basic"),
    ).fit()
    assert result.error is None
    assert len(result.metrics_history) == 3
    assert result.metrics["step"] == 2
    assert result.metrics["world"] == 2
    assert result.metrics["rank"] == 0  # driver keeps rank-0 metrics


@pytest.mark.timeout(120)
def test_checkpoint_save_and_resume(torch_cluster, tmp_path):  # noqa: F811
    def train_fn(config):
        import json
        import tempfile

        start = 0
        ckpt = train.get_checkpoint()
        if ckpt:
            with ckpt.as_directory() as d:
                start = json.load(open(os.path.join(d, "state.json")))["step"] + 1
        for i in range(start, start + 2):
            if train.get_context().get_world_rank() == 0:
                with tempfile.TemporaryDirectory() as d:
                    json.dump({"step": i}, open(os.path.join(d, "state.json"), "w"))
                    train.report({"step": i}, checkpoint=Checkpoint.from_directory(d))
            else:
                train.report({"step": i})

    r1 = TorchTrainer(train_fn, scaling_config=ScalingConfig(num_workers=2, **CPU),
                      worker_env=ONE_THREAD,
                      run_config=_cfg(tmp_path, "t_ckpt")).fit()
    assert r1.checkpoint is not None
    assert os.path.exists(os.path.join(r1.checkpoint.path, "state.json"))
    r2 = TorchTrainer(train_fn, scaling_config=ScalingConfig(num_workers=2, **CPU),
                      worker_env=ONE_THREAD,
                      run_config=_cfg(tmp_path, "t_ckpt2"),
                      resume_from_checkpoint=r1.checkpoint).fit()
    assert [m["step"] for m in r2.metrics_history] == [2, 3]  # resumed after step 1


@pytest.mark.timeout(120)
def test_all_reduce_across_train_workers(torch_cluster, tmp_path):  # noqa: F811
    """ray_tpu's collective-group case, through the gang's gloo process
    group: each rank adds rank + 1."""

    def train_fn(config):
        import torch
        import torch.distributed as dist

        ctx = train.get_context()
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 2
        x = torch.tensor([float(ctx.get_world_rank() + 1)])
        dist.all_reduce(x)
        train.report({"sum": float(x[0])})

    result = TorchTrainer(train_fn, scaling_config=ScalingConfig(num_workers=2, **CPU),
                          worker_env=ONE_THREAD,
                          run_config=_cfg(tmp_path, "t_coll")).fit()
    assert result.metrics["sum"] == 3.0  # 1 + 2


def test_collective_across_train_workers(torch_cluster, tmp_path):  # noqa: F811
    """ray_tpu's case on the port: the gang's collective group (TorchConfig's
    "store" backend by default) allreduces each rank's rank + 1."""

    def train_fn(config):
        from ray_tpu_torch.util import collective

        ctx = train.get_context()
        group = ctx.get_collective_group()
        assert group is not None
        out = collective.allreduce(
            np.array([float(ctx.get_world_rank() + 1)]), group_name=group
        )
        train.report({"sum": float(np.asarray(out)[0])})

    result = TorchTrainer(
        train_fn,
        scaling_config=ScalingConfig(num_workers=2, **CPU),
        worker_env=ONE_THREAD,
        run_config=RunConfig(name="t_coll", storage_path=str(tmp_path)),
    ).fit()
    assert result.metrics["sum"] == 3.0  # 1 + 2


@pytest.mark.timeout(120)
def test_failure_raises_training_failed(torch_cluster, tmp_path):  # noqa: F811
    def train_fn(config):
        raise ValueError("boom")

    trainer = TorchTrainer(
        train_fn,
        scaling_config=ScalingConfig(num_workers=1, **CPU), worker_env=ONE_THREAD,
        run_config=RunConfig(name="t_fail", storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=0)),
    )
    with pytest.raises(TrainingFailedError, match="boom"):
        trainer.fit()


def test_checkpoint_manager_topk(tmp_path):
    mgr = _CheckpointManager(CheckpointConfig(num_to_keep=2, checkpoint_score_attribute="acc"))
    paths = []
    for i, acc in enumerate([0.1, 0.9, 0.5]):
        p = tmp_path / f"ckpt_{i}"
        p.mkdir()
        paths.append(str(p))
        mgr.register(str(p), {"acc": acc})
    kept = [c[0] for c in mgr.checkpoints]
    assert str(tmp_path / "ckpt_0") not in kept  # worst dropped
    assert not os.path.exists(paths[0])
    assert mgr.best() == str(tmp_path / "ckpt_1")


def test_shard_datasets_sequences():
    shards = _shard_datasets({"train": [1, 2, 3, 4, 5]}, 2)
    assert shards[0]["train"] == [1, 3, 5]
    assert shards[1]["train"] == [2, 4]


@pytest.mark.timeout(120)
def test_dataset_shard_in_session(torch_cluster, tmp_path):  # noqa: F811
    def train_fn(config):
        shard = train.get_dataset_shard("train")
        train.report({"n": len(shard), "total": sum(shard)})

    result = TorchTrainer(train_fn, scaling_config=ScalingConfig(num_workers=2, **CPU),
                          worker_env=ONE_THREAD,
                          run_config=_cfg(tmp_path, "t_ds"),
                          datasets={"train": list(range(10))}).fit()
    assert result.metrics["n"] == 5


def test_rendezvous_port_is_listening_when_handed_out():
    """Rank 0's store is bound before its port goes to the other ranks: a
    client connects at once, and the store answers it. A probe that binds
    port 0, reads the number and closes its socket hands out a port nobody
    listens on, which another process can take before init_process_group
    binds it again (EADDRINUSE, and the gang's setup times out)."""
    import socket

    import torch.distributed as dist

    from ray_tpu_torch.train import torch as train_torch

    port = train_torch._bind_store("127.0.0.1", 2, 30.0)
    try:
        socket.create_connection(("127.0.0.1", port), timeout=5).close()
        client = dist.TCPStore("127.0.0.1", port, 2, is_master=False)
        client.set("rank1", "ready")
        assert train_torch._store.get("rank1") == b"ready"
    finally:
        train_torch._teardown_worker()
    assert train_torch._store is None


# -- the GPU trainer's parity, on the CPU ---------------------------------------


def _tiny(dtype=torch.float32):
    return tr.TransformerConfig(**TINY, dtype=dtype, attention_impl="kernel")


@pytest.mark.timeout(150)
def test_one_worker_trainer_step_matches_bare_and_jax(torch_cluster, tmp_path):  # noqa: F811
    """The tiny f32 step through a one-worker trainer equals the bare
    make_train_step and the JAX package's, within test_torch_train_step's
    tolerances, at each of 3 steps."""
    steps = 3
    jcfg = jax_tr.TransformerConfig(**TINY, dtype=jnp.float32, attention_impl="xla")
    toks = np.random.RandomState(1).randint(0, TINY["vocab_size"], (4, 17)).astype(np.int32)
    init, jax_trace = _run_jax(jcfg, toks, steps=steps)
    tcfg = _tiny()

    def train_fn(config):
        import torch

        from ray_tpu_torch.convert import params_from_jax, params_to_numpy
        from ray_tpu_torch.models import transformer as tr
        from ray_tpu_torch.train.torch import get_device

        dev = get_device()
        cfg = config["cfg"]
        init_state, step = tr.make_train_step(
            cfg, dev, optimizer=lambda p: tr.adamw(p, lr=config["lr"], weight_decay=config["wd"]))
        state = init_state(model=params_from_jax(config["init"], cfg, device=dev))
        batch = {"tokens": torch.from_numpy(config["toks"]).long().to(dev)}
        for i in range(config["steps"]):
            state, m = step(state, batch)
            train.report({"device": str(dev), "loss": float(m["loss"]),
                          "grad_norm": float(m["grad_norm"]),
                          "params": params_to_numpy(state["model"])})

    result = TorchTrainer(
        train_fn,
        train_loop_config={"cfg": tcfg, "init": init, "toks": toks, "steps": steps,
                           "lr": LR, "wd": WD},
        scaling_config=ScalingConfig(num_workers=1, **CPU), worker_env=ONE_THREAD,
        run_config=_cfg(tmp_path, "t_parity"),
    ).fit()

    init_state, step = tr.make_train_step(
        tcfg, device="cpu", optimizer=lambda p: tr.adamw(p, lr=LR, weight_decay=WD))
    state = init_state(model=params_from_jax(init, tcfg, device="cpu"))
    batch = {"tokens": torch.from_numpy(toks).long()}
    assert len(result.metrics_history) == steps
    for i, (got, (jax_loss, jax_gnorm, jax_params)) in enumerate(
            zip(result.metrics_history, jax_trace), start=1):
        state, m = step(state, batch)
        assert got["device"] == "cpu"
        for want_loss, want_gnorm in ((float(m["loss"]), float(m["grad_norm"])),
                                      (jax_loss, jax_gnorm)):
            np.testing.assert_allclose(got["loss"], want_loss, rtol=LOSS_RTOL)
            np.testing.assert_allclose(got["grad_norm"], want_gnorm, rtol=GNORM_RTOL)
        _assert_params_close(got["params"], params_to_numpy(state["model"]), i)
        _assert_params_close(got["params"], jax_params, i)


@pytest.mark.timeout(150)
@pytest.mark.parametrize("wrapped", [True, False], ids=["ddp", "unwrapped"])
def test_two_worker_ddp_step_matches_whole_batch(torch_cluster, tmp_path, wrapped):  # noqa: F811
    """Two gloo workers, each on half the batch, step through
    make_train_step(wrap=prepare_model): after 2 steps the parameters,
    grad norm and mean loss equal the bare step's on the whole batch. With
    the loss computed outside DDP's forward (unwrapped) the gradients go
    unreduced and the parameters come out different: the case this test
    is there to catch."""
    steps, lr = 2, 0.5
    tcfg = _tiny()
    toks = np.random.RandomState(2).randint(0, TINY["vocab_size"], (4, 17)).astype(np.int64)

    def train_fn(config):
        import torch
        import torch.distributed as dist

        from ray_tpu_torch.convert import params_to_numpy
        from ray_tpu_torch.models import transformer as tr
        from ray_tpu_torch.train.torch import get_device, prepare_model

        dev = get_device()
        rank, world = dist.get_rank(), dist.get_world_size()
        init_state, step = tr.make_train_step(
            config["cfg"], dev, optimizer=lambda p: torch.optim.SGD(p, lr=config["lr"]),
            wrap=prepare_model if config["wrapped"] else None)
        state = init_state(torch.Generator().manual_seed(0))
        half = len(config["toks"]) // world
        batch = {"tokens": torch.from_numpy(config["toks"][rank * half:(rank + 1) * half]).to(dev)}
        for _ in range(config["steps"]):
            state, m = step(state, batch)
            loss = m["loss"].clone()
            dist.all_reduce(loss)
            train.report({"loss": float(loss) / world, "grad_norm": float(m["grad_norm"]),
                          "params": params_to_numpy(state["model"])})

    result = TorchTrainer(
        train_fn,
        train_loop_config={"cfg": tcfg, "toks": toks, "steps": steps, "lr": lr,
                           "wrapped": wrapped},
        scaling_config=ScalingConfig(num_workers=2, **CPU), worker_env=ONE_THREAD,
        run_config=_cfg(tmp_path, "t_ddp"),
    ).fit()

    init_state, step = tr.make_train_step(
        tcfg, device="cpu", optimizer=lambda p: torch.optim.SGD(p, lr=lr))
    state = init_state(torch.Generator().manual_seed(0))
    for _ in range(steps):
        state, m = step(state, {"tokens": torch.from_numpy(toks)})
    got = result.metrics  # rank 0's, after the last step
    want = params_to_numpy(state["model"])
    diffs = [np.abs(got["params"]["blocks"][n] - want["blocks"][n]).max()
             for n in tr.BLOCK_PARAMS]
    diffs.append(np.abs(got["params"]["embed"] - want["embed"]).max())
    if wrapped:
        assert max(diffs) <= DDP_ATOL, diffs
        np.testing.assert_allclose(got["loss"], float(m["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["grad_norm"], float(m["grad_norm"]), rtol=GNORM_RTOL)
    else:
        assert max(diffs) > 100 * DDP_ATOL, diffs


@pytest.mark.timeout(150)
def test_checkpoint_resume_continues_the_step(torch_cluster, tmp_path):  # noqa: F811
    """save_state after step 2 of 4, then a second fit resumed from that
    checkpoint takes steps 3 and 4 to the first fit's losses: the model and
    the AdamW moments come back."""
    tcfg = _tiny()
    toks = np.random.RandomState(3).randint(0, TINY["vocab_size"], (4, 17)).astype(np.int64)

    def train_fn(config):
        import tempfile

        import torch

        from ray_tpu_torch.models import transformer as tr
        from ray_tpu_torch.train.torch import get_device, load_state, save_state

        dev = get_device()
        init_state, step = tr.make_train_step(config["cfg"], dev)
        state = init_state(torch.Generator().manual_seed(0))
        ckpt = train.get_checkpoint()
        if ckpt:
            with ckpt.as_directory() as d:
                load_state(state, d)
        batch = {"tokens": torch.from_numpy(config["toks"]).to(dev)}
        while state["step"] < config["steps"]:
            state, m = step(state, batch)
            metrics = {"step": state["step"], "loss": float(m["loss"])}
            if state["step"] == config["save_at"]:
                with tempfile.TemporaryDirectory() as d:
                    save_state(state, d)
                    train.report(metrics, checkpoint=Checkpoint.from_directory(d))
            else:
                train.report(metrics)

    loop = {"cfg": tcfg, "toks": toks, "steps": 4, "save_at": 2}
    cpu = ScalingConfig(num_workers=1, **CPU)
    first = TorchTrainer(train_fn, train_loop_config=loop, scaling_config=cpu,
                         worker_env=ONE_THREAD, run_config=_cfg(tmp_path, "t_resume")).fit()
    again = TorchTrainer(train_fn, train_loop_config=loop, scaling_config=cpu,
                         worker_env=ONE_THREAD, run_config=_cfg(tmp_path, "t_resume2"),
                         resume_from_checkpoint=first.checkpoint).fit()
    assert [m["step"] for m in first.metrics_history] == [1, 2, 3, 4]
    assert [m["step"] for m in again.metrics_history] == [3, 4]
    assert [m["loss"] for m in again.metrics_history] == \
        [m["loss"] for m in first.metrics_history[2:]]


@pytest.mark.timeout(120)
def test_gpu_gang_without_a_card_raises_naming_cuda(monkeypatch, tmp_path):
    """use_gpu=True (the default) on a node without a card: fit() raises
    before placing the gang; with a GPU resource but no card in the worker,
    the worker's device setup raises as the gang starts. Both name CUDA."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")  # no card, here or on a GPU host

    def train_fn(config):
        train.report({"ran": True})

    for resources in ({}, {"num_gpus": 1}):
        ray_tpu_torch.init(num_cpus=2, **resources)
        try:
            with pytest.raises(RuntimeError, match="CUDA"):
                TorchTrainer(train_fn, scaling_config=ScalingConfig(num_workers=1),
                             worker_env=ONE_THREAD,
                             run_config=_cfg(tmp_path, "t_nocard")).fit()
        finally:
            ray_tpu_torch.shutdown()
