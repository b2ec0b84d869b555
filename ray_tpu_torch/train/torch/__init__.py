"""TorchTrainer: data-parallel PyTorch training on the port's runtime, on GPUs.

Port of ray_tpu/train/torch plus the gang bootstrap of ray_tpu's JaxConfig
(train/_backend_executor.py), with the GPU as the device (reference:
python/ray/train/torch, torch_trainer.py and config.py:65-147):

- the process-group backend is "nccl" when the gang uses GPUs and "gloo"
  otherwise, and a one-worker gang makes none;
- the rendezvous listens at rank 0's node address;
- each worker trains on `cuda:{local_rank}` (`get_device()`), or on the CPU
  only when the scaling config says `use_gpu=False`; the rank counts within
  the gang, since a GPU lease names no card, so a node runs one GPU gang;
- `prepare_model` moves the model there and wraps it in
  DistributedDataParallel when the gang has more than one worker.

    from ray_tpu_torch.train.torch import TorchTrainer, get_device
    from ray_tpu_torch.air import ScalingConfig

    def train_fn(config):
        device = get_device()
        init_state, step = make_train_step(cfg, device, wrap=prepare_model)
        ...
        ray_tpu_torch.train.report({"loss": loss})

    TorchTrainer(train_fn, scaling_config=ScalingConfig(num_workers=1)).fit()

A checkpoint of a train step's state is `model.state_dict()` and
`opt.state_dict()` moved to the CPU, written by `torch.save`
(`save_state` / `load_state`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch.train._backend_executor import Backend, BackendConfig
from ray_tpu_torch.train._session import _get_session
from ray_tpu_torch.train.base_trainer import DataParallelTrainer

STATE_FILE = "state.pt"


@dataclass
class TorchConfig(BackendConfig):
    """reference: train/torch/config.py TorchConfig.

    backend: None picks "nccl" when the gang uses GPUs, "gloo" otherwise.
    Whether it uses GPUs is the trainer's ScalingConfig(use_gpu=...), read
    from the gang's bundles when it starts.
    """

    backend: Optional[str] = None
    init_timeout_s: float = 120.0

    @property
    def backend_cls(self):
        return _TorchBackend


# The device of this worker process's rank, set when the gang starts. A train
# worker is a process of its own (an actor), so the process holds one rank.
_device = None
# Rank 0's rendezvous store, listening from the moment its port is known
# until the gang is torn down.
_store = None


def _bind_store(host: str, world_size: int, timeout_s: float) -> int:
    """Rank 0: listen for the gang's rendezvous on a port the OS picks and
    return that port. The store is bound before its port is handed out, so
    no other process can take the port in between, as it could between a
    probe that frees a port and a later bind."""
    import datetime

    import torch.distributed as dist

    global _store
    _store = dist.TCPStore(host, 0, world_size, is_master=True, wait_for_workers=False,
                           timeout=datetime.timedelta(seconds=timeout_s))
    return _store.port


def _setup_worker(use_gpu: bool, local_rank: int, backend: Optional[str],
                  rendezvous: Optional[Tuple[str, int]], rank: int, world_size: int,
                  timeout_s: float) -> str:
    """Pick this rank's device and, for a gang of more than one, join the
    process group through rank 0's store at `rendezvous` (host, port).
    Raises on a GPU gang without a usable card."""
    import datetime

    import torch

    global _device
    if use_gpu:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available in the train worker: the gang uses GPUs "
                "(ScalingConfig(use_gpu=True)); pass use_gpu=False to train on the CPU"
            )
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(
                f"CUDA: local rank {local_rank} has no card "
                f"({torch.cuda.device_count()} visible)"
            )
        _device = torch.device("cuda", local_rank)
        torch.cuda.set_device(_device)
    else:
        _device = torch.device("cpu")
    if rendezvous is not None:
        import torch.distributed as dist

        if not dist.is_initialized():
            timeout = datetime.timedelta(seconds=timeout_s)
            host, port = rendezvous
            store = _store if rank == 0 else dist.TCPStore(
                host, port, world_size, is_master=False, timeout=timeout)
            dist.init_process_group(
                backend=backend,
                store=store,
                rank=rank,
                world_size=world_size,
                timeout=timeout,
                device_id=_device if use_gpu else None,
            )
    return str(_device)


def _teardown_worker():
    import torch.distributed as dist

    global _device, _store
    _device = None
    if dist.is_initialized():
        dist.destroy_process_group()
    _store = None


class _TorchBackend(Backend):
    """reference: train/torch/config.py _TorchBackend.on_start — rank 0's
    worker binds the rendezvous store at its node's address and reports the
    port it got; every worker picks its device and runs init_process_group
    through that store."""

    def on_start(self, worker_group, backend_config: TorchConfig):
        use_gpu = worker_group.pg.bundles[0].get("GPU", 0) > 0
        backend = backend_config.backend or ("nccl" if use_gpu else "gloo")
        world = len(worker_group)
        rendezvous = None
        if world > 1:
            host = worker_group.node_ips[0]
            port = ray_tpu_torch.get(worker_group.workers[0].apply.remote(
                cloudpickle.dumps(_bind_store), host, world, backend_config.init_timeout_s))
            rendezvous = (host, port)
        setup_blob = cloudpickle.dumps(_setup_worker)
        refs = [
            w.apply.remote(
                setup_blob,
                use_gpu,
                worker_group.local_ranks[rank],
                backend,
                rendezvous,
                rank,
                world,
                backend_config.init_timeout_s,
            )
            for rank, w in enumerate(worker_group.workers)
        ]
        ray_tpu_torch.get(refs, timeout=backend_config.init_timeout_s + 30)

    def on_shutdown(self, worker_group, backend_config: TorchConfig):
        try:
            worker_group.execute("apply", cloudpickle.dumps(_teardown_worker))
        except Exception:
            pass


class TorchTrainer(DataParallelTrainer):
    """DataParallelTrainer whose workers each train on one GPU (reference:
    train/torch/torch_trainer.py). `fit()` raises, naming CUDA, when the
    scaling config asks for more GPUs than the cluster has."""

    _default_backend_config = TorchConfig

    def fit(self):
        need = self.scaling_config.total_resources.get("GPU", 0.0)
        have = ray_tpu_torch.cluster_resources().get("GPU", 0.0)
        if need > have:
            raise RuntimeError(
                f"CUDA: the train gang needs {need:g} GPUs (ScalingConfig(use_gpu=True)) "
                f"but the cluster has {have:g}; pass use_gpu=False to train on the CPU"
            )
        return super().fit()


# -- in-loop helpers (reference: train/torch/train_loop_utils.py) -------------


def get_device():
    """This rank's device: `cuda:{local_rank}` (made the thread's current
    device) when the gang uses GPUs, the CPU only when `use_gpu=False`."""
    import torch

    _get_session()  # raises outside a train worker
    if _device is None:
        raise RuntimeError("get_device() needs a TorchTrainer's worker gang")
    if _device.type == "cuda":
        torch.cuda.set_device(_device)  # the current device is per thread
    return _device


def prepare_model(model):
    """Move `model` to this rank's device and, in a gang of more than one,
    wrap it in DistributedDataParallel (device_ids=[local_rank] on GPUs).
    DDP reduces gradients only for what runs through its forward."""
    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel as DDP

    device = get_device()
    model = model.to(device)
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        if device.type == "cuda":
            return DDP(model, device_ids=[device.index])
        return DDP(model)
    return model


def prepare_data_loader(data_loader):
    """Reshard a DataLoader across workers via DistributedSampler."""
    import torch.distributed as dist
    from torch.utils.data import DataLoader
    from torch.utils.data.distributed import DistributedSampler

    if not (dist.is_available() and dist.is_initialized()):
        return data_loader
    if isinstance(data_loader.sampler, DistributedSampler):
        return data_loader
    return DataLoader(
        data_loader.dataset,
        batch_size=data_loader.batch_size,
        sampler=DistributedSampler(data_loader.dataset),
        num_workers=data_loader.num_workers,
        collate_fn=data_loader.collate_fn,
        drop_last=data_loader.drop_last,
    )


def _to_cpu(obj):
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save_state(state: Dict[str, Any], directory: str) -> None:
    """Write a train step's state ({'model', 'opt', 'step'}, as
    `make_train_step` builds it) to `directory`: the model's and the
    optimizer's state dicts moved to the CPU, by torch.save."""
    import torch

    torch.save({"model": _to_cpu(state["model"].state_dict()),
                "opt": _to_cpu(state["opt"].state_dict()),
                "step": state["step"]},
               os.path.join(directory, STATE_FILE))


def load_state(state: Dict[str, Any], directory: str) -> None:
    """Load what `save_state` wrote into `state`, in place: the weights and
    the optimizer's moments go back to the model's device."""
    import torch

    saved = torch.load(os.path.join(directory, STATE_FILE), map_location="cpu")
    state["model"].load_state_dict(saved["model"])
    state["opt"].load_state_dict(saved["opt"])
    state["step"] = saved["step"]


__all__ = [
    "TorchConfig",
    "TorchTrainer",
    "get_device",
    "load_state",
    "prepare_data_loader",
    "prepare_model",
    "save_state",
]
