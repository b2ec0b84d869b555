"""Entry points of the port: the flagship forward + a multi-device
dry run. Counterpart of __graft_entry__.py, which stays the JAX package's.

entry(device)        -> (fn, example_args): the flagship model's forward.
dryrun_multichip(n)  -> the FULL sharded train step over an n-device mesh
                        (data/fsdp/tensor/sequence, `_factor_axes(n)`), one
                        step on tiny shapes, then the same step through a
                        TorchTrainer gang (phase 2).

Torch has one device per process, so the n-device CPU mesh is n spawned
gloo processes; it runs on any machine, a card or none.

    python -m ray_tpu_torch.dryrun 4     # both phases on 4 CPU processes
    python -m ray_tpu_torch.dryrun       # entry() on the card
"""

from __future__ import annotations

import math


def _tiny_transformer_cfg(dtype=None):
    import torch

    from ray_tpu_torch.models import TransformerConfig

    return TransformerConfig(
        vocab_size=512,
        d_model=128,
        n_layers=2,
        n_heads=8,
        n_kv_heads=4,
        max_seq_len=128,
        dtype=dtype or torch.bfloat16,
        attention_impl="torch",  # the reference's "xla": attention as plain ops
    )


def entry(device="cuda"):
    """The flagship model's forward (decoder transformer) and its example
    arguments, on `device`."""
    import torch

    from ray_tpu_torch.models import transformer_apply, transformer_init

    cfg = _tiny_transformer_cfg()
    model = transformer_init(cfg, device=device)
    gen = torch.Generator(device=model.embed.device).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), device=model.embed.device, generator=gen)

    def fn(model, tokens):
        return transformer_apply(model, tokens)

    return fn, (model, tokens)


def _factor_axes(n: int):
    """Split n devices over (data, fsdp, tensor, sequence), favoring data."""
    axes = {"data": 1, "fsdp": 1, "tensor": 1, "sequence": 1}
    order = ["tensor", "sequence", "fsdp", "data"]
    # Give each non-data axis one factor of 2 if available, rest to data.
    rem = n
    for name in order[:-1]:
        if rem % 2 == 0 and rem > 1:
            axes[name] = 2
            rem //= 2
    axes["data"] = rem
    assert axes["data"] * axes["fsdp"] * axes["tensor"] * axes["sequence"] == n
    return axes


def _sharded_step(axes, device: str = "cpu") -> float:
    """One f32 AdamW(1e-3) step of the tiny model, weights from seed 0, on a
    mesh of `axes` over the process group (every rank calls it), on a
    global batch from RandomState(7): max(4, 2 * data * fsdp) rows of
    32 * sequence tokens. Returns the global loss."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import make_train_step
    from ray_tpu_torch.models.transformer import adamw
    from ray_tpu_torch.parallel import make_mesh

    mesh = make_mesh(axes, device=device)
    cfg = _tiny_transformer_cfg(dtype=torch.float32)
    init_state, step = make_train_step(cfg, optimizer=lambda p: adamw(p, lr=1e-3), mesh=mesh)
    state = init_state(torch.Generator(device=device).manual_seed(0))
    batch = max(4, 2 * axes["data"] * axes["fsdp"])
    seq = 32 * axes["sequence"]
    raw = np.random.RandomState(7).randint(0, cfg.vocab_size, size=(batch, seq + 1))
    tokens = torch.from_numpy(raw).to(device)
    state, metrics = step(state, {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]})
    loss = float(metrics["loss"])
    if not (math.isfinite(loss) and loss > 0):
        raise RuntimeError(f"bad loss {loss}")
    return loss


def dryrun_multichip(n_devices: int) -> None:
    """The full sharded train step over an n_devices CPU mesh (n gloo
    processes), one step on tiny shapes; then phase 2, the same step
    through the runtime, which must give the same loss."""
    from ray_tpu_torch.testing import run_in_processes

    axes = _factor_axes(n_devices)
    loss = run_in_processes(_sharded_step, n_devices, axes)
    print(f"dryrun_multichip ok: mesh={axes} loss={loss:.6f}")
    _dryrun_trainer_runtime(n_devices, loss)


def _train_fn(config) -> None:
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.train.torch import get_device

    loss = _sharded_step(config["axes"], device=get_device().type)
    train.report({"loss": loss, "mesh": config["axes"],
                  "world": torch.distributed.get_world_size()})


def _dryrun_trainer_runtime(n_devices: int, expect: float) -> None:
    """Phase 2: the same sharded step through the RUNTIME: a TorchTrainer
    gang of n_devices CPU workers (one device each), its gloo process group
    from the trainer's rendezvous, and one step over the global mesh
    spanning the gang. Raises unless the gang's loss equals `expect`,
    phase 1's on the same seed and batch."""
    import tempfile

    import ray_tpu_torch
    from ray_tpu_torch.air import RunConfig, ScalingConfig
    from ray_tpu_torch.train.torch import TorchTrainer

    ray_tpu_torch.init(num_cpus=max(2, n_devices))
    try:
        with tempfile.TemporaryDirectory() as storage:
            result = TorchTrainer(
                _train_fn,
                train_loop_config={"axes": _factor_axes(n_devices)},
                scaling_config=ScalingConfig(num_workers=n_devices, use_gpu=False),
                worker_env={"OMP_NUM_THREADS": "1"},
                run_config=RunConfig(name="dryrun_runtime", storage_path=storage),
            ).fit()
    finally:
        ray_tpu_torch.shutdown()
    # fit() raises TrainingFailedError on any rank failure.
    loss = result.metrics["loss"]
    if not math.isclose(loss, expect, rel_tol=1e-6):
        raise RuntimeError(f"the gang's loss {loss} is not phase 1's {expect}")
    print(f"dryrun trainer runtime ok: {result.metrics['world']} processes, "
          f"mesh={result.metrics['mesh']} loss={loss:.6f}")


if __name__ == "__main__":
    import sys

    if len(sys.argv) > 1:
        dryrun_multichip(int(sys.argv[1]))
    else:
        fn, args = entry()
        print("entry ok:", tuple(fn(*args).shape))
