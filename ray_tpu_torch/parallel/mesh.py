"""Device mesh and sharding rules on torch.distributed.

Port of ray_tpu/parallel/mesh.py. There, parallelism is the axes of one
jax.sharding.Mesh and XLA inserts the collectives; here a mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the process group's world,
one device per process, with the same axis names, and the train step makes
its collectives itself (models/transformer.py). Canonical axis names:

    data      — pure data parallelism (gradient mean)
    fsdp      — data parallelism with sharded params/optimizer (ZeRO-3)
    tensor    — megatron-style tensor parallelism within attention/mlp
    sequence  — context parallelism (ring attention / all-to-all)
    expert    — MoE expert parallelism

Any subset may be present; size-1 axes are free, so one codepath serves one
device through many. The reference's `shard_pytree` (device_put of every
leaf) has no counterpart in eager torch: the train step places a whole
model's parameters itself (`make_train_step(..., mesh=...)`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

import torch

from ray_tpu_torch.device import resolve_device

DATA, FSDP, TENSOR, SEQUENCE, EXPERT = "data", "fsdp", "tensor", "sequence", "expert"
CANONICAL_ORDER = (DATA, FSDP, EXPERT, SEQUENCE, TENSOR)


@dataclass
class MeshSpec:
    """Declarative mesh: axis name -> size. One axis may be -1 (inferred).

    Axis order matters on hardware: later axes are placed on
    faster/closer device groups (tensor innermost => tensor-parallel
    collectives ride the shortest hops).
    """

    axes: Dict[str, int] = field(default_factory=dict)

    def resolve(self, num_devices: int) -> Dict[str, int]:
        axes = dict(self.axes)
        unknown = [k for k, v in axes.items() if v == -1]
        if len(unknown) > 1:
            raise ValueError("at most one mesh axis may be -1")
        known = math.prod(v for v in axes.values() if v != -1)
        if unknown:
            if num_devices % known:
                raise ValueError(
                    f"cannot infer {unknown[0]}: {num_devices} % {known} != 0"
                )
            axes[unknown[0]] = num_devices // known
        if math.prod(axes.values()) != num_devices:
            raise ValueError(
                f"mesh {axes} does not cover {num_devices} devices"
            )
        return axes


def _start_world_of_one(device: torch.device) -> None:
    """A process group of this process alone: NCCL on the card, gloo on the
    CPU, through an in-memory store (no port, no peer)."""
    import torch.distributed as dist

    device_id = None
    if device.type == "cuda":
        device_id = torch.device("cuda", torch.cuda.current_device() if device.index is None
                                 else device.index)
        torch.cuda.set_device(device_id)
    dist.init_process_group("nccl" if device_id else "gloo", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=device_id)


def make_mesh(axes: Optional[Dict[str, int]] = None, device="cuda"):
    """A DeviceMesh over the process group's world from an axis spec
    (`axes=None` -> pure data-parallel mesh), with `mesh_dim_names`.

    Canonical axes (data/fsdp/expert/sequence/tensor) are ALWAYS laid out in
    CANONICAL_ORDER regardless of dict order, so tensor/sequence collectives
    ride the innermost groups; non-canonical axis names keep their given
    order, outermost. Rank r sits at the row-major coordinate of r.

    Without a process group, a mesh that covers one device starts a world
    of one itself (NCCL on the card, gloo on the CPU); any larger mesh
    needs the group first. On the card the group's backend must be NCCL.
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    device = resolve_device(device)
    if not dist.is_initialized():
        try:
            MeshSpec(dict(axes or {})).resolve(1)
        except ValueError:
            raise ValueError(f"mesh {axes} spans more than one device: initialize the "
                             "process group first") from None
        _start_world_of_one(device)
    if device.type == "cuda" and dist.get_backend() != "nccl":
        raise ValueError(f"a mesh on the card needs the NCCL backend, not {dist.get_backend()}")
    world = dist.get_world_size()
    if axes is None:
        axes = {DATA: world}
    resolved = MeshSpec(dict(axes)).resolve(world)
    resolved = dict(sorted(
        resolved.items(),
        key=lambda kv: CANONICAL_ORDER.index(kv[0])
        if kv[0] in CANONICAL_ORDER else -1,
    ))
    return init_device_mesh(device.type, tuple(resolved.values()),
                            mesh_dim_names=tuple(resolved.keys()))


def axis_size(mesh, name: str) -> int:
    """Size of mesh axis `name`, 1 where the mesh lacks it."""
    names = mesh.mesh_dim_names
    return mesh.size(names.index(name)) if name in names else 1


def axis_rank(mesh, name: str) -> int:
    """This rank's coordinate on mesh axis `name`, 0 where the mesh lacks it."""
    names = mesh.mesh_dim_names
    return mesh.get_local_rank(name) if name in names else 0


def axis_group(mesh, name: str):
    """The process group of mesh axis `name`, None where the mesh lacks it
    or it has one device (nothing to communicate)."""
    return mesh.get_group(name) if axis_size(mesh, name) > 1 else None


def shard_of(mesh, x: torch.Tensor, dims: Dict[int, Sequence[str]]) -> torch.Tensor:
    """This rank's block of a global tensor: dim d split over the mesh axes
    dims[d], the first of them major (as PartitionSpec(("data", "fsdp")))."""
    for d, names in dims.items():
        n, i = 1, 0
        for name in names:
            n, i = n * axis_size(mesh, name), i * axis_size(mesh, name) + axis_rank(mesh, name)
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not split over {names} ({n})")
        x = x.narrow(d, i * (x.shape[d] // n), x.shape[d] // n)
    return x


def batch_slice(mesh, tokens: torch.Tensor) -> torch.Tensor:
    """This rank's part of a global [B, T, ...] batch: B split over (data,
    fsdp) and T over sequence (the reference's P(("data", "fsdp"),
    "sequence"))."""
    return shard_of(mesh, tokens, {0: (DATA, FSDP), 1: (SEQUENCE,)}).contiguous()


# ---------------------------------------------------------------------------
# Logical-axis sharding rules (t5x/flax style): map parameters to mesh axes
# by logical axis name, as plain data.
# ---------------------------------------------------------------------------


@dataclass
class ShardingRules:
    """Rules mapping logical array axes to mesh axes.

    e.g. rules = ShardingRules({"embed": "fsdp", "mlp": "tensor",
                                "heads": "tensor", "batch": ("data", "fsdp")})
    """

    rules: Dict[str, Optional[object]] = field(default_factory=dict)

    def spec(self, logical_axes: Sequence[Optional[str]]) -> tuple:
        """Per array dim, the mesh axis (or tuple of axes, or None) it splits
        over: the counterpart of a PartitionSpec."""
        return tuple(self.rules.get(a) if a else None for a in logical_axes)


def default_transformer_rules(mesh) -> ShardingRules:
    """Params shard over fsdp+tensor, activations over data+sequence."""
    names = mesh.mesh_dim_names
    has = lambda a: a in names

    def ax(*prefs):
        got = [p for p in prefs if has(p)]
        if not got:
            return None
        return got[0] if len(got) == 1 else tuple(got)

    return ShardingRules(
        {
            "batch": ax(DATA, FSDP),
            "embed": ax(FSDP),
            "mlp": ax(TENSOR),
            "heads": ax(TENSOR),
            "kv": None,
            "vocab": ax(TENSOR),
            "seq": ax(SEQUENCE),
        }
    )


def fsdp_sharding_for_leaf(mesh, leaf) -> Optional[int]:
    """Default ZeRO-3 rule: the dim to shard over fsdp, the largest dim
    divisible by the fsdp size (the first among equals); None to replicate."""
    if FSDP not in mesh.mesh_dim_names:
        return None
    n = axis_size(mesh, FSDP)
    shape = getattr(leaf, "shape", ())
    candidates = [i for i, d in enumerate(shape) if d % n == 0 and d >= n]
    if not candidates:
        return None
    return max(candidates, key=lambda i: shape[i])


def host_local_device_count(device="cuda") -> int:
    """Devices of this host a mesh can use: the visible cards, or one CPU
    (a CPU mesh is one process per device)."""
    device = resolve_device(device)
    return torch.cuda.device_count() if device.type == "cuda" else 1
