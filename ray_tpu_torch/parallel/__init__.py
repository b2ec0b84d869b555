"""ray_tpu_torch.parallel: meshes, sharding rules, and context parallelism.

Port of ray_tpu.parallel. DP/FSDP/TP/SP are axes of one DeviceMesh over the
process group (one device per process); see mesh.py for axis conventions,
ring_attention.py / ulysses.py for the long-context primitives.
"""

from ray_tpu_torch.parallel.mesh import (
    CANONICAL_ORDER,
    DATA,
    EXPERT,
    FSDP,
    SEQUENCE,
    TENSOR,
    MeshSpec,
    ShardingRules,
    batch_slice,
    default_transformer_rules,
    fsdp_sharding_for_leaf,
    host_local_device_count,
    make_mesh,
    shard_of,
)
from ray_tpu_torch.parallel.ring_attention import (
    full_attention,
    ring_attention,
    ring_attention_loopback,
    ring_attention_on_group,
    ring_attention_sharded,
)
from ray_tpu_torch.parallel.ulysses import (
    ulysses_attention,
    ulysses_attention_on_group,
    ulysses_attention_sharded,
)

__all__ = [
    "DATA",
    "FSDP",
    "TENSOR",
    "SEQUENCE",
    "EXPERT",
    "CANONICAL_ORDER",
    "MeshSpec",
    "ShardingRules",
    "make_mesh",
    "batch_slice",
    "shard_of",
    "default_transformer_rules",
    "fsdp_sharding_for_leaf",
    "host_local_device_count",
    "ring_attention",
    "ring_attention_loopback",
    "ring_attention_on_group",
    "ring_attention_sharded",
    "full_attention",
    "ulysses_attention",
    "ulysses_attention_on_group",
    "ulysses_attention_sharded",
]
