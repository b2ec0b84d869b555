"""ray_tpu_torch.autoscaler: demand-driven cluster scaling.

Analog of python/ray/autoscaler (v2 architecture: autoscaler/v2/
autoscaler.py + scheduler.py + instance_manager, consuming
GcsAutoscalerStateManager state): the Autoscaler polls cluster state —
pending worker-lease demand and per-node utilization — and asks a
NodeProvider to launch or terminate nodes. Providers: FakeNodeProvider
(in-process raylets via cluster_utils, the reference's fake_multi_node
test provider) and GCEGPUNodeProvider (GPU-VM command construction).
"""

from ray_tpu_torch.autoscaler.autoscaler import Autoscaler, AutoscalerConfig
from ray_tpu_torch.autoscaler.node_provider import (
    FakeNodeProvider,
    GCEGPUNodeProvider,
    NodeProvider,
)

__all__ = [
    "Autoscaler",
    "AutoscalerConfig",
    "FakeNodeProvider",
    "GCEGPUNodeProvider",
    "NodeProvider",
]
