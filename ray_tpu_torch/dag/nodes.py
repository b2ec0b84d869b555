"""DAG node types: lazy graph construction via .bind().

Analog of python/ray/dag/{dag_node.py,class_node.py,input_node.py,
output_node.py}: `actor.method.bind(upstream)` builds a ClassMethodNode;
`with InputNode() as inp:` marks the graph entry; MultiOutputNode fans
several leaves out to the caller.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple


class DAGNode:
    # Transport for this node's OUTPUT edges: None (pickle shm channel),
    # "tensor" (array-native shm channel), or "device" (compiled ppermute
    # device channel; reference analog: TorchTensorType/with_tensor_transport
    # with transport="nccl" on aDAG edges).
    _tensor_transport: Optional[str] = None
    _transport_meta: Optional[Dict[str, Any]] = None

    def experimental_compile(self, *, max_buf_size: int = 10 * 1024 * 1024):
        from ray_tpu_torch.dag.compiled import CompiledDAG

        return CompiledDAG(self, max_buf_size=max_buf_size)

    def with_tensor_transport(
        self,
        transport: str = "tensor",
        *,
        group_name: str = "default",
        src: int = 0,
        dst: int = 1,
    ) -> "DAGNode":
        """Mark this node's outputs as array payloads.

        transport="tensor": raw-buffer shm channels (dtype/shape header +
        memcpy — no pickle). transport="device": compiled device channels —
        shm control frame + jitted ppermute payload hop between collective
        ranks `src` (producer) and `dst` (consumer) of xla group
        `group_name`; see docs/collectives.md. Only actor→actor edges ride
        the device path — driver-facing edges degrade to "tensor".
        Reference: DAGNode.with_tensor_transport(...)."""
        self._tensor_transport = transport
        if transport == "device":
            self._transport_meta = {
                "group": group_name, "src": int(src), "dst": int(dst)
            }
        return self

    def _upstream(self) -> List["DAGNode"]:
        return []


class InputNode(DAGNode):
    """Graph entry placeholder (reference: input_node.py)."""

    def __enter__(self) -> "InputNode":
        return self

    def __exit__(self, *exc) -> None:
        return None


class ClassMethodNode(DAGNode):
    def __init__(self, actor_handle, method_name: str, args: Tuple, kwargs: Dict):
        self.actor = actor_handle
        self.method_name = method_name
        self.args = args
        self.kwargs = kwargs
        for a in list(args) + list(kwargs.values()):
            if isinstance(a, InputNode):
                continue
        ups = [a for a in list(args) + list(kwargs.values()) if isinstance(a, DAGNode)]
        self._ups = ups

    def _upstream(self) -> List[DAGNode]:
        return self._ups


class MultiOutputNode(DAGNode):
    def __init__(self, outputs: List[DAGNode]):
        self.outputs = list(outputs)

    def _upstream(self) -> List[DAGNode]:
        return self.outputs


def bind(actor_method, *args, **kwargs) -> ClassMethodNode:
    """actor.method.bind(...) — attached to ActorMethod by ray_tpu_torch.actor."""
    return ClassMethodNode(
        actor_method._handle, actor_method._name, args, kwargs
    )
