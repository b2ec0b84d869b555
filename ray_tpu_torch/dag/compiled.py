"""CompiledDAG: turn a bind() graph into resident actor loops + channels.

Analog of python/ray/dag/compiled_dag_node.py (CompiledDAG:288): compilation
walks the graph, allocates one shm channel per edge, and starts a resident
execution loop on every participating actor. execute() then costs one
channel write + one channel read — no task submission, scheduling, or
object-store round trip per call (the reference's aDAG motivation).
"""

from __future__ import annotations

import uuid
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private.common import RayTpuError
from ray_tpu_torch.dag.channel import Channel, make_channel
from ray_tpu_torch.dag.exec_loop import STOP, unwrap
from ray_tpu_torch.dag.nodes import ClassMethodNode, DAGNode, InputNode, MultiOutputNode


class CompiledDAGRef:
    """Future for one execute() call (reference: CompiledDAGRef)."""

    def __init__(self, dag: "CompiledDAG", idx: int):
        self._dag = dag
        self._idx = idx
        self._value: Any = None
        self._consumed = False

    def get(self, timeout: Optional[float] = 30.0) -> Any:
        if not self._consumed:
            wires = [ch.read(timeout) for ch in self._dag._output_channels]
            # Mark consumed before unwrap: an executor error must not wedge
            # the DAG (the slot IS consumed — the error is the result).
            self._consumed = True
            self._dag._pending_ref = None
            try:
                self._value = (
                    unwrap(wires[0])
                    if not self._dag._multi_output
                    else [unwrap(w) for w in wires]
                )
            except Exception as e:
                self._value = e
                raise
        if isinstance(self._value, BaseException):
            raise self._value
        return self._value


class CompiledDAG:
    def __init__(self, leaf: DAGNode, *, max_buf_size: int = 10 * 1024 * 1024):
        self._max_buf = max_buf_size
        self._uid = uuid.uuid4().hex[:10]
        self._counter = 0
        self._pending_ref: Optional[CompiledDAGRef] = None
        self._torn_down = False

        self._multi_output = isinstance(leaf, MultiOutputNode)
        leaves = leaf.outputs if self._multi_output else [leaf]
        for lf in leaves:
            if not isinstance(lf, ClassMethodNode):
                raise RayTpuError("compiled DAG leaves must be actor method nodes")

        # Topological order over ClassMethodNodes.
        order: List[ClassMethodNode] = []
        seen: Dict[int, bool] = {}

        def visit(node: DAGNode):
            if id(node) in seen:
                return
            seen[id(node)] = True
            for up in node._upstream():
                visit(up)
            if isinstance(node, ClassMethodNode):
                order.append(node)

        for lf in leaves:
            visit(lf)
        if not order:
            raise RayTpuError("empty compiled DAG")
        actors = {n.actor._actor_id for n in order}
        if len(actors) != len(order):
            raise RayTpuError(
                "compiled DAG supports one node per actor (each actor hosts "
                "one resident loop)"
            )
        self._nodes = order

        # One channel per edge. driver->node edges for InputNode args,
        # node->node edges for DAGNode args, leaf->driver edges for outputs.
        self._input_channels: List[Channel] = []  # driver writes
        self._output_channels: List[Channel] = []  # driver reads
        node_out_specs: Dict[int, List[Tuple[str, int]]] = {id(n): [] for n in order}
        node_specs: Dict[int, Dict[str, Any]] = {}

        self._all_chan_names: List[str] = []

        def new_chan_spec(kind: str = "chan", meta=None):
            self._counter += 1
            name = f"rtdag_{self._uid}_{self._counter}"
            self._all_chan_names.append(name)
            if meta is not None:
                return (name, self._max_buf, kind, meta)
            return (name, self._max_buf, kind)

        for node in order:
            arg_specs = []
            for a in node.args:
                arg_specs.append(self._arg_spec(a, node_out_specs, new_chan_spec))
            kwarg_specs = {
                k: self._arg_spec(v, node_out_specs, new_chan_spec)
                for k, v in node.kwargs.items()
            }
            node_specs[id(node)] = {
                "method_name": node.method_name,
                "arg_specs": arg_specs,
                "kwarg_specs": kwarg_specs,
            }
        for lf in leaves:
            spec = new_chan_spec(
                "tensor" if lf._tensor_transport else "chan"
            )
            self._output_channels.append(make_channel(spec, create=True))
            node_out_specs[id(lf)].append(spec)

        # Start the resident loops (one long-running actor task per node).
        self._loop_refs = []
        for node in order:
            spec = node_specs[id(node)]
            spec["out_channels"] = node_out_specs[id(node)]
            from ray_tpu_torch.actor import ActorMethod

            loop = ActorMethod(_handle_of(node), "__rt_dag_loop__")
            self._loop_refs.append(loop.remote(spec))

    def _arg_spec(self, a, node_out_specs, new_chan_spec):
        if isinstance(a, InputNode):
            spec = new_chan_spec("tensor" if a._tensor_transport else "chan")
            ch = make_channel(spec, create=True)
            self._input_channels.append(ch)
            return ("chan", spec)
        if isinstance(a, ClassMethodNode):
            # Edge transport follows the PRODUCER's annotation
            # (reference: with_tensor_transport on the upstream node).
            # actor->actor edges are the only ones eligible for the compiled
            # device path; everything else degrades to the shm tensor wire.
            if a._tensor_transport == "device":
                spec = new_chan_spec("device", a._transport_meta)
            else:
                spec = new_chan_spec("tensor" if a._tensor_transport else "chan")
            # Create driver-side so the consumer can open it immediately.
            make_channel(spec, create=True).close()
            node_out_specs[id(a)].append(spec)
            return ("chan", spec)
        if isinstance(a, DAGNode):
            raise RayTpuError(f"unsupported DAG node arg {type(a).__name__}")
        return ("const", a)

    # -- execution -----------------------------------------------------------

    def execute(self, *args) -> CompiledDAGRef:
        if self._torn_down:
            raise RayTpuError("compiled DAG was torn down")
        if self._pending_ref is not None:
            raise RayTpuError(
                "previous execute() result not consumed yet (one in-flight "
                "execution per compiled DAG; call .get() first)"
            )
        value = args[0] if len(args) == 1 else tuple(args)
        for ch in self._input_channels:
            ch.write(value)
        ref = CompiledDAGRef(self, 0)
        self._pending_ref = ref
        return ref

    def teardown(self) -> None:
        if self._torn_down:
            return
        self._torn_down = True
        try:
            for ch in self._input_channels:
                ch.write(STOP)
            # Loops ack by forwarding STOP to the output channels.
            for ch in self._output_channels:
                try:
                    ch.read(timeout=10)
                except Exception:
                    pass
        finally:
            for ch in self._input_channels + self._output_channels:
                ch.close()
            from ray_tpu_torch._private import shm

            for name in self._all_chan_names:
                try:
                    shm.unlink(name)
                except Exception:
                    pass

    def __del__(self):
        try:
            self.teardown()
        except Exception:
            pass


def _handle_of(node: ClassMethodNode):
    return node.actor
