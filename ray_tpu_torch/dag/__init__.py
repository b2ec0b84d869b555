"""ray_tpu_torch.dag: compiled actor graphs over shared-memory channels.

Analog of the reference's compiled graphs / aDAG (python/ray/dag +
python/ray/experimental/channel): a lazy DAG of actor-method calls is
compiled once; per-call RPC + object-store traffic is replaced by
preallocated mutable shm channels (seqlock'd single-writer ring of one
slot), with each actor running a resident execution loop. On TPU pods the
inter-host tensor path composes with jit collective programs (ICI) — the
channel tier here is the intra-host control/data plane, like the reference's
mutable plasma objects (experimental_mutable_object_manager.h:37).

    import ray_tpu_torch
    from ray_tpu_torch import dag

    a = Adder.remote(); b = Doubler.remote()
    with dag.InputNode() as inp:
        graph = b.double.bind(a.add.bind(inp))
    compiled = graph.experimental_compile()
    assert compiled.execute(3).get() == 8   # (3+1)*2
"""

from ray_tpu_torch.dag.compiled import CompiledDAG, CompiledDAGRef
from ray_tpu_torch.dag.nodes import ClassMethodNode, DAGNode, InputNode, MultiOutputNode

__all__ = [
    "ClassMethodNode",
    "CompiledDAG",
    "CompiledDAGRef",
    "DAGNode",
    "InputNode",
    "MultiOutputNode",
]
