"""ray_tpu_torch.workflow: durable workflows — DAGs with per-step checkpointing.

Analog of python/ray/workflow (workflow_executor.py, workflow_storage.py,
task_executor.py): `workflow.run(fn.bind(...))` executes the task graph,
persisting every step's output; `workflow.resume(workflow_id)` re-runs the
graph, skipping any step whose checkpoint exists — crash recovery restarts
only the unfinished suffix.

    @ray_tpu_torch.remote
    def add(a, b): return a + b

    out = workflow.run(add.bind(add.bind(1, 2), 3), workflow_id="w1")  # 6
"""

from ray_tpu_torch.workflow.api import (
    Continuation,
    FunctionNode,
    WorkflowStatus,
    continuation,
    delete,
    get_metadata,
    get_output,
    get_step_metadata,
    list_all,
    resume,
    run,
    run_async,
)

__all__ = [
    "Continuation",
    "FunctionNode",
    "WorkflowStatus",
    "continuation",
    "delete",
    "get_metadata",
    "get_output",
    "get_step_metadata",
    "list_all",
    "resume",
    "run",
    "run_async",
]
