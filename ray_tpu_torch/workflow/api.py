"""Workflow execution + storage.

Steps are the reference's task nodes (python/ray/workflow/task_executor.py);
storage layout mirrors workflow_storage.py: one directory per workflow id,
one pickle per finished step, a JSON status/metadata file.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch._private.common import RayTpuError

DEFAULT_STORAGE = os.path.expanduser("~/ray_tpu_torch_workflows")


class WorkflowStatus:
    RUNNING = "RUNNING"
    SUCCESSFUL = "SUCCESSFUL"
    FAILED = "FAILED"
    RESUMABLE = "RESUMABLE"


class FunctionNode:
    """Lazy task node: fn.bind(*args) (reference: dag/function_node.py).
    Args may contain other FunctionNodes."""

    # Step-level execution options (reference: workflow.options()):
    # retries re-run the step on application exceptions; catch_exceptions
    # makes the step's value a (result, exception) pair instead of
    # propagating. CLASS-level defaults so graph.pkl files persisted
    # before these options existed still unpickle and resume.
    max_retries = 0
    catch_exceptions = False

    def __init__(self, remote_fn, args: Tuple, kwargs: Dict):
        self.remote_fn = remote_fn
        self.args = args
        self.kwargs = kwargs

    def options(
        self,
        *,
        max_retries: Optional[int] = None,
        catch_exceptions: Optional[bool] = None,
    ) -> "FunctionNode":
        if max_retries is not None:
            self.max_retries = int(max_retries)
        if catch_exceptions is not None:
            self.catch_exceptions = bool(catch_exceptions)
        return self

    def _upstream(self) -> List["FunctionNode"]:
        return [
            a
            for a in list(self.args) + list(self.kwargs.values())
            if isinstance(a, FunctionNode)
        ]


class Continuation:
    """A step's result that says "my real value is this sub-workflow"
    (reference: workflow continuations — task_executor.py re-enters the
    executor with the returned DAG). Return `workflow.continuation(
    next_step.bind(...))` from inside a step; the executor runs the
    sub-DAG (checkpointed under the parent step's namespace) and uses its
    output as the step's value. Recursion-friendly: each nesting level
    gets its own namespaced steps, so resume lands mid-recursion."""

    def __init__(self, node: FunctionNode):
        if not isinstance(node, FunctionNode):
            raise RayTpuError("continuation() expects fn.bind(...)")
        self.node = node


def continuation(node: FunctionNode) -> Continuation:
    return Continuation(node)


class _Storage:
    def __init__(self, workflow_id: str, base: Optional[str] = None):
        self.dir = os.path.join(base or DEFAULT_STORAGE, workflow_id)
        os.makedirs(os.path.join(self.dir, "steps"), exist_ok=True)

    def step_path(self, step_id: str) -> str:
        return os.path.join(self.dir, "steps", f"{step_id}.pkl")

    def has_step(self, step_id: str) -> bool:
        return os.path.exists(self.step_path(step_id))

    def load_step(self, step_id: str) -> Any:
        with open(self.step_path(step_id), "rb") as f:
            return pickle.load(f)

    def save_step(self, step_id: str, value: Any) -> None:
        tmp = self.step_path(step_id) + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(value, f)
        os.replace(tmp, self.step_path(step_id))  # atomic checkpoint commit

    def write_meta(self, **kw) -> None:
        meta = self.read_meta()
        meta.update(kw)
        tmp = os.path.join(self.dir, "meta.json.tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, os.path.join(self.dir, "meta.json"))

    # Per-step metadata (reference: workflow_storage.py step metadata
    # records): attempts, timing, status — queryable per step.

    def _step_meta_path(self, step_id: str) -> str:
        return os.path.join(self.dir, "steps", f"{step_id}.meta.json")

    def write_step_meta(self, step_id: str, **kw) -> None:
        meta = self.read_step_meta(step_id)
        meta.update(kw)
        tmp = self._step_meta_path(step_id) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, self._step_meta_path(step_id))

    def read_step_meta(self, step_id: str) -> Dict[str, Any]:
        try:
            with open(self._step_meta_path(step_id)) as f:
                return json.load(f)
        except FileNotFoundError:
            return {}

    def list_step_meta(self) -> Dict[str, Dict[str, Any]]:
        out = {}
        steps_dir = os.path.join(self.dir, "steps")
        for fname in sorted(os.listdir(steps_dir)):
            if fname.endswith(".meta.json"):
                sid = fname[: -len(".meta.json")]
                out[sid] = self.read_step_meta(sid)
        return out

    def read_meta(self) -> Dict[str, Any]:
        try:
            with open(os.path.join(self.dir, "meta.json")) as f:
                return json.load(f)
        except FileNotFoundError:
            return {}


def _graph_blob(node: FunctionNode) -> bytes:
    import cloudpickle

    return cloudpickle.dumps(node)


def _step_ids(node: FunctionNode) -> Dict[int, str]:
    """Deterministic step ids: topo index + function name + arg structure
    hash, so resume matches steps across processes."""
    order: List[FunctionNode] = []
    seen = set()

    def visit(n: FunctionNode):
        if id(n) in seen:
            return
        seen.add(id(n))
        for up in n._upstream():
            visit(up)
        order.append(n)

    visit(node)
    ids: Dict[int, str] = {}
    for i, n in enumerate(order):
        name = getattr(n.remote_fn, "__name__", "step")
        sig = hashlib.sha1(
            f"{i}:{name}:{len(n.args)}:{sorted(n.kwargs)}".encode()
        ).hexdigest()[:8]
        ids[id(n)] = f"{i:04d}_{name}_{sig}"
    return ids


def _run_step(n: FunctionNode, step_id: str, args, kwargs, storage: _Storage) -> Any:
    """One step with retries / catch_exceptions / continuation handling
    (reference: task_executor.py — application retries + the continuation
    re-entry into the executor)."""
    storage.write_step_meta(
        step_id,
        name=getattr(n.remote_fn, "__name__", "step"),
        status="RUNNING",
        start_time=time.time(),
    )
    root = n
    root_step_id = step_id
    attempts = 0
    chain_depth = 0
    caught: Optional[Exception] = None
    result: Any = None
    while True:
        attempts += 1
        try:
            result = ray_tpu_torch.get(n.remote_fn.remote(*args, **kwargs))
            # Continuations (the step's real value is another workflow).
            # A chain of single-step continuations — the recursion pattern
            # (e.g. fact(n) -> fact(n-1)) — iterates IN THIS FRAME: each
            # link gets its own metadata record under the root step's
            # namespace, and no threads/pools/stack accumulate with depth.
            # A continuation that is a full DAG re-enters the executor.
            # Failures at any link honor the ROOT step's
            # max_retries/catch_exceptions (checkpointed sub-steps skip on
            # retry).
            while isinstance(result, Continuation):
                sub = result.node
                if sub._upstream():
                    result = _execute(
                        sub, storage, prefix=f"{root_step_id}."
                    )
                else:
                    chain_depth += 1
                    n = sub
                    args = list(sub.args)
                    kwargs = dict(sub.kwargs)
                    step_id = (
                        f"{root_step_id}."
                        f"{chain_depth:04d}_"
                        f"{getattr(sub.remote_fn, '__name__', 'step')}"
                    )
                    storage.write_step_meta(
                        step_id,
                        name=getattr(sub.remote_fn, "__name__", "step"),
                        status="RUNNING",
                        start_time=time.time(),
                    )
                    result = ray_tpu_torch.get(n.remote_fn.remote(*args, **kwargs))
                    storage.write_step_meta(
                        step_id, status="SUCCESSFUL", end_time=time.time()
                    )
            break
        except Exception as e:
            if attempts <= root.max_retries:
                storage.write_step_meta(
                    root_step_id, attempts=attempts, last_error=repr(e)
                )
                continue
            if root.catch_exceptions:
                caught = e
                break
            storage.write_step_meta(
                root_step_id, status="FAILED", attempts=attempts,
                last_error=repr(e), end_time=time.time(),
            )
            raise
    if root.catch_exceptions:
        result = (None, caught) if caught is not None else (result, None)
    storage.save_step(root_step_id, result)
    storage.write_step_meta(
        root_step_id,
        # A caught permanent failure must be distinguishable from a clean
        # success in the step records.
        status="CAUGHT_FAILURE" if caught is not None else "SUCCESSFUL",
        attempts=attempts,
        end_time=time.time(),
        **({"last_error": repr(caught)} if caught is not None else {}),
    )
    return result


def _execute(node: FunctionNode, storage: _Storage, prefix: str = "") -> Any:
    """Dependency-resolved parallel executor: a step is submitted the
    moment its own upstreams finish — no wave barrier, so a slow branch
    never delays ready work on an independent branch (reference:
    workflow_executor.py submits tasks as dependencies resolve). Each
    finished step is checkpointed before its value feeds downstream. On a
    step failure, in-flight siblings are drained (never orphaned into the
    storage directory) before the error propagates."""
    ids = {k: prefix + v for k, v in _step_ids(node).items()}
    cache: Dict[int, Any] = {}
    order: List[FunctionNode] = []
    seen = set()

    def visit(n: FunctionNode):
        if id(n) in seen:
            return
        seen.add(id(n))
        for up in n._upstream():
            visit(up)
        order.append(n)

    visit(node)

    import concurrent.futures as cf

    remaining: Dict[int, FunctionNode] = {}
    for n in order:
        step_id = ids[id(n)]
        if storage.has_step(step_id):
            cache[id(n)] = storage.load_step(step_id)
        else:
            remaining[id(n)] = n

    def resolve(v):
        return cache[id(v)] if isinstance(v, FunctionNode) else v

    pool = cf.ThreadPoolExecutor(max_workers=8)
    futs: Dict[Any, int] = {}  # Future -> node id
    try:
        def submit_ready():
            for nid, n in list(remaining.items()):
                if all(id(up) in cache for up in n._upstream()):
                    del remaining[nid]
                    args = [resolve(a) for a in n.args]
                    kwargs = {k: resolve(v) for k, v in n.kwargs.items()}
                    futs[
                        pool.submit(_run_step, n, ids[nid], args, kwargs, storage)
                    ] = nid

        submit_ready()
        first_error: Optional[BaseException] = None
        while futs:
            done, _pending = cf.wait(futs, return_when=cf.FIRST_COMPLETED)
            for f in done:
                nid = futs.pop(f)
                try:
                    cache[nid] = f.result()
                except BaseException as e:  # noqa: BLE001
                    if first_error is None:
                        first_error = e
            if first_error is not None:
                # Drain in-flight siblings so no thread keeps executing
                # remote tasks or writing checkpoints after run() raised.
                for f in cf.as_completed(list(futs)):
                    try:
                        f.result()
                    except BaseException:  # noqa: BLE001 - already failing
                        pass
                raise first_error
            submit_ready()
        if remaining:
            raise RayTpuError("workflow graph has a dependency cycle")
    finally:
        pool.shutdown(wait=True)
    return cache[id(node)]


def run(
    node: FunctionNode,
    *,
    workflow_id: Optional[str] = None,
    storage: Optional[str] = None,
) -> Any:
    """Execute the workflow to completion, checkpointing each step."""
    if not isinstance(node, FunctionNode):
        raise RayTpuError("workflow.run expects fn.bind(...) (a FunctionNode)")
    workflow_id = workflow_id or f"wf-{uuid.uuid4().hex[:10]}"
    st = _Storage(workflow_id, storage)
    st.write_meta(
        workflow_id=workflow_id,
        status=WorkflowStatus.RUNNING,
        start_time=time.time(),
    )
    with open(os.path.join(st.dir, "graph.pkl"), "wb") as f:
        f.write(_graph_blob(node))
    try:
        result = _execute(node, st)
    except Exception as e:
        st.write_meta(status=WorkflowStatus.FAILED, error=repr(e))
        raise
    st.save_step("__output__", result)
    st.write_meta(status=WorkflowStatus.SUCCESSFUL, end_time=time.time())
    return result


def run_async(node: FunctionNode, **kw):
    """Run in a background task; returns an ObjectRef-like future via a
    driver thread (workflows are driver-side orchestrations)."""
    import concurrent.futures

    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    return pool.submit(run, node, **kw)


def resume(workflow_id: str, *, storage: Optional[str] = None) -> Any:
    """Re-run a workflow, skipping checkpointed steps."""
    st = _Storage(workflow_id, storage)
    if st.has_step("__output__"):
        return st.load_step("__output__")
    graph_path = os.path.join(st.dir, "graph.pkl")
    if not os.path.exists(graph_path):
        raise RayTpuError(f"no stored graph for workflow {workflow_id!r}")
    with open(graph_path, "rb") as f:
        node = pickle.load(f)
    st.write_meta(status=WorkflowStatus.RUNNING)
    try:
        result = _execute(node, st)
    except Exception as e:
        st.write_meta(status=WorkflowStatus.FAILED, error=repr(e))
        raise
    st.save_step("__output__", result)
    st.write_meta(status=WorkflowStatus.SUCCESSFUL, end_time=time.time())
    return result


def get_output(workflow_id: str, *, storage: Optional[str] = None) -> Any:
    st = _Storage(workflow_id, storage)
    if not st.has_step("__output__"):
        raise RayTpuError(f"workflow {workflow_id!r} has no output yet")
    return st.load_step("__output__")


def get_metadata(workflow_id: str, *, storage: Optional[str] = None) -> Dict:
    return _Storage(workflow_id, storage).read_meta()


def get_step_metadata(
    workflow_id: str, *, storage: Optional[str] = None
) -> Dict[str, Dict]:
    """Per-step records: {step_id: {name, status, attempts, start/end_time,
    last_error?}} (reference: workflow_storage.py step metadata)."""
    return _Storage(workflow_id, storage).list_step_meta()


def list_all(storage: Optional[str] = None) -> List[Tuple[str, str]]:
    base = storage or DEFAULT_STORAGE
    out = []
    if not os.path.isdir(base):
        return out
    for wid in sorted(os.listdir(base)):
        if not os.path.isdir(os.path.join(base, wid)):
            continue
        meta = _Storage(wid, base).read_meta()
        if meta:
            out.append((wid, meta.get("status", "UNKNOWN")))
    return out


def delete(workflow_id: str, *, storage: Optional[str] = None) -> None:
    import shutil

    st = _Storage(workflow_id, storage)
    shutil.rmtree(st.dir, ignore_errors=True)
