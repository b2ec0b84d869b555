"""The global Worker singleton and the sync<->async bridge.

Analog of the reference's python/ray/_private/worker.py: holds the process-wide
connection state (`global_worker`), implements init/shutdown and the public
get/put/wait primitives by posting coroutines onto the runtime event loop.

In a driver, the loop runs on a dedicated background thread. In a worker
process, the loop is the main thread (worker_main) and user task code runs on
executor threads — either way, sync API calls bridge with
run_coroutine_threadsafe.
"""

from __future__ import annotations

import asyncio
import atexit
import concurrent.futures
import threading
from typing import Any, Dict, List, Optional, Sequence

from ray_tpu_torch._private import rpc
from ray_tpu_torch._private.common import RayTpuError, config
from ray_tpu_torch._private.core_worker import CoreWorker, ObjectRef
from ray_tpu_torch._private.ids import JobID, WorkerID
from ray_tpu_torch._private.node import Node


class Worker:
    def __init__(self):
        self.loop: Optional[asyncio.AbstractEventLoop] = None
        self._loop_thread: Optional[threading.Thread] = None
        self.node: Optional[Node] = None
        self.core: Optional[CoreWorker] = None
        self.mode: str = "disconnected"
        self.namespace: str = "default"
        self._owns_loop = False
        # Client-mode context (remote driver via proxy); set by init("ray-tpu://...").
        self.client = None

    @property
    def connected(self) -> bool:
        return self.core is not None

    # -- event loop bridge ---------------------------------------------------

    def _start_loop(self) -> None:
        # Honor the rpc_event_loop knob (uvloop when installed; no-op on
        # the stock config) before the policy mints the driver's loop.
        rpc.install_event_loop()
        loop = asyncio.new_event_loop()
        started = threading.Event()

        def run():
            asyncio.set_event_loop(loop)
            started.set()
            loop.run_forever()

        t = threading.Thread(target=run, name="ray_tpu_torch_event_loop", daemon=True)
        t.start()
        started.wait()
        self.loop = loop
        self._loop_thread = t
        self._owns_loop = True

    def run_async(self, coro, timeout: Optional[float] = None):
        if self.loop is None:
            raise RayTpuError("ray_tpu_torch not initialized; call ray_tpu_torch.init()")
        if threading.current_thread() is self._loop_thread or (
            not self._owns_loop and self._on_loop_thread()
        ):
            raise RayTpuError(
                "sync API called from the event-loop thread; use the async API"
            )
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        try:
            return fut.result(timeout)
        except concurrent.futures.TimeoutError as e:
            fut.cancel()
            from ray_tpu_torch._private.common import GetTimeoutError

            raise GetTimeoutError("operation timed out") from e

    def _on_loop_thread(self) -> bool:
        try:
            return asyncio.get_running_loop() is self.loop
        except RuntimeError:
            return False


global_worker = Worker()
_init_lock = threading.Lock()


def init(
    address: Optional[str] = None,
    *,
    num_cpus: Optional[float] = None,
    num_gpus: Optional[float] = None,
    resources: Optional[Dict[str, float]] = None,
    object_store_memory: Optional[int] = None,
    namespace: Optional[str] = None,
    ignore_reinit_error: bool = False,
    worker_env: Optional[Dict[str, str]] = None,
) -> Dict[str, Any]:
    """Start (or connect to) a cluster and attach this process as driver.

    With no address, boots a head node in-process (GCS + raylet on a
    background event loop; reference: ray.init at worker.py:1214).
    `address="host:port"` connects to an existing GCS. `address="auto"` (or
    the RAY_TPU_TORCH_ADDRESS env var, set for submitted jobs) finds the
    running cluster.
    `num_gpus` sets the node's "GPU" resource; without it the node advertises
    the GPUs it detects (accelerators.GPUAcceleratorManager).

    The port never attaches to a ray_tpu cluster: its env var and state file
    are its own.
    """
    import os as _os

    config.refresh()  # pick up env overrides set after import (fixtures)

    if address and (address.startswith("ray-tpu://") or address.startswith("ray://")):
        # Client mode (reference: Ray Client, ray.init("ray://...")): drive
        # the cluster through its proxy endpoint; this process never joins
        # the cluster network.
        from ray_tpu_torch.util import client as client_mod

        with _init_lock:
            w = global_worker
            if w.connected or w.mode == "client":
                if ignore_reinit_error:
                    return {"address": address}
                raise RayTpuError("ray_tpu_torch.init() called twice")
            ctx = client_mod.connect(address, namespace=namespace)
            w.client = ctx
            w.mode = "client"
            atexit.register(shutdown)
            return {"address": address, "job_id": ctx.job_id}

    if address == "auto":
        address = _os.environ.get("RAY_TPU_TORCH_ADDRESS") or _read_cluster_address()
        if address is None:
            raise RayTpuError("address='auto' but no running cluster found")
    elif address is None and _os.environ.get("RAY_TPU_TORCH_ADDRESS"):
        address = _os.environ["RAY_TPU_TORCH_ADDRESS"]
    with _init_lock:
        w = global_worker
        if w.connected:
            if ignore_reinit_error:
                return {"address": w.core.gcs.conn.peername}
            raise RayTpuError("ray_tpu_torch.init() called twice")
        if w.loop is None:
            w._start_loop()
        if namespace:
            w.namespace = namespace

        async def _bring_up():
            node = None
            if address is None:
                node = Node(
                    head=True,
                    num_cpus=num_cpus,
                    num_gpus=num_gpus,
                    resources=resources,
                    object_store_memory=object_store_memory,
                    worker_env=worker_env,
                )
                await node.start()
                gcs_addr = node.gcs_addr
                raylet_addr = node.raylet_addr
            else:
                host, port = address.rsplit(":", 1)
                gcs_addr = (host, int(port))
                # Find a raylet: ask GCS for nodes, prefer a local one.
                conn = await rpc.connect(*gcs_addr)
                reply = await conn.call("GetAllNodes")
                await conn.close()
                alive = [n for n in reply["nodes"] if n["state"] == "ALIVE"]
                if not alive:
                    raise RayTpuError("no alive nodes in cluster")
                raylet_addr = tuple(alive[0]["addr"])

            server = rpc.Server("127.0.0.1", 0)
            addr = await server.start()
            raylet_conn = await rpc.connect(*raylet_addr, handlers=server._handlers)
            gcs_conn = await rpc.connect(*gcs_addr, handlers=server._handlers)
            job_id = JobID.from_random().hex()
            core = CoreWorker(
                job_id=job_id,
                session_name=node.session_name if node else "external",
                node_id="driver",
                gcs_conn=gcs_conn,
                raylet_conn=raylet_conn,
                is_driver=True,
                worker_id=WorkerID.from_random().hex(),
                server=server,
                gcs_leader_file=node.gcs_leader_file() if node else None,
            )
            core.addr = addr
            core.raylet_addr = tuple(raylet_addr)
            core.start_background()
            await core.gcs.call(
                "RegisterJob", {"job_id": job_id, "driver_addr": list(addr)}
            )
            if config.log_to_driver:
                await core.gcs.subscribe(
                    "logs", lambda msg: _print_worker_log(msg, job_id)
                )
            return node, core, gcs_addr

        node, core, gcs_addr = w.run_async(
            _bring_up(), timeout=config.driver_bringup_timeout_s
        )
        w.node = node
        w.core = core
        w.mode = "driver"
        atexit.register(shutdown)
        return {"address": f"{gcs_addr[0]}:{gcs_addr[1]}", "session": core.session_name}


def _print_worker_log(msg: dict, my_job_id: Optional[str] = None) -> None:
    """Echo a worker-log pubsub batch onto the driver's stderr (reference:
    log_to_driver via log_monitor.py -> print_to_stdstream). Prefix mirrors
    the reference's ``(pid=..., ip=...)`` tag. Batches attributed to another
    job are dropped; unattributed batches (pooled task workers) are echoed
    to every driver."""
    import sys as _sys

    batch_job = msg.get("job_id")
    if batch_job is not None and my_job_id is not None and batch_job != my_job_id:
        return
    tag = f"(pid={msg.get('pid')}, worker={str(msg.get('worker_id'))[:8]})"
    out = _sys.stderr
    for line in msg.get("lines") or []:
        print(f"{tag} {line}", file=out)


def cluster_state_file() -> str:
    """State file written by `ray-tpu start` (single source of the path)."""
    import os

    return os.path.join(os.environ.get("TMPDIR", "/tmp"), "ray_tpu_torch_cluster.json")


def _read_cluster_address() -> Optional[str]:
    """Address of a cluster started via `ray-tpu start` on this machine."""
    import json

    try:
        with open(cluster_state_file()) as f:
            return json.load(f)["address"]
    except Exception:
        return None


def attach_existing(core: CoreWorker, loop: asyncio.AbstractEventLoop) -> None:
    """Used by worker processes: the loop already exists (main thread)."""
    w = global_worker
    w.core = core
    w.loop = loop
    w.mode = "worker"
    w._owns_loop = False


async def close_driver(core: Optional[CoreWorker]) -> None:
    """A driver's farewell (JobFinished) and its core worker's close; nothing
    for a core already closed."""
    if core is None or core.closed:
        return
    try:
        await asyncio.wait_for(core.gcs.call("JobFinished", {"job_id": core.job_id}), 5)
    except Exception:
        pass
    await core.close()


def shutdown() -> None:
    w = global_worker
    if w.mode == "client":
        try:
            atexit.unregister(shutdown)
        except Exception:
            pass
        ctx, w.client = w.client, None
        w.mode = "disconnected"
        if ctx is not None:
            ctx.disconnect()
        return
    if not w.connected:
        return
    try:
        atexit.unregister(shutdown)
    except Exception:
        pass
    core, node = w.core, w.node
    w.core = None
    w.node = None
    w.mode = "disconnected"

    async def _down():
        try:
            await close_driver(core)
        finally:
            if node is not None:
                await node.stop()

    try:
        w.run_async(_down(), timeout=config.driver_shutdown_timeout_s)
    except Exception:
        pass

    async def _cancel_remaining():
        tasks = [
            t
            for t in asyncio.all_tasks()
            if t is not asyncio.current_task() and not t.done()
        ]
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)

    # Only sweep the loop when we own it: in worker mode the loop is the
    # process's serving loop and its RPC/heartbeat tasks must keep running.
    if w._owns_loop:
        try:
            w.run_async(_cancel_remaining(), timeout=5)
        except Exception:
            pass
    if w._owns_loop and w.loop is not None:
        w.loop.call_soon_threadsafe(w.loop.stop)
        if w._loop_thread is not None:
            w._loop_thread.join(timeout=5)
        w.loop = None
        w._loop_thread = None
        w._owns_loop = False


def _core() -> CoreWorker:
    core = global_worker.core
    if core is None:
        raise RayTpuError("ray_tpu_torch is not initialized; call ray_tpu_torch.init() first")
    return core


# -- public primitives (sync) ------------------------------------------------


def put(value: Any) -> ObjectRef:
    if global_worker.mode == "client":
        return global_worker.client.put(value)
    return global_worker.run_async(_core().put(value))


def get(refs, timeout: Optional[float] = None):
    if global_worker.mode == "client":
        return global_worker.client.get(refs, timeout)
    single = isinstance(refs, ObjectRef)
    ref_list: List[ObjectRef] = [refs] if single else list(refs)
    for r in ref_list:
        if not isinstance(r, ObjectRef):
            raise TypeError(f"ray_tpu_torch.get expects ObjectRef(s), got {type(r)}")
    result = global_worker.run_async(
        _core().get_objects(ref_list, timeout),
        timeout=None if timeout is None else timeout + 30,
    )
    return result[0] if single else result


def wait(
    refs: Sequence[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: Optional[float] = None,
):
    ref_list = list(refs)
    if num_returns > len(ref_list):
        raise ValueError("num_returns exceeds number of refs")
    if global_worker.mode == "client":
        return global_worker.client.wait(
            ref_list, num_returns=num_returns, timeout=timeout
        )
    return global_worker.run_async(
        _core().wait(ref_list, num_returns, timeout),
        timeout=None if timeout is None else timeout + 30,
    )


def cancel(ref: ObjectRef, *, force: bool = False) -> None:
    """Best-effort cancellation of the task producing `ref` (reference:
    ray.cancel at worker.py:2932)."""
    if global_worker.mode == "client":
        global_worker.client.cancel(ref, force=force)
        return
    if not isinstance(ref, ObjectRef):
        raise TypeError("ray_tpu_torch.cancel expects an ObjectRef")
    global_worker.run_async(_core().cancel(ref, force))


def kill(actor, *, no_restart: bool = True) -> None:
    from ray_tpu_torch.actor import ActorHandle

    if not isinstance(actor, ActorHandle):
        raise TypeError("ray_tpu_torch.kill expects an ActorHandle")
    if global_worker.mode == "client":
        global_worker.client.kill(actor._actor_id, no_restart=no_restart)
        return
    global_worker.run_async(_core().kill_actor(actor._actor_id, no_restart))


def get_actor(name: str, namespace: Optional[str] = None):
    from ray_tpu_torch.actor import ActorHandle

    if global_worker.mode == "client":
        return global_worker.client.get_actor(name, namespace)
    reply = global_worker.run_async(
        _core().gcs.call(
            "GetNamedActor",
            {"name": name, "namespace": namespace or global_worker.namespace},
        )
    )
    info = reply["actor"]
    if info is None or info["state"] == "DEAD":
        raise ValueError(f"no live actor named {name!r}")
    return ActorHandle(info["actor_id"], info.get("max_task_retries", 0))


def nodes() -> List[dict]:
    if global_worker.mode == "client":
        return global_worker.client.nodes()
    return global_worker.run_async(_core().gcs.call("GetAllNodes"))["nodes"]


def cluster_resources() -> Dict[str, float]:
    from ray_tpu_torch._private.common import ResourceSet

    total = ResourceSet()
    for n in nodes():
        if n["state"] == "ALIVE":
            total = total + ResourceSet.from_units(n["total"])
    return total.to_dict()


def available_resources() -> Dict[str, float]:
    from ray_tpu_torch._private.common import ResourceSet

    total = ResourceSet()
    for n in nodes():
        if n["state"] == "ALIVE":
            total = total + ResourceSet.from_units(n["available"])
    return total.to_dict()


def is_initialized() -> bool:
    return global_worker.connected or global_worker.mode == "client"
