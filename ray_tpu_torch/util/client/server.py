"""Client proxy server: the cluster side of the remote-driver protocol.

Analog of python/ray/util/client/server/server.py + proxier.py: ONE endpoint
on the head node through which a remote interactive driver reaches the whole
cluster. Each connected client gets a server-side Session holding a real
driver CoreWorker (own job id, own object ownership); client handles are ids
into that session. Values never deserialize in the proxy — puts, task args,
and get results move as opaque serialized payloads, because only the client
and the task workers have the user's code (reference: ray_client.proto:326
dataplane messages).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Dict, Optional, Tuple

from ray_tpu_torch._private import rpc, serialization
from ray_tpu_torch._private.common import ResourceSet, config
from ray_tpu_torch._private.core_worker import CoreWorker, ObjectRef
from ray_tpu_torch._private.ids import (
    JobID,
    ObjectID,
    WorkerID,
    fast_unique_hex,
    return_object_ids,
)

logger = logging.getLogger(__name__)


class Session:
    """One connected client's server-side driver state."""

    def __init__(self, core: CoreWorker, namespace: Optional[str]):
        self.core = core
        self.namespace = namespace
        # Pin every ref the client can still name; CRelease drops them.
        self.refs: Dict[str, ObjectRef] = {}

    def pin(self, refs) -> None:
        for r in refs:
            self.refs[r.hex()] = r

    def lookup(self, oid: str, owner_addr=None) -> ObjectRef:
        r = self.refs.get(oid)
        if r is not None:
            return r
        # Borrowed ref (e.g. returned nested inside a result): resolve via
        # the recorded owner.
        return ObjectRef(oid, tuple(owner_addr) if owner_addr else self.core.addr, self.core)

    async def close(self) -> None:
        self.refs.clear()
        try:
            await asyncio.wait_for(
                self.core.gcs.call("JobFinished", {"job_id": self.core.job_id}), 5
            )
        except Exception:
            pass
        try:
            await self.core.close()
        except Exception:
            pass


class ClientServer:
    """The proxy endpoint. Run on (or near) the head node:
    ``ClientServer(gcs_addr).start(port)``; clients connect with
    ``ray_tpu_torch.init(address="ray-tpu://host:port")``."""

    def __init__(self, gcs_addr: Tuple[str, int], host: str = "127.0.0.1", port: int = 0):
        self.gcs_addr = tuple(gcs_addr)
        self.server = rpc.Server(host, port)
        self.sessions: Dict[int, Session] = {}
        s = self.server
        s.register("CHello", self._hello)
        s.register("CPut", self._put)
        s.register("CTask", self._task)
        s.register("CActorCreate", self._actor_create)
        s.register("CActorCall", self._actor_call)
        s.register("CGet", self._get)
        s.register("CWait", self._wait)
        s.register("CRelease", self._release)
        s.register("CKill", self._kill)
        s.register("CCancel", self._cancel)
        s.register("CGetActor", self._get_actor)
        s.register("CClusterInfo", self._cluster_info)
        s.on_disconnect(self._on_disconnect)

    async def start(self) -> Tuple[str, int]:
        self.addr = await self.server.start()
        logger.info("client server on %s:%s -> gcs %s", *self.addr, self.gcs_addr)
        return self.addr

    async def stop(self) -> None:
        for sess in list(self.sessions.values()):
            await sess.close()
        self.sessions.clear()
        await self.server.stop()

    # -- session lifecycle ---------------------------------------------------

    def _session(self, conn) -> Session:
        sess = self.sessions.get(id(conn))
        if sess is None:
            raise rpc.RpcError("no session; send CHello first")
        return sess

    def _on_disconnect(self, conn) -> None:
        sess = self.sessions.pop(id(conn), None)
        if sess is not None:
            rpc.spawn(sess.close())

    async def _hello(self, conn, p):
        gcs_conn0 = await rpc.connect(*self.gcs_addr)
        reply = await gcs_conn0.call("GetAllNodes")
        await gcs_conn0.close()
        alive = [n for n in reply["nodes"] if n["state"] == "ALIVE"]
        if not alive:
            raise rpc.RpcError("no alive nodes in cluster")
        raylet_addr = tuple(alive[0]["addr"])
        server = rpc.Server("127.0.0.1", 0)
        addr = await server.start()
        raylet_conn = await rpc.connect(*raylet_addr, handlers=server._handlers)
        gcs_conn = await rpc.connect(*self.gcs_addr, handlers=server._handlers)
        job_id = JobID.from_random().hex()
        core = CoreWorker(
            job_id=job_id,
            session_name="client",
            node_id="client-proxy",
            gcs_conn=gcs_conn,
            raylet_conn=raylet_conn,
            is_driver=True,
            worker_id=WorkerID.from_random().hex(),
            server=server,
        )
        core.addr = addr
        core.raylet_addr = raylet_addr
        core.start_background()
        # Register the session BEFORE any further awaits: a client that
        # drops mid-handshake must be findable by _on_disconnect, or the
        # proxy-side CoreWorker and its job leak forever.
        sess = Session(core, p.get("namespace"))
        self.sessions[id(conn)] = sess
        await core.gcs.call("RegisterJob", {"job_id": job_id, "driver_addr": list(addr)})
        if config.log_to_driver:
            # Forward this job's worker logs to the remote client.
            def fwd(msg, _conn=conn, _job=job_id):
                if msg.get("job_id") in (None, _job):
                    try:
                        _conn.push_nowait("CLog", msg)
                    except rpc.ConnectionLost:
                        pass

            await core.gcs.subscribe("logs", fwd)
        if conn.closed:
            # Dropped during the handshake awaits; disconnect may have fired
            # before our registration landed.
            if self.sessions.pop(id(conn), None) is not None:
                await sess.close()
            raise rpc.RpcError("client disconnected during handshake")
        return {"job_id": job_id, "owner_addr": list(addr)}

    # -- data plane ----------------------------------------------------------

    async def _put(self, conn, p):
        sess = self._session(conn)
        core = sess.core
        oid = ObjectID.from_random().hex()
        # Small puts carry "payload" inline in the control frame; large puts
        # arrive as a blob sidecar injected by the RPC layer as "data".
        payload = p["data"] if "data" in p else p["payload"]
        if len(payload) <= config.max_direct_call_object_size:
            core.memory_store.put_inline(oid, payload)
        else:
            await core.plasma.put_bytes(oid, payload)
            core.memory_store.put_plasma_marker(oid, core.raylet_addr)
        core.reference_table.mark_owned(oid)
        ref = ObjectRef(oid, core.addr, core)
        sess.pin([ref])
        return {"oid": oid, "owner_addr": list(core.addr)}

    async def _task(self, conn, p):
        sess = self._session(conn)
        core = sess.core
        fn_blob = p.get("fn_blob")
        func_id = p["func_id"]
        if func_id not in core._func_ids_exported:
            if fn_blob is None:
                return {"need_fn": True}
            exported = await core.export_function(fn_blob)
            if exported != func_id:
                raise rpc.RpcError("function id mismatch")
        num_returns = p.get("num_returns", 1)
        if num_returns == "dynamic":
            num_returns = -1
        task_id = fast_unique_hex()
        return_ids = return_object_ids(
            task_id, 1 if num_returns == -1 else num_returns
        )
        res = ResourceSet(p.get("resources") or {"CPU": 1.0})
        args_blob, args_object = await self._stage_args(core, p["args_payload"])
        wire = core._task_wire(
            task_id=task_id,
            name=p.get("name", "task"),
            func_id=func_id,
            args_blob=args_blob,
            args_object=args_object,
            ref_positions=p.get("ref_positions") or [],
            kw_ref_keys=p.get("kw_ref_keys") or [],
            dependencies=[(d[0], tuple(d[1])) for d in p.get("dependencies") or []],
            num_returns=num_returns,
            return_ids=return_ids,
            resources=res.to_units(),
            max_retries=(
                p["max_retries"]
                if p.get("max_retries") is not None
                else config.default_max_task_retries
            ),
            retry_exceptions=p.get("retry_exceptions", False),
            pg_id=p.get("pg_id"),
            bundle_index=p.get("bundle_index", -1),
            scheduling_strategy=p.get("scheduling_strategy"),
            runtime_env=p.get("runtime_env"),
        )
        refs = core._launch_task(wire)
        sess.pin(refs)
        return {"oids": return_ids, "owner_addr": list(core.addr)}

    async def _stage_args(self, core, payload):
        """Return (args_blob, args_object): small payloads inline; large ones
        into the session's plasma store."""
        if payload is None or len(payload) <= config.max_direct_call_object_size:
            return payload, None
        args_object = ObjectID.from_random().hex()
        await core.plasma.put_bytes(args_object, payload)
        core.memory_store.put_plasma_marker(args_object, core.raylet_addr)
        return None, args_object

    async def _actor_create(self, conn, p):
        sess = self._session(conn)
        core = sess.core
        opts = p.get("opts") or {}
        actor_id = await core.create_actor(
            p["cls_blob"],
            p.get("name", "Actor"),
            (),
            {},
            resources=opts.get("resources"),
            max_restarts=opts.get("max_restarts", 0),
            max_concurrency=opts.get("max_concurrency", 1),
            max_task_retries=opts.get("max_task_retries", 0),
            concurrency_groups=opts.get("concurrency_groups"),
            name=opts.get("name"),
            namespace=opts.get("namespace") or sess.namespace,
            lifetime=opts.get("lifetime"),
            get_if_exists=opts.get("get_if_exists", False),
            scheduling_strategy=opts.get("scheduling_strategy"),
            runtime_env=opts.get("runtime_env"),
            prepared_args=(
                p.get("args_payload"),
                p.get("ref_positions") or [],
                p.get("kw_ref_keys") or [],
                [(d[0], tuple(d[1])) for d in p.get("dependencies") or []],
            ),
        )
        return {"actor_id": actor_id}

    async def _actor_call(self, conn, p):
        sess = self._session(conn)
        core = sess.core
        refs = await core.submit_actor_task(
            p["actor_id"],
            p["method"],
            (),
            {},
            num_returns=p.get("num_returns", 1),
            max_task_retries=p.get("max_task_retries", 0),
            concurrency_group=p.get("concurrency_group"),
            prepared_args=(
                p.get("args_payload"),
                p.get("ref_positions") or [],
                p.get("kw_ref_keys") or [],
                [(d[0], tuple(d[1])) for d in p.get("dependencies") or []],
            ),
        )
        sess.pin(refs)
        return {"oids": [r.hex() for r in refs], "owner_addr": list(core.addr)}

    async def _get(self, conn, p):
        sess = self._session(conn)
        core = sess.core
        deadline = None
        if p.get("timeout") is not None:
            import time as _time

            deadline = _time.monotonic() + p["timeout"]
        owners = p.get("owners") or [None] * len(p["oids"])
        fetched = await asyncio.gather(
            *(
                core._resolve_payload(sess.lookup(oid, owner), deadline)
                for oid, owner in zip(p["oids"], owners)
            )
        )
        payloads = {
            oid: bytes(pl) if isinstance(pl, memoryview) else pl
            for oid, pl in zip(p["oids"], fetched)
        }
        return {"payloads": payloads}

    async def _wait(self, conn, p):
        sess = self._session(conn)
        refs = [sess.lookup(oid, owner) for oid, owner in zip(p["oids"], p["owners"])]
        ready, not_ready = await sess.core.wait(
            refs, p.get("num_returns", 1), p.get("timeout")
        )
        return {
            "ready": [r.hex() for r in ready],
            "not_ready": [r.hex() for r in not_ready],
        }

    async def _release(self, conn, p):
        sess = self._session(conn)
        for oid in p["oids"]:
            sess.refs.pop(oid, None)
        return {"ok": True}

    async def _kill(self, conn, p):
        sess = self._session(conn)
        await sess.core.kill_actor(p["actor_id"], no_restart=p.get("no_restart", True))
        return {"ok": True}

    async def _cancel(self, conn, p):
        sess = self._session(conn)
        ref = sess.lookup(p["oid"], p.get("owner"))
        ok = await sess.core.cancel(ref, force=p.get("force", False))
        return {"ok": ok}

    async def _get_actor(self, conn, p):
        sess = self._session(conn)
        reply = await sess.core.gcs.call(
            "GetNamedActor",
            {
                "name": p["name"],
                "namespace": p.get("namespace") or sess.namespace or "default",
            },
        )
        actor = reply.get("actor")
        if actor is None or actor.get("state") == "DEAD":
            raise rpc.RpcError(f"no live actor named {p['name']!r}")
        return {
            "actor_id": actor["actor_id"],
            "max_task_retries": actor.get("max_task_retries", 0),
        }

    async def _cluster_info(self, conn, p):
        sess = self._session(conn)
        reply = await sess.core.gcs.call("GetAllNodes")
        return {"nodes": reply["nodes"]}


async def serve(gcs_addr, host: str = "127.0.0.1", port: int = 10001) -> ClientServer:
    srv = ClientServer(gcs_addr, host, port)
    await srv.start()
    return srv
