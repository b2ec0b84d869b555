"""Remote interactive driver ("Ray Client" equivalent).

Analog of python/ray/util/client: a laptop/notebook process drives a remote
cluster through ONE proxy endpoint (`ray_tpu_torch.init(address="ray-tpu://host:port")`)
— it never dials raylets or workers, holds only opaque handles, and all
values live cluster-side in the proxy session's object store. The top-level
API (`put/get/wait/remote/actors`) transparently routes here when the
session is in client mode (reference: ray_client.proto:326,
util/client/worker.py).
"""

from __future__ import annotations

import asyncio
import threading
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private import rpc, serialization
from ray_tpu_torch._private.common import GetTimeoutError, RayTpuError, config
from ray_tpu_torch.util.client.common import ClientObjectRef

__all__ = ["ClientContext", "ClientObjectRef", "connect"]


class ClientContext:
    """Client side of the proxy protocol. Owns a private event loop thread
    and one connection to the client server."""

    def __init__(self, host: str, port: int, namespace: Optional[str] = None):
        self.addr = (host, int(port))
        self.namespace = namespace
        self.closed = False
        self._release_buf: List[str] = []
        self._release_lock = threading.Lock()
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._run_loop, name="ray_tpu_torch_client", daemon=True
        )
        self._thread.start()
        self.conn = self._run(self._connect(), timeout=30)
        hello = self._run(
            self.conn.call("CHello", {"namespace": namespace}), timeout=30
        )
        self.job_id = hello["job_id"]
        self.owner_addr = tuple(hello["owner_addr"])
        self._fn_ids_known: set = set()

    # -- loop plumbing -------------------------------------------------------

    def _run_loop(self) -> None:
        asyncio.set_event_loop(self.loop)
        self.loop.run_forever()

    def _run(self, coro, timeout=None):
        import concurrent.futures

        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        try:
            return fut.result(timeout)
        except concurrent.futures.TimeoutError as e:
            # Not an alias of builtin TimeoutError until 3.11; name it.
            fut.cancel()
            raise GetTimeoutError(str(e) or "client call timed out") from e
        except rpc.RpcError as e:
            # Server-side errors arrive stringified as "TypeName: msg";
            # re-raise timeouts under their real type so `except
            # GetTimeoutError` behaves identically in client mode.
            if str(e).startswith("GetTimeoutError"):
                raise GetTimeoutError(str(e)) from e
            raise

    async def _connect(self):
        conn = await rpc.connect(
            *self.addr, handlers={"CLog": self._on_log}, retry=10
        )
        return conn

    async def _on_log(self, conn, msg):
        import sys

        tag = f"(pid={msg.get('pid')}, worker={str(msg.get('worker_id'))[:8]})"
        for line in msg.get("lines") or []:
            print(f"{tag} {line}", file=sys.stderr)

    # -- serialization helpers ----------------------------------------------

    def _prepare_args(self, args: tuple, kwargs: dict):
        """Client-side analog of CoreWorker._prepare_args: find top-level
        client refs, serialize the rest, collect contained-ref deps."""
        ref_positions = [
            i for i, a in enumerate(args) if isinstance(a, ClientObjectRef)
        ]
        kw_ref_keys = [
            k for k, v in kwargs.items() if isinstance(v, ClientObjectRef)
        ]
        serialized = serialization.serialize((tuple(args), kwargs))
        deps = []
        seen = set()
        for r in serialized.contained_refs:
            if r.hex() not in seen:
                seen.add(r.hex())
                deps.append([r.hex(), list(r.owner_addr or self.owner_addr)])
        return serialized.to_bytes(), ref_positions, kw_ref_keys, deps

    def _make_refs(self, oids: List[str], owner) -> List[ClientObjectRef]:
        owner = tuple(owner) if owner else self.owner_addr
        return [ClientObjectRef(oid, owner, self) for oid in oids]

    # -- public API ----------------------------------------------------------

    def put(self, value: Any) -> ClientObjectRef:
        payload = serialization.serialize(value).to_bytes()
        if len(payload) > config.max_direct_call_object_size:
            # Large values ride as a blob sidecar: the serialized region goes
            # to the socket as raw bytes (no msgpack re-pack of the payload)
            # and lands server-side as p["data"].
            reply = self._run(
                self.conn.call_with_blob("CPut", {}, payload, timeout=300),
                timeout=310,
            )
        else:
            reply = self._run(
                self.conn.call("CPut", {"payload": payload}), timeout=300
            )
        return ClientObjectRef(reply["oid"], tuple(reply["owner_addr"]), self)

    def get(self, refs, timeout: Optional[float] = None):
        single = not isinstance(refs, (list, tuple))
        if single:
            refs = [refs]
        oids = [r.hex() for r in refs]
        owners = [list(getattr(r, "owner_addr", None) or self.owner_addr) for r in refs]
        reply = self._run(
            self.conn.call(
                "CGet", {"oids": oids, "owners": owners, "timeout": timeout},
                timeout=None if timeout is None else timeout + 30,
            ),
            timeout=None if timeout is None else timeout + 60,
        )
        values = []
        for oid in oids:
            value, is_exc = serialization.deserialize(reply["payloads"][oid])
            if is_exc:
                raise value
            values.append(value)
        return values[0] if single else values

    def wait(self, refs, num_returns=1, timeout=None, fetch_local=True):
        oids = [r.hex() for r in refs]
        owners = [list(getattr(r, "owner_addr", None) or self.owner_addr) for r in refs]
        reply = self._run(
            self.conn.call(
                "CWait",
                {
                    "oids": oids,
                    "owners": owners,
                    "num_returns": num_returns,
                    "timeout": timeout,
                    "fetch_local": fetch_local,
                },
            ),
            timeout=None if timeout is None else timeout + 60,
        )
        by_hex = {r.hex(): r for r in refs}
        return (
            [by_hex[h] for h in reply["ready"]],
            [by_hex[h] for h in reply["not_ready"]],
        )

    def submit_remote_function(self, rf, args: tuple, kwargs: dict):
        from ray_tpu_torch._private.core_worker import function_id_of
        from ray_tpu_torch.remote_function import _build_resources, _strategy_fields

        opts = rf._options
        pickled = rf._get_pickled()
        func_id = function_id_of(pickled)
        payload, ref_pos, kw_refs, deps = self._prepare_args(args, kwargs)
        pg_id, bundle_index, strategy = _strategy_fields(opts)
        req = {
            "func_id": func_id,
            "name": opts.get("name") or getattr(rf._fn, "__name__", "task"),
            "args_payload": payload,
            "ref_positions": ref_pos,
            "kw_ref_keys": kw_refs,
            "dependencies": deps,
            "num_returns": opts.get("num_returns", 1),
            "resources": _build_resources(opts),
            "max_retries": opts.get("max_retries"),
            "retry_exceptions": opts.get("retry_exceptions", False),
            "pg_id": pg_id,
            "bundle_index": bundle_index,
            "scheduling_strategy": strategy,
            "runtime_env": opts.get("runtime_env"),
        }
        if func_id not in self._fn_ids_known:
            req["fn_blob"] = pickled
        reply = self._run(self.conn.call("CTask", req), timeout=300)
        if reply.get("need_fn"):
            req["fn_blob"] = pickled
            reply = self._run(self.conn.call("CTask", req), timeout=300)
        self._fn_ids_known.add(func_id)
        return self._make_refs(reply["oids"], reply.get("owner_addr"))

    def create_actor(self, actor_cls, args: tuple, kwargs: dict):
        from ray_tpu_torch.actor import ActorHandle
        from ray_tpu_torch.remote_function import _build_resources, _strategy_fields

        opts = actor_cls._options
        payload, ref_pos, kw_refs, deps = self._prepare_args(args, kwargs)
        pg_id, bundle_index, strategy = _strategy_fields(opts)
        reply = self._run(
            self.conn.call(
                "CActorCreate",
                {
                    "cls_blob": actor_cls._get_pickled(),
                    "name": actor_cls._cls.__name__,
                    "args_payload": payload,
                    "ref_positions": ref_pos,
                    "kw_ref_keys": kw_refs,
                    "dependencies": deps,
                    "opts": {
                        "resources": _build_resources(opts),
                        "max_restarts": opts.get("max_restarts", 0),
                        "max_concurrency": opts.get("max_concurrency", 1),
                        "max_task_retries": opts.get("max_task_retries", 0),
                        "concurrency_groups": opts.get("concurrency_groups"),
                        "name": opts.get("name"),
                        "namespace": opts.get("namespace") or self.namespace,
                        "lifetime": opts.get("lifetime"),
                        "get_if_exists": opts.get("get_if_exists", False),
                        "scheduling_strategy": strategy,
                        "runtime_env": opts.get("runtime_env"),
                    },
                },
            ),
            timeout=300,
        )
        return ActorHandle(reply["actor_id"], opts.get("max_task_retries", 0))

    def call_actor_method(
        self, actor_id: str, method: str, args, kwargs,
        num_returns=1, max_task_retries=0, concurrency_group=None,
    ):
        payload, ref_pos, kw_refs, deps = self._prepare_args(args, kwargs)
        reply = self._run(
            self.conn.call(
                "CActorCall",
                {
                    "actor_id": actor_id,
                    "method": method,
                    "args_payload": payload,
                    "ref_positions": ref_pos,
                    "kw_ref_keys": kw_refs,
                    "dependencies": deps,
                    "num_returns": num_returns,
                    "max_task_retries": max_task_retries,
                    "concurrency_group": concurrency_group,
                },
            ),
            timeout=300,
        )
        return self._make_refs(reply["oids"], reply.get("owner_addr"))

    def kill(self, actor_id: str, no_restart: bool = True) -> None:
        self._run(
            self.conn.call("CKill", {"actor_id": actor_id, "no_restart": no_restart}),
            timeout=60,
        )

    def cancel(self, ref, force: bool = False) -> None:
        self._run(
            self.conn.call(
                "CCancel",
                {
                    "oid": ref.hex(),
                    "owner": list(getattr(ref, "owner_addr", None) or self.owner_addr),
                    "force": force,
                },
            ),
            timeout=60,
        )

    def get_actor(self, name: str, namespace: Optional[str] = None):
        from ray_tpu_torch.actor import ActorHandle

        reply = self._run(
            self.conn.call(
                "CGetActor", {"name": name, "namespace": namespace}
            ),
            timeout=60,
        )
        return ActorHandle(reply["actor_id"], reply.get("max_task_retries", 0))

    def nodes(self) -> List[dict]:
        reply = self._run(self.conn.call("CClusterInfo", {}), timeout=60)
        return reply["nodes"]

    # -- ref releases --------------------------------------------------------

    def _schedule_release(self, oid: str) -> None:
        with self._release_lock:
            self._release_buf.append(oid)
            if len(self._release_buf) == 1:
                try:
                    self.loop.call_soon_threadsafe(
                        lambda: self.loop.call_later(0.2, self._flush_releases)
                    )
                except RuntimeError:
                    pass

    def _flush_releases(self) -> None:
        with self._release_lock:
            oids, self._release_buf = self._release_buf, []
        if oids and not self.conn.closed:
            try:
                self.conn.push_nowait("CRelease", {"oids": oids})
            except rpc.ConnectionLost:
                pass

    def disconnect(self) -> None:
        if self.closed:
            return
        self.closed = True
        try:
            self._run(self.conn.close(), timeout=5)
        except Exception:
            pass
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._thread.join(timeout=5)


def connect(address: str, namespace: Optional[str] = None) -> ClientContext:
    """Connect to a cluster's client server. ``address`` is ``host:port`` or
    ``ray-tpu://host:port``."""
    for prefix in ("ray-tpu://", "ray://"):
        if address.startswith(prefix):
            address = address[len(prefix):]
    host, port = address.rsplit(":", 1)
    return ClientContext(host, int(port), namespace=namespace)
