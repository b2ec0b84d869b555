"""HTTP ingress proxy actor.

Analog of python/ray/serve/_private/proxy.py (ProxyActor): an aiohttp server
inside an async actor. Routes by longest matching route prefix (route table
pushed from the controller via long-poll), then hands the request to the
ingress deployment through the shared pow-2 Router. The controller is never
on the request path.
"""

from __future__ import annotations

import asyncio
import json
import logging
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from ray_tpu_torch._private import rpc
from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch._private.common import config
from ray_tpu_torch.actor import ActorHandle
from ray_tpu_torch.serve._private.common import DeploymentOverloadedError
from ray_tpu_torch.serve._private.long_poll import LongPollClient

logger = logging.getLogger(__name__)


@dataclass
class HTTPRequest:
    """Picklable request passed to ingress deployments (stand-in for the
    reference's starlette Request)."""

    method: str = "GET"
    path: str = "/"
    query: Dict[str, str] = field(default_factory=dict)
    headers: Dict[str, str] = field(default_factory=dict)
    body: bytes = b""

    def json(self) -> Any:
        return json.loads(self.body or b"null")

    def text(self) -> str:
        return (self.body or b"").decode()


def _to_response(result: Any) -> Tuple[int, bytes, str]:
    if isinstance(result, tuple) and len(result) == 2 and isinstance(result[0], int):
        status, body = result
        _, b, ct = _to_response(body)
        return status, b, ct
    if isinstance(result, bytes):
        return 200, result, "application/octet-stream"
    if isinstance(result, str):
        return 200, result.encode(), "text/plain; charset=utf-8"
    return 200, json.dumps(result).encode(), "application/json"


class ProxyActor:
    def __init__(
        self, host: str = "127.0.0.1", port: int = 8000, grpc_port=None
    ):
        self._host = host
        self._port = port
        self._grpc_port = grpc_port
        self._grpc_server = None
        self._route_table: Dict[str, Dict[str, str]] = {}
        self._router = None
        self._runner = None
        self._poll: Optional[LongPollClient] = None

    async def _get_controller_handle(self) -> ActorHandle:
        core = worker_mod._core()
        reply = await core.gcs.call(
            "GetNamedActor", {"name": "SERVE_CONTROLLER", "namespace": "serve"}
        )
        return ActorHandle(reply["actor"]["actor_id"])

    async def ready(self) -> Dict[str, Any]:
        """Bind the HTTP server; returns the bound address."""
        if self._runner is not None:
            return {"host": self._host, "port": self._port}
        from aiohttp import web

        from ray_tpu_torch.serve._private.router import Router

        core = worker_mod._core()
        controller = await self._get_controller_handle()
        self._router = Router(controller, core)

        async def listen(keys_to_ids):
            refs = await core.submit_actor_task(
                controller._actor_id,
                "listen_for_change",
                (keys_to_ids,),
                {},
                num_returns=1,
            )
            return await core.get_objects(refs[0], timeout=None)

        self._poll = LongPollClient(
            listen, {"route_table": self._set_route_table}
        )
        self._poll.start()

        app = web.Application()
        app.router.add_route("*", "/{tail:.*}", self._handle)
        self._runner = web.AppRunner(app, access_log=None)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self._host, self._port)
        await site.start()
        if self._port == 0:
            self._port = site._server.sockets[0].getsockname()[1]
        if self._grpc_port is not None:
            await self._start_grpc()
        return {
            "host": self._host,
            "port": self._port,
            "grpc_port": self._grpc_port,
        }

    def _grpc_target(self, app: str):
        """Resolve a ServeRequest.application to a deployment id string."""
        for _, t in sorted(self._route_table.items()):
            if not app or t["app"] == app:
                return f"{t['app']}#{t['ingress']}"
        return None

    @staticmethod
    def _encode_reply(result: Any):
        """-> (payload bytes, content_type tag) for a ServeReply."""
        if isinstance(result, bytes):
            return result, "bytes"
        if isinstance(result, str):
            return result.encode(), "text"
        try:
            return json.dumps(result).encode(), "json"
        except (TypeError, ValueError):
            import cloudpickle

            return cloudpickle.dumps(result), "pickle"

    async def _start_grpc(self) -> None:
        """Typed gRPC ingress (reference: serve.proto RayServeAPIService):
        /ray_tpu_torch.serve.ServeAPIService/Predict (unary) and /PredictStreaming
        (server-streaming), with ServeRequest carrying application, handler
        method, multiplexed model id, and the payload."""
        import grpc

        from ray_tpu_torch.serve.protobuf import (
            ServeReply,
            add_serve_api_servicer,
        )

        def _meta(request):
            return {
                "call_method": request.method or "__call__",
                "multiplexed_model_id": request.multiplexed_model_id or None,
            }

        async def predict(request, context) -> "ServeReply":
            dep_id_str = self._grpc_target(request.application)
            if dep_id_str is None:
                await context.abort(
                    grpc.StatusCode.NOT_FOUND,
                    f"no serve application {request.application!r}",
                )
            try:
                result = await self._router.assign_request(
                    dep_id_str, _meta(request), (request.payload,), {},
                    timeout_s=config.serve_request_timeout_s,
                )
            except DeploymentOverloadedError as e:
                await context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
            except (TimeoutError, rpc.DeadlineExceeded) as e:
                await context.abort(grpc.StatusCode.UNAVAILABLE, str(e))
            except Exception as e:
                await context.abort(
                    grpc.StatusCode.INTERNAL, f"{type(e).__name__}: {e}"
                )
            payload, ctype = self._encode_reply(result)
            return ServeReply(payload=payload, content_type=ctype)

        async def predict_streaming(request, context):
            dep_id_str = self._grpc_target(request.application)
            if dep_id_str is None:
                await context.abort(
                    grpc.StatusCode.NOT_FOUND,
                    f"no serve application {request.application!r}",
                )
            try:
                async for item in self._router.assign_request_streaming(
                    dep_id_str, _meta(request), (request.payload,), {},
                    timeout_s=config.serve_request_timeout_s,
                ):
                    payload, ctype = self._encode_reply(item)
                    yield ServeReply(payload=payload, content_type=ctype)
            except DeploymentOverloadedError as e:
                await context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
            except (TimeoutError, rpc.DeadlineExceeded) as e:
                await context.abort(grpc.StatusCode.UNAVAILABLE, str(e))
            except Exception as e:
                await context.abort(
                    grpc.StatusCode.INTERNAL, f"{type(e).__name__}: {e}"
                )

        self._grpc_server = grpc.aio.server()
        add_serve_api_servicer(self._grpc_server, predict, predict_streaming)
        bound = self._grpc_server.add_insecure_port(
            f"{self._host}:{self._grpc_port}"
        )
        await self._grpc_server.start()
        self._grpc_port = bound

    @staticmethod
    def _request_budget(request) -> float:
        """Per-request deadline budget: clients may shrink (or stretch) the
        default via the serve-request-timeout-s header."""
        raw = request.headers.get("serve-request-timeout-s")
        if raw:
            try:
                return max(0.001, float(raw))
            except ValueError:
                pass
        return config.serve_request_timeout_s

    def _set_route_table(self, table: Dict[str, Dict[str, str]]) -> None:
        self._route_table = table or {}

    def _match_route(self, path: str) -> Optional[Tuple[str, Dict[str, str]]]:
        best = None
        for prefix, target in self._route_table.items():
            norm = prefix.rstrip("/") or "/"
            if path == norm or path.startswith(norm if norm != "/" else "/"):
                if norm != "/" and not (
                    path == norm or path[len(norm) :].startswith("/")
                ):
                    continue
                if best is None or len(norm) > len(best[0]):
                    best = (norm, target)
        return best

    async def _handle(self, request):
        from aiohttp import web

        path = request.path
        if path == "/-/healthz":
            return web.Response(text="success")
        if path == "/-/routes":
            return web.json_response(
                {p: t["app"] for p, t in self._route_table.items()}
            )
        match = self._match_route(path)
        if match is None:
            return web.Response(status=404, text=f"no route for {path}")
        prefix, target = match
        dep_id_str = f"{target['app']}#{target['ingress']}"
        body = await request.read()
        http_req = HTTPRequest(
            method=request.method,
            path=path[len(prefix) :] if prefix != "/" else path,
            query=dict(request.query),
            headers=dict(request.headers),
            body=body,
        )
        meta = {
            "call_method": "__call__",
            "is_http_request": True,
            # Reference Serve convention: multiplexed model id rides
            # an HTTP header.
            "multiplexed_model_id": request.headers.get(
                "serve_multiplexed_model_id", ""
            ),
        }
        # Streaming response modes (reference: StreamingResponse from a
        # generator deployment + the fastapi SSE integration):
        #   Accept: text/event-stream  -> standards-compliant SSE framing
        #     (each yielded item becomes one `data:` event; EventSource
        #     clients work unmodified);
        #   serve-streaming header    -> raw chunked bytes (legacy opt-in
        #     for binary streams).
        accept = request.headers.get("Accept", "")
        if "text/event-stream" in accept:
            return await self._handle_streaming(
                request, dep_id_str, meta, http_req, sse=True
            )
        if request.headers.get("serve-streaming"):
            return await self._handle_streaming(
                request, dep_id_str, meta, http_req
            )
        try:
            result = await self._router.assign_request(
                dep_id_str, meta, (http_req,), {},
                timeout_s=self._request_budget(request),
            )
        except DeploymentOverloadedError as e:
            # Typed shed -> 503 with Retry-After: the client should back
            # off, the deployment is refusing (not failing) the request.
            return web.Response(
                status=503, text=str(e), headers={"Retry-After": "1"}
            )
        except rpc.DeadlineExceeded as e:
            return web.Response(status=504, text=str(e))
        except TimeoutError as e:
            return web.Response(status=503, text=str(e))
        except Exception as e:
            logger.warning("request to %s failed: %r", dep_id_str, e)
            return web.Response(status=500, text=f"{type(e).__name__}: {e}")
        status, payload, ctype = _to_response(result)
        return web.Response(status=status, body=payload, content_type=ctype.split(";")[0])

    @staticmethod
    def _sse_frame(item) -> bytes:
        """One server-sent event per yielded item. Multi-line payloads get
        one `data:` line each (SSE spec: consecutive data lines join with
        newline on the client)."""
        if isinstance(item, bytes):
            text = item.decode("utf-8", "replace")
        elif isinstance(item, str):
            text = item
        else:
            text = json.dumps(item)
        lines = text.split("\n")
        return ("".join(f"data: {ln}\n" for ln in lines) + "\n").encode()

    async def _handle_streaming(
        self, request, dep_id_str, meta, http_req, sse: bool = False
    ):
        """Streamed HTTP response: each item the replica's generator yields
        is written as soon as it arrives. sse=True uses text/event-stream
        framing (Accept-negotiated); otherwise raw chunks (bytes as-is,
        str utf-8, other values JSON + newline)."""
        from aiohttp import web

        headers = (
            {
                "Content-Type": "text/event-stream",
                "Cache-Control": "no-cache",
                "Connection": "keep-alive",
            }
            if sse
            else {"Content-Type": "application/octet-stream"}
        )
        resp = web.StreamResponse(status=200, headers=headers)
        started = False
        try:
            async for item in self._router.assign_request_streaming(
                dep_id_str, meta, (http_req,), {},
                timeout_s=self._request_budget(request),
            ):
                if not started:
                    await resp.prepare(request)
                    started = True
                if sse:
                    chunk = self._sse_frame(item)
                elif isinstance(item, bytes):
                    chunk = item
                elif isinstance(item, str):
                    chunk = item.encode()
                else:
                    chunk = json.dumps(item).encode() + b"\n"
                await resp.write(chunk)
        except DeploymentOverloadedError as e:
            if not started:
                return web.Response(
                    status=503, text=str(e), headers={"Retry-After": "1"}
                )
            raise
        except TimeoutError as e:
            if not started:
                return web.Response(status=503, text=str(e))
            raise  # mid-stream: the broken body tells the client
        except Exception as e:
            logger.warning("streaming request to %s failed: %r", dep_id_str, e)
            if not started:
                return web.Response(
                    status=500, text=f"{type(e).__name__}: {e}"
                )
            raise
        if not started:
            await resp.prepare(request)
        await resp.write_eof()
        return resp

    async def check_health(self) -> bool:
        return True
