"""gRPC ingress: a second front end over the same route table and handles
as the HTTP proxy; the port's own copy of ``ray_tpu/serve/grpc_proxy.py``.

Reference: the gRPC proxy beside HTTP in
``python/ray/serve/_private/proxy.py:521`` (wire schema
``src/ray/protobuf/serve.proto``). The service is served with grpc's
generic handlers, no generated code, on this wire contract:

    service ray_tpu.serve.ServeAPI {
      rpc Predict        (bytes) returns (bytes);          // unary
      rpc PredictStreamed(bytes) returns (stream bytes);   // server stream
    }

A request names its serve route in its invocation metadata (``route``: the
full path, e.g. ``"/myapp/predict"``, matched against the route prefixes as
the HTTP proxy matches paths). The request's bytes are the body (typically
JSON) of a POST ``Request`` to the ingress deployment; a unary reply is the
handler's JSON (or raw bytes) result; a streamed reply is one message per
handler chunk, SSE framing stripped (gRPC frames its messages).

As the port's HTTP proxy, the server runs in the driver, on grpc's thread
pool, over the controller's ``RouteTable``, admitting each request through
an ``AdmissionController`` of its own (global budget, per-deployment
queues, tenant caps from ``set_tenant_policies``). ``grpc`` is imported
only when a server starts: ``import ray_tpu_torch.serve`` works without
``grpcio``.
"""

from __future__ import annotations

import json
import threading
from typing import Optional

from ray_tpu_torch.serve.config import ProxyConfig
from ray_tpu_torch.serve.proxy import (DEFAULT_TENANT, TENANT_HEADER, AdmissionController,
                                       Request, RouteTable)

SERVICE = "ray_tpu.serve.ServeAPI"
# a unary reply's and a streamed chunk's deadline, as the HTTP proxy's
REPLY_TIMEOUT_S = 120.0


def _encode_message(item) -> Optional[bytes]:
    """One deployment chunk -> one gRPC message (None: a framing-only chunk,
    skipped). SSE ``data:`` framing from HTTP-oriented generators is
    stripped: gRPC messages are already delimited."""
    from ray_tpu_torch.serve.streaming import RawBody, StreamStart

    if isinstance(item, StreamStart):
        return None
    if isinstance(item, RawBody):
        return item.tobytes()
    if isinstance(item, bytes):
        return item
    if isinstance(item, str):
        text = item
        if text.startswith("data: "):
            text = text[len("data: "):]
        text = text.strip()
        if not text or text == "[DONE]":
            return None
        return text.encode()
    return json.dumps(item).encode()


def _identity(b: bytes) -> bytes:
    return b


class GrpcProxyServer:
    """The gRPC server on ``host:port`` (0: any free port), over the
    controller's route table."""

    def __init__(self, controller, host: str = "127.0.0.1", port: int = 9000,
                 config: Optional[ProxyConfig] = None):
        from concurrent import futures

        import grpc

        self._rt = RouteTable(controller)
        self._admission = AdmissionController(config)
        proxy = self

        def resolve(request: bytes, context):
            md = dict(context.invocation_metadata() or ())
            route = md.get("route", "/")
            handle, rest = proxy._rt.match(route)
            if handle is None:
                context.abort(grpc.StatusCode.NOT_FOUND, f"no route for {route!r}")
            return handle, Request("POST", rest, {}, md, request)

        def admit(handle, req, context):
            tenant = req.headers.get(TENANT_HEADER, "") or DEFAULT_TENANT
            ticket = proxy._admission.try_admit(
                handle.deployment_name, tenant, dep_cap=proxy._rt.dep_cap(handle.deployment_name))
            if ticket is None:
                context.set_trailing_metadata(
                    (("retry-after", f"{proxy._admission.retry_after_s:g}"),))
                context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED,
                              "ingress overloaded; retry later")
            return ticket

        def predict(request: bytes, context) -> bytes:
            handle, req = resolve(request, context)
            ticket = admit(handle, req, context)
            try:
                try:
                    result = handle.remote(req).result(timeout_s=REPLY_TIMEOUT_S)
                except Exception as e:  # noqa: BLE001 — surfaced as a gRPC status
                    context.abort(grpc.StatusCode.INTERNAL, repr(e))
                    return b""
                if isinstance(result, bytes):
                    return result
                return json.dumps(result).encode()
            finally:
                proxy._admission.release(ticket)

        def predict_streamed(request: bytes, context):
            handle, req = resolve(request, context)
            ticket = admit(handle, req, context)
            chunks = None
            try:
                chunks = handle.options(stream=True).remote(req)
                chunks.unwrap_raw = False  # _encode_message takes RawBody
                while True:
                    try:
                        item = chunks.next(timeout_s=REPLY_TIMEOUT_S)
                    except StopIteration:
                        chunks = None
                        return
                    except Exception as e:  # noqa: BLE001
                        context.abort(grpc.StatusCode.INTERNAL, repr(e))
                        return
                    msg = _encode_message(item)
                    if msg is not None:
                        yield msg
            finally:
                if chunks is not None:
                    chunks.cancel()  # a client that went away mid-stream
                proxy._admission.release(ticket)

        handlers = grpc.method_handlers_generic_handler(SERVICE, {
            "Predict": grpc.unary_unary_rpc_method_handler(
                predict, request_deserializer=_identity, response_serializer=_identity),
            "PredictStreamed": grpc.unary_stream_rpc_method_handler(
                predict_streamed, request_deserializer=_identity,
                response_serializer=_identity),
        })
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=16, thread_name_prefix="grpc-proxy"))
        self._server.add_generic_rpc_handlers((handlers,))
        self._port = self._server.add_insecure_port(f"{host}:{port}")
        if self._port == 0:
            raise OSError(f"could not bind the gRPC proxy to {host}:{port}")
        self._server.start()

    @property
    def port(self) -> int:
        return self._port

    def set_tenant_policies(self, policies: list) -> None:
        """Tenant weights for per-tenant admission caps:
        ``[{"tenant": name, "weight": w}, ...]``."""
        self._admission.set_tenant_policies(policies)

    def get_stats(self) -> dict:
        return self._admission.snapshot()

    def shutdown(self, grace_s: float = 1.0) -> bool:
        self._server.stop(grace=grace_s).wait()
        global _grpc_proxy
        with _grpc_lock:
            if _grpc_proxy is self:
                _grpc_proxy = None
        return True


_grpc_proxy: Optional[GrpcProxyServer] = None
_grpc_lock = threading.Lock()


def start_grpc_proxy(port: int = 9000, *, host: str = "127.0.0.1",
                     config: Optional[ProxyConfig] = None):
    """Ensure this driver's gRPC proxy is running; returns (server, port).
    The controller must be up (``serve.run`` first)."""
    from ray_tpu_torch.serve import api

    global _grpc_proxy
    with _grpc_lock:
        if _grpc_proxy is None:
            _grpc_proxy = GrpcProxyServer(api._get_controller(), host=host, port=port,
                                          config=config)
        return _grpc_proxy, _grpc_proxy.port


def _stop_grpc_proxy() -> None:
    with _grpc_lock:
        proxy = _grpc_proxy
    if proxy is not None:
        proxy.shutdown()
