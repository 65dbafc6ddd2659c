"""HTTP proxy: routes requests to application ingress handles; a port of
``ray_tpu/serve/proxy.py``.

Reference: ``python/ray/serve/_private/proxy.py:1009`` (``ProxyActor``).
Here the proxy serves one host and runs in the driver, as threads: a
stdlib ``ThreadingHTTPServer`` whose handler threads call the ingress
deployment's handle at once (the JAX package runs it as an actor, with an
asyncio data plane by default and this threaded one beside it).

Request contract: the ingress callable receives a ``Request`` object with
``.method``, ``.path``, ``.query_params``, ``.headers``, ``.body``,
``.json()``. Its return value is JSON-encoded (dict/list/str/numbers/None)
or sent raw for ``bytes``; a generator streams (SSE for str chunks, ndjson
for objects). Admission (``AdmissionController``) sheds past its caps with
429 + ``Retry-After``; ``shutdown`` drains.

Left out, against the JAX package: one proxy per node registered with the
controller (``start_proxies``, proxy incarnations, ``list_proxies``), and
the zero-copy object-store body path (``_inproc_store``): the port has one
host and no object store, so bodies travel by value.
"""

from __future__ import annotations

import json
import math
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional
from urllib.parse import parse_qs, urlparse

from ray_tpu_torch.serve.config import ProxyConfig


class Request:
    def __init__(self, method: str, path: str, query: dict, headers: dict,
                 body: bytes, raw_query: str = ""):
        self.method = method
        self.path = path
        self.query_params = query
        self.headers = headers
        self.body = body
        # unparsed query string (repeated keys, encoding)
        self.raw_query = raw_query

    def json(self) -> Any:
        return json.loads(self.body or b"null")

    def __reduce__(self):
        return (
            Request,
            (self.method, self.path, self.query_params, self.headers,
             self.body, self.raw_query),
        )


def _encode_chunk(item) -> bytes:
    """Deployment chunk -> wire bytes."""
    if isinstance(item, str):
        return item.encode()
    if isinstance(item, bytes):
        return item
    return json.dumps(item).encode() + b"\n"


def _clean_header(name, value) -> tuple[str, str]:
    """Strip CR/LF (and NUL) from app-supplied header names/values before
    they reach the wire: an app echoing request input into a header must
    not be able to split the response."""
    tr = {ord("\r"): None, ord("\n"): None, ord("\x00"): None}
    return str(name).translate(tr), str(value).translate(tr)


# RFC 9112: these responses never carry a body — writing Transfer-Encoding
# or chunk framing for them desyncs keep-alive clients.
def _bodiless(status: int) -> bool:
    return status in (204, 304) or 100 <= status < 200


def _hget(headers: dict, name: str, default: str = "") -> str:
    """Case-insensitive header lookup on a case-preserving dict."""
    lname = name.lower()
    for k, v in headers.items():
        if k.lower() == lname:
            return v
    return default


# Request header naming the submitting tenant (admission accounting); absent
# = the default tenant.
TENANT_HEADER = "x-ray-tpu-tenant"
DEFAULT_TENANT = "default"
# Shared cap bucket for tenant names outside the policy records, and the
# overflow key + size bound for the per-tenant shed table: both keep
# untrusted free-form header values from bypassing isolation or growing
# proxy state without bound.
_UNREGISTERED_TENANT = "(unregistered)"
_OVERFLOW_TENANT = "(other)"
_SHED_TENANT_TABLE_MAX = 64
# fair-share weights below this floor are clamped (a weight is a share, not
# a switch)
_MIN_WEIGHT = 0.01


def admission_caps(policies: list[dict], budget: int) -> dict[str, int]:
    """Weight-proportional per-tenant shares of an ingress in-flight budget:
    the port's own copy of ``ray_tpu/_private/tenants.py:admission_caps``.
    Each tenant's cap is its weight fraction of the budget, floored at 1;
    {} when fewer than two tenants are known (the budget alone is then the
    policy). ``policies``: records with ``tenant`` and ``weight``."""
    known = {p["tenant"]: max(float(p.get("weight", 1.0)), _MIN_WEIGHT)
             for p in policies}
    if len(known) < 2 or budget <= 0:
        return {}
    total = sum(known.values())
    return {
        name: max(1, math.ceil(budget * w / total))
        for name, w in known.items()
    }


class AdmissionController:
    """Token-budget admission with load shedding (shed, don't stall).

    - a **global in-flight budget** per proxy
      (``serve_max_inflight_per_proxy``): past it, new requests get 429 +
      ``Retry-After`` instead of joining an unbounded backlog;
    - a **per-deployment bounded queue**
      (``serve_queue_depth_per_deployment``, overridable per deployment via
      ``max_queued_requests``) so one hot route cannot occupy the ingress;
    - **per-tenant caps** from tenant weights (``set_tenant_policies``; the
      JAX package reads them from its scheduler's tenant records): one
      tenant's burst sheds at its weight share of the budget.

    Thread-safe: handler threads and the control calls all touch the
    counters.
    """

    def __init__(self, config: Optional[ProxyConfig] = None):
        cfg = config or ProxyConfig()
        self.budget = cfg.serve_max_inflight_per_proxy
        self.dep_default_cap = cfg.serve_queue_depth_per_deployment
        self.retry_after_s = cfg.serve_shed_retry_after_s
        self.tenant_enabled = cfg.serve_tenant_admission
        self._lock = threading.Lock()
        self._inflight_total = 0
        self._inflight_dep: dict[str, int] = {}
        self._inflight_tenant: dict[str, int] = {}
        self._tenant_caps: dict[str, int] = {}
        self._draining = False
        self._stats = {
            "accepted": 0,
            "shed": 0,  # total sheds (all causes below + drain rejects)
            "shed_global": 0,
            "shed_deployment": 0,
            "shed_tenant": 0,
            "shed_draining": 0,
            "dropped_streams": 0,
            "body_bytes_copied": 0,
        }
        self._shed_by_tenant: dict[str, int] = {}

    def set_tenant_policies(self, policies: list) -> None:
        """Per-tenant caps from tenant policy records (``tenant``, ``weight``)."""
        caps = admission_caps(policies or [], self.budget)
        with self._lock:
            self._tenant_caps = caps

    def try_admit(self, deployment: str, tenant: str,
                  dep_cap: Optional[int] = None):
        """Admit (returns a release ticket) or shed (returns None)."""
        with self._lock:
            if self._draining:
                self._stats["shed"] += 1
                self._stats["shed_draining"] += 1
                return None
            if self._inflight_total >= self.budget:
                self._shed_locked(tenant, "shed_global")
                return None
            cap = dep_cap if dep_cap is not None else self.dep_default_cap
            if self._inflight_dep.get(deployment, 0) >= cap:
                self._shed_locked(tenant, "shed_deployment")
                return None
            if self.tenant_enabled and self._tenant_caps:
                tcap = self._tenant_caps.get(tenant)
                if tcap is None:
                    # the tenant header is free-form client input: every
                    # name outside the policy records shares ONE bucket at
                    # the smallest configured share
                    tenant = _UNREGISTERED_TENANT
                    tcap = min(self._tenant_caps.values())
                if self._inflight_tenant.get(tenant, 0) >= tcap:
                    self._shed_locked(tenant, "shed_tenant")
                    return None
            self._inflight_total += 1
            self._inflight_dep[deployment] = (
                self._inflight_dep.get(deployment, 0) + 1
            )
            self._inflight_tenant[tenant] = (
                self._inflight_tenant.get(tenant, 0) + 1
            )
            self._stats["accepted"] += 1
            return (deployment, tenant)

    def _shed_locked(self, tenant: str, reason: str) -> None:
        self._stats["shed"] += 1
        self._stats[reason] += 1
        # bounded: the tenant name is untrusted header input
        if (
            tenant not in self._shed_by_tenant
            and len(self._shed_by_tenant) >= _SHED_TENANT_TABLE_MAX
        ):
            tenant = _OVERFLOW_TENANT
        self._shed_by_tenant[tenant] = self._shed_by_tenant.get(tenant, 0) + 1

    def release(self, ticket) -> None:
        if ticket is None:
            return
        deployment, tenant = ticket
        with self._lock:
            self._inflight_total = max(0, self._inflight_total - 1)
            for table, key in (
                (self._inflight_dep, deployment),
                (self._inflight_tenant, tenant),
            ):
                left = table.get(key, 1) - 1
                if left > 0:
                    table[key] = left
                else:
                    table.pop(key, None)

    def count_body(self, nbytes: int) -> None:
        with self._lock:
            self._stats["body_bytes_copied"] += nbytes

    def begin_drain(self) -> None:
        with self._lock:
            self._draining = True

    @property
    def draining(self) -> bool:
        with self._lock:
            return self._draining

    def inflight(self) -> int:
        with self._lock:
            return self._inflight_total

    def note_dropped(self, n: int) -> None:
        with self._lock:
            self._stats["dropped_streams"] += n

    def snapshot(self) -> dict:
        with self._lock:
            return {
                **self._stats,
                "inflight": self._inflight_total,
                "inflight_by_deployment": dict(self._inflight_dep),
                "inflight_by_tenant": dict(self._inflight_tenant),
                "shed_by_tenant": dict(self._shed_by_tenant),
                "tenant_caps": dict(self._tenant_caps),
                "budget": self.budget,
                "draining": self._draining,
            }


class RouteTable:
    """Route-prefix -> ingress DeploymentHandle map, read from the
    controller (in this process) at each lookup; handles are kept while
    their route names the same ingress."""

    def __init__(self, controller):
        self._controller = controller
        self._routes: dict = {}
        self._dep_caps: dict = {}  # ingress deployment -> max_queued override
        self._routes_lock = threading.Lock()

    def _refresh(self):
        from ray_tpu_torch.serve.handle import DeploymentHandle

        routes = self._controller.list_routes()
        with self._routes_lock:
            self._routes = {
                prefix: (
                    self._routes[prefix]
                    if prefix in self._routes
                    and self._routes[prefix].deployment_name == info["ingress"]
                    else DeploymentHandle(info["ingress"])
                )
                for prefix, info in routes.items()
            }
            self._dep_caps = {
                info["ingress"]: info.get("max_queued") for info in routes.values()
            }

    def dep_cap(self, deployment_name: str):
        """Per-deployment admission-queue override (None = the config's)."""
        with self._routes_lock:
            return self._dep_caps.get(deployment_name)

    def table(self) -> dict:
        self._refresh()
        with self._routes_lock:
            return {p: h.deployment_name for p, h in self._routes.items()}

    def match(self, path: str):
        self._refresh()
        with self._routes_lock:
            routes = dict(self._routes)
        best = None
        for prefix, handle in routes.items():
            norm = prefix.rstrip("/") or ""
            if path == norm or path.startswith(norm + "/") or prefix == "/":
                if best is None or len(prefix) > len(best[0]):
                    best = (prefix, handle)
        if best is None:
            return None, path
        rest = path[len(best[0].rstrip("/")):] or "/"
        return best[1], rest


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    # the listen backlog: at socketserver's default of 5, a burst of
    # connections overflows it and the kernel drops their SYNs, which the
    # clients resend a second later (asyncio's start_server, the JAX
    # package's default data plane, listens with 100)
    request_queue_size = 128


class ProxyServer:
    """The HTTP proxy: a ``ThreadingHTTPServer`` on ``host:port`` (0: any
    free port) over the controller's route table, with its admission
    controller. ``/-/healthz``, ``/-/routes`` and ``/-/stats`` answer
    directly; every other path goes to its route's ingress deployment
    through a streaming handle call."""

    def __init__(self, controller, host: str = "127.0.0.1", port: int = 8000,
                 config: Optional[ProxyConfig] = None):
        self.config = config or ProxyConfig()
        self._rt = RouteTable(controller)
        self._admission = AdmissionController(self.config)
        self._host = host
        proxy = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def _handle(self):
                try:
                    parsed = urlparse(self.path)
                    if parsed.path == "/-/healthz":
                        if proxy._admission.draining:
                            return self._respond(503, b"draining", "text/plain")
                        return self._respond(200, b"ok", "text/plain")
                    if parsed.path == "/-/routes":
                        return self._respond(
                            200, json.dumps(proxy._rt.table()).encode(), "application/json")
                    if parsed.path == "/-/stats":
                        return self._respond(
                            200, json.dumps(proxy.get_stats()).encode(), "application/json")
                    handle, rest = proxy._rt.match(parsed.path)
                    if handle is None:
                        return self._respond(404, b"no route", "text/plain")
                    # read the body BEFORE any admission decision: a shed
                    # reply with the body unread would desync keep-alive
                    length = int(self.headers.get("Content-Length") or 0)
                    body = self.rfile.read(length) if length else b""
                    ticket = proxy._admit(handle.deployment_name, dict(self.headers.items()))
                    if ticket is None:
                        retry = proxy._admission.retry_after_s
                        return self._respond(
                            429, b"ingress overloaded; retry later", "text/plain",
                            extra_headers=[("Retry-After", f"{retry:g}")],
                        )
                    try:
                        req = Request(
                            self.command,
                            rest,
                            {k: v[-1] for k, v in parse_qs(parsed.query).items()},
                            dict(self.headers.items()),
                            body,
                            raw_query=parsed.query,
                        )
                        # every request rides the streaming path; a unary
                        # handler arrives as one non-StreamStart chunk and
                        # goes out as one buffered JSON (or raw) body
                        chunks = handle.options(stream=True).remote(req)
                        chunks.unwrap_raw = False
                        try:
                            first = chunks.next(timeout_s=120)
                        except StopIteration:
                            first = None
                        if chunks.stream_start is not None:
                            return self._stream_body(chunks.stream_start, first, chunks)
                        from ray_tpu_torch.serve.streaming import RawBody

                        if isinstance(first, RawBody):
                            first = first.tobytes()
                        if isinstance(first, bytes):
                            proxy._admission.count_body(len(first))
                            return self._respond(200, first, "application/octet-stream")
                        out = json.dumps(first).encode()
                        proxy._admission.count_body(len(out))
                        return self._respond(200, out, "application/json")
                    finally:
                        proxy._admission.release(ticket)
                except Exception:
                    return self._respond(500, traceback.format_exc().encode(), "text/plain")

            def _respond(self, code: int, body, ctype: str, extra_headers=None):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for name, value in extra_headers or []:
                    n, v = _clean_header(name, value)
                    self.send_header(n, v)
                self.end_headers()
                self.wfile.write(body)

            def _stream_body(self, start, first, chunks):
                """Chunked transfer-encoding: each deployment chunk hits the
                socket as it arrives — SSE works end to end. A mid-stream
                handler error TRUNCATES the chunked body (no terminator)
                and drops the connection: the head is on the wire, so a
                trailing 500 would corrupt keep-alive framing."""
                status = getattr(start, "status", 200)
                self.send_response(status)
                if not _bodiless(status):
                    _, ctype = _clean_header("", start.content_type)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Transfer-Encoding", "chunked")
                    self.send_header("Cache-Control", "no-cache")
                for name, value in getattr(start, "headers", None) or []:
                    n, v = _clean_header(name, value)
                    self.send_header(n, v)
                self.end_headers()
                if _bodiless(status):
                    # drain the stream, write no body/framing
                    try:
                        while True:
                            chunks.next(timeout_s=120)
                    except StopIteration:
                        pass
                    except Exception:  # noqa: BLE001
                        self.close_connection = True
                    return
                from ray_tpu_torch.serve.streaming import RawBody

                try:
                    item = first
                    while True:
                        if item is not None:
                            data = (item.tobytes() if isinstance(item, RawBody)
                                    else _encode_chunk(item))
                            if data:
                                self.wfile.write(f"{len(data):x}\r\n".encode())
                                self.wfile.write(data)
                                self.wfile.write(b"\r\n")
                                self.wfile.flush()
                                proxy._admission.count_body(len(data))
                        try:
                            # per-chunk deadline: a stalled replica must not
                            # pin this handler thread forever
                            item = chunks.next(timeout_s=120)
                        except StopIteration:
                            break
                    self.wfile.write(b"0\r\n\r\n")
                    self.wfile.flush()
                except Exception:
                    chunks.cancel()
                    self.close_connection = True

            do_GET = do_POST = do_PUT = do_DELETE = _handle

        self._server = _Server((host, port), Handler)
        self._port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True, name="serve-http"
        )
        self._thread.start()

    # -- admission ----------------------------------------------------------

    def _admit(self, deployment_name: str, headers: dict):
        """Admission decision for one request (ticket or None = shed)."""
        tenant = _hget(headers, TENANT_HEADER, "") or DEFAULT_TENANT
        return self._admission.try_admit(
            deployment_name, tenant, dep_cap=self._rt.dep_cap(deployment_name)
        )

    def set_tenant_policies(self, policies: list) -> None:
        """Tenant weights for per-tenant admission caps:
        ``[{"tenant": name, "weight": w}, ...]``."""
        self._admission.set_tenant_policies(policies)

    # -- stats / control ----------------------------------------------------

    def get_stats(self) -> dict:
        """Admission and data-plane counters (also served at ``/-/stats``)."""
        snap = self._admission.snapshot()
        snap["port"] = self._port
        return snap

    @property
    def port(self) -> int:
        return self._port

    def shutdown(self, drain_s: Optional[float] = None) -> bool:
        """Drain, then stop. New requests shed at once (and /-/healthz
        flips 503); in-flight requests get ``serve_drain_window_s`` to
        finish before the listener closes — those still open at the
        deadline are cut and counted (``dropped_streams``), never silently."""
        window = self.config.serve_drain_window_s if drain_s is None else drain_s
        self._admission.begin_drain()
        deadline = time.monotonic() + max(0.0, window)
        while time.monotonic() < deadline and self._admission.inflight() > 0:
            time.sleep(0.05)
        dropped = self._admission.inflight()
        if dropped:
            self._admission.note_dropped(dropped)
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=2.0)
        global _proxy
        with _proxy_lock:
            if _proxy is self:
                _proxy = None
        return True


_proxy: Optional[ProxyServer] = None
_proxy_lock = threading.Lock()


def start_proxy(port: int = 8000, *, host: str = "127.0.0.1",
                config: Optional[ProxyConfig] = None):
    """Ensure this driver's proxy is running; returns (proxy, port). The
    controller must be up (``serve.run`` first)."""
    from ray_tpu_torch.serve import api

    global _proxy
    with _proxy_lock:
        if _proxy is None:
            _proxy = ProxyServer(api._get_controller(), host=host, port=port, config=config)
        return _proxy, _proxy.port


def _stop_proxy() -> None:
    with _proxy_lock:
        proxy = _proxy
    if proxy is not None:
        proxy.shutdown()
