"""ASGI ingress: mount an ASGI app (FastAPI, Starlette, or a plain ASGI
callable) as a deployment; the port's own copy of ``ray_tpu/serve/asgi.py``.

Reference: ``serve.ingress(fastapi_app)`` (``python/ray/serve/api.py:174``)
and the uvicorn/ASGI proxy (``python/ray/serve/_private/proxy.py:697``).
The proxy's data plane stays the threaded HTTP server (``proxy.py``); the
ASGI protocol runs inside the replica process on a private event loop
(``_ASGIRunner``), and the response goes back as a streamed call
(``ProcessActor.call_stream``): a ``StreamStart(status, headers)`` carrying
the response head, then the body's bytes as the app sends them. One code
path serves SSE, streaming responses and plain JSON endpoints.

Usage::

    app = FastAPI()

    @app.get("/items/{item_id}")
    def get_item(item_id: int): ...

    @serve.deployment
    @serve.ingress(app)
    class Api:
        pass

    serve.run(Api.bind(), route_prefix="/api")

The app object never travels: the decorated class goes to its replicas by
reference (``deployment.py:TargetRef``), as every deployment does, with the
user class's module and qualified name, so each replica imports that module,
which builds the app there again. A decorated class defined inside a
function cannot be imported by name, and ``serve.run`` raises ``TypeError``
for it. The lifespan's startup is held open for the replica's life; a
``lifespan.startup.failed`` fails the replica's construction, so the
deployment stays short with the failure in ``status()``'s message. A
response stream that its consumer drops (a client that went away) closes
the replica's generator, which sets the request's ``http.disconnect``.
"""

from __future__ import annotations

import asyncio
import logging
import queue
import threading
from typing import Any

from ray_tpu_torch.serve.streaming import StreamStart

logger = logging.getLogger(__name__)

_DONE = object()
# how long the replica waits for the app's lifespan startup
LIFESPAN_STARTUP_S = 15.0
# a response frame's deadline: the consumer's wait for the next one, and
# the producer's for room in the bounded handoff
FRAME_TIMEOUT_S = 600.0
PRODUCER_STALL_S = 300.0


def _build_scope(request, state=None) -> dict:
    headers = [
        (k.lower().encode(), str(v).encode())
        for k, v in (request.headers or {}).items()
    ]
    path = request.path or "/"
    if not path.startswith("/"):
        path = "/" + path
    return {
        # per the ASGI lifespan-state extension: each request sees a shallow
        # copy of the state dict the lifespan startup populated
        "state": dict(state) if state is not None else {},
        "type": "http",
        "asgi": {"version": "3.0", "spec_version": "2.3"},
        "http_version": "1.1",
        "method": request.method,
        "scheme": "http",
        "path": path,
        "raw_path": path.encode(),
        "query_string": (getattr(request, "raw_query", "") or "").encode(),
        "root_path": "",
        "headers": headers,
        "client": ("127.0.0.1", 0),
        "server": ("127.0.0.1", 80),
    }


async def _run_asgi(app, request, out: "queue.Queue", state=None, box=None) -> None:
    """Drive one request through the ASGI app; response frames go to
    ``out`` (thread-safe: the consumer is the replica's streaming
    generator on another thread). ``box`` (dict) exposes the request's
    ``disconnected`` event to the consumer, so a dropped stream reaches
    the app at once."""
    body_sent = False
    disconnected = asyncio.Event()
    if box is not None:
        box["disconnected"] = disconnected

    async def receive():
        nonlocal body_sent
        if body_sent:
            # block until the client is gone: Starlette's
            # listen_for_disconnect loops on receive() while a
            # StreamingResponse is in flight, and an immediate
            # http.disconnect here would cancel the stream at its first chunk
            await disconnected.wait()
            return {"type": "http.disconnect"}
        body_sent = True
        return {
            "type": "http.request",
            "body": request.body or b"",
            "more_body": False,
        }

    started = False

    async def put(item):
        # bounded handoff: a fast producer streaming to a slow client must
        # not buffer the whole response in the replica (the consumer is a
        # generator on another thread, so poll rather than stall the
        # shared event loop); the deadline frees this task if the consumer
        # abandoned the stream
        loop = asyncio.get_running_loop()
        deadline = loop.time() + PRODUCER_STALL_S
        while True:
            try:
                out.put_nowait(item)
                return
            except queue.Full:
                if loop.time() > deadline:
                    disconnected.set()  # unblock listen_for_disconnect
                    raise RuntimeError("response consumer stalled or gone")
                await asyncio.sleep(0.02)

    async def send(message):
        nonlocal started
        if message["type"] == "http.response.start":
            started = True
            ctype = "application/octet-stream"
            extra = []
            for name, value in message.get("headers") or []:
                n = name.decode().lower()
                v = value.decode()
                if n == "content-type":
                    ctype = v
                elif n not in ("content-length", "transfer-encoding"):
                    extra.append((n, v))
            await put(StreamStart(content_type=ctype, status=int(message["status"]),
                                  headers=extra))
        elif message["type"] == "http.response.body":
            body = message.get("body") or b""
            if body:
                await put(body)

    try:
        await app(_build_scope(request, state), receive, send)
        if not started:
            await put(StreamStart(content_type="text/plain", status=500))
            await put(b"ASGI app returned without a response")
    except BaseException as e:  # noqa: BLE001 — surface as 500, don't hang
        try:
            if not started:
                await put(StreamStart(content_type="text/plain", status=500))
            await put(f"ASGI app error: {e!r}".encode())
        except RuntimeError:
            pass  # consumer gone: nothing to tell
    finally:
        disconnected.set()  # release a parked listen_for_disconnect task
        try:
            await put(_DONE)
        except RuntimeError:
            pass  # consumer gone; its get() deadline ends the generator


class _ASGIRunner:
    """The app's private event loop, on a thread of the replica process,
    with its lifespan held open."""

    def __init__(self, app):
        self.app = app
        self.loop = asyncio.new_event_loop()
        # populated by the app's lifespan startup (ASGI lifespan-state
        # extension); each request scope gets a shallow copy
        self.state: dict = {}
        threading.Thread(target=self._run, daemon=True, name="asgi-loop").start()
        self._lifespan()

    def _run(self):
        asyncio.set_event_loop(self.loop)
        self.loop.run_forever()

    def _lifespan(self) -> None:
        """Run the app's lifespan startup, then keep the lifespan open for
        the replica's life: a Starlette/FastAPI lifespan context tears down
        when it receives shutdown, so receive() blocks after startup rather
        than returning a fresh event. Apps without lifespan support are
        fine; a ``lifespan.startup.failed`` raises here."""
        started = threading.Event()
        failure: list[str] = []

        async def drive():
            scope = {"type": "lifespan", "asgi": {"version": "3.0"}, "state": self.state}
            sent_startup = False
            forever = asyncio.Event()

            async def receive():
                nonlocal sent_startup
                if not sent_startup:
                    sent_startup = True
                    return {"type": "lifespan.startup"}
                # shutdown would arrive only at the replica's teardown (the
                # loop's thread is a daemon and ends with the process)
                await forever.wait()
                return {"type": "lifespan.shutdown"}

            async def send(message):
                if message["type"] == "lifespan.startup.failed":
                    failure.append(message.get("message", ""))
                if message["type"].startswith("lifespan.startup"):
                    started.set()

            try:
                await self.app(scope, receive, send)
            except BaseException:  # noqa: BLE001
                # apps without lifespan support raise on the unknown scope
                # type (fine); a real startup crash must not be silent
                logger.warning("ASGI lifespan exited with an exception (harmless for apps "
                               "without lifespan support)", exc_info=True)
            finally:
                started.set()

        asyncio.run_coroutine_threadsafe(drive(), self.loop)
        started.wait(timeout=LIFESPAN_STARTUP_S)
        if failure:
            # the ASGI spec: no serving after startup.failed; raising fails
            # the replica's construction, which the controller reports
            raise RuntimeError(f"ASGI lifespan startup failed: {failure[0]}")

    def stream(self, request):
        """Generator of the response's frames (``StreamStart``, then bytes)."""
        out: "queue.Queue" = queue.Queue(maxsize=64)
        box: dict = {}
        asyncio.run_coroutine_threadsafe(_run_asgi(self.app, request, out, self.state, box),
                                         self.loop)
        try:
            while True:
                try:
                    item = out.get(timeout=FRAME_TIMEOUT_S)
                except queue.Empty:
                    return  # the producer died without a terminator
                if item is _DONE:
                    return
                yield item
        finally:
            # closed (a dropped stream) or completed: set the request's
            # disconnect so a listen_for_disconnect task, and an app still
            # streaming, end at once rather than at the producer's deadline
            ev = box.get("disconnected")
            if ev is not None:
                self.loop.call_soon_threadsafe(ev.set)


def ingress(app) -> Any:
    """Class decorator mounting ``app`` (any ASGI callable) as the
    deployment's HTTP handler. The decorated class's own ``__init__`` still
    runs (replica state, model loading, handles); HTTP requests go to the
    app, and the class's other methods stay callable through a handle."""

    def decorator(cls):
        class ASGIIngress(cls):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                self.__asgi = _ASGIRunner(app)

            def __call__(self, request):
                return self.__asgi.stream(request)

        # the replica finds the class under the user class's name
        ASGIIngress.__name__ = cls.__name__
        ASGIIngress.__qualname__ = getattr(cls, "__qualname__", cls.__name__)
        ASGIIngress.__module__ = cls.__module__
        ASGIIngress.__doc__ = cls.__doc__
        return ASGIIngress

    return decorator
