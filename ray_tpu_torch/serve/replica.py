"""Replica: hosts one copy of a deployment's user callable; a port of
``ray_tpu/serve/replica.py`` (``ReplicaActor``).

Reference: ``python/ray/serve/_private/replica.py:858`` (``Replica`` +
``UserCallableWrapper``): construct the user class, count ongoing
requests, expose health checks and metrics. A replica is a
``ProcessActor`` of its own (``controller.py:_start_replica``) running
``max_ongoing_requests + 2`` calls at once, so concurrent requests share
it (and ``@serve.batch`` sees them together) while a health check or a
metrics read never waits behind a full replica.

Its target arrives as the bytes of a reference to it (``api.target_ref``),
its arguments as their standard pickle: the constructor here unpickles
both, so a target that does not import fails the replica's construction.
``router`` is the driver's router address and key, through which a
handle built here (composition) sends its calls (``handle.py``);
``ledger`` the driver's card ledger, this process's default from the
start, so that processes it spawns (a gang's ranks) lease from it.
"""

from __future__ import annotations

import inspect
import os
import pickle
import threading
import time
from typing import Optional


def _drive_async_gen(agen):
    """Adapt an async-generator handler to a sync generator on a private
    event loop (streamed chunks still go out one by one)."""
    import asyncio

    loop = asyncio.new_event_loop()
    try:
        while True:
            try:
                yield loop.run_until_complete(agen.__anext__())
            except StopAsyncIteration:
                return
    finally:
        loop.close()


class ReplicaActor:
    def __init__(
        self,
        serialized_target: bytes,
        init_args_payload: bytes,
        deployment_name: str,
        replica_id: str,
        router: Optional[tuple] = None,
        ledger=None,
    ):
        t0 = time.time()
        from ray_tpu_torch._private.cards import set_default_ledger
        from ray_tpu_torch.serve import handle

        handle._ROUTER_ADDRESS = router
        if ledger is not None:
            set_default_ledger(ledger)
        target = pickle.loads(serialized_target).resolve()
        args, kwargs = pickle.loads(init_args_payload)
        args, kwargs = handle._resolve_handle_markers(args, kwargs)
        self.deployment_name = deployment_name
        self.replica_id = replica_id
        self._ongoing = 0
        self._total = 0
        self._lock = threading.Lock()
        if inspect.isclass(target):
            self._callable = target(*args, **kwargs)
        else:
            # function deployment: the function IS the handler
            self._callable = target
        self._user_health_check = getattr(self._callable, "check_health", None)
        # reconfigure(user_config) support (reference: user_config rollouts)
        self._user_config = None
        self._info = {"pid": os.getpid(), "constructed_at": time.time(),
                      "init_s": time.time() - t0}

    # -- data plane ---------------------------------------------------------

    def _resolve_and_call(self, method: str, args, kwargs):
        """Shared dispatch: resolve the handler, call it, drive coroutines
        on a per-request loop (requests already parallelize across the
        replica's concurrency threads)."""
        if inspect.isfunction(self._callable) or inspect.isbuiltin(
            self._callable
        ):
            fn = self._callable  # function deployment: one entry point
        else:
            fn = getattr(self._callable, method)
        result = fn(*args, **kwargs)
        if inspect.iscoroutine(result):
            import asyncio

            result = asyncio.run(result)
        return result

    def handle_request(self, method: str, *args, **kwargs):
        with self._lock:
            self._ongoing += 1
            self._total += 1
        try:
            return self._resolve_and_call(method, args, kwargs)
        finally:
            with self._lock:
                self._ongoing -= 1

    def handle_request_streaming(self, method: str, *args, **kwargs):
        """Generator method (called with ``ProcessActor.call_stream``):
        yields the handler's chunks as they are produced. A handler that
        returns a generator streams; anything else yields once (the proxy
        falls back to a buffered JSON response for single-item streams that
        don't start with a StreamStart)."""
        from ray_tpu_torch.serve.streaming import StreamStart

        with self._lock:
            self._ongoing += 1
            self._total += 1
        result = None
        try:
            result = self._resolve_and_call(method, args, kwargs)
            if hasattr(result, "__anext__"):
                result = _drive_async_gen(result)
            if inspect.isgenerator(result):
                first = True
                for item in result:
                    if first and not isinstance(item, StreamStart):
                        if isinstance(item, str):
                            ct = "text/event-stream"
                        elif isinstance(item, (bytes, bytearray, memoryview)):
                            ct = "application/octet-stream"
                        else:
                            ct = "application/x-ndjson"
                        yield StreamStart(ct)
                    first = False
                    yield self._picklable(item)
                if first:
                    yield StreamStart()
            else:
                yield self._picklable(result)
        finally:
            # a stream cancelled mid-way closes this generator: close the
            # handler's too, at once, so its own cleanup runs (an ASGI
            # app's request sees its disconnect)
            if inspect.isgenerator(result):
                result.close()
            with self._lock:
                self._ongoing -= 1

    @staticmethod
    def _picklable(item):
        """A memoryview does not pickle: it goes as its bytes."""
        return item.tobytes() if isinstance(item, memoryview) else item

    # -- control plane ------------------------------------------------------

    def reconfigure(self, user_config):
        self._user_config = user_config
        if hasattr(self._callable, "reconfigure"):
            self._callable.reconfigure(user_config)
        return True

    def check_health(self) -> bool:
        if self._user_health_check is not None:
            self._user_health_check()  # raises if unhealthy
        return True

    def get_metrics(self) -> dict:
        with self._lock:
            return {
                "ongoing": self._ongoing,
                "total": self._total,
                "ts": time.time(),
            }

    def replica_info(self) -> dict:
        """This process's pid, when its constructor returned, and the
        seconds it took (the user callable's construction included)."""
        return dict(self._info)

    def prepare_shutdown(self, grace_s: float = 20.0) -> bool:
        """Graceful drain hook (reference: graceful_shutdown_timeout_s):
        wait, up to ``grace_s``, until no request is ongoing."""
        deadline = time.time() + grace_s
        while time.time() < deadline:
            with self._lock:
                if self._ongoing == 0:
                    break
            time.sleep(0.05)
        return True
