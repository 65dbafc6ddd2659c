"""@serve.batch — dynamic request batching: the port's own copy of
``ray_tpu/serve/batching.py``.

Reference: ``python/ray/serve/batching.py`` — concurrent calls to the
decorated method are queued; a batch fires when ``max_batch_size`` requests
are waiting or ``batch_wait_timeout_s`` elapses. The wrapped function
receives a LIST of inputs and must return a list of outputs, positionally.

Calls reach a batch because a replica runs ``max_ongoing_requests + 2``
calls at once (``ProcessActor(max_concurrency=...)``).
"""

from __future__ import annotations

import functools
import os
import threading
import time
from typing import Any, Callable, Optional

_WAIT_DEADLINE_S = float(os.environ.get("RAY_TPU_TORCH_BATCH_WAIT_S", "600"))


class _BatchQueue:
    def __init__(self, fn: Callable, max_batch_size: int, timeout_s: float):
        self.fn = fn
        self.max_batch_size = max_batch_size
        self.timeout_s = timeout_s
        self._items: list[tuple[Any, "_Waiter"]] = []
        self._lock = threading.Lock()
        self._flusher: Optional[threading.Timer] = None

    def submit(self, instance, arg) -> Any:
        waiter = _Waiter()
        fire: Optional[list] = None
        with self._lock:
            self._items.append((arg, waiter))
            if len(self._items) >= self.max_batch_size:
                fire = self._take()
            elif self._flusher is None:
                self._flusher = threading.Timer(
                    self.timeout_s, self._timeout_flush, args=(instance,)
                )
                self._flusher.daemon = True
                self._flusher.start()
        if fire:
            self._run(instance, fire)
        return waiter.wait()

    def _take(self) -> list:
        items, self._items = self._items, []
        if self._flusher is not None:
            self._flusher.cancel()
            self._flusher = None
        return items

    def _timeout_flush(self, instance):
        with self._lock:
            self._flusher = None
            items = self._take()
        if items:
            self._run(instance, items)

    def _run(self, instance, items: list):
        args = [a for a, _ in items]
        try:
            outs = self.fn(instance, args) if instance is not None else self.fn(args)
            if len(outs) != len(args):
                raise ValueError(
                    f"batched function returned {len(outs)} results for "
                    f"{len(args)} inputs"
                )
            for (_, w), out in zip(items, outs):
                w.set(out)
        except BaseException as e:  # noqa: BLE001 — deliver to every waiter
            for _, w in items:
                w.set_error(e)


class _Waiter:
    def __init__(self):
        self._ev = threading.Event()
        self._value = None
        self._error: Optional[BaseException] = None

    def set(self, v):
        self._value = v
        self._ev.set()

    def set_error(self, e):
        self._error = e
        self._ev.set()

    def wait(self, deadline_s: Optional[float] = None):
        # bounded overall wait: _run delivers a result or error to every
        # waiter, but if the runner thread is killed at teardown before
        # delivering, an untimed wait here was an unrecoverable hang — now
        # it surfaces. Default is deliberately generous (first call's
        # engine build can run tens of seconds); RAY_TPU_TORCH_BATCH_WAIT_S
        # overrides for tighter SLOs.
        if deadline_s is None:
            deadline_s = _WAIT_DEADLINE_S
        deadline = time.monotonic() + deadline_s
        while not self._ev.wait(0.5):
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"batched call not completed within {deadline_s:.0f}s "
                    f"(batch runner died before delivering?)"
                )
        if self._error is not None:
            raise self._error
        return self._value


# Registry lives at module level and is resolved by import inside the
# wrappers: decorated callables must stay picklable (no locks/queues
# in closures), and each process rebuilds its own queues on first call.
_REGISTRY: dict[tuple, _BatchQueue] = {}
_REGISTRY_LOCK = threading.Lock()


def _get_queue(key: tuple, fn, max_batch_size: int, timeout_s: float) -> _BatchQueue:
    with _REGISTRY_LOCK:
        q = _REGISTRY.get(key)
        if q is None:
            q = _BatchQueue(fn, max_batch_size, timeout_s)
            _REGISTRY[key] = q
        return q


def batch(
    _fn: Optional[Callable] = None,
    *,
    max_batch_size: int = 8,
    batch_wait_timeout_s: float = 0.01,
):
    """Decorator for methods (or functions) taking a single request arg."""

    def wrap(fn: Callable):
        qual = getattr(fn, "__qualname__", repr(fn))

        @functools.wraps(fn)
        def method(self, arg):
            from ray_tpu_torch.serve import batching as _b

            q = _b._get_queue(
                (id(self), qual), fn, max_batch_size, batch_wait_timeout_s
            )
            return q.submit(self, arg)

        @functools.wraps(fn)
        def function(arg):
            from ray_tpu_torch.serve import batching as _b

            q = _b._get_queue((0, qual), fn, max_batch_size, batch_wait_timeout_s)
            return q.submit(None, arg)

        import inspect

        params = list(inspect.signature(fn).parameters)
        return method if params and params[0] == "self" else function

    if _fn is not None:
        return wrap(_fn)
    return wrap
