"""ActorPool over ``ProcessActor``s: the port's counterpart of
``ray_tpu/util/actor_pool.py``, with its semantics. ``fn(actor, value)``
returns the ``PendingResult`` of a call (``actor.call(...)``); results are
read with ``process_actor.get`` / ``wait``.

    pool = ActorPool([ProcessActor(Sq), ProcessActor(Sq)])
    list(pool.map(lambda a, v: a.call("sq", v), range(6)))  # submission order
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Iterable, Optional

from ray_tpu_torch._private.process_actor import get, wait


class ActorPool:
    """Round-robins work over a fixed set of actors, keeping each busy."""

    def __init__(self, actors: list):
        self._idle = deque(actors)
        self._future_to_actor: dict = {}
        self._pending: deque = deque()  # (fn, value) waiting for an actor
        self._inflight: list = []  # results in submission order

    def submit(self, fn: Callable, value: Any) -> None:
        """fn(actor, value) -> PendingResult."""
        if self._idle:
            actor = self._idle.popleft()
            h = fn(actor, value)
            self._future_to_actor[h] = actor
            self._inflight.append(h)
        else:
            self._pending.append((fn, value))

    def _reclaim(self, h) -> None:
        actor = self._future_to_actor.pop(h, None)
        if actor is None:
            return
        if self._pending:
            fn, value = self._pending.popleft()
            new = fn(actor, value)
            self._future_to_actor[new] = actor
            self._inflight.append(new)
        else:
            self._idle.append(actor)

    def get_next(self, timeout: Optional[float] = None) -> Any:
        """Next result in SUBMISSION order. On timeout (``TimeoutError``)
        the call stays in the pool, so it can be retried; a failed call is
        consumed and its actor goes back to the pool."""
        if not self._inflight:
            raise StopIteration("no pending results")
        h = self._inflight[0]
        try:
            value = get(h, timeout=timeout)
        except TimeoutError:
            raise  # retained: the call is retryable
        except Exception:
            self._inflight.pop(0)
            self._reclaim(h)
            raise
        self._inflight.pop(0)
        self._reclaim(h)
        return value

    def get_next_unordered(self, timeout: Optional[float] = None) -> Any:
        """Next COMPLETED result, any order."""
        if not self._inflight:
            raise StopIteration("no pending results")
        done, _ = wait(list(self._inflight), num_returns=1, timeout=timeout)
        if not done:
            raise TimeoutError("no result within timeout")
        h = done[0]
        self._inflight.remove(h)
        try:
            return get(h)
        finally:
            self._reclaim(h)

    def has_next(self) -> bool:
        return bool(self._inflight)

    def has_free(self) -> bool:
        return bool(self._idle) and not self._pending

    def map(self, fn: Callable, values: Iterable) -> Iterable:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable, values: Iterable) -> Iterable:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()
