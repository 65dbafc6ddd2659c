"""A bounded queue hosted on a CPU ``ProcessActor``: the port's counterpart
of ``ray_tpu/util/queue.py``, with its operations (``put`` / ``get`` with
block and timeout, ``Full`` / ``Empty``, the ``*_nowait`` and batch
operations, ``qsize``, ``empty``, ``shutdown``).

The host runs up to 8 calls at once (``actor_options["max_concurrency"]``)
and leases nothing unless ``actor_options`` names ``num_cpus``. A ``Queue``
passed to another port process (a call's argument) pickles as its host's
id and the address of the process that created it: its operations there
go over that process's link (``_private/driver_link.py``), which relays
them to the host's pipe. The items stay in the host; no copy travels with
the ``Queue``.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Optional

from ray_tpu_torch._private import driver_link
from ray_tpu_torch._private.process_actor import ProcessActor, get
from ray_tpu_torch._private.spawn_env import assign_cards

_OPTIONS = ("name", "max_concurrency", "num_cpus", "scheduling_strategy")


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self._q: deque = deque()

    def put_nowait(self, item) -> bool:
        if self.maxsize > 0 and len(self._q) >= self.maxsize:
            return False
        self._q.append(item)
        return True

    def put_nowait_batch(self, items: list) -> int:
        n = 0
        for it in items:
            if not self.put_nowait(it):
                break
            n += 1
        return n

    def get_nowait(self):
        if not self._q:
            return (False, None)
        return (True, self._q.popleft())

    def get_nowait_batch(self, n: int) -> list:
        out = []
        while self._q and len(out) < n:
            out.append(self._q.popleft())
        return out

    def qsize(self) -> int:
        return len(self._q)


class Queue:
    def __init__(self, maxsize: int = 0, actor_options: Optional[dict] = None):
        opts = dict(actor_options or {})
        unknown = set(opts) - set(_OPTIONS)
        if unknown:
            raise ValueError(f"a Queue's host takes {_OPTIONS}, not {sorted(unknown)}")
        lease = None
        if opts.get("num_cpus"):
            lease, = assign_cards(1, 0, "queue actor", cpu=float(opts["num_cpus"]))
        self.maxsize = maxsize
        self.actor = ProcessActor(_QueueActor, (maxsize,), lease=lease,
                                  name=opts.get("name", "Queue"),
                                  max_concurrency=opts.get("max_concurrency", 8),
                                  scheduling_strategy=opts.get("scheduling_strategy"))
        self.actor_id = self.actor.actor_id
        self._address: Optional[str] = None  # a copy in another process: its creator's

    def _call(self, method: str, *args):
        if self.actor is not None:
            return get(self.actor.call(method, *args), timeout=None)
        return driver_link.call("actor_call", self.actor_id, method, args, {},
                                address=self._address)

    def put(self, item, block: bool = True, timeout: Optional[float] = None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self._call("put_nowait", item):
                return
            if not block:
                raise Full()
            if deadline is not None and time.monotonic() > deadline:
                raise Full()
            time.sleep(0.01)

    def put_nowait(self, item) -> None:
        self.put(item, block=False)

    def get(self, block: bool = True, timeout: Optional[float] = None):
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            ok, item = self._call("get_nowait")
            if ok:
                return item
            if not block:
                raise Empty()
            if deadline is not None and time.monotonic() > deadline:
                raise Empty()
            time.sleep(0.01)

    def get_nowait(self):
        return self.get(block=False)

    def put_nowait_batch(self, items: list) -> None:
        n = self._call("put_nowait_batch", list(items))
        if n < len(items):
            raise Full(f"only {n}/{len(items)} items fit")

    def get_nowait_batch(self, n: int) -> list:
        return self._call("get_nowait_batch", n)

    def qsize(self) -> int:
        return self._call("qsize")

    def empty(self) -> bool:
        return self.qsize() == 0

    def shutdown(self) -> None:
        try:
            if self.actor is not None:
                self.actor.kill()
            else:
                driver_link.call("actor_kill", self.actor_id, address=self._address)
        except Exception:  # noqa: BLE001 — already gone
            pass

    def __reduce__(self):
        address = self._address or driver_link.ensure_server().address
        return (_rebuild_queue, (address, self.actor_id, self.maxsize))


def _rebuild_queue(address: str, actor_id: str, maxsize: int) -> Queue:
    q = Queue.__new__(Queue)
    q.actor, q.actor_id, q.maxsize = None, actor_id, maxsize
    q._address = address
    return q
