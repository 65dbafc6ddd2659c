"""The driver's record of the port's live processes, its placement groups and
its event channels.

The port's counterpart of the runtime controller's actor, worker and
placement-group tables and of its pubsub bus (``ray_tpu/_private/
controller.py``: ``publish`` / ``pubsub_poll``, the ``"actors"`` and
``"nodes"`` channels, ``task_events``), narrowed to the processes this
process spawns:

- every ``ProcessActor`` (``_private/process_actor.py``): its id, name,
  class, pid, state (``PENDING`` while its constructor runs, then
  ``ALIVE``, then ``DEAD``), the cards and CPU slots it runs under, and its
  placement group and bundle. The actor writes here when it starts, when
  its constructor returns, when its process is seen gone and when it is
  killed; each change of state goes out on the ``"actors"`` channel;
- every rank of a ``WorkerGroup`` (``train/_internal/worker_group.py``),
  which registers its ranks itself (kind ``"rank"``);
- every placement group (``util/placement_group.py``);
- each call's ``DISPATCHED`` and ``FINISHED`` / ``FAILED`` events, the
  state API's ``list_tasks``, ``summarize_tasks`` and ``timeline``.

It holds no strong reference to an actor, so a dropped handle is still
collected. The host is one node, its id made once a driver
(``node_id``); the ``"nodes"`` channel has it ``added`` at the start. A
port process that spawns processes of its own keeps its own record of
them: the state API read in the driver lists what the driver spawned.
"""

from __future__ import annotations

import collections
import os
import threading
import time
import uuid
import weakref
from typing import Optional

PUBSUB_TAIL = 1000  # events a channel keeps for late subscribers (the reference's)
TASK_EVENTS = 10000  # call events kept
DEAD_KEPT = 1000  # records of ended processes kept

_NODE_ENV = "RAY_TPU_TORCH_NODE_ID"


class Bus:
    """Ordered channels with a bounded tail each, and long-poll readers."""

    def __init__(self):
        self._cv = threading.Condition()
        self._events: dict = collections.defaultdict(
            lambda: collections.deque(maxlen=PUBSUB_TAIL))
        self._seq: dict = collections.defaultdict(int)

    def publish(self, channel: str, event: dict) -> None:
        with self._cv:
            self._seq[channel] += 1
            self._events[channel].append((self._seq[channel], {**event, "t": time.time()}))
            self._cv.notify_all()

    def poll(self, channel: str, after_seq: int, timeout: float) -> tuple:
        """Block until ``channel`` has events newer than ``after_seq`` or
        ``timeout`` passes; returns (latest seq, [events])."""
        deadline = time.monotonic() + max(timeout, 0.0)
        with self._cv:
            while True:
                events = [(s, e) for s, e in self._events.get(channel, ()) if s > after_seq]
                if events:
                    return events[-1][0], [e for _, e in events]
                left = deadline - time.monotonic()
                if left <= 0:
                    return self._seq.get(channel, 0), []
                self._cv.wait(left)


class Registry:
    """One process's record of what it spawned (see the module's text)."""

    def __init__(self):
        self.node_id = os.environ.get(_NODE_ENV) or uuid.uuid4().hex
        self.bus = Bus()
        self._lock = threading.Lock()
        self._procs: "collections.OrderedDict[str, dict]" = collections.OrderedDict()
        self._handles: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()
        self._groups: "collections.OrderedDict[str, object]" = collections.OrderedDict()
        self.task_events: collections.deque = collections.deque(maxlen=TASK_EVENTS)
        self.bus.publish("nodes", {"node_id": self.node_id, "event": "added"})

    # -- processes ------------------------------------------------------------

    def started(self, proc_id: str, *, kind: str, name: str, class_name: str, pid: int,
                cards: list, cpu: float, state: str, handle=None,
                placement_group_id: Optional[str] = None,
                bundle_index: Optional[int] = None) -> None:
        rec = {"id": proc_id, "kind": kind, "name": name, "class_name": class_name,
               "pid": pid, "state": state, "cards": list(cards), "cpu": float(cpu),
               "placement_group_id": placement_group_id, "bundle_index": bundle_index,
               "death_cause": None, "start_t": time.time(), "end_t": None}
        with self._lock:
            self._procs[proc_id] = rec
            if handle is not None:
                self._handles[proc_id] = handle
        if state == "ALIVE":
            self._publish_actor(rec)

    def set_state(self, proc_id: str, state: str, reason: Optional[str] = None) -> None:
        """PENDING -> ALIVE -> DEAD; a DEAD record stays DEAD."""
        with self._lock:
            rec = self._procs.get(proc_id)
            if rec is None or rec["state"] == "DEAD" or rec["state"] == state:
                return
            rec["state"] = state
            if state == "DEAD":
                rec["death_cause"], rec["end_t"] = reason, time.time()
                self._trim_locked()
            rec = dict(rec)
        self._publish_actor(rec)

    def _trim_locked(self) -> None:
        dead = [k for k, r in self._procs.items() if r["state"] == "DEAD"]
        for k in dead[:max(0, len(dead) - DEAD_KEPT)]:
            del self._procs[k]

    def _publish_actor(self, rec: dict) -> None:
        event = {"actor_id": rec["id"], "state": rec["state"], "name": rec["name"],
                 "class_name": rec["class_name"], "pid": rec["pid"], "kind": rec["kind"]}
        if rec["death_cause"]:
            event["reason"] = rec["death_cause"]
        self.bus.publish("actors", event)

    def processes(self) -> list[dict]:
        with self._lock:
            return [dict(r) for r in self._procs.values()]

    def handle(self, proc_id: str):
        """The live ``ProcessActor`` of ``proc_id``, or None."""
        return self._handles.get(proc_id)

    def live_handles(self) -> list:
        with self._lock:
            ids = [k for k, r in self._procs.items() if r["state"] == "ALIVE"]
        return [h for h in (self._handles.get(k) for k in ids) if h is not None]

    # -- placement groups -----------------------------------------------------

    def add_group(self, group) -> None:
        with self._lock:
            self._groups[group.id] = group

    def group(self, group_id: str):
        with self._lock:
            return self._groups.get(group_id)

    def groups(self) -> list:
        with self._lock:
            return list(self._groups.values())

    # -- calls ----------------------------------------------------------------

    def task_event(self, task_id: str, name: str, event: str, **extra) -> None:
        self.task_events.append({"task_id": task_id, "name": name, "event": event,
                                 "t": time.time(), **extra})


_registry: Optional[Registry] = None
_registry_lock = threading.Lock()


def registry() -> Registry:
    """This process's registry, made at its first use."""
    global _registry
    if _registry is None:
        with _registry_lock:
            if _registry is None:
                _registry = Registry()
    return _registry


def node_env() -> dict:
    """The host's node id for a spawned process's environment: a port
    process names the node its driver named."""
    return {_NODE_ENV: registry().node_id}
