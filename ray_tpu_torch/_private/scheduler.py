"""The driver's task queue: the part of the reference controller's work
(``ray_tpu/_private/controller.py``) that a one-host driver keeps.

- *Resources.* The logical resources are ``init``'s: ``CPU`` (``num_cpus``)
  and the custom ``resources``, and ``GPU`` when ``init`` was given
  ``num_gpus``. A task takes what it names while it runs. Its share of a
  card (``num_gpus``) is leased from the card ledger by the worker that
  runs it (``_private/task_worker.py``), beside every other lease of the
  host.
- *Dependencies.* A task is dispatched once every ``ObjectRef`` among its
  arguments is ready; a failed dependency fails the task with that
  dependency's error.
- *Order and gating.* One scheduler thread goes through the queue in the
  order of submission and dispatches each task that fits: its logical
  resources are free and its worker is at hand (a lease the ledger
  grants, a placement group that is placed). A task that does not fit
  stays queued; one that can never fit stays queued for ever and never
  errors.
- *Retries.* ``max_retries`` covers a worker's death: after the last retry
  the task fails with ``WorkerCrashedError``. With ``retry_exceptions`` it
  covers the function's errors too (``controller.py:7012-7020``).
- *Cancel* (``controller.py:7676-7686``): a queued task fails with
  ``TaskCancelledError``; a running task is only marked.
- *Events.* Each task's ``PENDING``, ``RUNNING``, ``RETRY``, ``FINISHED``
  and ``FAILED`` go to the registry (``_private/registry.py``), which the
  state API reads.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Optional

from ray_tpu_torch._private import object_store
from ray_tpu_torch._private.registry import registry
from ray_tpu_torch.exceptions import TaskCancelledError, WorkerCrashedError

POLL_S = 0.05  # how often a task that waits for a lease or a placement retries
_EPS = 1e-9


@dataclasses.dataclass(eq=False)
class Task:
    task_id: str
    name: str
    fn: Optional[Callable]  # the function itself, when it was submitted in the driver
    fn_blob: bytes  # the function, pickled by reference
    args: tuple  # the wire form of (args, kwargs), its top-level refs as markers
    deps: list  # the ids of its top-level refs, in order
    returns: list  # its return ids
    resources: dict  # logical: "CPU", custom, "GPU" when init counts it
    num_gpus: float
    strategy: object  # a scheduling strategy, or None
    max_retries: int
    retry_exceptions: bool
    state: str = "PENDING"  # PENDING, RUNNING, FINISHED, FAILED
    cancelled: bool = False
    pins: list = dataclasses.field(default_factory=list)  # ids it pins until it ends
    made: list = dataclasses.field(default_factory=list)  # ids a worker made for it
    worker_id: Optional[str] = None

    def __post_init__(self):
        self.retries_left = self.max_retries


class Scheduler:
    """The queue, the logical resources and the dispatch thread."""

    def __init__(self, totals: dict, pool, store: "object_store.ObjectStore"):
        self.totals = dict(totals)
        self.available = dict(totals)
        self.pool, self.store = pool, store
        self._cv = threading.Condition()
        self._queue: dict = {}  # task id -> Task, queued (insertion order = submission)
        self._running: dict = {}  # task id -> Task
        self._dirty = False
        self._waiting = False  # a queued task waits for a lease or a placement
        self._closed = False
        store.listener = self.kick
        self._thread = threading.Thread(target=self._loop, name="core-scheduler", daemon=True)
        self._thread.start()

    # -- submission ------------------------------------------------------------

    def submit(self, t: Task) -> None:
        self.store.create(t.returns)
        self.store.pin(t.pins)
        registry().task_event(t.task_id, t.name, "PENDING", kind="task")
        with self._cv:
            self._queue[t.task_id] = t
            self._dirty = True
            self._cv.notify_all()

    def pin_to_task(self, task_id: Optional[str], ids: list) -> None:
        """``ids`` made in a worker for its running task ``task_id`` live at
        least until that task ends."""
        with self._cv:
            t = self._running.get(task_id)
            if t is None:
                return
            t.made.extend(ids)
            self.store.pin(ids)

    def kick(self) -> None:
        with self._cv:
            self._dirty = True
            self._cv.notify_all()

    def cancel(self, task_id: str) -> None:
        with self._cv:
            t = self._queue.pop(task_id, None)
            if t is None:
                running = self._running.get(task_id)
                if running is not None:
                    running.cancelled = True
                return
        self._end(t, False, TaskCancelledError(f"task {t.name} cancelled"))

    # -- dispatch --------------------------------------------------------------

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._dirty and not self._closed:
                    if not self._cv.wait(POLL_S if self._waiting else None) and self._waiting:
                        break  # poll the tasks that wait for a lease or a placement
                if self._closed:
                    return
                self._dirty = False
                queued = list(self._queue.values())
            self.store.collect()
            waiting = False
            for t in queued:
                waiting |= self._try_dispatch(t)
            self._waiting = waiting

    def _fits(self, need: dict) -> bool:
        return all(self.available.get(k, 0.0) >= v - _EPS for k, v in need.items())

    def _take(self, need: dict, sign: float) -> None:
        for k, v in need.items():
            self.available[k] = self.available.get(k, 0.0) - sign * v

    def _try_dispatch(self, t: Task) -> bool:
        """Dispatch ``t`` if it fits; True when it waits for a worker."""
        states = [self.store.status(d) for d in t.deps]
        if any(s is None for s in states):
            return False
        failed = next((d for d, s in zip(t.deps, states) if s is False), None)
        if failed is not None:
            with self._cv:
                if self._queue.pop(t.task_id, None) is None:
                    return False
            self._end(t, False, self.store.read(failed)[1])
            return False
        with self._cv:
            if t.task_id not in self._queue or not self._fits(t.resources):
                return False
            self._take(t.resources, 1)
        try:
            worker = self.pool.acquire(t)
        except Exception as e:  # noqa: BLE001 — a placement that can never be: the task's error
            with self._cv:
                self._take(t.resources, -1)
                queued = self._queue.pop(t.task_id, None) is not None
            if queued:
                self._end(t, False, e)
            return False
        with self._cv:
            if worker is None or self._queue.pop(t.task_id, None) is None:
                self._take(t.resources, -1)
                if worker is not None:
                    self.pool.release(worker, dead=False)
                return worker is None
            t.state, t.worker_id = "RUNNING", worker.worker_id
            self._running[t.task_id] = t
        spec = (t.task_id, t.name, t.fn_blob, t.args,
                [self.store.read(d)[1] for d in t.deps], len(t.returns))
        registry().task_event(t.task_id, t.name, "RUNNING", kind="task", worker_id=t.worker_id)
        self.pool.launch(worker, t, spec, lambda kind, value: self._on_done(t, worker, kind, value))
        return False

    def _on_done(self, t: Task, worker, kind: str, value) -> None:
        """A run's outcome: ("ok", return wires), ("err", TaskError) or
        ("died", why)."""
        self.pool.release(worker, dead=kind == "died")
        with self._cv:
            self._take(t.resources, -1)
            self._running.pop(t.task_id, None)
            self._dirty = True
            self._cv.notify_all()
            retry = (not t.cancelled and not self._closed and t.retries_left != 0
                     and (kind == "died" or (kind == "err" and t.retry_exceptions)))
            if retry:
                t.retries_left -= 1
                t.state = "PENDING"
                made, t.made = t.made, []
                self._queue[t.task_id] = t
        if retry:
            self.store.unpin(made)
            registry().task_event(t.task_id, t.name, "RETRY", kind="task", cause=kind)
            return
        if kind == "ok":
            self._end(t, True, value)
        elif kind == "died":
            self._end(t, False, WorkerCrashedError(
                f"the worker running task {t.name} died ({value}); "
                f"{t.max_retries} retries were allowed"))
        else:
            self._end(t, False, value)

    def _end(self, t: Task, ok: bool, value) -> None:
        """Seal ``t``'s returns with its values (``ok``) or its error, and
        drop what it pinned."""
        t.state = "FINISHED" if ok else "FAILED"
        for i, oid in enumerate(t.returns):
            self.store.seal(oid, ok, value[i] if ok else value)
        registry().task_event(t.task_id, t.name, t.state, kind="task")
        self.store.unpin(t.pins + t.made)
        object_store.unlink(t.args)

    # -- reads -----------------------------------------------------------------

    def live(self) -> list[dict]:
        """The queued and running tasks, as the state API lists them."""
        with self._cv:
            running = list(self._running.values())
            queued = list(self._queue.values())
        out = [{"task_id": t.task_id, "name": t.name, "state": "RUNNING",
                "worker_id": t.worker_id} for t in running]
        for t in queued:
            ready = all(self.store.status(d) is not None for d in t.deps)
            out.append({"task_id": t.task_id, "name": t.name,
                        "state": "PENDING_SCHEDULING" if ready else "PENDING_ARGS_AVAIL",
                        "worker_id": None})
        return out

    def resources(self) -> tuple[dict, dict]:
        with self._cv:
            return dict(self.totals), {k: max(0.0, v) for k, v in self.available.items()}

    def close(self) -> None:
        """Stop dispatching; queued tasks are dropped with the table."""
        with self._cv:
            self._closed = True
            self._queue.clear()
            self._cv.notify_all()
        self._thread.join(timeout=10)
