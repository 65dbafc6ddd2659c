"""Where the core API's tasks run.

- *Process mode* (``init``'s default). A worker is a ``ProcessActor``
  (``_private/process_actor.py``) hosting a ``TaskExecutor``, which runs
  one task at a time. A CPU worker idle after its task is reused by a
  later CPU task; ``shutdown`` ends them all.
- *Card shares.* A task with ``num_gpus`` runs in a worker that leases its
  share through ``spawn_env.assign_cards``, so it never overlaps a Train
  group, a Serve replica or a placement group's reservation on the same
  ledger. While the ledger refuses the lease the task stays queued (a host
  with no card refuses every one: no task falls back to the CPU). The
  worker ends with its task, so the share is free again once the task's
  result is: as in the reference, a task holds its card only while it
  runs.
- *Placement groups.* A task with a ``PlacementGroupSchedulingStrategy``
  runs in a worker placed in the bundle through ``ProcessActor``'s own
  ``scheduling_strategy``, once the group is placed; that worker too ends
  with its task.
- *Thread mode* runs each task on a thread of the driver (the reference's
  ``local_mode`` analog); a card share is leased by the driver for the
  task's run.
- *Inside a worker*, the core API (``remote``, ``get``, ``put``, ``wait``,
  ``cancel``) goes to the driver over the driver link
  (``_private/worker.py``).

A task's run (``execute``) deserializes its arguments, puts its
dependencies' values in place of their refs, calls the function and
serializes each return; an exception comes back as a ``TaskError`` with
the remote traceback.
"""

from __future__ import annotations

import os
import pickle
import threading
import uuid
from typing import Callable, Optional

from ray_tpu_torch._private import object_store
from ray_tpu_torch.exceptions import PlacementGroupSchedulingError, TaskError

LEASE_NAME = "core API task worker"


class _Dep:
    """A top-level ``ObjectRef`` argument's place in a task's arguments."""

    __slots__ = ("i",)

    def __init__(self, i: int):
        self.i = i

    def __reduce__(self):
        return (_Dep, (self.i,))


def encode_args(args: tuple, kwargs: dict, shm: bool) -> tuple:
    """(wire form of the arguments with each top-level ref replaced by a
    marker, the refs' ids in order)."""
    from ray_tpu_torch.object_ref import ObjectRef

    deps: list = []

    def sub(v):
        if isinstance(v, ObjectRef):
            deps.append(v.hex())
            return _Dep(len(deps) - 1)
        return v

    template = (tuple(sub(a) for a in args), {k: sub(v) for k, v in kwargs.items()})
    return object_store.serialize(template, shm), deps


def _task_error(name: str, e: Exception) -> TaskError:
    err = TaskError(name, e)
    try:
        pickle.dumps(err)
    except Exception:  # noqa: BLE001 — a cause that does not pickle
        err = TaskError(name, RuntimeError(f"{type(e).__name__}: {e}"), err.remote_tb)
    return err


def execute(spec: tuple, fn: Optional[Callable] = None, shm: bool = False) -> tuple:
    """Run one task: ("ok", its return wires) or ("err", TaskError)."""
    from ray_tpu_torch._private import worker

    task_id, name, fn_blob, args_wire, dep_wires, n_returns = spec
    token = worker.set_current_task(task_id, name)
    try:
        if fn is None:
            fn = pickle.loads(fn_blob)
        args, kwargs = object_store.deserialize(args_wire)

        def put_back(v):
            return object_store.deserialize(dep_wires[v.i]) if isinstance(v, _Dep) else v

        value = fn(*[put_back(a) for a in args], **{k: put_back(v) for k, v in kwargs.items()})
        if n_returns == 1:
            values = [value]
        else:
            values = list(value) if n_returns else []
            if len(values) != n_returns:
                raise ValueError(f"task {name} returned {len(values)} values, but "
                                 f"num_returns={n_returns}")
        return ("ok", [object_store.serialize(v, shm) for v in values])
    except Exception as e:  # noqa: BLE001 — the task's error, raised at every get
        return ("err", _task_error(name, e))
    finally:
        worker.reset_current_task(token)


class TaskExecutor:
    """What a worker process hosts: runs tasks one at a time."""

    def __init__(self, context: dict):
        from ray_tpu_torch._private import worker

        os.environ[object_store.DRIVER_PID_ENV] = str(context["driver_pid"])
        worker.become_worker(context)

    def run(self, spec: tuple) -> tuple:
        return execute(spec, shm=True)


def _placement(t):
    """(group, bundle index) of a task placed in a placement group, else None."""
    from ray_tpu_torch.util.scheduling_strategies import PlacementGroupSchedulingStrategy

    s = t.strategy
    if not isinstance(s, PlacementGroupSchedulingStrategy):
        return None
    return s.placement_group, s.placement_group_bundle_index


def _group_placed(pg) -> bool:
    """The group is placed now (a pending one is tried); raises for a group
    this driver did not make or that was removed."""
    from ray_tpu_torch._private.registry import registry

    group = registry().group(pg.id)
    if group is None:
        raise PlacementGroupSchedulingError(
            f"placement group {pg.id} was not made by this driver: a task is placed by the "
            "group's creator")
    if group.state == "REMOVED":
        raise PlacementGroupSchedulingError(f"placement group {pg.id} was removed")
    return group.ready(timeout=0)


class _Worker:
    __slots__ = ("worker_id", "actor", "lease", "reusable")

    def __init__(self, lease=None, reusable: bool = False):
        self.worker_id = uuid.uuid4().hex
        self.actor, self.lease = None, lease
        self.reusable = reusable  # a CPU worker: idle after its task, for the next one


class ThreadPool:
    """Thread mode: a thread of the driver a task."""

    def __init__(self, ledger):
        self.ledger = ledger

    def acquire(self, t) -> Optional[_Worker]:
        from ray_tpu_torch._private.spawn_env import assign_cards
        from ray_tpu_torch.util.scheduling_strategies import resolve

        placed = _placement(t)
        if placed is not None and not _group_placed(placed[0]):
            return None
        if placed is None and t.strategy is not None:
            resolve(t.strategy, None)  # a node that is not the host's raises
        lease = None
        if t.num_gpus and placed is None:
            try:
                lease = assign_cards(1, t.num_gpus, LEASE_NAME + "s", ledger=self.ledger)[0]
            except RuntimeError:  # too few free cards, or none visible
                return None
        return _Worker(lease=lease)

    def launch(self, w: _Worker, t, spec: tuple, done: Callable) -> None:
        def run():
            done(*execute(spec, fn=t.fn, shm=False))

        threading.Thread(target=run, name=f"core-task-{t.name}", daemon=True).start()

    def release(self, w: _Worker, dead: bool) -> None:
        if w.lease is not None:
            w.lease.release()

    def pids(self) -> list:
        return []

    def shutdown(self) -> None:
        pass


class ProcessPool:
    """Process mode: worker processes; a CPU worker is reused while idle."""

    def __init__(self, ledger, context: dict):
        self.ledger, self.context = ledger, context
        self._lock = threading.Lock()
        self._idle: list = []  # CPU workers
        self._all: dict = {}  # worker id -> _Worker

    def acquire(self, t) -> Optional[_Worker]:
        from ray_tpu_torch._private.process_actor import ProcessActor
        from ray_tpu_torch._private.spawn_env import assign_cards

        placed = _placement(t)
        reusable = not t.num_gpus and placed is None
        if reusable:
            with self._lock:
                while self._idle:
                    w = self._idle.pop()
                    if w.actor.is_alive():
                        return w
                    self._all.pop(w.worker_id, None)
        if placed is not None and not _group_placed(placed[0]):
            return None
        lease = None
        if t.num_gpus and placed is None:
            try:
                lease = assign_cards(1, t.num_gpus, LEASE_NAME + "s", ledger=self.ledger)[0]
            except RuntimeError:  # too few free cards, or none visible
                return None
        w = _Worker(lease=lease, reusable=reusable)
        w.actor = ProcessActor(
            TaskExecutor, ({**self.context, "worker_id": w.worker_id},), lease=lease,
            name=f"core-worker-{w.worker_id[:8]}", kind="worker", scheduling_strategy=t.strategy)
        with self._lock:
            self._all[w.worker_id] = w
        return w

    def launch(self, w: _Worker, t, spec: tuple, done: Callable) -> None:
        from ray_tpu_torch._private.process_actor import ActorDiedError

        def finished(r) -> None:
            if r._ok:
                done(*r._value)
            elif isinstance(r._value, ActorDiedError):
                done("died", str(r._value))
            else:  # the executor itself raised: the task's error all the same
                done("err", _task_error(t.name, r._value))

        w.actor.call("run", spec).add_done_callback(finished)

    def release(self, w: _Worker, dead: bool) -> None:
        """A CPU worker goes idle; any other ends now, before its task's
        result is sealed, so its card share or bundle place is free by then."""
        with self._lock:
            known = self._all.get(w.worker_id) is w
            if known and not dead and w.reusable:
                self._idle.append(w)
                return
            self._all.pop(w.worker_id, None)
        if known and not dead:
            w.actor.kill()

    def pids(self) -> list:
        with self._lock:
            return [w.actor.pid for w in self._all.values()]

    def shutdown(self) -> None:
        with self._lock:
            workers, self._all = list(self._all.values()), {}
            self._idle.clear()
        threads = [threading.Thread(target=w.actor.kill, daemon=True) for w in workers]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
