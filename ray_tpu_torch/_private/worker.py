"""The core API of the driver and of its workers: ``init``, ``shutdown``,
``remote``, ``get``, ``put``, ``wait``, ``cancel`` and
``get_runtime_context``.

The port's counterpart of ``ray_tpu/_private/worker.py:227-640,865-1260``
on one host. ``init`` makes this process a driver: its object table
(``_private/object_store.py``), its task queue (``_private/scheduler.py``)
and its workers (``_private/task_worker.py``), and it starts the driver
link and writes the session's ``driver.json`` (``_private/driver_link.py``,
``_private/session.py``), so the CLI attaches to it. ``init`` counts no
card: the cards are counted at the first task that asks for one, or the
first resource query.

In a process the driver spawned (a task's worker, or any port process)
the same functions go to the driver over the driver link, as the state
API's do; ``init`` there raises. Objects a worker makes for its running
task (a ``put``, a nested task's returns) live at least until that task
ends, and longer when a value the driver holds contains them.
"""

from __future__ import annotations

import atexit
import os
import threading
import uuid
from typing import Any, Optional

from ray_tpu_torch.exceptions import GetTimeoutError, RayTpuError, TaskError
from ray_tpu_torch.object_ref import TASK_ID_HEX, ObjectRef

_lock = threading.Lock()
_driver: Optional["_Driver"] = None
_worker_context: Optional[dict] = None  # set in a task's worker process
_current = threading.local()  # the task this thread runs: task_id, name


def new_task_id() -> str:
    return uuid.uuid4().hex[:TASK_ID_HEX]


def set_current_task(task_id: str, name: str):
    old = (getattr(_current, "task_id", None), getattr(_current, "name", None))
    _current.task_id, _current.name = task_id, name
    return old


def reset_current_task(token) -> None:
    _current.task_id, _current.name = token


def become_worker(context: dict) -> None:
    """This process is a worker of the driver ``context`` names."""
    global _worker_context
    _worker_context = dict(context)


def _raise(err: BaseException):
    if isinstance(err, TaskError):
        raise err.as_instanceof_cause()
    raise err


class _Driver:
    """What ``init`` makes: the table, the queue, the workers."""

    def __init__(self, num_cpus, num_gpus, resources, mode):
        from ray_tpu_torch._private import driver_link, object_store, task_worker
        from ray_tpu_torch._private.cards import default_ledger
        from ray_tpu_torch._private.scheduler import Scheduler

        self.mode = mode
        self.job_id = uuid.uuid4().hex[:8]
        self.worker_id = uuid.uuid4().hex
        self.ledger = default_ledger()
        self.num_gpus = num_gpus
        totals = {"CPU": float((os.cpu_count() or 1) if num_cpus is None else num_cpus)}
        totals.update({k: float(v) for k, v in (resources or {}).items()})
        if num_gpus is not None:
            totals["GPU"] = float(num_gpus)
        os.environ[object_store.DRIVER_PID_ENV] = str(os.getpid())
        self.store = object_store.ObjectStore()
        self.store.install_hooks()
        if mode == "thread":
            self.pool = task_worker.ThreadPool(self.ledger)
        else:
            self.pool = task_worker.ProcessPool(
                self.ledger, {"driver_pid": os.getpid(), "job_id": self.job_id})
        self.scheduler = Scheduler(totals, self.pool, self.store)
        driver_link.ensure_server()

    @property
    def shm(self) -> bool:
        return self.mode == "process"

    # -- the operations, here or for a worker over the link ------------------------

    def op_submit(self, fn, fn_blob: bytes, name: str, args_wire: tuple, deps: list,
                  opts: dict, caller: Optional[str] = None) -> list:
        from ray_tpu_torch._private import object_store
        from ray_tpu_torch._private.scheduler import Task

        if fn is None and self.mode == "thread":
            import pickle

            fn = pickle.loads(fn_blob)
        task_id = new_task_id()
        n = opts["num_returns"]
        resources = dict(opts["resources"])
        if self.num_gpus is not None and opts["num_gpus"]:
            resources["GPU"] = opts["num_gpus"]
        t = Task(task_id, name, fn, fn_blob, args_wire, list(deps),
                 [f"{task_id}{i + 1:08x}" for i in range(n)], resources, opts["num_gpus"],
                 opts["strategy"], opts["max_retries"], opts["retry_exceptions"])
        t.pins = list(deps) + object_store.contained(args_wire)
        self.scheduler.submit(t)
        self.scheduler.pin_to_task(caller, t.returns)
        return t.returns

    def op_put(self, wire: tuple, caller: Optional[str] = None) -> str:
        oid = f"{new_task_id()}{0:08x}"
        self.store.put(oid, wire)
        self.scheduler.pin_to_task(caller, [oid])
        return oid

    def op_get(self, ids: list, timeout: Optional[float]) -> list:
        """Each id's (True, wire form) or (False, error)."""
        done = self.store.wait(ids, len(ids), timeout)
        if len(done) < len(ids):
            missing = next(i for i in ids if i not in set(done))
            raise GetTimeoutError(f"get timed out after {timeout} s waiting for "
                                  f"ObjectRef({missing})")
        return [self.store.read(i) for i in ids]

    def op_wait(self, ids: list, num_returns: int, timeout: Optional[float]) -> list:
        return self.store.wait(ids, num_returns, timeout)

    def op_cancel(self, oid: str) -> None:
        self.scheduler.cancel(oid[:TASK_ID_HEX])

    def op_context(self) -> dict:
        return {"job_id": self.job_id}

    def op_resources(self, which: int) -> dict:
        """The logical resources and the cards: in all (0) or free (1)."""
        totals, free = self.scheduler.resources()
        out = dict(totals if which == 0 else free)
        if "GPU" not in totals:
            cards, _ = self.ledger.totals()
            out["GPU"] = (float(len(cards)) if which == 0
                          else sum(self.ledger.free().shares.values()))
        return {k: v for k, v in out.items() if v > 0}

    def close(self) -> None:
        self.scheduler.close()
        self.pool.shutdown()
        self.store.close()


def driver_op(op: str, args: tuple):
    """A worker's operation, run in the driver (``driver_link``'s ``core``)."""
    d = _driver
    if d is None:
        raise RayTpuError("ray_tpu_torch.init() has not been called in the driver")
    return getattr(d, "op_" + op)(*args)


class _Link:
    """The driver's operations from a process it spawned."""

    def __getattr__(self, name: str):
        from ray_tpu_torch._private import driver_link

        op = name.removeprefix("op_")

        def call(*args):
            return driver_link.call("core", op, args)

        return call

    shm = True


def _api():
    if _driver is not None:
        return _driver
    if _worker_context is not None or _in_port_process():
        return _Link()
    raise RayTpuError("ray_tpu_torch.init() has not been called")


def _in_port_process() -> bool:
    from ray_tpu_torch._private import driver_link

    return driver_link.parent_address() is not None


def _caller() -> Optional[str]:
    """The task this thread runs, in a worker process or on a driver
    thread (its objects' pin), else None."""
    return getattr(_current, "task_id", None)


# -- the public functions ------------------------------------------------------------


def is_initialized() -> bool:
    return _driver is not None


def init(*, address: Optional[str] = None, num_cpus: Optional[int] = None,
         num_gpus: Optional[float] = None, resources: Optional[dict] = None,
         mode: str = "process", ignore_reinit_error: bool = False):
    """Make this process a driver (see the module's text). ``num_cpus``
    (default ``os.cpu_count()``) and ``resources`` are logical resources
    that tasks take while they run; ``num_gpus`` caps the card shares the
    core API's tasks hold at once (default: what the card ledger grants).
    ``mode="thread"`` runs tasks on the driver's threads."""
    global _driver
    if address is not None:
        raise RayTpuError(
            "ray_tpu_torch.init(address=...) is not supported: client mode is out by decision "
            "(ROADMAP.md). A process attaches to a running port driver through its session "
            "file, as the CLI does (ray_tpu_torch._private.session.attach, "
            "python -m ray_tpu_torch.scripts.cli)")
    if mode not in ("process", "thread"):
        raise ValueError(f"mode must be 'process' or 'thread', got {mode!r}")
    with _lock:
        if _driver is not None:
            if ignore_reinit_error:
                return _driver
            raise RayTpuError("ray_tpu_torch.init() called twice")
        if _worker_context is not None or _in_port_process():
            raise RayTpuError("init() must not be called inside a worker")
        _driver = _Driver(num_cpus, num_gpus, resources, mode)
    atexit.unregister(shutdown)  # one hook, however many times init runs
    atexit.register(shutdown)
    return _driver


def shutdown() -> None:
    """End every worker, free every object and unlink every segment."""
    global _driver
    with _lock:
        d, _driver = _driver, None
    if d is None:
        return
    ObjectRef._on_create = ObjectRef._on_delete = None
    d.close()


def submit(rf, args: tuple, kwargs: dict) -> list:
    """``RemoteFunction.remote``: the task's return refs."""
    from ray_tpu_torch._private.task_worker import encode_args

    api = _api()
    wire, deps = encode_args(args, kwargs, api.shm)
    opts = rf._task_options()
    fn = rf._function if isinstance(api, _Driver) else None
    ids = api.op_submit(fn, rf._blob, opts["name"], wire, deps, opts, _caller())
    return [ObjectRef(i) for i in ids]


def put(value: Any) -> ObjectRef:
    from ray_tpu_torch._private import object_store

    if isinstance(value, ObjectRef):
        raise TypeError("Calling put on an ObjectRef is not allowed")
    api = _api()
    return ObjectRef(api.op_put(object_store.serialize(value, api.shm), _caller()))


def get(refs, *, timeout: Optional[float] = None):
    """The value of one ref, or of a list of refs in order; raises the
    task's error (a ``TaskError`` that is also an instance of its cause),
    or ``GetTimeoutError`` after ``timeout`` seconds."""
    from ray_tpu_torch._private import object_store

    single = isinstance(refs, ObjectRef)
    ref_list = [refs] if single else list(refs)
    for r in ref_list:
        if not isinstance(r, ObjectRef):
            raise TypeError(f"ray_tpu_torch.get takes ObjectRefs, got {type(r)}")
    if not ref_list:
        return []
    values = []
    for ok, value in _api().op_get([r.hex() for r in ref_list], timeout):
        if not ok:
            _raise(value)
        values.append(object_store.deserialize(value))
    return values[0] if single else values


async def get_async(ref):
    """``get`` for ``await ref``, off the event loop's thread."""
    import asyncio

    return await asyncio.get_running_loop().run_in_executor(None, get, ref)


def wait(refs, *, num_returns: int = 1, timeout: Optional[float] = None):
    """(ready, not ready): the refs done once ``num_returns`` are, or at
    ``timeout``, each list in the order given, ready capped at
    ``num_returns``."""
    refs = list(refs)
    for r in refs:
        if not isinstance(r, ObjectRef):
            raise TypeError(f"ray_tpu_torch.wait takes ObjectRefs, got {type(r)}")
    if not refs:
        return [], []
    num_returns = min(num_returns, len(refs))
    done = set(_api().op_wait([r.hex() for r in refs], num_returns, timeout))
    ready = [r for r in refs if r.hex() in done][:num_returns]
    taken = {r.hex() for r in ready}
    return ready, [r for r in refs if r.hex() not in taken]


def cancel(ref: ObjectRef, *, force: bool = False) -> None:
    """Cancel the task of ``ref``: a queued task fails with
    ``TaskCancelledError``; a running task is only marked (no kill, as in
    the reference, which ignores ``force``)."""
    if not isinstance(ref, ObjectRef):
        raise TypeError(f"ray_tpu_torch.cancel takes an ObjectRef, got {type(ref)}")
    _api().op_cancel(ref.hex())


class RuntimeContext:
    """The job, worker, node and task of the calling thread."""

    def __init__(self, job_id: str, worker_id: str):
        self._job_id, self._worker_id = job_id, worker_id

    def get_job_id(self) -> str:
        return self._job_id

    def get_worker_id(self) -> str:
        return self._worker_id

    def get_node_id(self) -> str:
        from ray_tpu_torch._private.registry import registry

        return registry().node_id

    def get_task_name(self) -> Optional[str]:
        return getattr(_current, "name", None)


def get_runtime_context() -> RuntimeContext:
    if _driver is not None:
        return RuntimeContext(_driver.job_id, _driver.worker_id)
    if _worker_context is not None:
        return RuntimeContext(_worker_context["job_id"], _worker_context["worker_id"])
    ctx = _api().op_context()
    return RuntimeContext(ctx["job_id"], f"pid-{os.getpid()}")


def remote(*args, **kwargs):
    """``@remote`` on a function, bare or with options
    (``@remote(num_gpus=0.5)``). A class raises: actors come in part 2."""
    from ray_tpu_torch.remote_function import RemoteFunction

    def make(target, options):
        if isinstance(target, type):
            raise NotImplementedError(
                "ray_tpu_torch.remote on a class (actors) comes in the core API's part 2 "
                "(ROADMAP.md, Queue A item 9); use ProcessActor meanwhile")
        return RemoteFunction(target, options)

    if len(args) == 1 and not kwargs and callable(args[0]):
        return make(args[0], {})
    if args:
        raise TypeError("@remote takes keyword options only, e.g. @remote(num_gpus=1)")
    return lambda target: make(target, dict(kwargs))


def driver() -> Optional["_Driver"]:
    """This process's driver state, or None."""
    return _driver
