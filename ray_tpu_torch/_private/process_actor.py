"""A process handle: one spawned process hosting one object.

The port's stand-in for what ``ray_tpu.remote(cls)`` gives the JAX
package's RLlib, Data and Serve (an actor,
``ray_tpu/rllib/env/env_runner.py:332-335``). RLlib's remote env runners
and learners, SAC's runners, Data's actor pools and Serve's replicas run
on it.

    actor = ProcessActor(SingleAgentEnvRunner, ("CartPole-v1", spec), {"seed": 1})
    h = actor.call("sample")          # a PendingResult, at once
    out = get(h)                      # the method's return value
    n = get(actor.call(launch_counts))  # a module-level function, run there
    ready, rest = wait([h1, h2], num_returns=1, timeout=60.0)
    for chunk in actor.call_stream("tokens", 8):  # a generator method, chunk by chunk
        ...
    actor.kill()

- *Processes.* The ``spawn`` context, one process per actor, standing
  alone: no ``torch.distributed`` world, so a replacement can take a dead
  actor's place (a rank of ``WorkerGroup.start_loop`` cannot). The class
  and its arguments travel with the standard ``pickle``, by reference, so
  the class must be importable by name (no ``cloudpickle``).
- *Devices.* With ``lease=None`` the process sees no card
  (``CUDA_VISIBLE_DEVICES=""``) and runs one intra-op thread; with a
  lease from the host's card ledger (``spawn_env.assign_cards``) it sees
  exactly the lease's card, as ``cuda:0``, and holds the lease for its
  life (``_private/spawn_env.py``, shared with the Train layer's ranks):
  a process that is killed, however, leaves no lease behind.
- *Calls* go over a pipe by method name (or as a module-level function,
  by reference, run in the process on its arguments alone). With
  ``max_concurrency=1`` (the default) they run one at a time, in the
  order they were sent: a ``set_weights`` lands before the ``sample`` sent
  after it. With ``max_concurrency=n`` a pool of n threads in the child
  runs them at once, in no promised order (the JAX package's threaded
  actors; Serve's replicas take ``max_ongoing_requests + 2``, so that
  ``@serve.batch`` sees calls together and a health check never waits
  behind a full replica). A reader thread in the child keeps taking calls
  while methods run, so a large call never waits on a large reply.
- *On the object.* ``call(OnInstance(fn), ...)`` runs a module-level
  ``fn(obj, ...)`` on the hosted object (a compiled DAG starts its loop
  thread this way); ``bind("method", ...)`` makes a DAG node
  (``ray_tpu_torch.dag``); ``stacks()`` returns every thread's stack in
  the process, answered by the child's reader thread, so a running call
  does not hold it up.
- *Streams.* ``call_stream`` runs a generator method and sends each chunk
  under the call's id as it is produced, then an end marker or the error.
  The producer runs at most ``STREAM_WINDOW`` chunks ahead of the consumer
  (the consumer acknowledges what it took); ``cancel`` (or collecting the
  ``StreamResult`` before its end) closes the producer's generator.
- *Replies.* One reader thread in the parent, for each actor, reads its
  reply pipe and routes each reply to its call's ``PendingResult`` or
  ``StreamResult`` by call id; ``get`` and ``wait`` only wait on results,
  so any number of threads may call, get and wait on one actor at once.
- *Failures.* A method that raises comes back as ``RemoteError`` with the
  child's traceback. A process that dies turns each of its pending results
  and open streams into ``ActorDiedError`` as soon as its reply pipe
  closes (the JAX package waits out its ``get`` timeout). Construction is
  call 0 (``actor.ready``); if it raises, the process sends the error and
  exits.
- *Lifetime.* ``kill()`` terminates, joins with a deadline, then kills. A
  finalizer does the same when the handle is collected or the interpreter
  exits, and the process is a daemon besides: none outlives its owner.
  When the parent goes, the child's call pipe closes, and the child exits.
- *Process groups.* A daemon may not spawn processes of its own. With
  ``leads_group=True`` (Serve's replicas, one of which may host a gang of
  rank processes) the child is no daemon: it leads a process group of its
  own, which what it spawns joins. When its call pipe closes (the parent
  closed it, or went) it ends the group's other members (SIGKILL) and
  exits; ``kill()``, the finalizer and the interpreter's exit end the
  group from the parent (``spawn_env.end_process_group``, as a Tune
  trial's group is ended). No process the actor spawned outlives it, and
  their leases end with them.
- *Placement.* ``scheduling_strategy`` places the actor in a placement
  group's bundle (``util/scheduling_strategies.py``): it runs under the
  bundle's cards, holding a copy of the bundle's lease, and takes none of
  its own.
- *The record.* Each actor writes its state to this process's registry
  (``_private/registry.py``): ``PENDING`` when started, ``ALIVE`` when its
  constructor returns, ``DEAD`` when its process is seen gone or it is
  killed, and each call's dispatch and end. Each call carries the
  caller's trace context (``util/tracing.py``): a span opened in the
  method parents under the caller's. The child's environment carries the
  way back to this process (``_private/driver_link.py``), and its stdout
  and stderr go to the session's log files under its actor id
  (``_private/log_capture.py``), which the driver tails to its console.
"""

from __future__ import annotations

import atexit
import functools
import multiprocessing
import multiprocessing.util  # noqa: F401 — registers its exit hook before this module's
import os
import pickle
import queue
import sys
import threading
import time
import traceback
import uuid
import weakref
from typing import Callable, Optional

from ray_tpu_torch._private import driver_link
from ray_tpu_torch._private.cards import CardLedger, Lease, default_ledger
from ray_tpu_torch._private.registry import registry
from ray_tpu_torch._private.spawn_env import (end_process_group, kill_group_members,
                                              process_env, start_process)
from ray_tpu_torch.util import tracing
from ray_tpu_torch.util.placement_group import placed_env
from ray_tpu_torch.util.scheduling_strategies import resolve

# the JAX package's deadline on a remote runner's sample
# (ray_tpu/rllib/env/env_runner.py:405)
CALL_TIMEOUT_S = 300.0
# terminate -> kill, and kill -> reaped
KILL_GRACE_S = 10.0
# chunks a stream's producer may run ahead of its consumer (the JAX
# package's _generator_backpressure_num_objects, ray_tpu/serve/handle.py)
STREAM_WINDOW = 16
_ACK_EVERY = STREAM_WINDOW // 2

# every result that completes notifies this; ``wait`` waits on it
_CHANGED = threading.Condition()


class ActorError(RuntimeError):
    """A call that did not return a value."""


class RemoteError(ActorError):
    """The method raised in the actor's process; the message carries the
    child's traceback."""


class ActorDiedError(ActorError):
    """The actor's process exited (or was killed) before the call returned."""


def _dumps(obj, what: str) -> bytes:
    try:
        return pickle.dumps(obj)
    except (pickle.PicklingError, AttributeError, TypeError) as e:
        raise TypeError(
            f"{what} goes to other processes with the standard pickle, by reference: pass a "
            "class, a module-level function or a functools.partial of one, not a lambda or a "
            f"closure ({type(e).__name__}: {e})") from e


def require_picklable(obj, what: str) -> None:
    """Raise ``TypeError`` naming ``what`` unless ``obj`` pickles with the
    standard pickle: another process receives it by reference."""
    _dumps(obj, what)


class Result:
    """A value that arrives later: ``done``, then a value or an error.
    ``get`` and ``wait`` take any ``Result``; one whose arrival the caller
    drives (a compiled DAG's) has a ``_drain(timeout)``."""

    __slots__ = ("done", "_ok", "_value", "_callbacks")

    def __init__(self):
        self.done, self._ok, self._value = False, False, None
        self._callbacks: list = []

    def _set(self, ok: bool, value) -> None:
        with _CHANGED:
            if self.done:
                return
            self.done, self._ok, self._value = True, ok, value
            callbacks, self._callbacks = self._callbacks, []
            _CHANGED.notify_all()
        for fn in callbacks:
            fn(self)

    def add_done_callback(self, fn: Callable) -> None:
        """``fn(self)`` once the result is in: at once if it is, else on
        the thread that fills it in (the actor's reader thread)."""
        with _CHANGED:
            if not self.done:
                self._callbacks.append(fn)
                return
        fn(self)

    def result(self):
        if not self._ok:
            raise self._value
        return self._value


class PendingResult(Result):
    """One call's result, filled in when its reply arrives."""

    __slots__ = ("actor", "call_id", "method")

    def __init__(self, actor: "ProcessActor", call_id: int, method: str):
        super().__init__()
        self.actor, self.call_id, self.method = actor, call_id, method

    def __repr__(self):
        state = "done" if self.done else "pending"
        return f"<PendingResult {self.actor.name}.{self.method} #{self.call_id} {state}>"


_END = object()


class _StreamSink:
    """What a stream's reply side fills in: its chunks, then its end. The
    actor's link holds the sink, not the ``StreamResult``, so a consumer
    that drops its ``StreamResult`` mid-stream lets it be collected (and
    the stream cancelled)."""

    def __init__(self, call_id: int, method: str):
        self.call_id, self.method = call_id, method
        self.items: queue.SimpleQueue = queue.SimpleQueue()
        self.done = False  # the end, the error or the death has arrived
        self.callbacks: list = []
        self.lock = threading.Lock()

    def _put(self, item) -> None:
        self.items.put(item)

    def _end(self, error: Optional[BaseException]) -> None:
        with self.lock:
            if self.done:
                return
            self.done = True
            callbacks, self.callbacks = self.callbacks, []
        self.items.put((_END, error))
        for fn in callbacks:
            fn(self)


class StreamResult:
    """A generator method's chunks, in order, as they arrive: iterate, or
    ``next(timeout)``. The end raises ``StopIteration``; the method's error
    ``RemoteError``; the process's death ``ActorDiedError``."""

    def __init__(self, actor: "ProcessActor", call_id: int, method: str):
        self.actor, self.call_id, self.method = actor, call_id, method
        self._sink = _StreamSink(call_id, method)
        self.finished = False  # the consumer has reached the end
        self._taken = 0

    @property
    def done(self) -> bool:
        """The end, the error or the death has arrived."""
        return self._sink.done

    def _end(self, error: Optional[BaseException]) -> None:
        self._sink._end(error)

    def add_done_callback(self, fn: Callable) -> None:
        """``fn(sink)`` once the stream has ended (however it ended), on the
        thread that ends it."""
        sink = self._sink
        with sink.lock:
            if not sink.done:
                sink.callbacks.append(fn)
                return
        fn(sink)

    def next(self, timeout: Optional[float] = CALL_TIMEOUT_S):
        if self.finished:
            raise StopIteration
        try:
            item = self._sink.items.get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError(f"{self!r}: no chunk within {timeout:.0f} s") from None
        if isinstance(item, tuple) and len(item) == 2 and item[0] is _END:
            self.finished = True
            if item[1] is not None:
                raise item[1]
            raise StopIteration
        self._taken += 1
        if self._taken % _ACK_EVERY == 0:
            self.actor._control(("ack", self.call_id, _ACK_EVERY))
        return item

    def __iter__(self):
        return self

    def __next__(self):
        return self.next(timeout=None)

    def cancel(self) -> None:
        """Stop the producer: the child closes the method's generator and
        ends the stream; chunks not yet taken are dropped."""
        if not self.done:
            self.actor._control(("cancel", self.call_id))

    def __repr__(self):
        state = "done" if self.done else "open"
        return f"<StreamResult {self.actor.name}.{self.method} #{self.call_id} {state}>"


# -- the child ------------------------------------------------------------------


class OnInstance:
    """A module-level function sent as a call that runs on the hosted
    object: ``fn(obj, *args, **kwargs)`` (the reference's ``__ray_call__``,
    ``ray_tpu/actor.py:124``). A compiled DAG starts its loop this way."""

    def __init__(self, fn: Callable, name: Optional[str] = None):
        self.fn = fn
        self.__name__ = name or fn.__name__

    def __reduce__(self):
        return (OnInstance, (self.fn, self.__name__))


def dump_stacks() -> str:
    """Every thread's Python stack in this process, each under its name."""
    names = {t.ident: t.name for t in threading.enumerate()}
    parts = [f"pid={os.getpid()}"]
    for tid, frame in sorted(sys._current_frames().items()):
        parts.append(f"\n--- thread {names.get(tid, '?')} (ident {tid}) ---\n"
                     + "".join(traceback.format_stack(frame)))
    return "".join(parts)


def _actor_main(blob: bytes, calls, replies, one_thread: bool, max_concurrency: int = 1,
                leads_group: bool = False) -> None:
    """The child's body: build the object, then run calls until the parent
    closes the call pipe; one at a time in order, or on a pool of
    ``max_concurrency`` threads. ``leads_group``: first become the leader
    of a process group of its own, whose other members are ended (SIGKILL)
    when the parent closes the call pipe or goes."""
    if leads_group:
        os.setpgid(0, 0)
    if one_thread:
        import torch

        torch.set_num_threads(1)
    inbox: queue.SimpleQueue = queue.SimpleQueue()
    send_lock = threading.Lock()
    streams: dict = {}  # call id -> [credits semaphore, cancelled event]
    streams_lock = threading.Lock()

    def send(msg) -> None:
        with send_lock:
            try:
                replies.send(msg)
            except (pickle.PicklingError, AttributeError, TypeError):
                # the value did not pickle (send pickles before writing)
                replies.send((msg[0], "err", traceback.format_exc()))

    def read():
        try:
            while True:
                msg = pickle.loads(calls.recv_bytes())
                if msg[0] == "stacks":
                    send((msg[1], "ok", dump_stacks()))
                elif msg[0] == "ack":
                    with streams_lock:
                        s = streams.get(msg[1])
                    if s is not None:
                        for _ in range(msg[2]):
                            s[0].release()
                elif msg[0] == "cancel":
                    with streams_lock:
                        s = streams.get(msg[1])
                    if s is not None:
                        s[1].set()
                        s[0].release()
                else:
                    inbox.put(msg)
        except (EOFError, OSError):
            with streams_lock:  # wake producers waiting for credit
                for credits, cancelled in streams.values():
                    cancelled.set()
                    credits.release()
            inbox.put(None)

    threading.Thread(target=read, name="calls", daemon=True).start()
    try:
        cls, args, kwargs = pickle.loads(blob)
        obj = cls(*args, **kwargs)
    except Exception:
        replies.send((0, "err", traceback.format_exc()))
        return
    replies.send((0, "ok", None))

    def run(msg) -> None:
        call_id, method, args, kwargs, stream, ctx = msg
        token = tracing.attach_context(ctx)
        try:
            call(call_id, method, args, kwargs, stream)
        finally:
            tracing.detach_context(token)

    def call(call_id, method, args, kwargs, stream) -> None:
        if isinstance(method, str):
            fn = getattr(obj, method)
        elif isinstance(method, OnInstance):
            fn = functools.partial(method.fn, obj)
        else:
            fn = method
        if not stream:
            try:
                send((call_id, "ok", fn(*args, **kwargs)))
            except Exception:
                send((call_id, "err", traceback.format_exc()))
            return
        credits, cancelled = threading.Semaphore(STREAM_WINDOW), threading.Event()
        with streams_lock:
            streams[call_id] = (credits, cancelled)
        gen = None
        try:
            gen = iter(fn(*args, **kwargs))
            while not cancelled.is_set():
                credits.acquire()
                if cancelled.is_set():
                    break
                try:
                    item = next(gen)
                except StopIteration:
                    break
                send((call_id, "item", item))
            close = getattr(gen, "close", None)
            if close is not None:
                close()
            send((call_id, "end", None))
        except Exception:
            send((call_id, "err", traceback.format_exc()))
        finally:
            with streams_lock:
                streams.pop(call_id, None)

    if max_concurrency <= 1:
        while (msg := inbox.get()) is not None:
            run(msg)
    else:
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_concurrency, thread_name_prefix="actor-call")
        while (msg := inbox.get()) is not None:
            pool.submit(run, msg)
    # the parent closed the call pipe (or went): calls still running are
    # abandoned, as a killed process's are, and what this process spawned
    # ends with it
    if leads_group:
        kill_group_members(os.getpid(), but=os.getpid())
    if max_concurrency > 1:
        os._exit(0)


# -- the parent -----------------------------------------------------------------


def _exit_code(proc, timeout: float) -> Optional[int]:
    """``proc``'s exit code, waiting up to ``timeout`` for it to exit.
    Another thread may reap the process first (``Process.start`` and
    ``active_children`` poll every child, and so does ``is_alive``): this
    thread's ``waitpid`` then fails with ECHILD and ``join`` returns before
    the reaper has stored the code on the ``Popen`` both share, so the code
    is read again until it lands."""
    deadline = time.monotonic() + timeout
    proc.join(timeout)
    while proc.exitcode is None and time.monotonic() < deadline:
        time.sleep(0.001)
    return proc.exitcode


def _reap(proc, conns, grace_s: float, group: Optional[CardLedger] = None) -> None:
    """Terminate, join with a deadline, kill; close the pipes. ``group``:
    the process leads a process group, which is ended whole first, with
    the leases its members hold in that ledger."""
    if group is not None:
        end_process_group(proc.pid, group)
    if proc.exitcode is None:
        proc.terminate()
        if _exit_code(proc, grace_s) is None:
            proc.kill()
            _exit_code(proc, grace_s)
    for c in conns:
        c.close()


class _Link:
    """An actor's reply side, which its reader thread drives: the pending
    calls by id, and why the process is gone once it is. Holds no reference
    to the ``ProcessActor``, so a dropped handle is still collected."""

    def __init__(self, name: str, proc, replies, actor_id: str):
        self.name, self.proc, self.replies, self.actor_id = name, proc, replies, actor_id
        self.lock = threading.Lock()
        self.pending: dict = {}
        self.dead: Optional[str] = None

    def read_loop(self) -> None:
        while True:
            try:
                call_id, kind, value = self.replies.recv()
            except (EOFError, OSError):
                break
            except Exception:  # a reply that did not unpickle here: it is lost
                traceback.print_exc()
                continue
            with self.lock:
                h = (self.pending.get(call_id) if kind == "item"
                     else self.pending.pop(call_id, None))
            if h is None:
                continue
            if kind == "item":
                h._put(value)
                continue
            if kind == "err":
                value = RemoteError(f"{self.name}.{h.method} raised in process "
                                    f"{self.proc.pid}:\n{value}")
            if isinstance(h, _StreamSink):
                h._end(value if kind == "err" else None)
            else:
                h._set(kind == "ok", value)
        self.mark_dead()  # the pipe closed: the process is ending

    def mark_dead(self, why: Optional[str] = None) -> None:
        if why is None:
            why = (f"{self.name} (pid {self.proc.pid}) exited with code "
                   f"{_exit_code(self.proc, KILL_GRACE_S)}")
        with self.lock:
            if self.dead is None:
                self.dead = why
            pending, self.pending = list(self.pending.values()), {}
        registry().set_state(self.actor_id, "DEAD", self.dead)
        for h in pending:
            err = ActorDiedError(f"{self.dead} before {h.method} returned")
            if isinstance(h, _StreamSink):
                h._end(err)
            else:
                h._set(False, err)


# the live actors that lead a process group: ended at the interpreter's
# exit by a hook that runs before multiprocessing's own (registered first),
# which would join them, as they are no daemons, and wait for ever
_GROUP_LEADERS: "weakref.WeakSet" = weakref.WeakSet()


@atexit.register
def _end_group_leaders() -> None:
    for actor in list(_GROUP_LEADERS):
        actor.kill()


class ProcessActor:
    """``cls(*args, **kwargs)`` in a spawned process of its own; ``lease``
    is the card ledger's lease it holds (its card), or None for a CPU
    process that holds nothing; ``max_concurrency`` the calls it runs at
    once (1: one at a time, in order); ``leads_group`` lets it spawn
    processes of its own, which end with it; ``scheduling_strategy``
    places it (a placement group's bundle, in place of a lease)."""

    def __init__(self, cls, args: tuple = (), kwargs: Optional[dict] = None, *,
                 lease: Optional[Lease] = None, name: Optional[str] = None,
                 max_concurrency: int = 1, leads_group: bool = False,
                 scheduling_strategy=None):
        self.name = name or cls.__name__
        self.actor_id = uuid.uuid4().hex
        self._class_name = getattr(cls, "__name__", str(cls))
        try:
            placed = resolve(scheduling_strategy, lease)
            blob = _dumps((cls, tuple(args), dict(kwargs or {})),
                          f"{self.name}'s class and arguments")
            mp = multiprocessing.get_context("spawn")
            calls_r, calls_w = mp.Pipe(duplex=False)
            replies_r, replies_w = mp.Pipe(duplex=False)
            held = placed[2] if placed else lease
            cards = held.cards if held is not None else []
            env = {**process_env(cards, 1), **driver_link.child_env()}
            if placed:
                env.update(placed_env(scheduling_strategy.placement_group, placed[1]))
            self._proc = start_process(
                mp, _actor_main,
                (blob, calls_r, replies_w, not cards, max(1, max_concurrency), leads_group),
                name=self.name, env=env, lease=held, daemon=not leads_group,
                share=placed is not None, log_id=self.actor_id)
        finally:
            if lease is not None:
                lease.release()  # a no-op once the child holds it
        calls_r.close()  # the child holds these ends
        replies_w.close()
        self._calls = calls_w
        self._send_lock = threading.Lock()
        self._next_id = 1
        self._link = _Link(self.name, self._proc, replies_r, self.actor_id)
        self.ready = PendingResult(self, 0, "__init__")
        self._link.pending[0] = self.ready
        reg = registry()
        reg.started(self.actor_id, kind="actor", name=self.name, class_name=self._class_name,
                    pid=self._proc.pid, cards=cards, cpu=held.cpu if held is not None else 0.0,
                    state="PENDING", handle=self,
                    placement_group_id=placed[0].id if placed else None,
                    bundle_index=placed[1] if placed else None)
        if placed:
            placed[0].add_actor(placed[1], self.actor_id)
        self._track(0, f"{self._class_name}.__init__", self.ready)
        self.ready.add_done_callback(_on_ready)
        # what the group spawns leases from the ledger in effect here (a
        # Serve replica receives it), which its end waits on
        self._reaper = weakref.finalize(self, _reap, self._proc, (calls_w, replies_r),
                                        KILL_GRACE_S, default_ledger() if leads_group else None)
        if leads_group:
            _GROUP_LEADERS.add(self)
        threading.Thread(target=self._link.read_loop, name=f"replies-{self.name}",
                         daemon=True).start()

    @property
    def pid(self) -> int:
        return self._proc.pid

    def is_alive(self) -> bool:
        return self._link.dead is None and self._proc.is_alive()

    def call(self, method, *args, **kwargs) -> PendingResult:
        """Send ``method(*args, **kwargs)``: a method of the hosted object
        by name, or a module-level function, run in the process (sent by
        reference); returns its pending result."""
        return self._send(PendingResult, method, args, kwargs)

    def call_stream(self, method, *args, **kwargs) -> StreamResult:
        """Send a generator method (or module-level generator function):
        its chunks arrive on the returned ``StreamResult`` as the child
        produces them. Collecting the result before its end cancels it."""
        h = self._send(StreamResult, method, args, kwargs)
        weakref.finalize(h, _cancel_later, weakref.ref(self), h._sink)
        return h

    def _track(self, call_id: int, name: str, h) -> None:
        """The call's DISPATCHED event now, and its end's when ``h`` ends
        (a stream's sink carries no verdict: FINISHED)."""
        reg, task_id = registry(), f"{self.actor_id}:{call_id}"
        reg.task_event(task_id, name, "DISPATCHED", worker_id=self.actor_id)
        h.add_done_callback(lambda r: reg.task_event(
            task_id, name, "FAILED" if getattr(r, "_ok", True) is False else "FINISHED"))

    def _send(self, kind, method, args, kwargs):
        name = method if isinstance(method, str) else method.__name__
        stream = kind is StreamResult
        with self._send_lock:
            call_id = self._next_id
            self._next_id += 1
        h = kind(self, call_id, name)
        msg = _dumps((call_id, method, args, kwargs, stream, tracing.current_context()),
                     f"the arguments of {self.name}.{name}")
        self._track(call_id, f"{self._class_name}.{name}" if isinstance(method, str) else name, h)
        link = self._link
        with link.lock:
            dead = link.dead
            if dead is None:
                link.pending[call_id] = h._sink if stream else h
        if dead is not None:
            err = ActorDiedError(f"{dead} before {name} returned")
            if stream:
                h._end(err)
            else:
                h._set(False, err)
            return h
        try:
            with self._send_lock:
                self._calls.send_bytes(msg)
        except OSError:  # the pipe is closed: the process is going
            link.mark_dead()
        return h

    def stacks(self) -> PendingResult:
        """Every thread's stack in the actor's process, as text: answered by
        its reader thread, so a call running there (even with
        ``max_concurrency=1``) does not hold it up."""
        with self._send_lock:
            call_id = self._next_id
            self._next_id += 1
        h = PendingResult(self, call_id, "__stacks__")
        link = self._link
        with link.lock:
            dead = link.dead
            if dead is None:
                link.pending[call_id] = h
        if dead is not None:
            h._set(False, ActorDiedError(f"{dead} before its stacks were dumped"))
        else:
            self._control(("stacks", call_id))
        return h

    def bind(self, method: str, *args, **kwargs):
        """A DAG node for ``method(*args, **kwargs)`` on this actor, whose
        arguments may be other nodes (``ray_tpu_torch.dag``)."""
        from ray_tpu_torch.dag.dag_node import ClassMethodNode

        return ClassMethodNode(self, method, args, kwargs)

    def _control(self, msg: tuple) -> None:
        """A stream's acknowledgement or cancellation, or a stack dump's
        request, which the child's reader thread answers; lost if the
        process is gone."""
        data = pickle.dumps(msg)
        try:
            with self._send_lock:
                self._calls.send_bytes(data)
        except OSError:
            pass

    def kill(self) -> None:
        """Terminate the process (then kill it after ``KILL_GRACE_S``); its
        pending results become ``ActorDiedError``."""
        self._reaper()
        self._link.mark_dead(f"{self.name} (pid {self.pid}) was killed")

    def __repr__(self):
        state = "alive" if self.is_alive() else "dead"
        return f"<ProcessActor {self.name} pid={self.pid} {state}>"


def _on_ready(result: PendingResult) -> None:
    """The constructor's end: ALIVE, or DEAD with its error's last line."""
    if result._ok:
        registry().set_state(result.actor.actor_id, "ALIVE")
        return
    lines = str(result._value).strip().splitlines()
    registry().set_state(result.actor.actor_id, "DEAD",
                         lines[-1] if lines else "its constructor raised")


def _cancel_later(actor_ref, sink: _StreamSink) -> None:
    """A ``StreamResult`` was collected: if its stream was still open,
    cancel it from a thread of its own (a finalizer may run on a thread
    that holds the actor's send lock)."""
    actor = actor_ref()
    if actor is None or sink.done:
        return
    try:
        threading.Thread(target=actor._control, args=(("cancel", sink.call_id),),
                         daemon=True).start()
    except RuntimeError:  # the interpreter is shutting down
        pass


def start_all(actors: list) -> list:
    """Wait until every actor is built and return them; if one cannot
    start, kill them all and raise its error (no fallback)."""
    try:
        get([a.ready for a in actors])
    except ActorError:
        for a in actors:
            a.kill()
        raise
    return actors


def wait(handles: list, num_returns: int = 1,
         timeout: Optional[float] = None) -> tuple[list, list]:
    """Wait until ``num_returns`` of ``handles`` are done (a value or an
    error), or ``timeout`` seconds pass. Returns (done, not done), each in
    the order given. Safe from any thread. A compiled DAG's results are
    read here, by the caller, in the order they were submitted."""
    deadline = None if timeout is None else time.monotonic() + timeout
    num_returns = min(num_returns, len(handles))
    for h in handles:
        if sum(x.done for x in handles) >= num_returns:
            break
        if not h.done and hasattr(h, "_drain"):
            try:
                h._drain(None if deadline is None else max(0.0, deadline - time.monotonic()))
            except TimeoutError:
                break
    with _CHANGED:
        while sum(h.done for h in handles) < num_returns:
            left = None if deadline is None else deadline - time.monotonic()
            if left is not None and left <= 0:
                break
            _CHANGED.wait(left)
    done = [h for h in handles if h.done][:num_returns]
    ids = {id(h) for h in done}
    return done, [h for h in handles if id(h) not in ids]


def get(handle, timeout: float = CALL_TIMEOUT_S):
    """The result of one pending call (or any ``Result``: a DAG's), or a
    list's results in order; raises the call's ``ActorError`` (a DAG node's
    own error), or ``TimeoutError`` after ``timeout`` seconds."""
    if isinstance(handle, (list, tuple)):
        deadline = None if timeout is None else time.monotonic() + timeout
        return [get(h, None if deadline is None else max(0.0, deadline - time.monotonic()))
                for h in handle]
    done, _ = wait([handle], 1, timeout)
    if not done:
        raise TimeoutError(f"{handle!r} did not return within {timeout:.0f} s")
    return handle.result()
