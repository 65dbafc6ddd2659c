"""A process handle: one spawned process hosting one object.

The port's stand-in for what ``ray_tpu.remote(cls)`` gives the JAX
package's RLlib (an actor, ``ray_tpu/rllib/env/env_runner.py:332-335``).
RLlib's remote env runners, remote learners and SAC's runners run on it.

    actor = ProcessActor(SingleAgentEnvRunner, ("CartPole-v1", spec), {"seed": 1})
    h = actor.call("sample")          # a PendingResult, at once
    out = get(h)                      # the method's return value
    n = get(actor.call(launch_counts))  # a module-level function, run there
    ready, rest = wait([h1, h2], num_returns=1, timeout=60.0)
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
  by reference, run in the process on its arguments alone) and run in the
  order they were sent: a ``set_weights`` lands before the ``sample`` sent
  after it. A reader thread in the child keeps taking calls while a method
  runs, so a large call never waits on a large reply.
- *Failures.* A method that raises comes back as ``RemoteError`` with the
  child's traceback. A process that dies turns each of its pending results
  into ``ActorDiedError`` as soon as a ``get`` or ``wait`` sees its pipe
  close or its sentinel fire (the JAX package waits out its ``get``
  timeout). Construction is call 0 (``actor.ready``); if it raises, the
  process sends the error and exits.
- *Lifetime.* ``kill()`` terminates, joins with a deadline, then kills. A
  finalizer does the same when the handle is collected or the interpreter
  exits, and the process is a daemon besides: none outlives its owner.

One thread drives a set of actors: ``get`` and ``wait`` read the pipes
of the actors they wait on.
"""

from __future__ import annotations

import multiprocessing
import pickle
import threading
import time
import traceback
import weakref
from multiprocessing.connection import wait as _wait_ready
from typing import Any, Optional

from ray_tpu_torch._private.cards import Lease
from ray_tpu_torch._private.spawn_env import process_env, start_process

# the JAX package's deadline on a remote runner's sample
# (ray_tpu/rllib/env/env_runner.py:405)
CALL_TIMEOUT_S = 300.0
# terminate -> kill, and kill -> reaped
KILL_GRACE_S = 10.0


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


class PendingResult:
    """One call's result, filled in when its reply arrives."""

    __slots__ = ("actor", "call_id", "method", "done", "_ok", "_value")

    def __init__(self, actor: "ProcessActor", call_id: int, method: str):
        self.actor, self.call_id, self.method = actor, call_id, method
        self.done, self._ok, self._value = False, False, None

    def _set(self, ok: bool, value) -> None:
        self.done, self._ok, self._value = True, ok, value

    def result(self):
        if not self._ok:
            raise self._value
        return self._value

    def __repr__(self):
        state = "done" if self.done else "pending"
        return f"<PendingResult {self.actor.name}.{self.method} #{self.call_id} {state}>"


def _actor_main(blob: bytes, calls, replies, one_thread: bool) -> None:
    """The child's body: build the object, then run calls in order until
    the parent closes the call pipe."""
    import queue

    if one_thread:
        import torch

        torch.set_num_threads(1)
    inbox: queue.SimpleQueue = queue.SimpleQueue()

    def read():
        try:
            while True:
                inbox.put(calls.recv_bytes())
        except (EOFError, OSError):
            inbox.put(None)

    threading.Thread(target=read, name="calls", daemon=True).start()
    try:
        cls, args, kwargs = pickle.loads(blob)
        obj = cls(*args, **kwargs)
    except Exception:
        replies.send((0, False, traceback.format_exc()))
        return
    replies.send((0, True, None))
    while (msg := inbox.get()) is not None:
        call_id, method, args, kwargs = pickle.loads(msg)
        fn = getattr(obj, method) if isinstance(method, str) else method
        try:
            reply = (call_id, True, fn(*args, **kwargs))
        except Exception:
            reply = (call_id, False, traceback.format_exc())
        try:
            replies.send(reply)
        except (pickle.PicklingError, AttributeError, TypeError):
            # the return value did not pickle (send pickles before writing)
            replies.send((call_id, False, traceback.format_exc()))


def _reap(proc, conns, grace_s: float) -> None:
    """Terminate, join with a deadline, kill; close the pipes."""
    if proc.is_alive():
        proc.terminate()
        proc.join(grace_s)
    if proc.is_alive():
        proc.kill()
        proc.join(grace_s)
    for c in conns:
        c.close()


class ProcessActor:
    """``cls(*args, **kwargs)`` in a spawned process of its own; ``lease``
    is the card ledger's lease it holds (its card), or None for a CPU
    process that holds nothing."""

    def __init__(self, cls, args: tuple = (), kwargs: Optional[dict] = None, *,
                 lease: Optional[Lease] = None, name: Optional[str] = None):
        self.name = name or cls.__name__
        try:
            blob = _dumps((cls, tuple(args), dict(kwargs or {})),
                          f"{self.name}'s class and arguments")
            mp = multiprocessing.get_context("spawn")
            calls_r, calls_w = mp.Pipe(duplex=False)
            replies_r, replies_w = mp.Pipe(duplex=False)
            cards = lease.cards if lease is not None else []
            self._proc = start_process(mp, _actor_main, (blob, calls_r, replies_w, not cards),
                                       name=self.name, env=process_env(cards, 1), lease=lease,
                                       daemon=True)
        finally:
            if lease is not None:
                lease.release()  # a no-op once the child holds it
        calls_r.close()  # the child holds these ends
        replies_w.close()
        self._calls, self._replies = calls_w, replies_r
        self._next_id = 1
        self._dead: Optional[str] = None
        self.ready = PendingResult(self, 0, "__init__")
        self._pending: dict[int, PendingResult] = {0: self.ready}
        self._reaper = weakref.finalize(self, _reap, self._proc, (calls_w, replies_r),
                                        KILL_GRACE_S)

    @property
    def pid(self) -> int:
        return self._proc.pid

    def is_alive(self) -> bool:
        return self._dead is None and self._proc.is_alive()

    def call(self, method, *args, **kwargs) -> PendingResult:
        """Send ``method(*args, **kwargs)``: a method of the hosted object
        by name, or a module-level function, run in the process (sent by
        reference); returns its pending result."""
        name = method if isinstance(method, str) else method.__name__
        h = PendingResult(self, self._next_id, name)
        self._next_id += 1
        msg = _dumps((h.call_id, method, args, kwargs), f"the arguments of {self.name}.{name}")
        if self._dead is not None:
            h._set(False, ActorDiedError(self._dead))
            return h
        self._pending[h.call_id] = h
        try:
            self._calls.send_bytes(msg)
        except OSError:
            self._drain()
            self._mark_dead()
        return h

    def kill(self) -> None:
        """Terminate the process (then kill it after ``KILL_GRACE_S``); its
        pending results become ``ActorDiedError``."""
        self._reaper()
        self._mark_dead(f"{self.name} (pid {self.pid}) was killed")

    # -- replies ----------------------------------------------------------

    def _readable(self) -> list:
        return [self._replies, self._proc.sentinel]

    def _drain(self) -> None:
        """Take every reply that has arrived; at end of file (the process
        has gone) fail what is still pending."""
        if self._dead is not None:
            return
        # read before draining: a process seen exited here has all its
        # replies in the pipe, so the drain below takes them
        exited = self._proc.exitcode is not None
        try:
            while self._replies.poll():
                call_id, ok, value = self._replies.recv()
                h = self._pending.pop(call_id, None)
                if h is None:
                    continue
                if not ok:
                    value = RemoteError(f"{self.name}.{h.method} raised in process "
                                        f"{self.pid}:\n{value}")
                h._set(ok, value)
        except (EOFError, OSError):
            self._mark_dead()
            return
        if exited:
            self._mark_dead()

    def _mark_dead(self, why: Optional[str] = None) -> None:
        if self._dead is None:
            self._dead = why or (f"{self.name} (pid {self.pid}) exited with code "
                                 f"{self._proc.exitcode}")
        for h in self._pending.values():
            h._set(False, ActorDiedError(f"{self._dead} before {h.method} returned"))
        self._pending.clear()

    def __repr__(self):
        state = "alive" if self.is_alive() else "dead"
        return f"<ProcessActor {self.name} pid={self.pid} {state}>"


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
    the order given."""
    deadline = None if timeout is None else time.monotonic() + timeout
    while sum(h.done for h in handles) < num_returns:
        left = None if deadline is None else max(0.0, deadline - time.monotonic())
        owners: dict[Any, ProcessActor] = {}
        for h in handles:
            if not h.done:
                owners.update(dict.fromkeys(h.actor._readable(), h.actor))
        if not owners:  # fewer handles than num_returns, all done
            break
        for obj in _wait_ready(list(owners), left):
            owners[obj]._drain()
        if left == 0.0:  # the deadline passed: one look at the pipes, no wait
            break
    done = [h for h in handles if h.done][:num_returns]
    ids = {id(h) for h in done}
    return done, [h for h in handles if id(h) not in ids]


def get(handle, timeout: float = CALL_TIMEOUT_S):
    """The result of one pending call, or a list's results in order; raises
    the call's ``ActorError``, or ``TimeoutError`` after ``timeout``
    seconds."""
    if isinstance(handle, (list, tuple)):
        deadline = time.monotonic() + timeout
        return [get(h, max(0.0, deadline - time.monotonic())) for h in handle]
    done, _ = wait([handle], 1, timeout)
    if not done:
        raise TimeoutError(f"{handle!r} did not return within {timeout:.0f} s")
    return handle.result()
