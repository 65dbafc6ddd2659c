"""DeploymentHandle: the client for calling a deployment; a port of
``ray_tpu/serve/handle.py``.

Reference: ``python/ray/serve/handle.py:639`` (``DeploymentHandle``,
``.remote()`` -> ``DeploymentResponse``) and the router's
power-of-two-choices replica scheduler (``_private/router.py:357``).

- *In the driver* (where ``serve.run`` started the controller thread) a
  handle routes itself: it reads the controller's ready replicas (each a
  ``ProcessActor``) whenever the deployment's version moves, picks one by
  P2C on client-side in-flight counts with latency feedback (the JAX
  package's ``_pick_replica``, unchanged), and sends the call down that
  replica's pipe. A completion callback on the call's result takes the
  in-flight count back and feeds the latency estimate (the JAX package's
  drainer thread does this from a ``ray_tpu.wait`` loop).
- *In a replica* (composition: a ``_HandleMarker`` in ``bind`` becomes a
  handle there) the replica cannot reach another replica's pipe: those
  belong to the driver. The handle sends each call to the driver's router
  (``controller.py:RouterServer``, a Unix socket with an authkey), where a
  driver handle routes it by the same policy and the reply, streamed
  chunks included, comes back the same way (``_RouterClient``). One
  routing policy serves both.
- A ``DeploymentResponse`` passed as an argument is resolved to its value
  by the caller before the call is sent (the JAX package forwards its
  object ref, so the value flows replica to replica; the port has no
  object store).
- A replica counts as routable once its constructor has returned (the JAX
  package routes to replicas whose constructor is still running, and
  their calls queue there).
"""

from __future__ import annotations

import itertools
import pickle
import queue
import random
import threading
import time
import traceback
import weakref
from typing import Any, Optional

from ray_tpu_torch._private.process_actor import PendingResult, get
from ray_tpu_torch.serve.streaming import DeploymentResponseGenerator

# Bound on waiting out an empty replica list in ``_pick_replica`` (replica
# restart storm / deployment still rolling out). Module-level so tests can
# shrink it.
_EMPTY_WAIT_DEADLINE_S = 30.0

# Latency-feedback EWMA (see ``_note_latency``): asymmetric smoothing biases
# the estimate toward the TAIL — one slow reply moves the estimate up fast,
# while recovery credits back slowly (reference: the latency-aware replica
# schedulers of serve's request_router/).
_LATENCY_ALPHA_UP = 0.5
_LATENCY_ALPHA_DOWN = 0.05
# Routing floor: below this the latency term is noise vs the in-flight term.
_LATENCY_FLOOR_S = 1e-4
# Per-sample cap: streaming calls sample stream DURATION, and one long-lived
# SSE stream must not mark its replica slow for the next ~1/alpha_down
# fast replies.
_LATENCY_SAMPLE_CAP_S = 5.0
# Tie handling: latency only decides the pick when the scores differ both
# by this ratio AND by this absolute band; near-ties fall back to in-flight
# P2C with a random tie-break, so two equally fast replicas never pin.
_LATENCY_TIE_RATIO = 2.0
_LATENCY_TIE_BAND_S = 0.25
# Exploration: occasionally route on in-flight alone so a replica whose
# EWMA went bad (then recovered) still gets re-sampled.
_LATENCY_EXPLORE_P = 0.05


class _HandleMarker:
    """Serialization marker: an Application arg becomes a handle in the
    replica (composition edge)."""

    def __init__(self, deployment_name: str):
        self.deployment_name = deployment_name


def _resolve_handle_markers(args: tuple, kwargs: dict):
    def conv(v):
        return (
            DeploymentHandle(v.deployment_name)
            if isinstance(v, _HandleMarker)
            else v
        )

    return tuple(conv(a) for a in args), {k: conv(v) for k, v in kwargs.items()}


class DeploymentResponse:
    """Future for one deployment call (reference: ``handle.py``
    DeploymentResponse). Passed to another ``.remote`` it is resolved to
    its value first."""

    def __init__(self, pending):
        self._pending = pending  # a PendingResult, or a _RemoteCall in a replica

    def result(self, timeout_s: Optional[float] = None):
        if isinstance(self._pending, PendingResult):
            return get(self._pending, timeout=timeout_s)
        return self._pending.result(timeout_s)


def _resolve_args(args: tuple, kwargs: dict) -> tuple[tuple, dict]:
    args = tuple(a.result() if isinstance(a, DeploymentResponse) else a for a in args)
    kwargs = {k: (v.result() if isinstance(v, DeploymentResponse) else v)
              for k, v in kwargs.items()}
    return args, kwargs


# -- the router client (in a replica) ----------------------------------------

# set by a replica's constructor: (address, authkey) of the driver's router
_ROUTER_ADDRESS: Optional[tuple] = None
_router: Optional["_RouterClient"] = None
_router_lock = threading.Lock()


def _router_client() -> Optional["_RouterClient"]:
    global _router
    if _ROUTER_ADDRESS is None:
        return None
    with _router_lock:
        if _router is None:
            _router = _RouterClient(*_ROUTER_ADDRESS)
        return _router


class _RemoteCall:
    """A unary call relayed through the driver's router."""

    def __init__(self):
        self._event = threading.Event()
        self._ok, self._value = False, None

    def _set(self, ok: bool, value) -> None:
        self._ok, self._value = ok, value
        self._event.set()

    def result(self, timeout_s: Optional[float] = None):
        if not self._event.wait(timeout_s):
            raise TimeoutError(f"deployment call did not return within {timeout_s} s")
        if not self._ok:
            raise self._value
        return self._value


class _RemoteStream:
    """A streamed call relayed through the driver's router; collecting it
    before its end cancels the producer."""

    _END = ("__end__",)

    def __init__(self, client: "_RouterClient", req_id: int):
        self._client, self._req_id = client, req_id
        self._items: queue.SimpleQueue = queue.SimpleQueue()
        self.done = False
        self._state = {"done": False}
        weakref.finalize(self, _cancel_relayed, client, req_id, self._state)

    def _put(self, item) -> None:
        self._items.put(item)

    def _end(self, error) -> None:
        self.done = self._state["done"] = True
        self._items.put((self._END, error))

    def next(self, timeout: Optional[float] = None):
        try:
            item = self._items.get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError(f"no stream chunk within {timeout} s") from None
        if isinstance(item, tuple) and len(item) == 2 and item[0] is self._END:
            self._items.put(item)  # later calls end the same way
            if item[1] is not None:
                raise item[1]
            raise StopIteration
        return item

    def cancel(self) -> None:
        if not self.done:
            self._client.send(("cancel", self._req_id))


def _cancel_relayed(client: "_RouterClient", req_id: int, state: dict) -> None:
    if not state["done"]:
        try:
            threading.Thread(target=client.send, args=(("cancel", req_id),),
                             daemon=True).start()
        except RuntimeError:  # the interpreter is shutting down
            pass


class _RouterClient:
    """A replica's one connection to the driver's router: calls go out
    under request ids, a reader thread routes the replies back."""

    def __init__(self, address: str, authkey: bytes):
        from multiprocessing.connection import Client

        self._conn = Client(address, family="AF_UNIX", authkey=authkey)
        self._send_lock = threading.Lock()
        self._ids = itertools.count(1)
        self._pending: dict[int, Any] = {}
        self._lock = threading.Lock()
        threading.Thread(target=self._read, name="serve-router-client", daemon=True).start()

    def send(self, msg) -> None:
        data = pickle.dumps(msg)
        with self._send_lock:
            self._conn.send_bytes(data)

    def _submit(self, kind: str, req_id: int, entry, deployment: str, method: str, args,
                kwargs) -> None:
        data = pickle.dumps((kind, req_id, deployment, method, args, kwargs))
        with self._lock:
            self._pending[req_id] = entry
        with self._send_lock:
            self._conn.send_bytes(data)

    def call(self, deployment: str, method: str, args, kwargs) -> _RemoteCall:
        out = _RemoteCall()
        self._submit("call", next(self._ids), out, deployment, method, args, kwargs)
        return out

    def stream(self, deployment: str, method: str, args, kwargs) -> _RemoteStream:
        req_id = next(self._ids)
        out = _RemoteStream(self, req_id)
        # held weakly: a stream its consumer dropped is collected (and cancelled)
        self._submit("stream", req_id, weakref.ref(out), deployment, method, args, kwargs)
        return out

    def _read(self) -> None:
        while True:
            try:
                req_id, kind, value = self._conn.recv()
            except (EOFError, OSError):
                break
            except Exception:  # a reply that did not unpickle here: it is lost
                traceback.print_exc()
                continue
            with self._lock:
                obj = (self._pending.get(req_id) if kind == "item"
                       else self._pending.pop(req_id, None))
            if isinstance(obj, weakref.ref):
                obj = obj()
            if obj is None:
                continue
            if isinstance(obj, _RemoteCall):
                obj._set(kind == "ok", value)
            elif kind == "item":
                obj._put(value)
            else:
                obj._end(value if kind == "err" else None)
        with self._lock:
            pending, self._pending = list(self._pending.values()), {}
        err = RuntimeError("the serve driver's router closed")
        for obj in pending:
            if isinstance(obj, weakref.ref):
                obj = obj()
            if isinstance(obj, _RemoteCall):
                obj._set(False, err)
            elif obj is not None:
                obj._end(err)


# -- the handle ------------------------------------------------------------------


class _MethodCaller:
    def __init__(self, handle: "DeploymentHandle", method: str):
        self._handle = handle
        self._method = method

    def remote(self, *args, **kwargs):
        if getattr(self._handle, "_stream", False):
            return self._handle._call_streaming(self._method, args, kwargs)
        return self._handle._call(self._method, args, kwargs)


def _rebuild_handle(deployment_name: str, stream: bool) -> "DeploymentHandle":
    h = DeploymentHandle(deployment_name)
    return h.options(stream=True) if stream else h


def _controller():
    from ray_tpu_torch.serve import api

    return api._controller


class DeploymentHandle:
    def __init__(self, deployment_name: str):
        self.deployment_name = deployment_name
        self._replicas: list = []  # [(replica name, ProcessActor)], ready ones
        self._inflight: dict[str, int] = {}
        self._lock = threading.Lock()
        self._applied_version: Optional[int] = None
        # replica name -> EWMA of client-observed reply latency (seconds);
        # shared with the stream/unary variant (options()) like _inflight
        self._latency: dict[str, float] = {}
        # the empty-replica wait: waiters park on the controller's change
        # condition; the gate single-flights the forced refresh
        self._refresh_gate = threading.Lock()
        self._refresh_stats = {"calls": 0}  # dict: shared across variants

    # -- replica cache ------------------------------------------------------

    def _refresh(self, force: bool = False):
        ctrl = _controller()
        if ctrl is None:
            raise RuntimeError("serve is not running (no controller); call serve.run first")
        version = ctrl.replica_version(self.deployment_name)
        if not force and version == self._applied_version:
            return
        self._refresh_stats["calls"] += 1
        version, replicas = ctrl.get_replicas_versioned(self.deployment_name)
        self._apply(replicas, version)

    def _apply(self, replicas: list, version: int):
        with self._lock:
            self._applied_version = version
            self._replicas = replicas
            # mutate in place: the dict is shared with the stream/unary
            # variant handle (options(stream=...)) for combined P2C counts
            keep = {n for n, _ in replicas}
            for n in list(self._inflight):
                if n not in keep:
                    del self._inflight[n]
            for n in list(self._latency):
                if n not in keep:
                    del self._latency[n]
            for n in keep:
                self._inflight.setdefault(n, 0)

    # -- routing ------------------------------------------------------------

    def _pick_replica(self):
        """Power-of-two-choices on client-side in-flight counts, fed by
        the latency estimate; waits out an empty replica list."""
        self._refresh()
        with self._lock:
            # a replica whose process is gone waits for the controller's
            # health check to replace it; route around it meanwhile
            replicas = [r for r in self._replicas if r[1].is_alive()]
        if not replicas:
            replicas = self._wait_for_replicas()
        if len(replicas) == 1:
            return replicas[0]
        a, b = random.sample(replicas, 2)
        with self._lock:
            ia = self._inflight.get(a[0], 0)
            ib = self._inflight.get(b[0], 0)
            la = self._latency.get(a[0])
            lb = self._latency.get(b[0])
        if (
            la is None
            or lb is None
            or random.random() < _LATENCY_EXPLORE_P
        ):
            # no latency signal for one of the pair yet (fresh replica) or
            # an exploration probe: classic P2C on in-flight counts with a
            # random tie-break — the probed replica earns a fresh estimate
            if ia != ib:
                return a if ia < ib else b
            return a if random.random() < 0.5 else b
        # latency-feedback P2C: expected-wait score = (queue + 1) x the
        # tail-biased latency estimate; only a DECISIVE gap routes on it
        sa = (ia + 1) * max(la, _LATENCY_FLOOR_S)
        sb = (ib + 1) * max(lb, _LATENCY_FLOOR_S)
        lo, hi = (sa, sb) if sa <= sb else (sb, sa)
        if hi - lo >= _LATENCY_TIE_BAND_S and hi >= lo * _LATENCY_TIE_RATIO:
            return a if sa <= sb else b
        if ia != ib:
            return a if ia < ib else b
        return a if random.random() < 0.5 else b

    def _wait_for_replicas(self) -> list:
        """Wait out an empty replica list (rollout, restart storm). One
        forced refresh at a time (the gate), with jittered exponential
        backoff between attempts; every waiter parks on the controller's
        change condition, which a replica becoming ready (or going) wakes."""
        deadline = time.monotonic() + _EMPTY_WAIT_DEADLINE_S
        backoff = 0.05
        while True:
            with self._lock:
                live = [r for r in self._replicas if r[1].is_alive()]
            if live:
                return live
            now = time.monotonic()
            if now > deadline:
                raise RuntimeError(
                    f"no replicas for deployment {self.deployment_name!r}"
                )
            ctrl = _controller()
            if ctrl is None:
                raise RuntimeError("serve is not running (no controller)")
            wait_s = min(backoff * (1.0 + random.random()), max(0.05, deadline - now))
            if self._refresh_gate.acquire(blocking=False):
                try:
                    self._refresh(force=True)
                    with self._lock:
                        if any(r[1].is_alive() for r in self._replicas):
                            continue
                    # pace the NEXT forced refresh while parked on the
                    # controller's change condition (a change still wakes us)
                    ctrl.wait_for_change(self.deployment_name, self._applied_version, wait_s)
                finally:
                    self._refresh_gate.release()
            else:
                ctrl.wait_for_change(self.deployment_name, self._applied_version, wait_s)
                self._refresh()  # fetches only if the version moved
            backoff = min(backoff * 2.0, 1.0)

    def _note_latency(self, name: str, sample_s: float):
        """Fold one client-observed reply latency into the replica's EWMA
        (callers hold self._lock). Asymmetric: jumps up fast, recovers
        slowly — a tail-biased estimate (see _LATENCY_ALPHA_UP)."""
        sample_s = min(sample_s, _LATENCY_SAMPLE_CAP_S)
        prev = self._latency.get(name)
        if prev is None:
            self._latency[name] = sample_s
        else:
            alpha = (
                _LATENCY_ALPHA_UP if sample_s > prev else _LATENCY_ALPHA_DOWN
            )
            self._latency[name] = prev + alpha * (sample_s - prev)

    def _done_callback(self, name: str):
        t0 = time.monotonic()

        def done(_result):
            with self._lock:
                self._inflight[name] = max(0, self._inflight.get(name, 1) - 1)
                if name in self._inflight:
                    self._note_latency(name, max(time.monotonic() - t0, 0.0))

        return done

    def _call(self, method: str, args: tuple, kwargs: dict) -> DeploymentResponse:
        args, kwargs = _resolve_args(args, kwargs)
        client = None if _controller() is not None else _router_client()
        if client is not None:
            return DeploymentResponse(client.call(self.deployment_name, method, args, kwargs))
        name, actor = self._pick_replica()
        with self._lock:
            self._inflight[name] = self._inflight.get(name, 0) + 1
        done = self._done_callback(name)
        try:
            pending = actor.call("handle_request", method, *args, **kwargs)
        except Exception:
            done(None)
            raise
        pending.add_done_callback(done)
        return DeploymentResponse(pending)

    def _open_stream(self, method: str, args: tuple, kwargs: dict):
        """The streamed call's raw chunks (``StreamStart`` included): a
        ``StreamResult`` in the driver, a ``_RemoteStream`` in a replica."""
        args, kwargs = _resolve_args(args, kwargs)
        client = None if _controller() is not None else _router_client()
        if client is not None:
            return client.stream(self.deployment_name, method, args, kwargs)
        name, actor = self._pick_replica()
        with self._lock:
            self._inflight[name] = self._inflight.get(name, 0) + 1
        done = self._done_callback(name)
        try:
            stream = actor.call_stream("handle_request_streaming", method, *args, **kwargs)
        except Exception:
            done(None)
            raise
        stream.add_done_callback(done)
        return stream

    def _call_streaming(self, method: str, args: tuple, kwargs: dict):
        """Streaming call (reference: ``handle.options(stream=True)``): the
        replica's generator runs as a streamed call; chunks are consumable
        as they are produced. Dropping the generator mid-stream cancels
        the producer, and the in-flight count comes back when it ends."""
        return DeploymentResponseGenerator(self._open_stream(method, args, kwargs))

    def broadcast(self, method: str, *args, timeout_s: float = 120.0, **kwargs):
        """Call ``method`` on EVERY replica and return all results — for
        replica-state pushes (e.g. ``load_lora``) where routing to one
        replica would leave the others inconsistent. Driver only."""
        self._refresh(force=True)
        with self._lock:
            replicas = list(self._replicas)
        if not replicas:
            raise RuntimeError(
                f"no replicas for deployment {self.deployment_name!r}"
            )
        args, kwargs = _resolve_args(args, kwargs)
        pending = [actor.call("handle_request", method, *args, **kwargs)
                   for _, actor in replicas]
        return get(pending, timeout=timeout_s)

    def remote(self, *args, **kwargs):
        if getattr(self, "_stream", False):
            return self._call_streaming("__call__", args, kwargs)
        return self._call("__call__", args, kwargs)

    def __getattr__(self, item: str) -> _MethodCaller:
        if item.startswith("_") or item in ("deployment_name", "remote"):
            raise AttributeError(item)
        return _MethodCaller(self, item)

    def options(self, *, stream: bool = False, **_kwargs) -> "DeploymentHandle":
        if stream == getattr(self, "_stream", False):
            return self
        # cache the variant under the lock: options() runs per request in the
        # proxy; the variant SHARES this handle's lock, in-flight counts and
        # latency estimates so P2C sees combined stream+unary load
        with self._lock:
            cached = getattr(self, "_variant", None)
            if cached is None:
                h = DeploymentHandle(self.deployment_name)
                h._stream = stream
                h._lock = self._lock
                h._inflight = self._inflight
                h._latency = self._latency
                h._refresh_gate = self._refresh_gate
                h._refresh_stats = self._refresh_stats
                h._variant = self
                self._variant = h
                cached = h
        return cached

    def __reduce__(self):
        # the stream flag must survive pickling (a handle.options(stream=
        # True) passed into another deployment stays a streaming handle)
        return (_rebuild_handle, (self.deployment_name, getattr(self, "_stream", False)))

    def __repr__(self):
        return f"DeploymentHandle({self.deployment_name!r})"
