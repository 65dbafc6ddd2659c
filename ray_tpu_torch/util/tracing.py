"""Tracing: spans, their context across the port's processes, and the
chrome-trace export.

A copy of ``ray_tpu/util/tracing.py`` (pure Python; the port imports
nothing of ``ray_tpu``), without an OpenTelemetry dependency:

- :func:`span` / :func:`traced` record app spans into this process's
  bounded ring buffer (its drop counter counts what the bound evicted);
  a span parents under the innermost open span, else the context the
  current call carried in;
- a ``ProcessActor`` call carries the caller's :func:`current_context`,
  and the actor's process attaches it around the method
  (``_private/process_actor.py``), so a span opened in the method parents
  under the caller's span;
- the driver's state API (``util/state/api.py:cluster_spans`` /
  ``timeline``) drains each live actor's ring over its pipe and merges it
  with the driver's own into one chrome trace;
- sampling: ``trace_sample_n`` reads ``RAY_TPU_TRACE_SAMPLE_N``, else the
  port's default of 16 (the reference reads its runtime config there); 0
  turns every span off, 1 records every sampled chain. The ring's bound
  reads ``RAY_TPU_TRACE_BUFFER_SIZE``, else 4096.

Context rides a :class:`contextvars.ContextVar`, so spans opened in
concurrent coroutines or threads keep their own parents.
"""

from __future__ import annotations

import contextvars
import itertools
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Callable, Optional

_DEFAULT_BUFFER = 4096
_DEFAULT_SAMPLE_N = 16  # the reference's config default (trace_sample_n)

_spans: deque = deque()
_max_spans: Optional[int] = None  # resolved lazily (config/env)
_dropped = 0
_lock = threading.Lock()
_exporter: Optional[Callable[[dict], None]] = None
_id_counter = itertools.count(1)
# (trace_id, span_id) of the innermost open app span / attached task context.
# A ContextVar (not a threading.local): asyncio tasks copy their context at
# creation, so concurrent coroutines of one async actor keep separate parent
# chains on a single loop thread — a plain thread-local would cross-wire them.
_current: "contextvars.ContextVar[Optional[tuple]]" = contextvars.ContextVar(
    "rtpu_trace_ctx", default=None
)
# Fallback provider for the executing call's context, read when no enclosing
# span set the ContextVar (the port registers none: a ProcessActor's process
# attaches the context its caller sent with the call instead).
_context_provider: Optional[Callable[[], Optional[tuple]]] = None
_sample_n_cache: Optional[int] = None


def set_exporter(fn: Optional[Callable[[dict], None]]):
    """Attach a per-span callback (e.g. an OTLP bridge)."""
    global _exporter
    _exporter = fn


def set_context_provider(fn: Optional[Callable[[], Optional[tuple]]]):
    """Register the executing call's context fallback."""
    global _context_provider
    _context_provider = fn


# ------------------------------------------------------------ ids & context

# getpid() is a syscall — cache it (and refresh in forked children so two
# processes can't mint colliding ids from one cached pid).
_PID = os.getpid()
try:
    os.register_at_fork(
        after_in_child=lambda: globals().__setitem__("_PID", os.getpid())
    )
except AttributeError:  # platform without register_at_fork
    pass


def new_span_id() -> str:
    """Process-unique span id. ``time_ns`` alone collides for spans started
    in the same nanosecond across threads (and across processes started in
    the same tick); the pid + an atomic per-process counter make the id
    collision-free without an os.urandom syscall per span."""
    return f"{time.time_ns():x}-{_PID:x}-{next(_id_counter):x}"


def new_trace_id() -> str:
    return f"t{time.time_ns():x}{_PID:x}{next(_id_counter):x}"


def current_context() -> Optional[tuple]:
    """(trace_id, span_id) of the innermost open app span, else the
    registered fallback's, else None. This is what a ``ProcessActor`` call
    carries to the actor's process."""
    ctx = _current.get()
    if ctx is not None:
        return ctx
    if _context_provider is not None:
        return _context_provider()
    return None


def attach_context(ctx: Optional[tuple]):
    """Set the current (trace_id, span_id) pair; returns a token for
    :func:`detach_context`. Used by the async execution path (per-coroutine
    contexts) and by code that hops executors: capture with
    ``contextvars.copy_context()`` and run the hand-off under it, or attach
    the pair explicitly on the far side."""
    return _current.set(ctx)


def detach_context(token) -> None:
    _current.reset(token)


# ------------------------------------------------------------------ sampling

def trace_sample_n() -> int:
    """The sampling knob (env ``RAY_TPU_TRACE_SAMPLE_N``, else 16): 0
    disables tracing, 1 records every chain, N records 1-in-N chains by
    :func:`sampled`. Cached per process; tests reset via
    :func:`_reset_sampling`."""
    global _sample_n_cache
    if _sample_n_cache is None:
        env = os.environ.get("RAY_TPU_TRACE_SAMPLE_N")
        try:
            _sample_n_cache = max(0, int(env)) if env is not None else _DEFAULT_SAMPLE_N
        except ValueError:
            _sample_n_cache = _DEFAULT_SAMPLE_N
    return _sample_n_cache


def _reset_sampling() -> None:
    global _sample_n_cache, _max_spans
    _sample_n_cache = None
    _max_spans = None


def enabled() -> bool:
    return trace_sample_n() > 0


def sampled(task_id_bin: bytes, n: Optional[int] = None) -> bool:
    """Deterministic per-task sampling decision — every process computes
    the same verdict from the task id, so a sampled task's chain is
    complete instead of randomly holey."""
    if n is None:
        n = trace_sample_n()
    if n <= 0:
        return False
    if n == 1:
        return True
    # stable across processes (Python's hash() is salted per process)
    return int.from_bytes(task_id_bin[:8] or b"\0", "little") % n == 0


# ---------------------------------------------------------------- recording

def _buffer_cap() -> int:
    global _max_spans
    if _max_spans is None:
        env = os.environ.get("RAY_TPU_TRACE_BUFFER_SIZE")
        try:
            _max_spans = max(16, int(env)) if env is not None else _DEFAULT_BUFFER
        except ValueError:
            _max_spans = _DEFAULT_BUFFER
    return _max_spans


def _append(rec: dict) -> None:
    global _dropped
    cap = _buffer_cap()
    with _lock:
        while len(_spans) >= cap:
            _spans.popleft()
            _dropped += 1
        _spans.append(rec)
    if _exporter is not None:
        try:
            _exporter(rec)
        except Exception:  # noqa: BLE001 — exporters must not break tracing
            pass


def record_span(
    name: str,
    start: float,
    end: float,
    *,
    trace_id: Optional[str] = None,
    span_id: Optional[str] = None,
    parent_id: Optional[str] = None,
    plane: Optional[str] = None,
    task_id: Optional[str] = None,
    node: Optional[str] = None,
    **attributes,
) -> Optional[dict]:
    """Record one finished lifecycle span into the process ring buffer.
    ``start``/``end`` are wall-clock seconds; ids default to fresh ones.
    Returns None without recording when tracing is disabled."""
    if not enabled():
        return None
    rec = {
        "name": name,
        "span_id": span_id or new_span_id(),
        "parent_id": parent_id,
        "trace_id": trace_id,
        "plane": plane,
        "task_id": task_id,
        "node": node,
        "pid": _PID,
        "start": start,
        "end": end,
        "attributes": attributes,
    }
    _append(rec)
    return rec


@contextmanager
def span(name: str, **attributes):
    """App-level span: parents under the innermost open span, else the
    executing task's exec span, else roots a fresh trace. A no-op when
    tracing is disabled (``trace_sample_n=0`` means no recording, no
    buffering, no shipping — the off switch is total)."""
    if not enabled():
        yield
        return
    parent_ctx = current_context()
    trace_id = parent_ctx[0] if parent_ctx else new_trace_id()
    parent_id = parent_ctx[1] if parent_ctx else None
    sid = new_span_id()
    token = _current.set((trace_id, sid))
    start = time.time()
    try:
        yield
    finally:
        _current.reset(token)
        record_span(
            name,
            start,
            time.time(),
            trace_id=trace_id,
            span_id=sid,
            parent_id=parent_id,
            plane="app",
            **attributes,
        )


def traced(name: Optional[str] = None):
    """Decorator form of ``span``."""

    def wrap(fn):
        import functools

        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name or fn.__qualname__):
                return fn(*args, **kwargs)

        return inner

    return wrap


def get_spans() -> list[dict]:
    with _lock:
        return list(_spans)


def drain_spans() -> list[dict]:
    """Pop every buffered span (the state API reads a ring with
    :func:`get_spans` and merges by span id instead)."""
    with _lock:
        out = list(_spans)
        _spans.clear()
    return out


def requeue_spans(spans: list[dict]) -> None:
    """Put drained spans back (ship failed — retry next tick). Bounded:
    excess beyond the ring cap is counted into ``dropped_spans``."""
    global _dropped
    cap = _buffer_cap()
    with _lock:
        restored = 0
        for rec in reversed(spans):
            if len(_spans) >= cap:
                _dropped += len(spans) - restored
                break
            _spans.appendleft(rec)
            restored += 1


def dropped_spans() -> int:
    with _lock:
        return _dropped


def clear():
    global _dropped
    with _lock:
        _spans.clear()
        _dropped = 0


# ------------------------------------------------------------------- export

def spans_to_chrome(spans: list[dict], pid_of=None) -> list[dict]:
    """Render span records as chrome-trace complete events. ``pid_of(rec)``
    maps a span to a chrome pid (e.g. a node index); default is the
    recording process's pid."""
    out = []
    for s in spans:
        out.append(
            {
                "name": s["name"],
                "cat": s.get("plane") or "span",
                "ph": "X",
                "ts": s["start"] * 1e6,
                "dur": max((s["end"] - s["start"]) * 1e6, 1),
                "pid": pid_of(s) if pid_of is not None else s.get("pid", 0),
                "tid": s.get("pid", 0),
                "args": {
                    "trace_id": s.get("trace_id"),
                    "span_id": s.get("span_id"),
                    "parent_id": s.get("parent_id"),
                    "task_id": s.get("task_id"),
                    "node": s.get("node"),
                    "plane": s.get("plane"),
                    **(s.get("attributes") or {}),
                },
            }
        )
    return out


def export_chrome_trace(path: Optional[str] = None, include_tasks: bool = True) -> list[dict]:
    """The driver's merged timeline (its actors' calls and every span of
    theirs and its own) as one chrome trace, plus any local span the
    merged view does not carry (dedup by span_id keeps each single)."""
    trace: list = []
    if include_tasks:
        try:
            from ray_tpu_torch.util.state.api import timeline

            trace = timeline()
        except Exception:  # noqa: BLE001 — no driver to reach
            trace = []
    seen = {
        e.get("args", {}).get("span_id")
        for e in trace
        if isinstance(e.get("args"), dict)
    }
    trace.extend(
        spans_to_chrome(
            [s for s in get_spans() if s.get("span_id") not in seen]
        )
    )
    if path:
        import json

        with open(path, "w") as f:
            json.dump(trace, f)
    return trace
