"""Compiled DAG: shared-memory channels and persistent loops in the actors.

The port's counterpart of ``ray_tpu/dag/compiled_dag.py``. Compiling an
all-actor graph makes a channel (``experimental/channel.py``, a ring under
``/dev/shm``) for every edge that crosses from one actor to another, from
the driver to an actor and from an actor to the driver, and starts one
loop in each actor's process, on a thread of its own, holding the hosted
object (an ``OnInstance`` call, the reference's ``_call_fn``): the actor
keeps serving its normal calls, even with ``max_concurrency=1``. Each
``execute`` then writes the input into the entry channels and returns a
``CompiledDAGRef`` whose value the caller reads from the exit channels:
no call is sent and nothing is pickled twice on the way.

- *One tick a run.* A loop reads each of its input channels once, runs its
  nodes in order (an edge between two nodes of one actor passes the value
  in place) and writes each output channel once. Results come back in the
  order of the ``execute`` calls; a ``get`` that timed out can be retried
  (what was read stays read).
- *Errors.* A method that raises sends a ``DAGError`` down its edges in
  place of its value; the nodes after it pass it on without running, and
  ``get`` raises the error as the method raised it. The loops go on: the
  next ``execute`` runs as if nothing had happened.
- *Teardown* closes every data channel (each loop sees the end at its
  next read or write, closes its outputs and acknowledges on a channel of
  its own), waits for the acknowledgements, then destroys every channel:
  none is left under ``/dev/shm``.
- *Graphs with function nodes* run the per-execute plan (an eager run,
  ``dag_node.execute_nodes``), as the reference runs them. An all-actor
  graph never does: if its channels cannot be made, or a loop cannot
  start, compiling raises.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Any, Optional

from ray_tpu_torch._private.process_actor import OnInstance, Result, get
from ray_tpu_torch.dag.dag_node import (ClassMethodNode, DAGError, DAGNode, FunctionNode,
                                        InputAttributeNode, InputNode, MultiOutputNode,
                                        execute_nodes, input_value)
from ray_tpu_torch.experimental.channel import Channel, ChannelClosedError

LOOP_START_S = 60.0  # the loops' start, each a call to its actor
INPUT_WRITE_S = 60.0  # an execute's wait for room in an entry channel
TEARDOWN_ACK_S = 10.0  # teardown's wait for the loops' acknowledgements, together


def _write(ch: Channel, value, node_name: str) -> None:
    """Write ``value``; one that does not fit or pickle goes as its error."""
    try:
        ch.write(value)
    except (ValueError, TypeError, AttributeError) as e:
        if isinstance(value, DAGError):
            e = RuntimeError(f"{node_name}'s error did not pickle: {value.err!r}")
        ch.write(DAGError(e, node_name))


def _start_loop(instance, node_specs: list, close_channels: list, exit_ch: Channel) -> bool:
    """In an actor's process: start its loop on a thread of its own; the
    thread acknowledges its end on ``exit_ch``."""

    mapped = {id(c): c for c in close_channels + [exit_ch]}
    for _, arg_plan, kwarg_plan, _ in node_specs:
        mapped.update({id(v): v for kind, v in arg_plan + list(kwarg_plan.values())
                       if kind == "chan"})

    def run():
        try:
            _loop(instance, node_specs, close_channels)
        finally:
            try:
                exit_ch.write(True, timeout_s=5)
            except (ChannelClosedError, TimeoutError, OSError):
                pass
            for ch in mapped.values():  # this process's mappings and doorbells
                ch.release()

    threading.Thread(target=run, daemon=True, name="dag-loop").start()
    return True


def _loop(instance, node_specs: list, close_channels: list) -> None:
    """The loop (see the module's text). ``node_specs``: this actor's nodes
    in topological order, each (method, arg plan, kwarg plan, output
    channels); a plan entry is ("chan", Channel), ("const", value) or
    ("local", i), the i-th node's output of the same tick."""

    def resolve(plan, outs):
        return [v.read() if kind == "chan" else outs[v] if kind == "local" else v
                for kind, v in plan]

    try:
        while True:
            outs: list[Any] = []
            for method, arg_plan, kwarg_plan, out_channels in node_specs:
                args = resolve(arg_plan, outs)
                kwargs = dict(zip(kwarg_plan, resolve(list(kwarg_plan.values()), outs)))
                err = next((a for a in args + list(kwargs.values()) if isinstance(a, DAGError)),
                           None)
                if err is not None:
                    out = err
                else:
                    try:
                        out = getattr(instance, method)(*args, **kwargs)
                    except Exception as e:  # noqa: BLE001 — goes down the edges
                        out = DAGError(e, method)
                outs.append(out)
                for ch in out_channels:
                    _write(ch, out, method)
    except ChannelClosedError:
        return  # teardown
    finally:
        for ch in close_channels:
            ch.close()


class CompiledDAGRef(Result):
    """One ``execute``'s result (the reference's ``CompiledDAGRef``): read
    from the exit channels by whoever waits on it."""

    __slots__ = ("_dag",)

    def __init__(self, dag: "CompiledDAG"):
        super().__init__()
        self._dag = dag

    def _drain(self, timeout: Optional[float]) -> None:
        self._dag._drain_until(self, timeout)

    def __repr__(self):
        return f"<CompiledDAGRef {'done' if self.done else 'pending'}>"


def _destroy(channels: list) -> None:
    for ch in channels:
        ch.destroy()


class CompiledDAG:
    def __init__(self, root: DAGNode, *, buffer_size_bytes: int = 4 << 20):
        self._root = root
        self._schedule = root.topological()
        self._channel_mode = not any(isinstance(n, FunctionNode) for n in self._schedule)
        self._torn_down = False
        self._write_lock = threading.Lock()  # an execute's input writes
        self._read_lock = threading.Lock()  # the exit channels' reads
        self._pending: list[CompiledDAGRef] = []
        self._partial_outs: list = []
        self._all_channels: list[Channel] = []
        self._exit_acks: list[tuple] = []  # (actor, ack channel)
        self._finalizer = weakref.finalize(self, _destroy, self._all_channels)
        if self._channel_mode:
            try:
                self._compile_channels(buffer_size_bytes)
            except BaseException:
                self._close_channels()
                self._finalizer()  # destroys every channel made
                raise

    # -- compiling ------------------------------------------------------------

    def _new_channel(self, slot_size: int, num_slots: int = 2) -> Channel:
        ch = Channel.create(slot_size=slot_size, num_slots=num_slots)
        self._all_channels.append(ch)
        return ch

    def _compile_channels(self, buffer_size_bytes: int) -> None:
        actor_nodes = [n for n in self._schedule if isinstance(n, ClassMethodNode)]
        if not actor_nodes:
            raise ValueError("a compiled DAG needs at least one actor node")
        self._driver_out: list[tuple] = []  # (input node, channel)
        producer_outs: dict[int, list] = {id(n): [] for n in actor_nodes}
        per_actor_index: dict[int, int] = {}
        by_actor: dict[str, list] = {}
        for n in actor_nodes:
            nodes = by_actor.setdefault(n._actor.actor_id, [])
            per_actor_index[id(n)] = len(nodes)
            nodes.append(n)

        def edge(consumer: ClassMethodNode, arg):
            if not isinstance(arg, DAGNode):
                return ("const", arg)
            if isinstance(arg, (InputNode, InputAttributeNode)):
                ch = self._new_channel(buffer_size_bytes)
                self._driver_out.append((arg, ch))
                return ("chan", ch)
            if isinstance(arg, ClassMethodNode):
                if arg._actor.actor_id == consumer._actor.actor_id:
                    return ("local", per_actor_index[id(arg)])
                ch = self._new_channel(buffer_size_bytes)
                producer_outs[id(arg)].append(ch)
                return ("chan", ch)
            raise ValueError(f"a compiled DAG cannot take a {type(arg).__name__} as an argument")

        plans = {id(n): ([edge(n, a) for a in n._bound_args],
                         {k: edge(n, v) for k, v in n._bound_kwargs.items()})
                 for n in actor_nodes}
        outputs = (list(self._root._bound_args) if isinstance(self._root, MultiOutputNode)
                   else [self._root])
        self._exit_channels = []
        for out in outputs:
            if not isinstance(out, ClassMethodNode):
                raise ValueError("a compiled DAG's outputs must be actor nodes")
            ch = self._new_channel(buffer_size_bytes)
            producer_outs[id(out)].append(ch)
            self._exit_channels.append(ch)
        # every loop's plan is checked before any loop starts
        to_start = []
        for nodes in by_actor.values():
            specs, inputs = [], 0
            for n in nodes:
                arg_plan, kwarg_plan = plans[id(n)]
                inputs += sum(kind == "chan" for kind, _ in arg_plan + list(kwarg_plan.values()))
                specs.append((n._method, arg_plan, kwarg_plan, producer_outs[id(n)]))
            if not inputs:
                raise ValueError(f"{nodes[0]._actor.name}'s nodes read no channel: its loop "
                                 "would run free (bind the InputNode or another actor's node)")
            close = [ch for n in nodes for ch in producer_outs[id(n)]]
            to_start.append((nodes[0]._actor, specs, close))
        starts = []
        for actor, specs, close in to_start:
            ack = self._new_channel(64, num_slots=1)
            self._exit_acks.append((actor, ack))
            starts.append(actor.call(OnInstance(_start_loop, "dag_loop"), specs, close, ack))
        get(starts, timeout=LOOP_START_S)  # a loop that cannot start fails the compile
        self._multi_output = isinstance(self._root, MultiOutputNode)

    # -- running --------------------------------------------------------------

    def execute(self, *input_args, **input_kwargs):
        if self._torn_down:
            raise RuntimeError("CompiledDAG was torn down")
        if not self._channel_mode:
            return execute_nodes(self._schedule, input_args, input_kwargs)
        base = input_value(input_args, input_kwargs)
        with self._write_lock:
            for src, ch in self._driver_out:
                ch.write(src.select(base) if isinstance(src, InputAttributeNode) else base,
                         timeout_s=INPUT_WRITE_S)
            res = CompiledDAGRef(self)
            self._pending.append(res)
        return res

    def _drain_until(self, ref: CompiledDAGRef, timeout: Optional[float]) -> None:
        """Complete the pending results, oldest first, until ``ref`` is
        done; raise ``TimeoutError`` after ``timeout`` (what was read stays
        read, so a retry resumes where this one stopped)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        if not self._read_lock.acquire(timeout=-1 if timeout is None else timeout):
            raise TimeoutError("another thread is reading this DAG's results")
        try:
            while not ref.done:
                if not self._pending:
                    raise RuntimeError("no pending compiled-DAG executions")
                while len(self._partial_outs) < len(self._exit_channels):
                    ch = self._exit_channels[len(self._partial_outs)]
                    left = None if deadline is None else max(0.0, deadline - time.monotonic())
                    self._partial_outs.append(ch.read(timeout_s=left))
                outs, self._partial_outs = self._partial_outs, []
                res = self._pending.pop(0)
                err = next((o for o in outs if isinstance(o, DAGError)), None)
                if err is not None:
                    res._set(False, err.err)
                else:
                    res._set(True, outs if self._multi_output else outs[0])
        except ChannelClosedError:
            raise RuntimeError("CompiledDAG was torn down") from None
        finally:
            self._read_lock.release()

    # -- the end --------------------------------------------------------------

    def _close_channels(self) -> None:
        """Close every data channel and wait for the loops' acknowledgements."""
        acks = {id(ch) for _, ch in self._exit_acks}
        for ch in self._all_channels:
            if id(ch) not in acks:
                ch.close()
        deadline = time.monotonic() + TEARDOWN_ACK_S
        for actor, ack in self._exit_acks:
            if not actor.is_alive():
                continue
            try:
                ack.read(timeout_s=max(0.0, deadline - time.monotonic()))
            except (ChannelClosedError, TimeoutError):
                pass

    def teardown(self) -> None:
        with self._write_lock:
            if self._torn_down:
                return
            self._torn_down = True
        if self._channel_mode:
            self._close_channels()  # a reader blocked on an exit channel wakes
        with self._read_lock:  # no reader is left inside a channel
            pending, self._pending = self._pending, []
        self._finalizer()  # destroys every channel
        for res in pending:
            res._set(False, RuntimeError("CompiledDAG was torn down before this result was read"))

    def __repr__(self):
        mode = "channels" if self._channel_mode else "tasks"
        return f"CompiledDAG(num_nodes={len(self._schedule)}, mode={mode})"
