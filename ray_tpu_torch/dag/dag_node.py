"""DAG nodes: lazily bound graphs of actor-method and function calls.

The port's counterpart of ``ray_tpu/dag/dag_node.py``. A graph is built with
``ProcessActor.bind("method", *args, **kwargs)`` (the reference binds
``actor.method.bind``, ``ray_tpu/actor.py:63``; the port calls methods by
name) and ``FunctionNode(fn, args, kwargs)`` (the reference's
``remote_fn.bind``), whose arguments may be other nodes and an
``InputNode``; ``dag.execute(x)`` runs it eagerly, ``experimental_compile``
compiles it (``compiled_dag.py``).

- *Eager execution* sends each node's call as soon as its arguments have
  arrived and returns the root's result at once (a list of results for a
  ``MultiOutputNode``), which ``get`` and ``wait`` of
  ``_private/process_actor.py`` take, as ``ray_tpu.get`` takes the
  reference's refs. An actor node's call runs on the hosted object in the
  actor's process; a node whose argument failed fails with the same error
  without being called.
- *Function nodes.* The port has no remote functions (the core runtime is
  out by decision): a ``FunctionNode`` wraps a module-level function and
  runs it on a thread of the driver, as the port's Data runs its stateless
  task stages (``data/execution.py``).
- *Errors* are raised by ``get`` as the node raised them (a ``ValueError``
  as a ``ValueError``), as the reference's ``get`` raises an error that is
  also an instance of its cause; a process that died raises
  ``ActorDiedError``.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Optional

from ray_tpu_torch._private.process_actor import OnInstance, Result

FUNCTION_THREADS = 8  # the driver's threads that run function nodes

_pool: Optional[ThreadPoolExecutor] = None
_pool_lock = threading.Lock()


def _function_pool() -> ThreadPoolExecutor:
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(FUNCTION_THREADS, thread_name_prefix="dag-function")
        return _pool


class DAGError:
    """A node's failure, carried through the graph in place of its value."""

    def __init__(self, err: BaseException, node_name: str):
        self.err, self.node_name = err, node_name


def call_method(instance, method: str, args: tuple, kwargs: dict):
    """In an actor's process: ``method`` on the hosted object, its error
    returned as a ``DAGError`` (which keeps the error's type)."""
    try:
        return getattr(instance, method)(*args, **kwargs)
    except Exception as e:  # noqa: BLE001 — goes back to the caller as the node's error
        return DAGError(e, method)


class DAGResult(Result):
    """One node's eager result."""

    __slots__ = ("node_name",)

    def __init__(self, node_name: str):
        super().__init__()
        self.node_name = node_name

    def _fill(self, result: Result) -> None:
        """From an actor call's result: its value, or its error."""
        if result._ok and isinstance(result._value, DAGError):
            self._set(False, result._value.err)
        else:
            self._set(result._ok, result._value)

    def __repr__(self):
        return f"<DAGResult {self.node_name} {'done' if self.done else 'pending'}>"


def _when_ready(values: list, fn: Callable[[], None]) -> None:
    """``fn()`` once every ``Result`` among ``values`` is done."""
    waiting = [v for v in values if isinstance(v, Result)]
    left = [len(waiting)]
    lock = threading.Lock()

    def one_done(_):
        with lock:
            left[0] -= 1
            last = left[0] == 0
        if last:
            fn()

    if not waiting:
        fn()
    for v in waiting:
        v.add_done_callback(one_done)


def _value(v):
    return v._value if isinstance(v, Result) else v


def _failed(values: list) -> Optional[BaseException]:
    for v in values:
        if isinstance(v, Result) and not v._ok:
            return v._value
    return None


class DAGNode:
    """Base: a node owns (args, kwargs) that may contain other nodes."""

    def __init__(self, args: tuple, kwargs: dict):
        self._bound_args = tuple(args)
        self._bound_kwargs = dict(kwargs)

    # -- graph traversal ------------------------------------------------------

    def _children(self) -> list["DAGNode"]:
        return [a for a in list(self._bound_args) + list(self._bound_kwargs.values())
                if isinstance(a, DAGNode)]

    def topological(self) -> list["DAGNode"]:
        order: list[DAGNode] = []
        seen: set[int] = set()

        def visit(node: DAGNode):
            if id(node) in seen:
                return
            seen.add(id(node))
            for c in node._children():
                visit(c)
            order.append(node)

        visit(self)
        return order

    # -- execution ------------------------------------------------------------

    def execute(self, *input_args, **input_kwargs):
        """Eager execution: every node's call sent as its arguments arrive;
        returns the root's result (a list of results for a
        ``MultiOutputNode``) at once."""
        return execute_nodes(self.topological(), input_args, input_kwargs)

    def _resolve(self, results: dict, value):
        return results[id(value)] if isinstance(value, DAGNode) else value

    def _execute_node(self, results: dict, input_args: tuple, input_kwargs: dict):
        raise NotImplementedError

    def experimental_compile(self):
        from ray_tpu_torch.dag.compiled_dag import CompiledDAG

        return CompiledDAG(self)


def execute_nodes(schedule: list, input_args: tuple, input_kwargs: dict):
    """One eager run of ``schedule`` (a topological order ending in the
    root); the root's result."""
    results: dict[int, Any] = {}
    for node in schedule:
        results[id(node)] = node._execute_node(results, input_args, input_kwargs)
    return results[id(schedule[-1])]


class InputNode(DAGNode):
    """The DAG's input placeholder (a context manager, as in the reference)."""

    def __init__(self):
        super().__init__((), {})

    def __enter__(self) -> "InputNode":
        return self

    def __exit__(self, *exc):
        return None

    def __getattr__(self, key):
        if key.startswith("_"):
            raise AttributeError(key)
        return InputAttributeNode(self, key)

    def __getitem__(self, key):
        return InputAttributeNode(self, key)

    def _execute_node(self, results, input_args, input_kwargs):
        return input_value(input_args, input_kwargs)


def input_value(input_args: tuple, input_kwargs: dict):
    """What ``execute``'s arguments give the ``InputNode``."""
    if input_args and input_kwargs:
        raise ValueError("dag.execute() takes positional OR keyword inputs, not both "
                         "(keyword inputs are read via InputNode['key'])")
    if len(input_args) == 1:
        return input_args[0]
    if input_kwargs:
        return dict(input_kwargs)
    return input_args


class InputAttributeNode(DAGNode):
    """``InputNode[...]`` / ``InputNode.attr``."""

    def __init__(self, parent: InputNode, key):
        super().__init__((parent,), {})
        self._key = key

    def select(self, base):
        if isinstance(base, dict) or isinstance(self._key, int):
            return base[self._key]
        return getattr(base, self._key)

    def _execute_node(self, results, input_args, input_kwargs):
        return self.select(self._resolve(results, self._bound_args[0]))


class _CallNode(DAGNode):
    """A node that calls something once its arguments have arrived."""

    name = "?"

    def _execute_node(self, results, input_args, input_kwargs):
        args = [self._resolve(results, a) for a in self._bound_args]
        kwargs = {k: self._resolve(results, v) for k, v in self._bound_kwargs.items()}
        out = DAGResult(self.name)

        def ready():
            err = _failed(args + list(kwargs.values()))
            if err is not None:
                out._set(False, err)
                return
            try:
                self._submit(out, tuple(_value(a) for a in args),
                             {k: _value(v) for k, v in kwargs.items()})
            except Exception as e:  # noqa: BLE001 — unpicklable arguments: the node's error
                out._set(False, e)

        _when_ready(args + list(kwargs.values()), ready)
        return out

    def _submit(self, out: DAGResult, args: tuple, kwargs: dict) -> None:
        raise NotImplementedError


class FunctionNode(_CallNode):
    """A bound call of a module-level function, run on a driver thread."""

    def __init__(self, fn: Callable, args: tuple = (), kwargs: Optional[dict] = None):
        super().__init__(args, kwargs or {})
        self._fn = fn
        self.name = getattr(fn, "__name__", repr(fn))

    def _submit(self, out, args, kwargs):
        def run():
            try:
                out._set(True, self._fn(*args, **kwargs))
            except Exception as e:  # noqa: BLE001 — the node's error, raised by get
                out._set(False, e)

        _function_pool().submit(run)


class ClassMethodNode(_CallNode):
    """A bound actor-method call (``ProcessActor.bind``)."""

    def __init__(self, actor, method: str, args: tuple, kwargs: dict):
        super().__init__(args, kwargs)
        self._actor, self._method = actor, method
        self.name = f"{actor.name}.{method}"

    def _submit(self, out, args, kwargs):
        h = self._actor.call(OnInstance(call_method, self._method), self._method, args, kwargs)
        h.add_done_callback(out._fill)


class MultiOutputNode(DAGNode):
    """Fan-in terminal: a list of the outputs' results."""

    def __init__(self, outputs: list):
        super().__init__(tuple(outputs), {})

    def _execute_node(self, results, input_args, input_kwargs):
        return [self._resolve(results, a) for a in self._bound_args]
