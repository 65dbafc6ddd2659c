"""ObjectRef: a handle to an immutable object in the driver's object table.

The port's copy of ``ray_tpu/object_ref.py:16-90``. An id is 32 hex
characters: the 24 of the task that made the object, then its return index
(a ``put`` is a task of its own, index 0). In the driver, the table
(``_private/object_store.py``) installs ``_on_create`` and ``_on_delete``
and so counts the driver's live refs of each object; in a worker process
no hook is installed. A ref pickles by its id: the core API's serializer
records it as a reference the enclosing object or task holds, and a plain
pickle rebuilds a ref to the same id.
"""

from __future__ import annotations

from typing import Callable, Optional

TASK_ID_HEX = 24


class ObjectRef:
    _on_create: Optional[Callable] = None  # installed by the driver's table
    _on_delete: Optional[Callable] = None

    __slots__ = ("_id", "__weakref__")

    def __init__(self, object_id: str):
        self._id = object_id
        if ObjectRef._on_create is not None:
            ObjectRef._on_create(object_id)

    def id(self) -> str:
        return self._id

    def hex(self) -> str:
        return self._id

    def task_id(self) -> str:
        """The id of the task that made the object."""
        return self._id[:TASK_ID_HEX]

    def __hash__(self):
        return hash(self._id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._id == self._id

    def __repr__(self):
        return f"ObjectRef({self._id})"

    def __del__(self):
        cb = ObjectRef._on_delete
        if cb is not None:
            try:
                cb(self._id)
            except Exception:  # noqa: BLE001 — a finalizer raises nothing
                pass

    def __reduce__(self):
        return (ObjectRef, (self._id,))

    def __await__(self):
        from ray_tpu_torch._private.worker import get_async

        return get_async(self).__await__()

    def future(self):
        """A ``concurrent.futures.Future`` resolving to this object's value."""
        import concurrent.futures
        import threading

        from ray_tpu_torch._private.worker import get

        fut: concurrent.futures.Future = concurrent.futures.Future()

        def resolve():
            try:
                fut.set_result(get(self))
            except BaseException as e:  # noqa: BLE001 — goes to the future
                fut.set_exception(e)

        threading.Thread(target=resolve, daemon=True).start()
        return fut
