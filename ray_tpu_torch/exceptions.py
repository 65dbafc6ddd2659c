"""What tasks and objects raise: the port's copy of ``ray_tpu/exceptions.py``.

``ActorError`` and ``ActorDiedError`` of the port's process actors stay in
``_private/process_actor.py``.
"""

from __future__ import annotations

import traceback


class RayTpuError(Exception):
    """Base class of the core API's errors."""


class TaskError(RayTpuError):
    """A task raised: the original exception and its remote traceback,
    raised again at every ``get`` of the task's results."""

    def __init__(self, function_name: str, cause: BaseException, remote_tb: str | None = None):
        self.function_name = function_name
        self.cause = cause
        self.remote_tb = remote_tb or "".join(
            traceback.format_exception(type(cause), cause, cause.__traceback__))
        super().__init__(f"task {function_name} failed: {cause!r}\nRemote traceback:\n"
                         f"{self.remote_tb}")

    def __reduce__(self):
        return (TaskError, (self.function_name, self.cause, self.remote_tb))

    def as_instanceof_cause(self) -> BaseException:
        """An exception that is both a ``TaskError`` and of the cause's type."""
        cause_cls = type(self.cause)
        if issubclass(cause_cls, TaskError):
            return self.cause
        try:
            cls = type("TaskError_" + cause_cls.__name__, (TaskError, cause_cls),
                       {"__init__": lambda s: None,
                        "__reduce__": lambda s: (_rebuild_dual, (self,))})
            err = cls()
            err.function_name = self.function_name
            err.cause = self.cause
            err.remote_tb = self.remote_tb
            err.args = self.args
            return err
        except TypeError:
            return self


def _rebuild_dual(task_error: TaskError):
    return task_error.as_instanceof_cause()


class ObjectLostError(RayTpuError):
    def __init__(self, object_id_hex: str):
        self.object_id_hex = object_id_hex
        super().__init__(f"Object {object_id_hex} was lost and could not be reconstructed")

    def __reduce__(self):
        return (ObjectLostError, (self.object_id_hex,))


class GetTimeoutError(RayTpuError, TimeoutError):
    pass


class WorkerCrashedError(RayTpuError):
    pass


class TaskCancelledError(RayTpuError):
    pass


class PlacementGroupSchedulingError(RayTpuError):
    pass
