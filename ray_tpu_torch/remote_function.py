"""Remote functions: the port's copy of ``ray_tpu/remote_function.py:10-101``.

``@ray_tpu_torch.remote`` gives a ``RemoteFunction``: ``f.remote(*args)``
submits a task to the driver's queue and returns its ``ObjectRef`` (a list
of them for ``num_returns=n``), ``f.options(...)`` a copy with other
options, ``f.bind(...)`` a DAG node that runs the function as a task.

The function goes to workers with the standard pickle, by reference: a
lambda or a closure raises ``TypeError`` at ``.remote()`` (the reference
cloudpickles it, ``ray_tpu/remote_function.py:71``).
"""

from __future__ import annotations

PART_2 = "the core API's part 2 (ROADMAP.md, Queue A item 9)"
OPTIONS = ("num_cpus", "num_gpus", "resources", "num_returns", "max_retries",
           "retry_exceptions", "name", "scheduling_strategy", "placement_group",
           "placement_group_bundle_index")


def _check_options(options: dict) -> None:
    if options.get("num_tpus") is not None:
        raise TypeError("num_tpus: the port's tasks run on cards; ask for a share of one with "
                        "num_gpus (a share below 1, or whole cards)")
    if options.get("num_returns") == "streaming":
        raise NotImplementedError(f"num_returns='streaming' (ObjectRefGenerator) comes in "
                                  f"{PART_2}")
    if options.get("runtime_env") is not None:
        raise NotImplementedError(f"runtime_env comes in {PART_2}")
    for key in ("tenant", "priority"):
        if options.get(key) is not None:
            raise NotImplementedError(
                f"{key} on tasks is not ported: ROADMAP.md, Queue A item 9, decides it")
    unknown = set(options) - set(OPTIONS) - {"num_tpus", "runtime_env", "tenant", "priority"}
    if unknown:
        raise ValueError(f"unknown task options {sorted(unknown)}; the options are {OPTIONS}")
    n = options.get("num_returns", 1)
    if not isinstance(n, int) or n < 0:
        raise ValueError(f"num_returns must be an int >= 0, got {n!r}")
    g = float(options.get("num_gpus") or 0)
    if g < 0 or (g > 1 and g != int(g)):
        raise ValueError(f"num_gpus is a share of one card below 1 or whole cards, got {g}")
    resources = options.get("resources") or {}
    for k in ("CPU", "GPU", "TPU"):
        if k in resources:
            raise ValueError(f"resources names custom resources; ask for {k} with "
                             f"num_{k.lower()}s")


def _strategy(options: dict):
    from ray_tpu_torch.util.scheduling_strategies import (PlacementGroupSchedulingStrategy,
                                                          SpreadSchedulingStrategy)

    s = options.get("scheduling_strategy")
    if s is None:
        pg = options.get("placement_group")
        if pg is None:
            return None
        return PlacementGroupSchedulingStrategy(pg, options.get("placement_group_bundle_index", -1))
    if isinstance(s, str):
        if s.upper() == "DEFAULT":
            return None
        if s.upper() == "SPREAD":
            return SpreadSchedulingStrategy()
        raise ValueError(f"unknown scheduling strategy {s!r}")
    return s


class RemoteFunction:
    def __init__(self, function, options: dict):
        _check_options(options)
        self._function = function
        self._options = dict(options)
        self._blob = None
        self.__name__ = getattr(function, "__name__", "anonymous")
        self.__doc__ = getattr(function, "__doc__", None)

    def __call__(self, *args, **kwargs):
        raise TypeError(f"Remote function {self.__name__}() cannot be called directly; "
                        f"use {self.__name__}.remote().")

    def options(self, **new_options):
        rf = RemoteFunction(self._function, {**self._options, **new_options})
        rf._blob = self._blob
        return rf

    def _task_options(self) -> dict:
        o = self._options
        resources = {k: float(v) for k, v in (o.get("resources") or {}).items() if v}
        cpus = o.get("num_cpus")
        resources["CPU"] = 1.0 if cpus is None else float(cpus)
        return {"name": o.get("name") or self.__name__,
                "num_returns": o.get("num_returns", 1),
                "resources": {k: v for k, v in resources.items() if v},
                "num_gpus": float(o.get("num_gpus") or 0),
                "max_retries": int(o.get("max_retries", 0)),
                "retry_exceptions": bool(o.get("retry_exceptions", False)),
                "strategy": _strategy(o)}

    def remote(self, *args, **kwargs):
        from ray_tpu_torch._private import worker
        from ray_tpu_torch._private.process_actor import _dumps

        if self._blob is None:
            self._blob = _dumps(self._function, f"remote function {self.__name__}")
        refs = worker.submit(self, args, kwargs)
        return refs[0] if self._options.get("num_returns", 1) == 1 else refs

    def bind(self, *args, **kwargs):
        """A DAG node that runs the function as a task
        (``ray_tpu_torch.dag``)."""
        from ray_tpu_torch.dag.dag_node import FunctionNode

        return FunctionNode(self, args, kwargs)
