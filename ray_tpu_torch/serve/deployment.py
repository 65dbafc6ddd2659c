"""@serve.deployment + application graph: the port's own copy of
``ray_tpu/serve/deployment.py``.

Reference: ``python/ray/serve/api.py`` (``@serve.deployment``),
``serve/deployment.py`` (``Deployment.bind`` building an ``Application``
DAG whose nodes become ``DeploymentHandle``s at deploy time). A
deployment's class or function goes to its replica processes with the
standard pickle, by reference (``api.py:target_ref``), so it must be
defined at a module's top level.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Optional, Union

from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig


class Deployment:
    def __init__(
        self,
        target: Union[type, Callable],
        name: str,
        config: DeploymentConfig,
        route_prefix: Optional[str] = None,
    ):
        self._target = target
        self.name = name
        self.config = config
        self.route_prefix = route_prefix

    def options(self, **kwargs) -> "Deployment":
        cfg = copy.deepcopy(self.config)
        name = kwargs.pop("name", self.name)
        route_prefix = kwargs.pop("route_prefix", self.route_prefix)
        if kwargs.get("num_replicas") == "auto":
            # mirror the decorator's special case
            kwargs.pop("num_replicas")
            kwargs.setdefault("autoscaling_config", AutoscalingConfig())
        if "autoscaling_config" in kwargs:
            ac = kwargs.pop("autoscaling_config")
            cfg.autoscaling_config = (
                AutoscalingConfig(**ac) if isinstance(ac, dict) else ac
            )
        for k, v in kwargs.items():
            if hasattr(cfg, k):
                setattr(cfg, k, v)
            else:
                raise ValueError(f"unknown deployment option: {k}")
        return Deployment(self._target, name, cfg, route_prefix)

    def bind(self, *args, **kwargs) -> "Application":
        return Application(self, args, kwargs)

    @property
    def func_or_class(self):
        return self._target

    def __repr__(self):
        return f"Deployment(name={self.name!r})"


class Application:
    """A bound deployment node; arguments may contain other Applications
    (composition edges resolved to handles at deploy time)."""

    def __init__(self, deployment: Deployment, args: tuple, kwargs: dict):
        self.deployment = deployment
        self.args = args
        self.kwargs = kwargs

    def walk(self) -> list["Application"]:
        """Topological order, dependencies first, dedup by deployment name."""
        seen: dict[str, Application] = {}
        order: list[Application] = []

        def visit(app: Application):
            for a in list(app.args) + list(app.kwargs.values()):
                if isinstance(a, Application):
                    visit(a)
            prev = seen.get(app.deployment.name)
            if prev is None:
                seen[app.deployment.name] = app
                order.append(app)
            elif prev is not app:
                # same deployment bound twice with (possibly) different args:
                # ambiguous — reference requires unique names via .options(name=)
                raise ValueError(
                    f"deployment name {app.deployment.name!r} bound more than "
                    f"once in the application graph; use "
                    f".options(name=...) to disambiguate"
                )

        visit(self)
        return order


def deployment(
    _target: Optional[Union[type, Callable]] = None,
    *,
    name: Optional[str] = None,
    num_replicas: Optional[Union[int, str]] = None,
    max_ongoing_requests: int = 8,
    max_queued_requests: Optional[int] = None,
    autoscaling_config: Optional[Union[dict, AutoscalingConfig]] = None,
    ray_actor_options: Optional[dict] = None,
    health_check_period_s: float = 2.0,
    health_check_timeout_s: float = 30.0,
    initial_health_grace_s: Optional[float] = None,
    user_config: Optional[Any] = None,
    route_prefix: Optional[str] = None,
) -> Union[Deployment, Callable[..., Deployment]]:
    """Decorator turning a class or function into a Deployment."""

    if num_replicas == "auto" and autoscaling_config is None:
        autoscaling_config = AutoscalingConfig()
        num_replicas = None

    def build(target) -> Deployment:
        if isinstance(autoscaling_config, dict):
            ac = AutoscalingConfig(**autoscaling_config)
        else:
            ac = autoscaling_config
        cfg = DeploymentConfig(
            num_replicas=num_replicas or 1,
            max_ongoing_requests=max_ongoing_requests,
            max_queued_requests=max_queued_requests,
            autoscaling_config=ac,
            ray_actor_options=ray_actor_options,
            health_check_period_s=health_check_period_s,
            health_check_timeout_s=health_check_timeout_s,
            initial_health_grace_s=initial_health_grace_s,
            user_config=user_config,
        )
        return Deployment(
            target, name or getattr(target, "__name__", "deployment"), cfg,
            route_prefix,
        )

    if _target is not None:
        return build(_target)
    return build


class TargetRef:
    """A deployment's class or function, by reference: its module and
    qualified name, resolved by import in the replica. The name may hold
    the ``Deployment`` that ``@serve.deployment`` left in its place; the
    replica unwraps it."""

    def __init__(self, module: str, qualname: str):
        self.module, self.qualname = module, qualname

    def resolve(self):
        import importlib

        obj = importlib.import_module(self.module)
        for part in self.qualname.split("."):
            obj = getattr(obj, part)
        return obj.func_or_class if isinstance(obj, Deployment) else obj


def target_ref(target) -> TargetRef:
    """``target`` as a ``TargetRef``; ``TypeError`` unless a replica can
    import it by name: a lambda, a closure or a class defined inside a
    function cannot go to another process with the standard pickle (the
    JAX package cloudpickles them)."""
    module = getattr(target, "__module__", None)
    qualname = getattr(target, "__qualname__", "")
    ref = TargetRef(module or "", qualname)
    found = None
    if module and "<" not in qualname:
        try:
            found = ref.resolve()
        except (ImportError, AttributeError):
            found = None
    if found is not target:
        raise TypeError(
            f"deployment target {target!r} goes to its replica processes with the standard "
            "pickle, by reference: define it at a module's top level, not as a lambda, a "
            "closure or a class inside a function")
    return ref
