"""serve.run / serve.shutdown / status — the public control API; a port
of ``ray_tpu/serve/api.py``.

Reference: ``python/ray/serve/api.py`` (``serve.run``). ``serve.run(app)``
starts the controller (a thread of this process) if it is not running,
walks the bound application graph (dependencies first), registers every
deployment, and returns a handle to the ingress deployment. A
deployment's class or function goes to its replicas by reference
(``deployment.target_ref``) and its arguments with the standard pickle:
a lambda, a closure, a class defined inside a function, or an argument
that does not pickle raises ``TypeError`` here, at once (the JAX package
cloudpickles them).
"""

from __future__ import annotations

import pickle
import threading
import time
from typing import Optional

from ray_tpu_torch._private.process_actor import require_picklable
from ray_tpu_torch.serve.deployment import Application, Deployment, target_ref
from ray_tpu_torch.serve.handle import DeploymentHandle, _HandleMarker

_controller = None
_controller_lock = threading.Lock()
# held for a whole shutdown, so a second caller returns only once Serve is
# down: the CLI's ``serve deploy`` exits after its own call, and must not
# end while a ``serve shutdown`` from the driver link is still running
_shutdown_lock = threading.RLock()


def _get_controller(create: bool = False):
    global _controller
    with _controller_lock:
        if _controller is None:
            if not create:
                raise RuntimeError(
                    "serve is not running (no controller); call serve.run first")
            from ray_tpu_torch.serve.controller import ServeController

            _controller = ServeController()
        return _controller


def _specs(app: Application) -> list[dict]:
    specs = []
    for node in app.walk():
        d = node.deployment
        # composition: nested Applications become handle markers
        args = tuple(
            _HandleMarker(a.deployment.name) if isinstance(a, Application) else a
            for a in node.args
        )
        kwargs = {
            k: (_HandleMarker(v.deployment.name) if isinstance(v, Application) else v)
            for k, v in node.kwargs.items()
        }
        require_picklable((args, kwargs), f"the arguments of deployment {d.name!r}")
        cfg = d.config
        specs.append(
            {
                "name": d.name,
                "serialized_target": pickle.dumps(target_ref(d.func_or_class)),
                "init_args_payload": pickle.dumps((args, kwargs)),
                "initial_replicas": cfg.initial_replicas(),
                "max_ongoing_requests": cfg.max_ongoing_requests,
                "max_queued_requests": cfg.max_queued_requests,
                "autoscaling_config": (
                    cfg.autoscaling_config.__dict__ if cfg.autoscaling_config else None
                ),
                "ray_actor_options": cfg.ray_actor_options,
                "health_check_timeout_s": cfg.health_check_timeout_s,
                "health_check_period_s": cfg.health_check_period_s,
                "initial_health_grace_s": cfg.initial_health_grace_s,
                "graceful_shutdown_timeout_s": cfg.graceful_shutdown_timeout_s,
                "user_config": cfg.user_config,
            }
        )
    return specs


def run(
    app: Application,
    *,
    name: str = "default",
    route_prefix: Optional[str] = None,
    blocking: bool = False,
    _wait_for_ready_s: float = 60.0,
) -> DeploymentHandle:
    if isinstance(app, Deployment):
        app = app.bind()
    if not isinstance(app, Application):
        raise TypeError("serve.run expects a bound Application (use .bind())")
    specs = _specs(app)  # raises before anything starts
    controller = _get_controller(create=True)
    ingress = app.deployment.name
    prefix = route_prefix or app.deployment.route_prefix or "/"
    controller.deploy_application(name, prefix, specs, ingress)
    handle = DeploymentHandle(ingress)
    # wait until the ingress deployment has replicas (started; a handle's
    # call waits until one has finished constructing)
    deadline = time.time() + _wait_for_ready_s
    while not controller.get_replica_names(ingress):
        if time.time() > deadline:
            message = controller.status()["applications"].get(name, {}).get(
                "deployments", {}).get(ingress, {}).get("message", "")
            raise RuntimeError(
                f"application {name!r} failed to become ready within "
                f"{_wait_for_ready_s}s: ingress {ingress!r} has no replicas"
                + (f" ({message})" if message else "")
            )
        time.sleep(0.1)
    if blocking:
        try:
            while True:
                time.sleep(1)
        except KeyboardInterrupt:
            pass
    return handle


def delete(name: str):
    _get_controller().delete_application(name)


def status() -> dict:
    return _get_controller().status()


def get_deployment_handle(deployment_name: str, app_name: str = "default") -> DeploymentHandle:
    return DeploymentHandle(deployment_name)


def get_app_handle(app_name: str = "default") -> DeploymentHandle:
    app = _get_controller().get_app_route(app_name)
    if app is None:
        raise RuntimeError(f"no application named {app_name!r}")
    return DeploymentHandle(app["ingress"])


def shutdown():
    """Stop the proxies (draining the HTTP one), every replica (their
    leases, and what they spawned, end with them) and the controller;
    returns once they are stopped, also when another thread began it."""
    global _controller
    from ray_tpu_torch.serve.grpc_proxy import _stop_grpc_proxy
    from ray_tpu_torch.serve.proxy import _stop_proxy

    with _shutdown_lock:
        _stop_proxy()
        _stop_grpc_proxy()
        with _controller_lock:
            controller, _controller = _controller, None
        if controller is not None:
            controller.shutdown()
