"""Declarative serve config: a dict or a YAML file -> running applications;
the port's own copy of ``ray_tpu/serve/schema.py``.

Reference: ``python/ray/serve/schema.py`` (ServeDeploySchema) and the
``serve deploy`` / ``serve status`` CLI (``serve/scripts.py``). Subset:

```yaml
applications:
  - name: default
    route_prefix: /
    import_path: my_module:app          # Application | Deployment | builder
    args: {}                            # builder kwargs (optional)
    deployments:                        # per-deployment overrides (optional)
      - name: Model
        num_replicas: 2
        max_ongoing_requests: 16
        user_config: {temperature: 0.5}
        autoscaling_config: {min_replicas: 1, max_replicas: 4}
```

``deploy(config)`` is idempotent and reconciling: deploying an updated
config rolls the deployments whose code or init arguments changed (the
controller replaces their replicas one at a time once each successor is
healthy) and applies the rest in place. The port's Serve runs in the
driver's threads, so ``deploy`` is a call in the driver; there is no
``serve deploy`` command that another process could use. PyYAML is
imported only to read a file.
"""

from __future__ import annotations

import importlib
from typing import Union

from ray_tpu_torch.serve.deployment import Application, Deployment


def _load_config(config: Union[str, dict]) -> dict:
    if isinstance(config, dict):
        return config
    import yaml

    with open(config) as f:
        return yaml.safe_load(f)


def _import_target(import_path: str):
    module_name, _, attr = import_path.partition(":")
    if not attr:
        raise ValueError(f"import_path must be 'module:attribute', got {import_path!r}")
    module = importlib.import_module(module_name)
    return getattr(module, attr)


def build_app(app_cfg: dict) -> Application:
    """Resolve one application entry to a bound Application with its
    per-deployment overrides applied."""
    target = _import_target(app_cfg["import_path"])
    args = app_cfg.get("args") or {}
    if isinstance(target, Deployment):
        target = target.bind()
    elif not isinstance(target, Application):
        # a builder function (reference: app builders take an args dict)
        target = target(args) if args else target()
        if isinstance(target, Deployment):
            target = target.bind()
    if not isinstance(target, Application):
        raise TypeError(f"{app_cfg['import_path']} did not resolve to an Application")
    overrides = {d["name"]: d for d in app_cfg.get("deployments") or []}
    if overrides:
        for node in target.walk():
            ov = overrides.pop(node.deployment.name, None)
            if ov is None:
                continue
            opts = {k: v for k, v in ov.items() if k != "name"}
            node.deployment = node.deployment.options(**opts)
        if overrides:
            raise ValueError(
                f"config overrides reference unknown deployments: {sorted(overrides)}")
    return target


def deploy(config: Union[str, dict]) -> list[str]:
    """Deploy every application in the config (a file path or a dict).
    Returns the deployed application names."""
    from ray_tpu_torch import serve

    cfg = _load_config(config)
    apps = cfg.get("applications")
    if not apps:
        raise ValueError("config has no 'applications' list")
    names = []
    for app_cfg in apps:
        name = app_cfg.get("name", "default")
        serve.run(build_app(app_cfg), name=name, route_prefix=app_cfg.get("route_prefix"))
        names.append(name)
    return names


def status() -> dict:
    from ray_tpu_torch import serve

    return serve.status()
