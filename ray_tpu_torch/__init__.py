"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu's compute layer.

Mirrors the JAX package's module names (``models/llama.py``,
``ops/rmsnorm.py``, ``llm/engine.py``, ...) so each module's counterpart is
easy to find. Plain tensor code is PyTorch; every op that the JAX package
runs as a Pallas TPU kernel is a CUDA kernel written for Hopper (sources in
``ops/csrc/``, built by ``_native/build.py`` at first use).

The package imports nothing from ``ray_tpu``: what it needs of the
framework-neutral modules it keeps as its own copies.

The core API of ``ray_tpu/__init__.py`` (``init``, ``remote``, ``get``,
``put``, ``wait``, ``cancel``, ``ObjectRef``, the exceptions,
``cluster_resources``, ...) is exported lazily (a module ``__getattr__``),
so that ``import ray_tpu_torch`` imports no torch:

    import ray_tpu_torch
    ray_tpu_torch.init()

    @ray_tpu_torch.remote
    def f(x):
        return x * 2

    ray_tpu_torch.get(f.remote(21))  # 42
"""

from __future__ import annotations

import importlib
from typing import TYPE_CHECKING, Optional, Union

if TYPE_CHECKING:
    import torch

_LAZY = {
    **dict.fromkeys(("init", "shutdown", "is_initialized", "get", "put", "wait", "cancel",
                     "get_runtime_context", "remote"), "ray_tpu_torch._private.worker"),
    "RemoteFunction": "ray_tpu_torch.remote_function",
    "ObjectRef": "ray_tpu_torch.object_ref",
    **dict.fromkeys(("RayTpuError", "TaskError", "ObjectLostError", "GetTimeoutError",
                     "WorkerCrashedError", "TaskCancelledError",
                     "PlacementGroupSchedulingError"), "ray_tpu_torch.exceptions"),
    **dict.fromkeys(("ActorError", "ActorDiedError"), "ray_tpu_torch._private.process_actor"),
    **dict.fromkeys(("placement_group", "remove_placement_group", "PlacementGroup"),
                    "ray_tpu_torch.util.placement_group"),
    **dict.fromkeys(("cluster_resources", "available_resources", "nodes"),
                    "ray_tpu_torch._private.state"),
}

__version__ = "0.1.0"

__all__ = ["resolve_device", "__version__", *_LAZY]


def __getattr__(name: str):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module 'ray_tpu_torch' has no attribute {name!r}")
    value = getattr(importlib.import_module(module), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))


def resolve_device(device: Optional[Union[str, "torch.device"]] = None) -> "torch.device":
    """The device an entry point runs on: CUDA unless the caller names
    another. Never falls back to the CPU on its own — a missing card is an
    error, and a CPU run has to be asked for (``device="cpu"``). Torch is
    imported here, not with the package, so that the runtime's
    framework-neutral modules (the CLI among them) start without it."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ray_tpu_torch: no CUDA device is available; pass device='cpu' "
                "to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
