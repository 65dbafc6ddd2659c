"""ray_tpu_torch.serve — online serving on replica processes: the port of
``ray_tpu.serve``'s runtime.

The JAX package's public names (``ray_tpu/serve/__init__.py``):
``@serve.deployment`` + ``serve.run``, the controller, the HTTP proxy,
handles with P2C routing and composition, queue-depth autoscaling, dynamic
batching, model multiplexing. The controller, the proxy and the router
for handles inside replicas are threads of the driver; each replica is a
``ProcessActor`` of its own that leases what its deployment names from the
host's card ledger (``controller.py``). Not ported yet: the ASGI ingress
(``serve.ingress``), the declarative YAML deploy, the gRPC proxy and one
proxy per node (``start_proxies``, ``list_proxies``).
"""

from ray_tpu_torch.serve.api import (
    delete,
    get_app_handle,
    get_deployment_handle,
    run,
    shutdown,
    status,
)
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig, ProxyConfig
from ray_tpu_torch.serve.deployment import Application, Deployment, deployment
from ray_tpu_torch.serve.handle import DeploymentHandle, DeploymentResponse
from ray_tpu_torch.serve.multiplex import get_multiplexed_model_id, multiplexed
from ray_tpu_torch.serve.proxy import ProxyServer, Request, start_proxy
from ray_tpu_torch.serve.streaming import RawBody

__all__ = [
    "Application",
    "AutoscalingConfig",
    "Deployment",
    "DeploymentConfig",
    "DeploymentHandle",
    "DeploymentResponse",
    "ProxyConfig",
    "ProxyServer",
    "Request",
    "batch",
    "delete",
    "deployment",
    "get_app_handle",
    "get_deployment_handle",
    "get_multiplexed_model_id",
    "multiplexed",
    "run",
    "RawBody",
    "shutdown",
    "start_proxy",
    "status",
]
