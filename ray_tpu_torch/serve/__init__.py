"""ray_tpu_torch.serve — online serving on replica processes: the port of
``ray_tpu.serve``'s runtime.

The JAX package's public names (``ray_tpu/serve/__init__.py``):
``@serve.deployment`` + ``serve.run``, the controller, the HTTP proxy,
handles with P2C routing and composition, queue-depth autoscaling, dynamic
batching, model multiplexing, the ASGI ingress (``serve.ingress``,
``asgi.py``), the declarative deploy (``schema.deploy`` / ``schema.status``
of a dict or a YAML file, ``schema.py``) and the gRPC proxy
(``start_grpc_proxy``, ``grpc_proxy.py``; ``grpc`` is imported only when
it starts). The controller, the proxies and the router for handles inside
replicas are threads of the driver; each replica is a ``ProcessActor`` of
its own, leading a process group (so it may host a gang of rank
processes), that leases what its deployment names from the host's card
ledger (``controller.py``). Left out, with multi-host placement: one proxy
per node (``start_proxies``, ``list_proxies``).
"""

from ray_tpu_torch.serve.api import (
    delete,
    get_app_handle,
    get_deployment_handle,
    run,
    shutdown,
    status,
)
from ray_tpu_torch.serve.asgi import ingress
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig, ProxyConfig
from ray_tpu_torch.serve.deployment import Application, Deployment, deployment
from ray_tpu_torch.serve.grpc_proxy import GrpcProxyServer, start_grpc_proxy
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
    "GrpcProxyServer",
    "ProxyConfig",
    "ProxyServer",
    "Request",
    "batch",
    "delete",
    "deployment",
    "get_app_handle",
    "get_deployment_handle",
    "get_multiplexed_model_id",
    "ingress",
    "multiplexed",
    "run",
    "RawBody",
    "shutdown",
    "start_grpc_proxy",
    "start_proxy",
    "status",
]
