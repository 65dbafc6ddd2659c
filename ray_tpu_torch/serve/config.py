"""Serve configuration schemas: the port's own copy of
``ray_tpu/serve/config.py`` (``AutoscalingConfig``, ``DeploymentConfig``),
and ``ProxyConfig``, the proxy's knobs, which the JAX package reads from
its runtime's config (``ray_tpu/_private/config.py:119-139``), with the
same defaults.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional


@dataclasses.dataclass
class AutoscalingConfig:
    """Queue-depth-driven replica autoscaling (reference:
    ``serve/autoscaling_policy.py`` + ``_private/autoscaling_state.py``).
    The port's controller also samples the metrics every
    ``metrics_interval_s`` (at most every 0.5 s, the JAX controller's one
    period)."""

    min_replicas: int = 1
    max_replicas: int = 10
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 3.0
    downscale_delay_s: float = 30.0
    metrics_interval_s: float = 1.0
    # smoothing applied to the desired-replica delta per decision
    upscaling_factor: float = 1.0
    downscaling_factor: float = 1.0

    def desired_replicas(self, total_ongoing: float, current: int) -> int:
        if current <= 0:
            return self.min_replicas
        raw = total_ongoing / max(self.target_ongoing_requests, 1e-9)
        if raw > current:
            desired = current + (raw - current) * self.upscaling_factor
        else:
            desired = current - (current - raw) * self.downscaling_factor
        desired = math.ceil(desired - 1e-9)
        return max(self.min_replicas, min(self.max_replicas, desired))


@dataclasses.dataclass
class DeploymentConfig:
    num_replicas: int = 1
    max_ongoing_requests: int = 8
    # Per-deployment bound on admitted-but-unfinished requests at the
    # proxy: past it the proxy sheds with 429 + Retry-After instead of
    # queueing. None = ProxyConfig.serve_queue_depth_per_deployment.
    max_queued_requests: Optional[int] = None
    autoscaling_config: Optional[AutoscalingConfig] = None
    # {"resources": {"GPU": g, "CPU": c}} (or num_cpus): what
    # each replica leases from the host's card ledger; nothing named,
    # nothing leased (a CPU process that sees no card)
    ray_actor_options: Optional[dict] = None
    health_check_period_s: float = 2.0
    health_check_timeout_s: float = 30.0
    graceful_shutdown_timeout_s: float = 20.0
    # Bound on how long a replica may stay STARTING (its constructor still
    # running) before it is replaced. None = unbounded: only a dead replica
    # process is replaced while it starts.
    initial_health_grace_s: Optional[float] = None
    user_config: Optional[Any] = None

    def initial_replicas(self) -> int:
        if self.autoscaling_config:
            return self.autoscaling_config.min_replicas
        return self.num_replicas


@dataclasses.dataclass
class ProxyConfig:
    """The HTTP proxy's admission knobs (``proxy.py:AdmissionController``)."""

    # admitted-but-unfinished requests across every deployment and tenant;
    # past it the proxy sheds (429 + Retry-After) instead of queueing
    serve_max_inflight_per_proxy: int = 256
    # the per-deployment bound (overridable by max_queued_requests)
    serve_queue_depth_per_deployment: int = 128
    # the Retry-After hint (seconds) of a shed reply
    serve_shed_retry_after_s: float = 1.0
    # how long shutdown lets in-flight requests finish; those still open at
    # the deadline are cut and counted (dropped_streams)
    serve_drain_window_s: float = 10.0
    # per-tenant caps from the tenant weights (set_tenant_policies)
    serve_tenant_admission: bool = True
