from ray_tpu_torch.util.state.api import (
    cluster_metrics,
    cluster_spans,
    list_actors,
    list_nodes,
    list_placement_groups,
    list_tasks,
    list_workers,
    proxy_stats,
    set_tenant_quota,
    summarize_tasks,
    tenant_stats,
    timeline,
)

__all__ = [
    "cluster_metrics",
    "cluster_spans",
    "list_actors",
    "list_nodes",
    "list_placement_groups",
    "list_tasks",
    "list_workers",
    "proxy_stats",
    "set_tenant_quota",
    "summarize_tasks",
    "tenant_stats",
    "timeline",
]
