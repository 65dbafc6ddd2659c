"""The port's counterpart of ``ray_tpu/util/`` (all of it but
``collective``), on the port's own processes: placement groups over the
card ledger, scheduling strategies, ``ActorPool``, ``Queue``, pubsub,
metrics, tracing and the state API."""

from ray_tpu_torch.util.placement_group import (
    PlacementGroup,
    get_current_placement_group,
    placement_group,
    remove_placement_group,
)

__all__ = [
    "placement_group",
    "remove_placement_group",
    "get_current_placement_group",
    "PlacementGroup",
]
