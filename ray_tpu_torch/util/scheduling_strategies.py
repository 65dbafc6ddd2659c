"""Scheduling strategies, the port's counterpart of
``ray_tpu/util/scheduling_strategies.py``, taken by
``ProcessActor(..., scheduling_strategy=...)`` on the port's one host:

- ``PlacementGroupSchedulingStrategy(pg, i)``: the actor runs under bundle
  i's cards (-1: the bundle with the fewest live actors) and takes no
  lease of its own (``util/placement_group.py``).
  ``placement_group_capture_child_tasks`` is accepted: an actor process
  spawns no actors of its own, so there is nothing to capture;
- ``NodeAffinitySchedulingStrategy(node_id, soft)``: the host's node id
  (``state.list_nodes()``) places as usual; another id raises unless
  ``soft``;
- ``SpreadSchedulingStrategy``: one host, placed as usual.
"""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch._private.registry import registry


class PlacementGroupSchedulingStrategy:
    def __init__(self, placement_group, placement_group_bundle_index: int = -1,
                 placement_group_capture_child_tasks: bool = False):
        self.placement_group = placement_group
        self.placement_group_bundle_index = placement_group_bundle_index
        self.placement_group_capture_child_tasks = placement_group_capture_child_tasks


class NodeAffinitySchedulingStrategy:
    def __init__(self, node_id: str, soft: bool = False):
        self.node_id = node_id
        self.soft = soft


class SpreadSchedulingStrategy:
    pass


def resolve(strategy, lease) -> Optional[tuple]:
    """Where an actor with ``strategy`` runs: (group, bundle index, the
    bundle's lease) for a placement group, else None (its own ``lease``,
    if any). Raises for a node that is not the host's (unless soft), for
    a lease beside a bundle, and for a group that is not created."""
    if strategy is None or isinstance(strategy, SpreadSchedulingStrategy):
        return None
    if isinstance(strategy, NodeAffinitySchedulingStrategy):
        if strategy.node_id != registry().node_id and not strategy.soft:
            raise ValueError(f"node {strategy.node_id} is not this host's node "
                             f"{registry().node_id}, and the affinity is not soft")
        return None
    if isinstance(strategy, PlacementGroupSchedulingStrategy):
        if lease is not None:
            raise ValueError("an actor placed in a bundle runs under the bundle's cards; "
                             "pass no lease of its own")
        group = registry().group(strategy.placement_group.id)
        if group is None:
            raise ValueError(f"placement group {strategy.placement_group.id} was not made in "
                             "this process: an actor is placed by the group's creator")
        index, bundle = group.place_actor(strategy.placement_group_bundle_index)
        return group, index, bundle
    raise TypeError(f"unknown scheduling strategy {strategy!r}")
