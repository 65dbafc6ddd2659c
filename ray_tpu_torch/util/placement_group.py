"""Placement groups: bundles of card-ledger leases reserved together.

The port's counterpart of ``ray_tpu/util/placement_group.py``, on one host
and the port's own processes. A group's bundles are leases of the host's
card ledger (``_private/cards.py``), taken with one ``CardLedger.acquire``,
all or none:

- *The reservation.* The group's creator holds the bundles' leases, so a
  bundle's capacity is counted once, whether or not an actor runs in it,
  and a reservation whose holder is gone frees itself as every lease does.
  Every other lease of the ledger (``spawn_env.assign_cards``: Train's and
  the gangs' ranks, Tune's trials, Data's actors, Serve's replicas) is
  taken beside it, so the two never overlap.
- *Actors in a bundle.* ``ProcessActor(...,
  scheduling_strategy=PlacementGroupSchedulingStrategy(pg, i))`` runs
  under bundle i's cards and takes no lease of its own: it receives a copy
  of the bundle's lease descriptor, so the bundle stays reserved while
  either the creator or the actor holds it. A killed actor leaves its
  bundle reserved. Actors in one bundle share its cards.
- *A pending group* (too little free) is placed when capacity frees: by
  ``ready(timeout)`` / ``wait``, which retry until their deadline, and by
  any placement into it.
- *Strategies on one host.* PACK, SPREAD and STRICT_PACK place every
  bundle on the host; STRICT_SPREAD with more than one bundle is never
  placed (the reference's outcome on a one-node cluster).
- *Removal* ends the actors placed in the group, then frees its bundles:
  on one ledger a freed bundle under a live actor would let a new lease
  overlap its card. The reference frees the bundles and leaves the actors
  running.
- *Resources.* Bundles name ``"CPU"`` (slots) and ``"GPU"`` (a share of
  one card below 1, or whole cards) only.

A group lives in the process that made it, with its leases. A port process
that receives a ``PlacementGroup`` queries it through its spawner
(``_private/driver_link.py``); inside an actor placed in a group,
``get_current_placement_group()`` returns that group.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from typing import Optional

from ray_tpu_torch._private import driver_link
from ray_tpu_torch._private.cards import CardLedger, LedgerError, default_ledger
from ray_tpu_torch._private.registry import registry

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")
BUNDLE_RESOURCES = ("CPU", "GPU")
PLACE_POLL_S = 0.05  # how often a pending group's ready() retries

_ENV = "RAY_TPU_TORCH_PLACEMENT_GROUP"


class PlacementGroup:
    def __init__(self, pg_id: str, bundles: list[dict], strategy: str):
        self.id = pg_id
        self.bundles = bundles
        self.strategy = strategy

    def ready(self, timeout: Optional[float] = None) -> bool:
        """True once every bundle is reserved; False if ``timeout`` seconds
        pass first (None: wait until it is), or once it is removed."""
        return group_op(self.id, "ready", (timeout,))

    def wait(self, timeout_seconds: Optional[float] = None) -> bool:
        return self.ready(timeout=timeout_seconds)

    @property
    def bundle_specs(self) -> list[dict]:
        return self.bundles

    def table(self) -> dict:
        return group_op(self.id, "table", ())

    def __reduce__(self):
        return (PlacementGroup, (self.id, self.bundles, self.strategy))

    def __repr__(self):
        return f"<PlacementGroup {self.id[:12]} {self.strategy} {self.bundles}>"


class _Group:
    """A group's state in the process that made it: PENDING, CREATED or
    REMOVED; its bundles' leases; the actors placed in each bundle."""

    def __init__(self, bundles: list[dict], strategy: str, name: str, ledger: CardLedger):
        self.id = uuid.uuid4().hex
        self.bundles = [dict(b) for b in bundles]
        self.strategy, self.name, self.ledger = strategy, name, ledger
        self.state = "PENDING"
        self.leases: list = []
        self.actors: list[list[str]] = [[] for _ in bundles]
        self.created_t, self.placed_t, self.removed_t = time.time(), None, None
        self._lock = threading.Lock()

    def _place_locked(self) -> bool:
        if self.state != "PENDING":
            return self.state == "CREATED"
        if self.strategy == "STRICT_SPREAD" and len(self.bundles) > 1:
            return False  # one node: no two bundles on distinct nodes
        try:
            self.leases = self.ledger.acquire(
                self.bundles, f"placement group {self.name or self.id[:12]}")
        except LedgerError:
            return False
        self.state, self.placed_t = "CREATED", time.time()
        return True

    def ready(self, timeout: Optional[float] = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                if self._place_locked():
                    return True
                if self.state == "REMOVED":
                    return False
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(PLACE_POLL_S if deadline is None
                       else max(0.0, min(PLACE_POLL_S, deadline - time.monotonic())))

    def table(self) -> dict:
        with self._lock:
            placed = self.state == "CREATED"
            node = registry().node_id if placed else None
            return {"placement_group_id": self.id, "name": self.name,
                    "bundles": [dict(b) for b in self.bundles], "strategy": self.strategy,
                    "state": self.state, "ready": placed, "nodes": [node] * len(self.bundles),
                    "bundle_cards": [dict(lease.gpu) for lease in self.leases] if placed
                    else [None] * len(self.bundles),
                    "bundle_actors": [list(a) for a in self.actors]}

    def place_actor(self, index: int) -> tuple:
        """(bundle index, its lease) for an actor placed in the group:
        ``index``, or -1 for the bundle with the fewest live actors."""
        with self._lock:
            if not self._place_locked():
                raise RuntimeError(f"placement group {self.id[:12]} is {self.state.lower()}: "
                                   "an actor is placed only in a created group")
            if not -1 <= index < len(self.bundles):
                raise ValueError(f"bundle index {index} out of range for "
                                 f"{len(self.bundles)} bundles")
            if index == -1:
                live = [sum(registry().handle(a) is not None for a in ids) for ids in self.actors]
                index = live.index(min(live))
            return index, self.leases[index]

    def add_actor(self, index: int, actor_id: str) -> None:
        with self._lock:
            self.actors[index].append(actor_id)

    def remove(self) -> None:
        """End the group's actors, then free its bundles."""
        with self._lock:
            if self.state == "REMOVED":
                return
            self.state = "REMOVED"
            actors = [a for ids in self.actors for a in ids]
            leases, self.leases = self.leases, []
        for actor_id in actors:
            handle = registry().handle(actor_id)
            if handle is not None:
                handle.kill()
        for lease in leases:
            lease.release()
        self.removed_t = time.time()


def group_op(group_id: str, method: str, args: tuple):
    """``method`` of the group in the process that holds it: here, or the
    spawner's (over the link)."""
    group = registry().group(group_id)
    if group is not None:
        return getattr(group, method)(*args)
    if driver_link.parent_address() is None:
        raise ValueError(f"unknown placement group {group_id}")
    return driver_link.call("group", group_id, method, args)


def _validate(bundles: list[dict]) -> None:
    for b in bundles:
        if not b or any(v < 0 for v in b.values()):
            raise ValueError(f"invalid bundle: {b}")
        unknown = set(b) - set(BUNDLE_RESOURCES)
        if unknown:
            raise ValueError(f"a bundle names {BUNDLE_RESOURCES} only (the host's card ledger), "
                             f"got {sorted(unknown)} in {b}")
        g = float(b.get("GPU", 0))
        if g > 1 and g != int(g):
            raise ValueError(f"a bundle's GPU is a share of one card below 1 or whole cards, "
                             f"got {g}")


def placement_group(bundles: list[dict], strategy: str = "PACK", name: str = "",
                    lifetime: Optional[str] = None) -> PlacementGroup:
    """Reserve ``bundles`` on the host's card ledger (all or none), now if
    they fit, else once capacity frees. ``lifetime`` is accepted: a group
    lives as long as the process that made it."""
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"strategy must be one of {VALID_STRATEGIES}, got {strategy}")
    if not bundles:
        raise ValueError("placement group requires at least one bundle")
    _validate(bundles)
    group = _Group(bundles, strategy, name, default_ledger())
    registry().add_group(group)
    with group._lock:
        group._place_locked()
    return PlacementGroup(group.id, [dict(b) for b in bundles], strategy)


def remove_placement_group(pg: PlacementGroup) -> None:
    """End the actors placed in ``pg``, then free its bundles."""
    group_op(pg.id, "remove", ())


def get_current_placement_group() -> Optional[PlacementGroup]:
    """Inside an actor placed in a group: that group; else None."""
    spec = os.environ.get(_ENV)
    if not spec:
        return None
    d = json.loads(spec)
    return PlacementGroup(d["id"], d["bundles"], d["strategy"])


def placed_env(pg: PlacementGroup, index: int) -> dict:
    """The environment entry of an actor placed in bundle ``index`` of
    ``pg``."""
    return {_ENV: json.dumps({"id": pg.id, "bundles": pg.bundles, "strategy": pg.strategy,
                              "bundle_index": index})}
