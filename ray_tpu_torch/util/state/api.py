"""State API: the port's live processes, placement groups, calls, metrics
and spans.

The port's counterpart of ``ray_tpu/util/state/api.py``, read from the
port's own sources in the driver: its registry (``_private/registry.py``:
the ``ProcessActor``s and ``WorkerGroup`` ranks it spawned, its placement
groups, each call's events), the host's card ledger (``_private/
cards.py``), the live actors' metrics registries and span rings (asked
over their pipes), and Serve's proxy. In a port process, each function
runs in its spawner, over its link (``_private/driver_link.py``).

The log functions read the driver's session log directory and its ring
buffer (``_private/log_capture.py``); ``get_worker_stacks`` asks each live
actor's reader thread for its threads' stacks.

The node functions (``drain_node``, ``drain_status``, ``preempt_node``)
act on the card ledger's nodes (``_private/cards.py``, the autoscaler's
card pools) in the calling process, driver or not: a node's state lives in
its file, which any process may change. ``autoscaler_state`` is the
autoscaler's view: the ledger's nodes and the driver's unplaced work (the
bundles of its ``PENDING`` placement groups and the Serve replicas that
found no lease). Functions with no source on one host are not ported:
``list_objects`` (no object store), ``transfer_stats``,
``recovery_stats`` and ``actor_creation_stats`` (``ROADMAP.md``, "Out by
decision").
"""

from __future__ import annotations

import collections
import functools
import json
import os
import sys
import threading
from collections import Counter
from typing import Optional

from ray_tpu_torch._private import driver_link, log_capture
from ray_tpu_torch._private.registry import registry
from ray_tpu_torch.util import metrics, tracing

PULL_TIMEOUT_S = 10.0  # how long a pull waits for the live actors' replies
STACKS_TIMEOUT_S = 5.0  # how long a stack dump waits for the live actors' replies
SPANS_KEPT = 16384  # merged spans the driver keeps, oldest dropped first

_DRIVER_FNS: dict = {}
_aggregator = metrics.MetricsAggregator()
_spans: "collections.OrderedDict[str, dict]" = collections.OrderedDict()
_spans_dropped = 0
_spans_lock = threading.Lock()
_tenants: dict = {}
_tenants_lock = threading.Lock()


def _in_driver(fn):
    """``fn`` runs in the driver: here, or in this process's spawner."""
    _DRIVER_FNS[fn.__name__] = fn

    @functools.wraps(fn)
    def inner(*args, **kwargs):
        if driver_link.parent_address() is not None:
            return driver_link.call("state", fn.__name__, args, kwargs)
        return fn(*args, **kwargs)

    return inner


def driver_function(name: str):
    return _DRIVER_FNS[name]


def _pull(fn) -> list[tuple]:
    """(actor, value) of ``fn`` run in each live actor, for those that
    answer within ``PULL_TIMEOUT_S`` (one busy with a long call is left
    out; a later pull asks it again)."""
    from ray_tpu_torch._private.process_actor import wait

    calls = [(h, h.call(fn)) for h in registry().live_handles()]
    wait([c for _, c in calls], num_returns=len(calls), timeout=PULL_TIMEOUT_S)
    return [(h, c._value) for h, c in calls if c.done and c._ok]


@_in_driver
def list_actors(limit: int = 1000) -> list[dict]:
    """Every ``ProcessActor`` this driver spawned (the ended ones too, the
    last 1,000): id, name, class, state, pid, cards and CPU slots,
    placement group and bundle, calls pending, death cause."""
    out = []
    for r in registry().processes():
        if r["kind"] != "actor":
            continue
        h = registry().handle(r["id"])
        out.append({"actor_id": r["id"], "class_name": r["class_name"], "state": r["state"],
                    "name": r["name"], "pid": r["pid"], "cards": r["cards"], "cpu": r["cpu"],
                    "placement_group_id": r["placement_group_id"],
                    "bundle_index": r["bundle_index"],
                    "pending_tasks": len(h._link.pending) if h is not None else 0,
                    "restarts_left": 0, "death_cause": r["death_cause"]})
    return out[:limit]


@_in_driver
def list_workers(limit: int = 1000) -> list[dict]:
    """Every live process this driver spawned: its actors and its
    ``WorkerGroup`` ranks."""
    out = []
    for r in registry().processes():
        if r["state"] == "DEAD":
            continue
        h = registry().handle(r["id"])
        running = len(h._link.pending) if h is not None else 0
        out.append({"worker_id": r["id"], "node_id": registry().node_id, "pid": r["pid"],
                    "kind": r["kind"], "name": r["name"], "state": r["state"],
                    "running_tasks": running, "idle": running == 0})
    return out[:limit]


@_in_driver
def list_nodes() -> list[dict]:
    """The card ledger's nodes when it has any (each with its cards, CPU
    slots, what of them no lease holds, its group and its drain state);
    otherwise the host: its CPU slots and cards, and what of them no lease
    holds."""
    from ray_tpu_torch._private.cards import default_ledger

    ledger = default_ledger()
    nodes = ledger.node_table()
    if nodes:
        return [{"NodeID": n["node_id"], "Alive": n["alive"], "Resources": n["total"],
                 "Available": n["available"], "Cards": n["cards"], "Labels": n["labels"],
                 "Group": n["group"], "Draining": n["draining"], "DrainState": n["drain_state"]}
                for n in nodes]
    free, (cards, cpus) = ledger.free(), ledger.totals()
    return [{"NodeID": registry().node_id, "Alive": True,
             "Resources": {"CPU": cpus, "GPU": float(len(cards))},
             "Available": {"CPU": free.cpus, "GPU": sum(free.shares.values())},
             "Cards": cards, "Labels": {}, "Draining": False, "DrainState": None}]


def _tenant() -> str:
    return os.environ.get("RAY_TPU_TENANT") or "default"


@_in_driver
def autoscaler_state(ledger=None) -> dict:
    """The autoscaler's view (the reference's ``autoscaler_state``): the
    nodes of ``ledger`` (default: the driver's) with ``node_id``,
    ``alive``, ``idle``, ``total``, ``available``, ``labels``,
    ``draining`` and ``preempting``; and ``pending_demand``, one entry a
    bundle of each ``PENDING`` placement group and one a Serve replica
    that found no lease, each ``{"resources": shape, "tenant": name}``."""
    from ray_tpu_torch._private.cards import default_ledger

    demand = [{"resources": dict(b), "tenant": _tenant()}
              for g in registry().groups() if g.state == "PENDING" for b in g.bundles]
    serve_api = sys.modules.get("ray_tpu_torch.serve.api")
    controller = None if serve_api is None else serve_api._controller
    if controller is not None:
        demand += [{"resources": shape, "tenant": _tenant()}
                   for shape in controller.lease_demand()]
    nodes = [{k: n[k] for k in ("node_id", "alive", "idle", "total", "available", "labels",
                                "draining", "preempting")}
             for n in (ledger or default_ledger()).node_table()]
    return {"pending_demand": demand, "nodes": nodes}


def drain_node(node_id: str, deadline_s: float = 60.0, reason: str = "", ledger=None) -> dict:
    """Stop granting a node's cards, so that it drains before it is
    removed (``ray drain-node``): its leases run on, no new lease lands on
    it. Returns the drain record; poll ``drain_status`` for ``drained``
    (no lease left on its cards) or ``timeout`` (``deadline_s`` lapsed
    first)."""
    from ray_tpu_torch._private.cards import default_ledger

    return (ledger or default_ledger()).drain_node(node_id, deadline_s, reason)


def drain_status(node_id: Optional[str] = None, ledger=None):
    """One drain record (by a prefix of the node's id), or every one.
    Records outlive their nodes (the newest ``cards.DRAINS_KEPT``)."""
    from ray_tpu_torch._private.cards import default_ledger

    recs = (ledger or default_ledger()).drains()
    if node_id is None:
        return recs
    matches = [r for r in recs if r["node_id"].startswith(node_id)]
    return matches[-1] if matches else None


def preempt_node(node_id: str, notice_s: float = 30.0, reason: str = "", ledger=None) -> dict:
    """A termination notice for a node: it will be gone in ``notice_s``
    seconds. It drains as ``drain_node`` does, reads ``preempting`` (the
    autoscaler launches its replacement at once) and counts as dead once
    the notice lapses. Returns the drain record."""
    from ray_tpu_torch._private.cards import default_ledger

    return (ledger or default_ledger()).drain_node(
        node_id, max(float(notice_s), 0.0), reason or "preempt-notice", preempt=True)


@_in_driver
def list_placement_groups(limit: int = 1000) -> list[dict]:
    return [g.table() for g in registry().groups()][:limit]


@_in_driver
def list_tasks(limit: int = 1000) -> list[dict]:
    """The core API's queued and running tasks (``PENDING_ARGS_AVAIL``,
    ``PENDING_SCHEDULING``, ``RUNNING``, as the reference lists them), then
    the calls sent to a live actor and not yet answered (``RUNNING``; the
    port does not tell a call queued in the actor from one running)."""
    names = {e["task_id"]: e["name"] for e in list(registry().task_events)
             if e["event"] == "DISPATCHED"}
    core = sys.modules.get("ray_tpu_torch._private.worker")
    driver = None if core is None else core.driver()
    out = [] if driver is None else driver.scheduler.live()
    for h in registry().live_handles():
        if h._kind == "worker":  # its task is listed above
            continue
        with h._link.lock:
            pending = list(h._link.pending.items())
        out += [{"task_id": f"{h.actor_id}:{call_id}",
                 "name": names.get(f"{h.actor_id}:{call_id}", f"{h._class_name}.{p.method}"),
                 "state": "RUNNING", "worker_id": h.actor_id} for call_id, p in pending]
    return out[:limit]


@_in_driver
def summarize_tasks() -> dict:
    """Event counts per call name (``ray summary tasks`` analog)."""
    by_name: dict[str, Counter] = {}
    for e in list(registry().task_events):
        by_name.setdefault(e["name"], Counter())[e["event"]] += 1
    return {name: dict(c) for name, c in by_name.items()}


@_in_driver
def cluster_metrics() -> list[dict]:
    """The merged metrics model: each live actor's ``metrics.snapshot()``
    (a reporter each; counters as deltas) plus the driver's own registry,
    with the host's ``node`` label on every sample."""
    node = registry().node_id
    for h, snap in _pull(metrics.snapshot):
        _aggregator.apply(node, h.actor_id, snap)
    return metrics.merged_model(_aggregator, local_node=node)


@_in_driver
def cluster_spans() -> dict:
    """Every span of the live actors' rings and of the driver's own, merged
    by span id: ``{"spans": [...], "dropped_spans": n}``."""
    global _spans_dropped
    shipped = [s for _, spans in _pull(tracing.get_spans) for s in spans]
    with _spans_lock:
        for s in shipped + tracing.get_spans():
            _spans[s["span_id"]] = s
        while len(_spans) > SPANS_KEPT:
            _spans.popitem(last=False)
            _spans_dropped += 1
        return {"spans": list(_spans.values()),
                "dropped_spans": _spans_dropped + tracing.dropped_spans()}


@_in_driver
def timeline(path: Optional[str] = None) -> list[dict]:
    """Chrome-trace export: each actor call and core API task (its dispatch
    or start to its end) and every merged span, with parent edges in ``args``."""
    starts: dict[str, dict] = {}
    trace: list[dict] = []
    for e in list(registry().task_events):
        if e["event"] in ("DISPATCHED", "RUNNING"):
            starts.setdefault(e["task_id"], e)
        elif e["event"] in ("FINISHED", "FAILED"):
            s = starts.pop(e["task_id"], None)
            begin = s["t"] if s else e["t"]
            trace.append({"name": e["name"], "cat": "task", "ph": "X", "ts": begin * 1e6,
                          "dur": max((e["t"] - begin) * 1e6, 1), "pid": 1,
                          "tid": hash(e["task_id"]) % 64,
                          "args": {"task_id": e["task_id"], "status": e["event"]}})
    node_pids: dict = {"head": 1}
    trace.extend(tracing.spans_to_chrome(
        cluster_spans()["spans"],
        pid_of=lambda s: node_pids.setdefault(s.get("node") or "head", len(node_pids) + 1)))
    if path:
        with open(path, "w") as f:
            json.dump(trace, f)
    return trace


@_in_driver
def list_logs() -> list[dict]:
    """Every captured process's log files (dead processes too): its id (an
    actor's is its actor id), pid, name and the bytes of its stdout and
    stderr."""
    return log_capture.list_logs()


@_in_driver
def get_log(worker_id_prefix: str, source: str = "out", tail_bytes: int = 65536) -> str:
    """The last ``tail_bytes`` of a process's captured stdout (``"out"``)
    or stderr (``"err"``), by a prefix of its id; dead processes too (the
    files outlive them)."""
    return log_capture.get_log(worker_id_prefix, source, tail_bytes)


@_in_driver
def tail_cluster_logs(n: int = 1000) -> list[dict]:
    """The latest ``n`` captured lines across every process (the ring
    buffer): id, source, line, time, pid, name."""
    return log_capture.tail(n)


@_in_driver
def get_worker_stacks(worker_id: Optional[str] = None) -> dict:
    """Every thread's stack in each live actor's process (or those whose id
    starts with ``worker_id``): {actor id: text}. Each is answered by the
    actor's reader thread, so an actor busy in a method answers too; one
    that does not within ``STACKS_TIMEOUT_S`` reads
    ``"<no response within 5 s>"``."""
    from ray_tpu_torch._private.process_actor import wait

    asks = [(h, h.stacks()) for h in registry().live_handles()
            if worker_id is None or h.actor_id.startswith(worker_id)]
    wait([r for _, r in asks], num_returns=len(asks), timeout=STACKS_TIMEOUT_S)
    return {h.actor_id: (r._value if r.done and r._ok else
                         f"<no response within {STACKS_TIMEOUT_S:g} s>") for h, r in asks}


def _proxy():
    module = sys.modules.get("ray_tpu_torch.serve.proxy")
    return None if module is None else module._proxy


@_in_driver
def tenant_stats() -> list[dict]:
    """Each configured tenant's policy (weight, priority, quota) with the
    proxy's in-flight and shed counts for it."""
    proxy = _proxy()
    stats = proxy.get_stats() if proxy is not None else {}
    with _tenants_lock:
        rows = [dict(r) for r in _tenants.values()]
    for r in rows:
        r["inflight"] = stats.get("inflight_by_tenant", {}).get(r["tenant"], 0)
        r["shed"] = stats.get("shed_by_tenant", {}).get(r["tenant"], 0)
    return rows


@_in_driver
def set_tenant_quota(tenant: str, quota: Optional[dict] = None, weight: Optional[float] = None,
                     priority: Optional[int] = None) -> dict:
    """Configure a tenant's policy: ``quota`` a per-resource cap dict
    (``{}`` clears, None leaves it), ``weight`` its fair share of the
    proxy's in-flight budget, ``priority`` its tier. The running proxy's
    per-tenant caps follow (``ProxyServer.set_tenant_policies``)."""
    with _tenants_lock:
        r = _tenants.setdefault(tenant, {"tenant": tenant, "weight": 1.0, "priority": 0,
                                         "quota": None, "configured": True})
        if quota is not None:
            r["quota"] = {k: float(v) for k, v in quota.items()} if quota else None
        if weight is not None:
            r["weight"] = max(float(weight), 0.01)
        if priority is not None:
            r["priority"] = int(priority)
        rows = [dict(x) for x in _tenants.values()]
        out = dict(r)
    proxy = _proxy()
    if proxy is not None:
        proxy.set_tenant_policies(rows)
    return out


@_in_driver
def proxy_stats(proxy_id_prefix: Optional[str] = None) -> dict:
    """The driver's proxy's admission and data-plane counters
    (``/-/stats``), keyed by proxy id (node id and port)."""
    proxy = _proxy()
    if proxy is None:
        return {}
    pid = f"{registry().node_id}:{proxy.port}"
    if proxy_id_prefix and not pid.startswith(proxy_id_prefix):
        return {}
    return {pid: proxy.get_stats()}


@_in_driver
def serve_status() -> dict:
    """The driver's Serve applications (``serve.schema.status``), for a
    process attached to it (the CLI's ``serve status``)."""
    from ray_tpu_torch.serve import schema

    return schema.status()


@_in_driver
def serve_shutdown() -> None:
    """Shut the driver's Serve down (``serve.shutdown``), for a process
    attached to it (the CLI's ``serve shutdown``)."""
    from ray_tpu_torch import serve

    serve.shutdown()
