"""Application metrics: Counter / Gauge / Histogram, merged across the
port's processes.

A copy of ``ray_tpu/util/metrics.py`` (pure Python; the port imports
nothing of ``ray_tpu``): an in-process registry with Prometheus text
exposition (``export_prometheus``), a serializable :func:`snapshot` of the
registry, and a :class:`MetricsAggregator` that merges per-reporter
snapshots into one view keyed by a ``node`` label: counters as deltas
against the reporter's previous snapshot (re-applying the same cumulative
snapshot adds zero; a missed report's counts arrive with the next
snapshot), gauges as last-write, histograms as per-bucket delta merges.
``export_prometheus_merged`` renders the local registry plus the aggregate
as one scrape. On the port, the driver's state API
(``util/state/api.py:cluster_metrics``) asks each live ``ProcessActor``
for its ``snapshot()`` over its pipe and merges them, each actor a
reporter, the host the node. The same calls give the same Prometheus text
in both packages, byte for byte.
"""

from __future__ import annotations

import bisect
import threading
from typing import Optional, Sequence

_registry: dict[str, "Metric"] = {}
_registry_lock = threading.Lock()


class Metric:
    kind = "untyped"

    def __init__(self, name: str, description: str = "", tag_keys: Sequence[str] = ()):
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()
        self._default_tags: dict[str, str] = {}
        with _registry_lock:
            _registry[name] = self

    def set_default_tags(self, tags: dict[str, str]) -> "Metric":
        self._default_tags = dict(tags)
        return self

    def _key(self, tags: Optional[dict]) -> tuple:
        merged = dict(self._default_tags)
        if tags:
            merged.update(tags)
        return tuple(merged.get(k, "") for k in self.tag_keys)

    def _samples(self):
        with self._lock:
            return dict(self._values)


class Counter(Metric):
    kind = "counter"

    def inc(self, value: float = 1.0, tags: Optional[dict] = None):
        if value < 0:
            raise ValueError("counters only increase")
        k = self._key(tags)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + value


class Gauge(Metric):
    kind = "gauge"

    def set(self, value: float, tags: Optional[dict] = None):
        with self._lock:
            self._values[self._key(tags)] = float(value)


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, name, description="", boundaries: Sequence[float] = (), tag_keys=()):
        super().__init__(name, description, tag_keys)
        self.boundaries = sorted(boundaries) or [0.1, 1, 10, 100, 1000]
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}

    def observe(self, value: float, tags: Optional[dict] = None):
        k = self._key(tags)
        with self._lock:
            counts = self._counts.setdefault(k, [0] * (len(self.boundaries) + 1))
            counts[bisect.bisect_left(self.boundaries, value)] += 1
            self._sums[k] = self._sums.get(k, 0.0) + value

    def _hist_samples(self):
        with self._lock:
            return (
                {k: list(v) for k, v in self._counts.items()},
                dict(self._sums),
            )


def export_prometheus() -> str:
    """All registered metrics in Prometheus text format."""
    lines = []
    with _registry_lock:
        metrics = list(_registry.values())
    for m in metrics:
        lines.append(f"# HELP {m.name} {m.description}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        if isinstance(m, Histogram):
            counts, sums = m._hist_samples()
            for key, bucket_counts in counts.items():
                base = _fmt_tags(m.tag_keys, key)
                cum = 0
                for b, c in zip(m.boundaries + [float("inf")], bucket_counts):
                    cum += c
                    le = "+Inf" if b == float("inf") else repr(b)
                    tag_str = _fmt_tags(m.tag_keys + ("le",), key + (le,))
                    lines.append(f"{m.name}_bucket{tag_str} {cum}")
                lines.append(f"{m.name}_sum{base} {sums.get(key, 0.0)}")
                lines.append(f"{m.name}_count{base} {cum}")
        else:
            for key, v in m._samples().items():
                lines.append(f"{m.name}{_fmt_tags(m.tag_keys, key)} {v}")
    return "\n".join(lines) + "\n"


def _escape_label(v) -> str:
    # Prometheus exposition format: backslash, quote, newline must be escaped
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _fmt_tags(keys: tuple, values: tuple) -> str:
    if not keys:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label(v)}"' for k, v in zip(keys, values)
    )
    return "{" + inner + "}"


def _clear_registry():
    with _registry_lock:
        _registry.clear()


def fold_counter_delta(metric: "Counter", last: dict, key, value: float, tags: Optional[dict] = None) -> None:
    """Fold a monotonically-growing stats-dict value into a Counter as a
    delta against the last mirrored value (Counters only inc). A value
    BELOW the last mirrored one means the source table was reset (its
    process restarted its counts): re-baseline so the
    mirror resumes instead of freezing until the new cumulative values
    grow past the old ones."""
    prev = last.get(key, 0.0)
    if value > prev:
        metric.inc(value - prev, tags=tags)
        last[key] = value
    elif value < prev:
        last[key] = value


# ---------------------------------------------------------- cluster shipping

def snapshot() -> list[dict]:
    """Serializable snapshot of this process's registry (cumulative values
    since process start). The driver's state API asks each live actor for
    it over the actor's pipe; the aggregator diffs consecutive snapshots
    per reporter, so reading is stateless here and idempotent there."""
    out = []
    with _registry_lock:
        metrics = list(_registry.values())
    for m in metrics:
        rec: dict = {
            "name": m.name,
            "kind": m.kind,
            "description": m.description,
            "tag_keys": tuple(m.tag_keys),
        }
        if isinstance(m, Histogram):
            counts, sums = m._hist_samples()
            rec["boundaries"] = list(m.boundaries)
            rec["counts"] = counts
            rec["sums"] = sums
        else:
            rec["values"] = m._samples()
        out.append(rec)
    return out


class MetricsAggregator:
    """The driver's merge of per-reporter registry snapshots into one view
    with a ``node`` label.

    Each reporter (one actor process) ships CUMULATIVE values;
    the aggregator stores the reporter's last snapshot and folds only the
    positive delta into the per-node aggregate. That makes the merge immune
    to the report-channel failure modes: a REPLAYED snapshot (retry after a
    lost reply) diffs to zero — no double count; a DROPPED report's counts
    ride the next snapshot's larger cumulative value; a RESTARTED reporter
    has a new reporter id (pid-salted), so its fresh counts add cleanly.
    Gauges are last-write per (node, tags); histograms delta-merge per
    bucket. Reporter baselines are a bounded LRU keyed by last report
    (re-insert on every apply), so eviction hits the least-recently-
    reporting — i.e. dead — reporters first. The cap must exceed the
    LIVE reporter count: evicting a live reporter's baseline makes its
    next cumulative snapshot re-add its entire history.
    """

    def __init__(self, max_reporters: int = 4096):
        import collections
        import threading as _threading

        self._lock = _threading.Lock()
        self._max_reporters = max_reporters
        # reporter -> {metric name -> last snapshot rec}
        self._last: "collections.OrderedDict[str, dict]" = (
            collections.OrderedDict()
        )
        # name -> {"kind","description","tag_keys",
        #          "values": {(tags..., node): float},
        #          "counts": {key: [..]}, "sums": {key: float},
        #          "boundaries": [..]}
        self._agg: dict[str, dict] = {}

    def apply(self, node: str, reporter: str, snap: list[dict]) -> None:
        with self._lock:
            last = self._last.pop(reporter, None) or {}
            self._last[reporter] = {rec["name"]: rec for rec in snap}
            while len(self._last) > self._max_reporters:
                self._last.popitem(last=False)
            for rec in snap:
                self._apply_one(node, last.get(rec["name"]), rec)

    def _apply_one(self, node: str, prev: Optional[dict], rec: dict) -> None:
        name = rec["name"]
        agg = self._agg.get(name)
        if agg is None:
            agg = self._agg[name] = {
                "kind": rec["kind"],
                "description": rec.get("description", ""),
                "tag_keys": tuple(rec.get("tag_keys", ())),
                "values": {},
                "counts": {},
                "sums": {},
                "boundaries": list(rec.get("boundaries", [])),
            }
        if rec["kind"] == "histogram":
            prev_counts = (prev or {}).get("counts", {})
            prev_sums = (prev or {}).get("sums", {})
            for key, buckets in rec.get("counts", {}).items():
                nkey = key + (node,)
                old = prev_counts.get(key, [0] * len(buckets))
                dst = agg["counts"].setdefault(nkey, [0] * len(buckets))
                if len(dst) < len(buckets):
                    dst.extend([0] * (len(buckets) - len(dst)))
                for i, c in enumerate(buckets):
                    dst[i] += max(c - (old[i] if i < len(old) else 0), 0)
                agg["sums"][nkey] = agg["sums"].get(nkey, 0.0) + max(
                    rec.get("sums", {}).get(key, 0.0)
                    - prev_sums.get(key, 0.0),
                    0.0,
                )
            return
        prev_values = (prev or {}).get("values", {})
        for key, v in rec.get("values", {}).items():
            nkey = key + (node,)
            if rec["kind"] == "counter":
                delta = v - prev_values.get(key, 0.0)
                if delta < 0:  # reporter reset under a reused id
                    delta = v
                agg["values"][nkey] = agg["values"].get(nkey, 0.0) + delta
            else:  # gauge / untyped: last write per (tags, node)
                agg["values"][nkey] = v

    def model(self) -> list[dict]:
        """The merged cluster view, snapshot-shaped with the ``node`` tag
        appended to every metric's tag keys (the ``cluster_metrics`` op
        reply)."""
        out = []
        with self._lock:
            for name, agg in sorted(self._agg.items()):
                rec: dict = {
                    "name": name,
                    "kind": agg["kind"],
                    "description": agg["description"],
                    "tag_keys": agg["tag_keys"] + ("node",),
                }
                if agg["kind"] == "histogram":
                    rec["boundaries"] = list(agg["boundaries"])
                    rec["counts"] = {k: list(v) for k, v in agg["counts"].items()}
                    rec["sums"] = dict(agg["sums"])
                else:
                    rec["values"] = dict(agg["values"])
                out.append(rec)
        return out


def merged_model(aggregator: Optional["MetricsAggregator"], local_node: str = "head") -> list[dict]:
    """One cluster-wide metrics model: the local (head-process) registry —
    stamped with ``node=local_node`` — merged with the aggregator's
    shipped per-node view. Same-name metrics union their (tags, node)
    sample sets; the local process wins ties (it is the live value)."""
    by_name: dict[str, dict] = {}
    for rec in aggregator.model() if aggregator is not None else []:
        by_name[rec["name"]] = rec
    for rec in snapshot():
        tagged = {
            "name": rec["name"],
            "kind": rec["kind"],
            "description": rec["description"],
            "tag_keys": tuple(rec["tag_keys"]) + ("node",),
        }
        if rec["kind"] == "histogram":
            tagged["boundaries"] = list(rec.get("boundaries", []))
            tagged["counts"] = {
                k + (local_node,): list(v)
                for k, v in rec.get("counts", {}).items()
            }
            tagged["sums"] = {
                k + (local_node,): v for k, v in rec.get("sums", {}).items()
            }
        else:
            tagged["values"] = {
                k + (local_node,): v for k, v in rec.get("values", {}).items()
            }
        base = by_name.get(rec["name"])
        if base is None:
            by_name[rec["name"]] = tagged
        elif rec["kind"] == "histogram":
            # same (tags, node) sample from both the local registry and the
            # aggregate (a head-process reporter): combine, don't shadow
            counts = base.setdefault("counts", {})
            for k, v in tagged["counts"].items():
                dst = counts.setdefault(k, [0] * len(v))
                for i, c in enumerate(v):
                    if i < len(dst):
                        dst[i] += c
                    else:
                        dst.append(c)
            sums = base.setdefault("sums", {})
            for k, v in tagged["sums"].items():
                sums[k] = sums.get(k, 0.0) + v
        else:
            values = base.setdefault("values", {})
            for k, v in tagged["values"].items():
                if rec["kind"] == "counter":
                    values[k] = values.get(k, 0.0) + v
                else:
                    values[k] = v
    return [by_name[k] for k in sorted(by_name)]


def render_prometheus(model: list[dict]) -> str:
    """Prometheus text exposition of a metrics model (snapshot-shaped)."""
    lines = []
    for rec in model:
        name, keys = rec["name"], tuple(rec["tag_keys"])
        lines.append(f"# HELP {name} {rec.get('description', '')}")
        lines.append(f"# TYPE {name} {rec['kind']}")
        if rec["kind"] == "histogram":
            bounds = list(rec.get("boundaries", []))
            for key, bucket_counts in rec.get("counts", {}).items():
                base = _fmt_tags(keys, key)
                cum = 0
                for b, c in zip(bounds + [float("inf")], bucket_counts):
                    cum += c
                    le = "+Inf" if b == float("inf") else repr(b)
                    tag_str = _fmt_tags(keys + ("le",), key + (le,))
                    lines.append(f"{name}_bucket{tag_str} {cum}")
                lines.append(
                    f"{name}_sum{base} {rec.get('sums', {}).get(key, 0.0)}"
                )
                lines.append(f"{name}_count{base} {cum}")
        else:
            for key, v in rec.get("values", {}).items():
                lines.append(f"{name}{_fmt_tags(keys, key)} {v}")
    return "\n".join(lines) + "\n"


def export_prometheus_merged(
    aggregator: Optional["MetricsAggregator"], local_node: str = "head"
) -> str:
    """The cluster scrape: local registry + every shipped node, one text
    exposition with a ``node`` label on every sample."""
    return render_prometheus(merged_model(aggregator, local_node))
