"""Path-based partitioning for file datasources.

Reference: ``python/ray/data/datasource/partitioning.py`` —
``Partitioning`` (hive ``key=value`` dirs or positional ``dir`` style),
partition-field extraction from paths, and ``PathPartitionFilter`` for
partition pruning at read planning time (files whose partitions fail the
predicate are never turned into read tasks).

The port's copy of ``ray_tpu/data/partitioning.py``.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence


class Partitioning:
    """Describes how partition fields are encoded in file paths.

    - ``style="hive"``: ``.../year=2024/month=07/file.parquet`` — field
      names come from the path itself.
    - ``style="dir"``: ``.../2024/07/file.parquet`` with
      ``field_names=["year", "month"]`` — positional directories under
      ``base_dir``.
    """

    def __init__(
        self,
        style: str = "hive",
        base_dir: str = "",
        field_names: Optional[Sequence[str]] = None,
    ):
        if style not in ("hive", "dir"):
            raise ValueError(f"unknown partitioning style: {style!r}")
        if style == "dir" and not field_names:
            raise ValueError("style='dir' requires field_names")
        self.style = style
        self.base_dir = os.path.expanduser(base_dir) if base_dir else ""
        self.field_names = list(field_names or [])

    def parse(self, path: str) -> dict:
        """Partition fields encoded in ``path`` (empty dict when none)."""
        rel = path
        if self.base_dir:
            base = self.base_dir.rstrip(os.sep) + os.sep
            if path.startswith(base):
                rel = path[len(base):]
        parts = rel.split(os.sep)[:-1]  # directories only
        if self.style == "hive":
            out = {}
            for p in parts:
                if "=" in p:
                    k, _, v = p.partition("=")
                    out[k] = v
            return out
        # dir style: positional from the END of the dir chain — robust to
        # un-stripped leading path components
        tail = parts[-len(self.field_names):]
        if len(tail) < len(self.field_names):
            return {}
        return dict(zip(self.field_names, tail))


class PathPartitionFilter:
    """Predicate over parsed partition dicts (reference:
    ``PathPartitionFilter.of``): files whose partitions fail are pruned
    before read tasks are created."""

    def __init__(self, partitioning: Partitioning, filter_fn: Callable[[dict], bool]):
        self.partitioning = partitioning
        self.filter_fn = filter_fn

    @staticmethod
    def of(filter_fn: Callable[[dict], bool], style: str = "hive",
           base_dir: str = "", field_names=None) -> "PathPartitionFilter":
        return PathPartitionFilter(
            Partitioning(style, base_dir, field_names), filter_fn
        )

    def __call__(self, path: str) -> bool:
        return bool(self.filter_fn(self.partitioning.parse(path)))
