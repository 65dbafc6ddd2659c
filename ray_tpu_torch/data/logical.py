"""Logical plan: operators + plan object.

Reference: ``python/ray/data/_internal/logical/`` — a ``Dataset`` wraps an
immutable chain of logical operators; execution compiles it to physical
stages. The key optimization (mirroring the reference's
``OperatorFusionRule`` — and XLA's fusion philosophy) is that consecutive
per-block operators fuse into ONE task per block; only all-to-all operators
(repartition/shuffle/sort) and the read boundary break fusion.

The port's copy of ``ray_tpu/data/logical.py``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from ray_tpu_torch.data.datasource import Datasource


class LogicalOp:
    name = "op"

    def is_per_block(self) -> bool:
        return False


class Read(LogicalOp):
    name = "Read"

    def __init__(self, datasource: Datasource, parallelism: int = -1):
        self.datasource = datasource
        self.parallelism = parallelism


class InputBlocks(LogicalOp):
    """Already-materialized refs (e.g. after .materialize())."""

    name = "InputBlocks"

    def __init__(self, refs: list):
        self.refs = refs


class Project(LogicalOp):
    """Column selection (``Dataset.select_columns``) — its own operator so
    the optimizer can push it into columnar reads (reference:
    ``logical/operators/map_operator.py`` Project + projection pushdown)."""

    name = "Project"

    def __init__(self, cols: list):
        self.cols = list(cols)

    def is_per_block(self) -> bool:
        return True


class MapBatches(LogicalOp):
    name = "MapBatches"

    def __init__(self, fn: Callable, batch_size: Optional[int], batch_format: Optional[str],
                 fn_kwargs: Optional[dict] = None, compute: Any = None):
        self.fn = fn
        self.batch_size = batch_size
        self.batch_format = batch_format
        self.fn_kwargs = fn_kwargs or {}
        # None = stateless tasks; ActorPoolStrategy = warm actor pool
        # (stateful UDFs, e.g. models loaded once per actor — reference:
        # ``python/ray/data/_internal/compute.py`` ActorPoolStrategy)
        self.compute = compute

    def is_per_block(self) -> bool:
        return True


class MapRows(LogicalOp):
    name = "Map"

    def __init__(self, fn: Callable):
        self.fn = fn

    def is_per_block(self) -> bool:
        return True


class Filter(LogicalOp):
    name = "Filter"

    def __init__(self, fn: Callable):
        self.fn = fn

    def is_per_block(self) -> bool:
        return True


class FlatMap(LogicalOp):
    name = "FlatMap"

    def __init__(self, fn: Callable):
        self.fn = fn

    def is_per_block(self) -> bool:
        return True


class Limit(LogicalOp):
    name = "Limit"

    def __init__(self, n: int):
        self.n = n


class Repartition(LogicalOp):
    name = "Repartition"

    def __init__(self, num_blocks: int):
        self.num_blocks = num_blocks


class RandomShuffle(LogicalOp):
    name = "RandomShuffle"

    def __init__(self, seed: Optional[int] = None):
        self.seed = seed


class Sort(LogicalOp):
    name = "Sort"

    def __init__(self, key: str, descending: bool = False):
        self.key = key
        self.descending = descending


class Union(LogicalOp):
    name = "Union"

    def __init__(self, others: list):  # list[LogicalPlan]
        self.others = others


class Zip(LogicalOp):
    """Positional column concatenation with another dataset (reference:
    ``Dataset.zip``, ``python/ray/data/dataset.py``)."""

    name = "Zip"

    def __init__(self, other):  # LogicalPlan
        self.other = other


class Join(LogicalOp):
    """Hash join on a key column (reference: ``Dataset.join``) — built on
    the same hash-partition exchange as the distributed groupby."""

    name = "Join"

    def __init__(self, other, on: str, how: str = "inner",
                 suffix: str = "_right"):
        self.other = other  # LogicalPlan
        self.on = on
        self.how = how
        self.suffix = suffix


class LogicalPlan:
    def __init__(self, ops: list[LogicalOp]):
        self.ops = ops

    def with_op(self, op: LogicalOp) -> "LogicalPlan":
        return LogicalPlan(self.ops + [op])

    def __repr__(self):
        return " -> ".join(op.name for op in self.ops)


# ---------------------------------------------------------------------------
# Optimizer rules (reference: python/ray/data/_internal/logical/rules/ —
# a pluggable list of plan→plan rewrites applied before physical planning;
# users add custom rules via DataContext.optimizer_rules).
# ---------------------------------------------------------------------------


class Rule:
    """One logical-plan rewrite. Must be pure: return a NEW plan."""

    name = "rule"

    def apply(self, plan: LogicalPlan) -> LogicalPlan:
        return plan


class EliminateRedundantOps(Rule):
    """Merge consecutive Limits (min wins), collapse consecutive
    Repartitions (last wins), drop a RandomShuffle directly before a Sort
    (the sort re-orders everything anyway)."""

    name = "EliminateRedundantOps"

    def apply(self, plan: LogicalPlan) -> LogicalPlan:
        ops: list[LogicalOp] = []
        for op in plan.ops:
            prev = ops[-1] if ops else None
            if isinstance(op, Limit) and isinstance(prev, Limit):
                ops[-1] = Limit(min(prev.n, op.n))
            elif isinstance(op, Repartition) and isinstance(prev, Repartition):
                ops[-1] = op
            elif isinstance(op, Sort) and isinstance(prev, RandomShuffle):
                ops[-1] = op
            else:
                ops.append(op)
        return LogicalPlan(ops)


class LimitPushdown(Rule):
    """Move a Limit upstream past row-count-preserving 1:1 operators
    (Map, Project) — the streaming executor then transforms only rows that
    survive the limit (reference: ``rules/limit_pushdown.py``). Filter,
    FlatMap, and MapBatches may change row counts: the limit stops there."""

    name = "LimitPushdown"

    def apply(self, plan: LogicalPlan) -> LogicalPlan:
        ops = list(plan.ops)
        moved = True
        while moved:
            moved = False
            for i in range(1, len(ops)):
                if isinstance(ops[i], Limit) and isinstance(
                    ops[i - 1], (MapRows, Project)
                ):
                    ops[i - 1], ops[i] = ops[i], ops[i - 1]
                    moved = True
        return LogicalPlan(ops)


class ProjectionPushdown(Rule):
    """A Project directly after a columnar Read becomes the reader's column
    list — parquet then never decodes pruned columns (reference:
    parquet projection pushdown via ``columns=``)."""

    name = "ProjectionPushdown"

    def apply(self, plan: LogicalPlan) -> LogicalPlan:
        from ray_tpu_torch.data.datasource import ParquetDatasource

        ops = list(plan.ops)
        for i in range(len(ops) - 1):
            op, nxt = ops[i], ops[i + 1]
            if (
                isinstance(op, Read)
                and isinstance(nxt, Project)
                and isinstance(op.datasource, ParquetDatasource)
                and "columns" not in op.datasource.reader_kwargs
            ):
                import copy as _copy

                src = _copy.copy(op.datasource)
                src.reader_kwargs = dict(src.reader_kwargs)
                # partition fields come from paths, not parquet columns.
                # Union across ALL paths: in a heterogeneous layout a column
                # can be a partition field for one file but a real parquet
                # column in another — pruning from the first path alone
                # would wrongly drop (or keep) it; if the layouts disagree,
                # skip the pushdown entirely.
                part_fields = set()
                if src.partitioning is not None and src.paths:
                    per_path = [
                        set(src.partitioning.parse(p)) for p in src.paths
                    ]
                    part_fields = set().union(*per_path)
                    if any(s != per_path[0] for s in per_path[1:]):
                        inconsistent = part_fields - set.intersection(*per_path)
                        if inconsistent & set(nxt.cols):
                            continue
                file_cols = [c for c in nxt.cols if c not in part_fields]
                if not file_cols:
                    # projecting ONLY partition columns: a zero-column
                    # parquet read normalizes to an empty block and would
                    # silently drop every row — keep the full read
                    continue
                src.reader_kwargs["columns"] = file_cols
                new_read = Read(src, op.parallelism)
                # keep the Project: it orders/filters partition columns and
                # is nearly free post-pushdown
                ops[i] = new_read
        return LogicalPlan(ops)


# projection pushdown MUST run before limit pushdown: LimitPushdown swaps a
# Limit in front of Project, which would break the Read->Project adjacency
# the parquet column pruning matches on
DEFAULT_RULES = (EliminateRedundantOps, ProjectionPushdown, LimitPushdown)


def optimize(plan: LogicalPlan, rules=None) -> LogicalPlan:
    """Apply optimizer rules (DataContext.optimizer_rules by default)."""
    if rules is None:
        from ray_tpu_torch.data.context import DataContext

        rules = DataContext.get_current().optimizer_rules
    for rule in rules:
        if isinstance(rule, type):
            rule = rule()
        plan = rule.apply(plan)
    return plan
