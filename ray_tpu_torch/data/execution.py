"""Streaming executor: the port's counterpart of ``ray_tpu/data/execution.py``.

Reference: ``python/ray/data/_internal/execution/streaming_executor.py:52`` —
blocks stream through operator stages; per-stage in-flight caps provide
backpressure; all-to-all stages are barriers.

The plan compiles, as in the JAX package, into alternating [per-block fused
stage | all-to-all stage] segments. The port has no object store and no task
runtime: its blocks live in the driver, and a stage's stream carries blocks
or ``concurrent.futures.Future``s of blocks (``_resolve`` waits for one),
where the JAX package's carries object refs.

- *Stateless task stages* (reads, and fused per-block transforms with no
  compute strategy) run on a pool of threads in the driver, one pool a
  stage, with at most ``DataContext.max_tasks_in_flight`` tasks in flight:
  the cap adapts inside [min, max] as the reference's does and is the
  backpressure; outputs come in submission order. A spawned CPU worker would
  import torch (seconds a process) and could not receive the lambdas of
  ``map`` and ``filter`` by the standard pickle. A streaming read task feeds
  its blocks through a bounded queue, so a large file never sits whole in
  the driver ahead of a slow consumer.
- *ActorPoolStrategy stages* run the fused chain on ``ProcessActor``s
  (``_private/process_actor.py``), one ``_TransformActor`` each, which
  builds callable classes once. Blocks go to the least-loaded actor by the
  standard pickle, two in flight an actor, and come back in input order.
  The pool grows from ``min_size`` to ``max_size`` when every actor is busy
  and input waits. ``resources`` naming ``"GPU"`` (a share below 1, or whole
  cards) or ``"CPU"`` lease from the host's card ledger through
  ``spawn_env.assign_cards``; a stage that names neither leases nothing and
  its actors run on the CPU. The first ``min_size`` actors raise
  ``LedgerError`` when the ledger has no room (no CPU fallback); a pool that
  cannot lease another actor stops growing. UDFs travel by reference: a
  lambda or closure raises ``TypeError``.
- *All-to-all stages* (repartition, shuffle, sort, zip, join, and the
  groupby of ``dataset.py``) run the reference's partition and reduce
  functions on driver threads. With the same blocks and seed the rows come
  out in the reference's order.
"""

from __future__ import annotations

import importlib
import os
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Iterator, Optional

import numpy as np

from ray_tpu_torch._private.cards import LedgerError
from ray_tpu_torch._private.process_actor import ProcessActor, get
from ray_tpu_torch._private.spawn_env import assign_cards
from ray_tpu_torch.data import logical as L
from ray_tpu_torch.data.block import Block, BlockAccessor
from ray_tpu_torch.data.context import DataContext

# -- per-block transform chain ----------------------------------------------


def _apply_transforms(block: Block, transforms: list) -> Block:
    for op in transforms:
        acc = BlockAccessor.for_block(block)
        if isinstance(op, L.MapBatches):
            n = acc.num_rows()
            bs = op.batch_size or n or 1
            outs = []
            for s in range(0, n, bs):
                # for_block: a slice of an arrow block is an arrow block
                batch = BlockAccessor.for_block(
                    acc.slice(s, min(s + bs, n))
                ).to_batch(op.batch_format)
                out = op.fn(batch, **op.fn_kwargs)
                outs.append(BlockAccessor.normalize(out))
            block = BlockAccessor.concat(outs) if outs else {}
        elif isinstance(op, L.Project):
            nb = BlockAccessor.normalize(block)
            # KeyError on a missing column — a typo must fail loudly, not
            # silently drop the column downstream
            block = {k: nb[k] for k in op.cols}
        elif isinstance(op, L.MapRows):
            block = BlockAccessor.from_rows([op.fn(r) for r in acc.iter_rows()])
        elif isinstance(op, L.Filter):
            keep = [i for i, r in enumerate(acc.iter_rows()) if op.fn(r)]
            block = acc.take_indices(np.asarray(keep, dtype=np.int64))
        elif isinstance(op, L.FlatMap):
            rows = []
            for r in acc.iter_rows():
                rows.extend(op.fn(r))
            block = BlockAccessor.from_rows(rows)
        else:
            raise TypeError(f"not a per-block op: {op}")
    return block


def _resolve(item) -> Block:
    """A stream item's block: the value, or the result of its future."""
    return item.result() if isinstance(item, Future) else item


def _count_rows(block) -> int:
    return BlockAccessor.for_block(block).num_rows()


def _concat_blocks(*blocks):
    return BlockAccessor.concat([BlockAccessor.normalize(b) for b in blocks])


def _concat_sort(key, descending, *blocks):
    merged = BlockAccessor.concat([BlockAccessor.normalize(b) for b in blocks])
    if not merged:
        return merged
    order = np.argsort(merged[key], kind="stable")
    if descending:
        order = order[::-1]
    return BlockAccessor(merged).take_indices(order)


def _shuffle_partition(block, n, seed):
    """Map phase of random shuffle: rows → n random buckets."""
    acc = BlockAccessor.for_block(block)
    rows = acc.num_rows()
    rng = np.random.default_rng(seed)
    assignment = rng.integers(0, n, size=rows)
    out = [acc.take_indices(np.nonzero(assignment == i)[0]) for i in range(n)]
    return tuple(out) if n > 1 else out[0]


def _concat_permute(seed, *blocks):
    """Reduce phase of random shuffle: concat buckets THEN permute rows —
    without this, rows inside each bucket keep their original order and a
    single-block shuffle would be a no-op."""
    merged = BlockAccessor.concat([BlockAccessor.normalize(b) for b in blocks])
    acc = BlockAccessor.for_block(merged)
    if not acc.num_rows():
        return merged
    rng = np.random.default_rng(seed)
    return acc.take_indices(rng.permutation(acc.num_rows()))


def _range_partition(block, key, boundaries):
    """Map phase of sort: rows → len(boundaries)+1 key-range buckets."""
    acc = BlockAccessor.for_block(block)
    n = len(boundaries) + 1
    if not acc.num_rows():
        return tuple({} for _ in range(n)) if n > 1 else {}
    keys = block[key]
    assignment = np.searchsorted(np.asarray(boundaries), keys, side="right")
    out = [acc.take_indices(np.nonzero(assignment == i)[0]) for i in range(n)]
    return tuple(out) if n > 1 else out[0]


def _hash_partition(block, key, n):
    """Map phase of distributed groupby: rows → n buckets by a deterministic
    key hash, so every row of one group lands in exactly one bucket
    (reference: the shuffle-based aggregate, ``_internal/planner/
    exchange/``)."""
    import zlib

    acc = BlockAccessor.for_block(block)
    if not acc.num_rows():
        return tuple({} for _ in range(n)) if n > 1 else {}
    keys = np.asarray(block[key] if isinstance(block, dict) else acc.to_numpy()[key])
    uniq, inv = np.unique(keys, return_inverse=True)
    # crc32 over the repr of the PYTHON value: .item() strips numpy scalar
    # wrappers, and integral floats collapse to ints so 5 and 5.0 (equal
    # keys that np.unique would merge within one block) bucket identically
    # even when different blocks carry the key at different dtypes
    def key_repr(u):
        v = u.item() if hasattr(u, "item") else u
        if isinstance(v, float) and v.is_integer():
            v = int(v)
        return repr(v)

    bucket_of = np.array([zlib.crc32(key_repr(u).encode()) % n for u in uniq])
    assignment = bucket_of[inv]
    out = [acc.take_indices(np.nonzero(assignment == i)[0]) for i in range(n)]
    return tuple(out) if n > 1 else out[0]


def _group_aggregate(key, aggs, *blocks):
    """Reduce phase: every group in these buckets is complete, so aggregates
    are exact locally — no partial-agg merge. ``aggs``: [(op, col)] with op
    in count/sum/mean/min/max/std."""
    merged = BlockAccessor.concat([BlockAccessor.normalize(b) for b in blocks])
    if not merged:
        return {}
    keys = np.asarray(merged[key])
    uniq, inv = np.unique(keys, return_inverse=True)
    cols = {key: uniq}
    order = np.argsort(inv, kind="stable")
    bounds = np.searchsorted(inv[order], np.arange(len(uniq)))
    for op, col in aggs:
        if op == "count":
            cols["count()"] = np.bincount(inv, minlength=len(uniq))
            continue
        vals = np.asarray(merged[col], dtype=np.float64)
        counts = np.bincount(inv, minlength=len(uniq))
        sums = np.bincount(inv, weights=vals, minlength=len(uniq))
        if op == "sum":
            out = sums
        elif op == "mean":
            out = sums / counts
        elif op == "min":
            out = np.minimum.reduceat(vals[order], bounds)
        elif op == "max":
            out = np.maximum.reduceat(vals[order], bounds)
        elif op == "std":
            # sample std (ddof=1), matching Dataset.std and the reference's
            # Std aggregate default
            sq = np.bincount(inv, weights=vals * vals, minlength=len(uniq))
            mean = sums / counts
            var = np.maximum(sq - counts * mean * mean, 0.0) / np.maximum(
                counts - 1, 1
            )
            out = np.sqrt(var)
        else:
            raise ValueError(f"unknown aggregate op: {op}")
        cols[f"{op}({col})"] = out
    return cols


def _group_map(key, fn, *blocks):
    """Reduce phase of map_groups: apply fn to each complete group."""
    merged = BlockAccessor.concat([BlockAccessor.normalize(b) for b in blocks])
    if not merged:
        return {}
    keys = np.asarray(merged[key])
    uniq, inv = np.unique(keys, return_inverse=True)
    acc = BlockAccessor(merged)
    outs = []
    for g in range(len(uniq)):
        group = acc.take_indices(np.nonzero(inv == g)[0])
        outs.append(BlockAccessor.normalize(fn(group)))
    return BlockAccessor.concat(outs)


def _sample_block(block, key, k):
    acc = BlockAccessor.for_block(block)
    rows = acc.num_rows()
    if not rows:
        return np.asarray([])
    idx = np.linspace(0, rows - 1, min(k, rows)).astype(np.int64)
    return np.sort(np.asarray(block[key])[idx])


def _zip_blocks(left, right):
    """Column-concat two row-aligned blocks; collisions get a ``_1`` suffix
    (reference zip semantics)."""
    la = BlockAccessor.normalize(left)
    ra = BlockAccessor.normalize(right)
    out = dict(la)
    for k, v in ra.items():
        out[k if k not in out else f"{k}_1"] = v
    return out


def _join_bucket(on, how, suffix, n_left, *blocks):
    """Join one hash bucket: first ``n_left`` blocks are the left side.

    Inner/left hash join with numpy: every row of a key is in this bucket
    on both sides, so the join is complete locally."""
    left = BlockAccessor.concat(
        [BlockAccessor.normalize(b) for b in blocks[:n_left]]
    )
    right = BlockAccessor.concat(
        [BlockAccessor.normalize(b) for b in blocks[n_left:]]
    )
    if not left:
        return {}
    lacc = BlockAccessor.for_block(left)
    if not right:
        if how == "left":
            return left
        return {}
    lk = np.asarray(left[on])
    rk = np.asarray(right[on])
    # index right rows by key
    r_order = np.argsort(rk, kind="stable")
    rk_sorted = rk[r_order]
    starts = np.searchsorted(rk_sorted, lk, side="left")
    ends = np.searchsorted(rk_sorted, lk, side="right")
    # vectorized match expansion: left row i repeats once per right match
    counts = ends - starts
    total = int(counts.sum())
    li = np.repeat(np.arange(len(lk)), counts)
    run_starts = np.cumsum(counts) - counts  # output offset of row i's run
    pos = np.arange(total) - np.repeat(run_starts, counts) + np.repeat(
        starts, counts
    )
    ri = r_order[pos] if total else np.asarray([], dtype=np.int64)
    unmatched = np.nonzero(counts == 0)[0].tolist() if how == "left" else []
    lsel = lacc.take_indices(li.astype(np.int64))
    racc = BlockAccessor.for_block(right)
    rsel = racc.take_indices(np.asarray(ri, dtype=np.int64))
    out = dict(BlockAccessor.normalize(lsel))
    n_rows = total
    for k, v in BlockAccessor.normalize(rsel).items():
        if k == on:
            continue
        out[k if k not in out else f"{k}{suffix}"] = v
    if how == "left" and unmatched:
        lun = BlockAccessor.normalize(
            lacc.take_indices(np.asarray(unmatched, dtype=np.int64))
        )
        pad = dict(lun)
        for k, v in BlockAccessor.normalize(rsel).items():
            if k == on:
                continue
            name = k if k not in lun else f"{k}{suffix}"
            arr = np.asarray(v)
            shape = (len(unmatched),) + arr.shape[1:]
            if np.issubdtype(arr.dtype, np.floating):
                fill = np.full(shape, np.nan, dtype=arr.dtype)
            elif np.issubdtype(arr.dtype, np.integer):
                fill = np.full(shape, np.nan, dtype=np.float64)
            else:
                # strings/bools/objects: a None sentinel, never a
                # fabricated value indistinguishable from real data
                fill = np.full(shape, None, dtype=object)
            pad[name] = fill
        if n_rows:
            return BlockAccessor.concat([out, pad])
        return pad
    return out


def in_threads(fn: Callable, calls: list, ctx: Optional[DataContext] = None) -> list:
    """``[fn(*args) for args in calls]``, in order, at most
    ``max_tasks_in_flight`` at once on driver threads: the port's
    counterpart of a wave of remote tasks."""
    if len(calls) <= 1:
        return [fn(*args) for args in calls]
    workers = (ctx or DataContext.get_current()).max_tasks_in_flight
    with ThreadPoolExecutor(max_workers=min(workers, len(calls)),
                            thread_name_prefix="data-task") as pool:
        return list(pool.map(lambda args: fn(*args), calls))


# -- actor pools --------------------------------------------------------------


class _TransformActor:
    """Warm per-actor transform executor: the fused op chain (with its
    stateful callables) is built ONCE per actor (reference: the actor-pool
    map operator — UDF classes construct in the actor, not per batch)."""

    def __init__(self, transforms: list):
        # callable classes instantiate once here
        self._transforms = []
        for op in transforms:
            fn = op.fn if hasattr(op, "fn") else None
            if isinstance(fn, type):
                op.fn = fn()
            self._transforms.append(op)
        self.built_at = time.time()

    def apply(self, block):
        return _apply_transforms(block, self._transforms)

    def info(self) -> dict:
        """When the chain was built (``time.time()``), and the process."""
        return {"pid": os.getpid(), "built_at": self.built_at}


class ActorPoolStrategy:
    """Compute strategy for ``map_batches``: a warm, autoscaling actor pool
    (reference: ``python/ray/data/_internal/compute.py`` ActorPoolStrategy).
    ``resources``: what each actor leases from the host's card ledger,
    ``{"GPU": g, "CPU": c}`` (a share g below 1, or whole cards)."""

    def __init__(
        self,
        size: Optional[int] = None,
        *,
        min_size: int = 1,
        max_size: Optional[int] = None,
        resources: Optional[dict] = None,
    ):
        if size is not None:
            min_size = max_size = size
        self.min_size = max(1, min_size)
        self.max_size = max_size or max(self.min_size, 4)
        self.resources = resources or {}


class ActorPool:
    """One actor stage's processes: each a ``ProcessActor`` hosting a
    ``_TransformActor`` over the stage's chain, with its lease (or none).
    ``spawned_at``: ``time.time()`` at each actor's spawn."""

    def __init__(self, transforms: list, strategy: ActorPoolStrategy):
        self.transforms, self.strategy = transforms, strategy
        self.gpu = float(strategy.resources.get("GPU", 0))
        self.cpu = float(strategy.resources.get("CPU", 0))
        self.actors: list[ProcessActor] = []
        self.spawned_at: list[float] = []
        self.can_grow = True
        try:
            self.add(strategy.min_size)
        except BaseException:
            self.kill()
            raise

    def add(self, n: int) -> None:
        """Spawn ``n`` actors, their leases taken all or none; raises
        ``LedgerError`` when the ledger has no room for them."""
        leases = assign_cards(n, self.gpu, "data actors", cpu=self.cpu)
        for i, lease in enumerate(leases):
            t = time.time()
            try:
                actor = ProcessActor(_TransformActor, (self.transforms,), lease=lease,
                                     name=f"data-actor-{len(self.actors)}")
            except BaseException:
                for rest in leases[i + 1:]:  # the failed one's is released
                    if rest is not None:
                        rest.release()
                raise
            self.actors.append(actor)
            self.spawned_at.append(t)

    def grow(self) -> bool:
        """One more actor, if the ledger has room; once it has none, the
        pool stops growing."""
        if self.can_grow:
            try:
                self.add(1)
            except LedgerError:
                self.can_grow = False
        return self.can_grow

    def get(self, handle):
        """A block's result; when its actor failed to build, that error."""
        try:
            return get(handle, timeout=None)
        except Exception:
            ready = handle.actor.ready
            if ready.done and not ready._ok:
                ready.result()
            raise

    def kill(self) -> None:
        for a in self.actors:
            a.kill()


def _libraries(plan: L.LogicalPlan) -> set:
    """The optional libraries that the plan's tasks will import. pyarrow
    (25, and pandas, which imports it) first imported on a thread other than
    the main one crashes the process later, so ``execute`` imports them
    first, on the thread that calls it: lazily still, and only what the
    plan uses."""
    from ray_tpu_torch.data.datasource import CSVDatasource, ParquetDatasource

    out = set()
    for op in plan.ops:
        if isinstance(op, L.MapBatches) and op.batch_format in ("pandas", "pyarrow"):
            out.add(op.batch_format)
        elif isinstance(op, L.Read) and isinstance(op.datasource, CSVDatasource):
            out.add("pandas")
        elif isinstance(op, L.Read) and isinstance(op.datasource, ParquetDatasource):
            out.add("pyarrow.parquet")
    return out


def _same_compute(a, b) -> bool:
    """Fusable iff both task-compute (None); actor pools never fuse with a
    neighbor (each pool's actors hold different state)."""
    return a is None and b is None


# -- streaming driver --------------------------------------------------------


class _StreamingRead:
    """A streaming read task on a pool thread: its blocks, transformed, pass
    through a queue of ``depth`` at most (the reference's generator
    backpressure) and the stage yields them in production order."""

    def __init__(self, pool: ThreadPoolExecutor, task, transforms: list, depth: int):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._future = pool.submit(self._produce, task, transforms)

    def _produce(self, task, transforms) -> None:
        try:
            for b in task.iter_blocks():
                self._put((True, _apply_transforms(b, transforms)))
        except BaseException as e:  # noqa: BLE001 — raised at the consumer
            self._put((False, e))
            return
        self._put(None)

    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                pass

    def done(self) -> bool:
        return self._future.done() or not self._q.empty()

    def cancel(self) -> None:
        self._stop.set()
        self._future.cancel()

    def __iter__(self):
        while (item := self._q.get()) is not None:
            ok, value = item
            if not ok:
                raise value
            yield value


def _read_submits(tasks, transforms, depth):
    """Submit functions with `transforms` bound NOW — the executor's loop
    variable gets rebound per stage, and these generators run lazily."""
    for t in tasks:
        if getattr(t, "streaming", False):
            yield lambda pool, t=t: _StreamingRead(pool, t, transforms, depth)
        else:
            yield lambda pool, t=t: pool.submit(
                lambda: _apply_transforms(t(), transforms))


def _transform_submits(items, transforms):
    for item in items:
        yield lambda pool, item=item: pool.submit(
            lambda: _apply_transforms(_resolve(item), transforms))


class StreamingExecutor:
    """``execute(plan)`` -> an iterator of blocks and futures of blocks.
    ``actor_pools``: the actor stages' pools of this execution, while their
    stages run (a caller may read their processes before the stream ends)."""

    def __init__(self, ctx: Optional[DataContext] = None):
        self.ctx = ctx or DataContext.get_current()
        self.actor_pools: list[ActorPool] = []

    # .. per-block stage ....................................................

    def _stream_stage(self, submit_iter: Iterator[Callable[[ThreadPoolExecutor], Any]]
                      ) -> Iterator[Any]:
        """Dispatch tasks with an ADAPTIVE in-flight cap; yield them in
        order. The cap moves inside [min, max]: a starved consumer (head
        not finished when popped) grows it; a stage consistently ahead
        shrinks it (reference: per-op backpressure policies,
        ``_internal/execution/backpressure_policy/``)."""
        max_cap = self.ctx.max_tasks_in_flight
        cap = max(self.ctx.min_tasks_in_flight, min(4, max_cap))
        ahead_streak = 0
        pending: deque = deque()
        exhausted = False
        it = iter(submit_iter)
        pool = ThreadPoolExecutor(max_workers=max_cap, thread_name_prefix="data-task")
        try:
            while pending or not exhausted:
                while not exhausted and len(pending) < cap:
                    try:
                        pending.append(next(it)(pool))
                    except StopIteration:
                        exhausted = True
                if pending:
                    head = pending.popleft()
                    if not head.done():
                        # consumer starved: widen the pipeline
                        cap = min(cap * 2, max_cap)
                        ahead_streak = 0
                    else:
                        ahead_streak += 1
                        if ahead_streak >= 2 * cap and cap > self.ctx.min_tasks_in_flight:
                            cap = max(cap - 1, self.ctx.min_tasks_in_flight)
                            ahead_streak = 0
                    if isinstance(head, _StreamingRead):
                        # its blocks flatten into the stage output in
                        # production order
                        yield from head
                    else:
                        yield head
        finally:
            # a closed stream: what was never handed on is cancelled; what
            # was runs to its end on the pool's threads, which then exit
            for p in pending:
                p.cancel()
            pool.shutdown(wait=False)

    def _actor_pool_stage(
        self, stream: Iterator[Any], transforms: list, strategy: ActorPoolStrategy
    ) -> Iterator[Any]:
        """Run a fused transform chain on a warm actor pool: blocks go to
        the least-loaded actor; outputs yield in input order. The pool
        autoscales between min_size and max_size — a new actor spawns when
        every actor is busy and input is waiting (reference: the autoscaling
        actor pool, ``_internal/execution/operators/
        actor_pool_map_operator.py``). A block is yielded once its actor
        has returned it, so the teardown has nothing left to drain: it
        kills the actors, and their leases end with them."""
        pool = ActorPool(transforms, strategy)
        self.actor_pools.append(pool)
        inflight: dict[int, int] = {i: 0 for i in range(len(pool.actors))}
        pending: deque = deque()  # (handle, actor_idx) in input order
        per_actor = 2  # pipeline depth per actor
        it = iter(stream)
        exhausted = False
        try:
            while pending or not exhausted:
                while not exhausted and len(pending) < per_actor * len(pool.actors):
                    idx = min(inflight, key=inflight.get)
                    try:
                        block = _resolve(next(it))
                    except StopIteration:
                        exhausted = True
                        break
                    pending.append((pool.actors[idx].call("apply", block), idx))
                    inflight[idx] += 1
                if (
                    not exhausted
                    and len(pool.actors) < strategy.max_size
                    and len(pending) >= per_actor * len(pool.actors)
                    and pool.grow()
                ):
                    # every actor saturated with more input waiting: grown
                    inflight[len(pool.actors) - 1] = 0
                    continue
                if pending:
                    handle, idx = pending.popleft()
                    block = pool.get(handle)
                    inflight[idx] -= 1
                    yield block
        finally:
            pool.kill()
            self.actor_pools.remove(pool)

    def execute(self, plan: L.LogicalPlan) -> Iterator[Any]:
        """Returns an iterator of blocks and futures of blocks."""
        plan = L.optimize(plan)  # DataContext.optimizer_rules
        for name in _libraries(plan):
            importlib.import_module(name)
        stream: Optional[Iterator[Any]] = None
        ops = plan.ops
        i = 0
        while i < len(ops):
            op = ops[i]
            if isinstance(op, (L.Read, L.InputBlocks)):
                # fuse following per-block ops into the read tasks (task
                # compute only; actor-pool segments become their own stages)
                segments, i = self._collect_segments(ops, i + 1)
                head_transforms = []
                if segments and segments[0][0] is None:
                    head_transforms = segments.pop(0)[1]
                if isinstance(op, L.Read):
                    parallelism = op.parallelism
                    if parallelism in (-1, None):
                        from ray_tpu_torch._private.cards import default_ledger

                        # the reference reads the cluster's CPUs; the port's
                        # are the host ledger's
                        parallelism = max(int(default_ledger().cpu_total()) * 2, 8)
                    tasks = op.datasource.get_read_tasks(parallelism)
                    stream = self._stream_stage(
                        _read_submits(tasks, head_transforms, self.ctx.max_tasks_in_flight)
                    )
                else:
                    blocks = op.refs
                    if head_transforms:
                        stream = self._stream_stage(
                            _transform_submits(blocks, head_transforms)
                        )
                    else:
                        stream = iter(blocks)
                for compute, transforms in segments:
                    stream = self._make_stage(stream, compute, transforms)
            elif op.is_per_block():
                segments, i = self._collect_segments(ops, i)
                for compute, transforms in segments:
                    stream = self._make_stage(stream, compute, transforms)
            elif isinstance(op, L.Limit):
                stream = self._apply_limit(stream, op.n)
                i += 1
            elif isinstance(op, L.Repartition):
                stream = iter(self._repartition(self._all(stream), op.num_blocks))
                i += 1
            elif isinstance(op, L.RandomShuffle):
                stream = iter(self._random_shuffle(self._all(stream), op.seed))
                i += 1
            elif isinstance(op, L.Sort):
                stream = iter(self._sort(self._all(stream), op.key, op.descending))
                i += 1
            elif isinstance(op, L.Zip):
                stream = iter(self._zip(self._all(stream), op.other))
                i += 1
            elif isinstance(op, L.Join):
                stream = iter(
                    self._join(self._all(stream), op.other, op.on, op.how, op.suffix)
                )
                i += 1
            elif isinstance(op, L.Union):
                head = stream

                def _chain(head=head, others=op.others):
                    if head is not None:
                        yield from head
                    for other in others:
                        yield from StreamingExecutor(self.ctx).execute(other)

                stream = _chain()
                i += 1
            else:
                raise TypeError(f"unknown logical op: {op}")
        return stream if stream is not None else iter(())

    def _collect_segments(self, ops, start) -> tuple[list, int]:
        """Consecutive per-block ops grouped by compute strategy:
        [(None | ActorPoolStrategy, [transforms])] — same-compute neighbors
        fuse; a compute change breaks fusion (reference:
        ``OperatorFusionRule`` fuses only same-compute map operators)."""
        segments: list = []
        i = start
        while i < len(ops) and ops[i].is_per_block():
            compute = getattr(ops[i], "compute", None)
            if segments and _same_compute(segments[-1][0], compute):
                segments[-1][1].append(ops[i])
            else:
                segments.append((compute, [ops[i]]))
            i += 1
        return segments, i

    def _make_stage(self, stream, compute, transforms):
        if compute is None:
            return self._stream_stage(_transform_submits(stream, transforms))
        return self._actor_pool_stage(stream, transforms, compute)

    # .. all-to-all stages ..................................................

    @staticmethod
    def _all(stream) -> list:
        return [_resolve(x) for x in (stream if stream is not None else ())]

    def _apply_limit(self, stream, n: int) -> Iterator[Any]:
        """Driver-side row budget: truncate and stop dispatching early."""
        remaining = n
        for item in stream:
            if remaining <= 0:
                break
            block = _resolve(item)
            rows = BlockAccessor.for_block(block).num_rows()
            if rows <= remaining:
                remaining -= rows
                yield block
            else:
                yield BlockAccessor.for_block(block).slice(0, remaining)
                remaining = 0

    def _repartition(self, blocks: list, n: int) -> list:
        counts = [_count_rows(b) for b in blocks]
        total = sum(counts)
        # target row ranges per output block
        bounds = [round(total * j / n) for j in range(n + 1)]
        pieces: list[list] = [[] for _ in range(n)]
        offset = 0
        for block, cnt in zip(blocks, counts):
            acc = BlockAccessor.for_block(block)
            for j in range(n):
                s = max(bounds[j] - offset, 0)
                e = min(bounds[j + 1] - offset, cnt)
                if e > s:
                    pieces[j].append(acc.slice(s, e))
            offset += cnt
        return [_concat_blocks(*p) if p else {} for p in pieces]

    def _random_shuffle(self, blocks: list, seed: Optional[int]) -> list:
        n = max(len(blocks), 1)
        base = seed if seed is not None else np.random.randint(0, 2**31)
        buckets = in_threads(_shuffle_partition,
                             [(b, n, base + i) for i, b in enumerate(blocks)], self.ctx)
        if n == 1:
            return [_concat_permute(base + 1_000_003, *buckets)]
        return in_threads(_concat_permute,
                          [(base + 1_000_003 + r, *[buckets[m][r] for m in range(len(blocks))])
                           for r in range(n)], self.ctx)

    def _zip(self, blocks: list, other_plan) -> list:
        """Row-align the other side to this side's block boundaries, then
        column-concat pairwise (reference: ``Dataset.zip``)."""
        other = self._all(StreamingExecutor(self.ctx).execute(other_plan))
        counts = [_count_rows(b) for b in blocks]
        other_counts = [_count_rows(b) for b in other]
        if sum(counts) != sum(other_counts):
            raise ValueError(
                f"zip requires equal row counts: {sum(counts)} vs "
                f"{sum(other_counts)}"
            )
        # slice the other side to this side's row ranges
        bounds = np.cumsum([0] + counts)
        pieces: list[list] = [[] for _ in blocks]
        offset = 0
        for block, cnt in zip(other, other_counts):
            acc = BlockAccessor.for_block(block)
            for j in range(len(blocks)):
                s = max(bounds[j] - offset, 0)
                e = min(bounds[j + 1] - offset, cnt)
                if e > s:
                    pieces[j].append(acc.slice(int(s), int(e)))
            offset += cnt
        aligned = [_concat_blocks(*p) if p else {} for p in pieces]
        return [_zip_blocks(left, right) for left, right in zip(blocks, aligned)]

    def _join(self, blocks: list, other_plan, on, how, suffix) -> list:
        """Two-phase hash join: both sides hash-partition on the key (same
        exchange as the distributed groupby), then each bucket joins
        locally."""
        other = self._all(StreamingExecutor(self.ctx).execute(other_plan))
        n = max(len(blocks), len(other), 1)
        parts = in_threads(_hash_partition, [(b, on, n) for b in blocks + other], self.ctx)
        l_buckets, r_buckets = parts[:len(blocks)], parts[len(blocks):]

        def bucket(b, j):
            return b[j] if n > 1 else b

        calls = []
        for j in range(n):
            lparts = [bucket(b, j) for b in l_buckets]
            rparts = [bucket(b, j) for b in r_buckets]
            calls.append((on, how, suffix, len(lparts), *lparts, *rparts))
        return in_threads(_join_bucket, calls, self.ctx)

    def _sort(self, blocks: list, key: str, descending: bool) -> list:
        if not blocks:
            return []
        n = len(blocks)
        samples = [_sample_block(b, key, 20) for b in blocks]
        nonempty = [s for s in samples if len(s)]
        if not nonempty:
            return blocks  # all blocks empty: nothing to sort
        allkeys = np.sort(np.concatenate(nonempty))
        # n-1 boundaries at even quantiles
        bidx = [int(len(allkeys) * j / n) for j in range(1, n)]
        boundaries = [allkeys[min(i, len(allkeys) - 1)] for i in bidx]
        buckets = in_threads(_range_partition, [(b, key, boundaries) for b in blocks], self.ctx)
        if n == 1:
            out = [_concat_sort(key, descending, *buckets)]
        else:
            out = in_threads(_concat_sort,
                             [(key, descending, *[buckets[m][r] for m in range(n)])
                              for r in range(n)], self.ctx)
        return list(reversed(out)) if descending else out
