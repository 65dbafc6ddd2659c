"""Dataset: the lazy data API; the port's counterpart of
``ray_tpu/data/dataset.py``.

Reference: ``python/ray/data/dataset.py`` — an immutable chain of logical
operators executed by the streaming executor (``execution.py``).
Transformations return new Datasets; consumption (`take`, `iter_batches`,
`materialize`) triggers streaming execution.

The port's blocks live in the driver, where the JAX package's are object
refs: a ``MaterializedDataset`` holds its blocks, and pickles with them
(``split`` and ``streaming_split`` shards go to Train's rank processes so).
``map_batches(compute=ActorPoolStrategy(...))`` sends its UDF to other
processes by reference: a lambda or closure raises ``TypeError`` at the
call. ``iter_torch_batches`` and ``iter_device_batches`` stand where the
JAX package has ``iter_jax_batches``.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Optional

import numpy as np

from ray_tpu_torch._private.process_actor import require_picklable
from ray_tpu_torch.data import logical as L
from ray_tpu_torch.data.block import Block, BlockAccessor
from ray_tpu_torch.data.execution import StreamingExecutor, _resolve, in_threads
from ray_tpu_torch.data.iterator import DataIterator


class Dataset:
    def __init__(self, plan: L.LogicalPlan):
        self._plan = plan

    # -- transformations (lazy) ---------------------------------------------

    def _with(self, op: L.LogicalOp) -> "Dataset":
        return Dataset(self._plan.with_op(op))

    def map(self, fn: Callable[[dict], dict]) -> "Dataset":
        return self._with(L.MapRows(fn))

    def map_batches(
        self,
        fn: Callable,
        *,
        batch_size: Optional[int] = None,
        batch_format: Optional[str] = "numpy",
        fn_kwargs: Optional[dict] = None,
        compute=None,
        **_ignored,
    ) -> "Dataset":
        """``compute=ActorPoolStrategy(...)`` runs the UDF on a warm actor
        pool — classes are instantiated once per actor and reused across
        batches (stateful UDFs, e.g. a model loaded once; reference:
        ``ActorPoolStrategy``, ``python/ray/data/_internal/compute.py``).
        The UDF and ``fn_kwargs`` go to the actors' processes by the
        standard pickle: a class or a module-level function (or a
        ``functools.partial`` of one), else ``TypeError`` here."""
        if compute is not None:
            require_picklable((fn, fn_kwargs), "an actor stage's UDF and fn_kwargs")
        return self._with(
            L.MapBatches(fn, batch_size, batch_format, fn_kwargs, compute=compute)
        )

    def filter(self, fn: Callable[[dict], bool]) -> "Dataset":
        return self._with(L.Filter(fn))

    def flat_map(self, fn: Callable[[dict], list]) -> "Dataset":
        return self._with(L.FlatMap(fn))

    def add_column(self, name: str, fn: Callable) -> "Dataset":
        def _add(batch):
            batch = dict(batch) if isinstance(batch, dict) else {"data": batch}
            batch[name] = np.asarray(fn(batch))
            return batch

        return self.map_batches(_add, batch_format="dict")

    def drop_columns(self, cols: list[str]) -> "Dataset":
        return self.map_batches(
            lambda b: {k: v for k, v in b.items() if k not in cols},
            batch_format="dict",
        )

    def select_columns(self, cols: list[str]) -> "Dataset":
        # a first-class Project op: the optimizer pushes it into columnar
        # reads (ProjectionPushdown) where a lambda could not be inspected
        return self._with(L.Project(list(cols)))

    def rename_columns(self, mapping: dict[str, str]) -> "Dataset":
        return self.map_batches(
            lambda b: {mapping.get(k, k): v for k, v in b.items()},
            batch_format="dict",
        )

    def limit(self, n: int) -> "Dataset":
        return self._with(L.Limit(n))

    def repartition(self, num_blocks: int) -> "Dataset":
        return self._with(L.Repartition(num_blocks))

    def random_shuffle(self, *, seed: Optional[int] = None) -> "Dataset":
        return self._with(L.RandomShuffle(seed))

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        return self._with(L.Sort(key, descending))

    def union(self, *others: "Dataset") -> "Dataset":
        return self._with(L.Union([o._plan for o in others]))

    def zip(self, other: "Dataset") -> "Dataset":
        """Positional column concat: row i of the result has this dataset's
        columns plus ``other``'s (collisions suffixed ``_1``). Both sides
        must have the same number of rows (reference: ``Dataset.zip``)."""
        return self._with(L.Zip(other._plan))

    def join(
        self,
        other: "Dataset",
        on: str,
        *,
        how: str = "inner",
        suffix: str = "_right",
    ) -> "Dataset":
        """Hash join on column ``on`` (``how``: inner | left). Runs as a
        two-phase hash-partition exchange — every row of one key lands in
        one bucket, joined locally (reference: ``Dataset.join``)."""
        if how not in ("inner", "left"):
            raise ValueError(f"how must be 'inner' or 'left', got {how!r}")
        return self._with(L.Join(other._plan, on, how, suffix))

    # -- consumption (eager) ------------------------------------------------

    def _execute(self) -> Iterator[Any]:
        return StreamingExecutor().execute(self._plan)

    def _blocks(self) -> Iterator[Block]:
        """The executed blocks, in order."""
        for item in self._execute():
            yield _resolve(item)

    def materialize(self) -> "MaterializedDataset":
        return MaterializedDataset(list(self._blocks()))

    def take(self, n: int = 20) -> list[dict]:
        out: list[dict] = []
        for block in self.limit(n)._blocks():
            out.extend(BlockAccessor.for_block(block).iter_rows())
            if len(out) >= n:
                break
        return out[:n]

    def take_all(self) -> list[dict]:
        out: list[dict] = []
        for block in self._blocks():
            out.extend(BlockAccessor.for_block(block).iter_rows())
        return out

    def take_batch(self, batch_size: int = 20, batch_format: str = "numpy"):
        for batch in self.iterator().iter_batches(
            batch_size=batch_size, batch_format=batch_format
        ):
            return batch
        return {}

    def count(self) -> int:
        return sum(BlockAccessor.for_block(b).num_rows() for b in self._blocks())

    def schema(self) -> Optional[dict[str, str]]:
        for block in self.limit(1)._blocks():
            return BlockAccessor.for_block(block).schema()
        return None

    def columns(self) -> Optional[list[str]]:
        s = self.schema()
        return list(s) if s else None

    # -- aggregates ---------------------------------------------------------

    def _agg(self, col: str, block_fn, combine):
        vals = []
        for block in self._blocks():
            if block and BlockAccessor.for_block(block).num_rows():
                vals.append(block_fn(np.asarray(block[col])))
        if not vals:
            return None
        return combine(vals)

    def sum(self, col: str):
        return self._agg(col, np.sum, lambda v: float(np.sum(v)))

    def min(self, col: str):
        return self._agg(col, np.min, lambda v: float(np.min(v)))

    def max(self, col: str):
        return self._agg(col, np.max, lambda v: float(np.max(v)))

    def mean(self, col: str):
        total, count = 0.0, 0
        for block in self._blocks():
            if block and BlockAccessor.for_block(block).num_rows():
                arr = np.asarray(block[col])
                total += float(arr.sum())
                count += arr.size
        return total / count if count else None

    def std(self, col: str):
        parts = []
        for block in self._blocks():
            if block and BlockAccessor.for_block(block).num_rows():
                parts.append(np.asarray(block[col]).ravel())
        if not parts:
            return None
        rows = np.concatenate(parts)
        return float(np.std(rows, ddof=1)) if rows.size > 1 else 0.0

    def groupby(self, key: str) -> "GroupedData":
        return GroupedData(self, key)

    # -- iteration ----------------------------------------------------------

    def iterator(self) -> DataIterator:
        # a bound method: it pickles with the dataset (a shard's blocks)
        return DataIterator(self._execute, repr(self))

    def iter_rows(self) -> Iterator[dict]:
        return self.iterator().iter_rows()

    def iter_batches(self, **kwargs) -> Iterator[Any]:
        return self.iterator().iter_batches(**kwargs)

    def iter_device_batches(self, **kwargs) -> Iterator[Any]:
        return self.iterator().iter_device_batches(**kwargs)

    def iter_torch_batches(self, **kwargs) -> Iterator[Any]:
        return self.iterator().iter_torch_batches(**kwargs)

    # -- splitting (Train integration) --------------------------------------

    def split(self, n: int, *, equal: bool = False) -> list["MaterializedDataset"]:
        return [MaterializedDataset([b]) for b in self.repartition(n)._blocks()]

    def streaming_split(self, n: int, *, equal: bool = True) -> list[DataIterator]:
        """N iterators over disjoint shards (reference:
        ``Dataset.streaming_split`` used by Train's DataConfig)."""
        shards = self.split(n, equal=equal)
        return [s.iterator() for s in shards]

    def train_test_split(self, test_size: float, *, shuffle: bool = False, seed=None):
        ds = self.random_shuffle(seed=seed) if shuffle else self
        rows = ds.take_all()
        k = int(len(rows) * (1 - test_size))
        return from_items(rows[:k]), from_items(rows[k:])

    # -- writing ------------------------------------------------------------

    def _write(self, path: str, writer: Callable[[Block, str], None], ext: str):
        import os

        os.makedirs(path, exist_ok=True)
        for i, block in enumerate(self._blocks()):
            block = BlockAccessor.normalize(block)
            if BlockAccessor(block).num_rows():
                writer(block, os.path.join(path, f"part-{i:05d}.{ext}"))

    def write_parquet(self, path: str, partition_cols: Optional[list] = None):
        """``partition_cols``: hive-style partitioned output — rows land in
        ``col=value/`` subdirectories readable back with
        ``read_parquet(path, partitioning=Partitioning('hive'))``
        (reference: ``Dataset.write_parquet(partition_cols=...)``)."""
        import os as _os

        def w(block, p):
            import pyarrow.parquet as pq

            pq.write_table(BlockAccessor(block).to_arrow(), p)

        if not partition_cols:
            self._write(path, w, "parquet")
            return
        _os.makedirs(path, exist_ok=True)
        for i, block in enumerate(self._blocks()):
            block = BlockAccessor.normalize(block)
            acc = BlockAccessor(block)
            n = acc.num_rows()
            if not n:
                continue
            keys = np.stack(
                [np.asarray(block[c]).astype(str) for c in partition_cols],
                axis=1,
            )
            uniq, inverse = np.unique(keys, axis=0, return_inverse=True)
            for g, vals in enumerate(uniq):
                idx = np.nonzero(inverse == g)[0]
                sub = acc.take_indices(idx)
                # partition values live in the path, not the file
                sub = {
                    k: v
                    for k, v in BlockAccessor.normalize(sub).items()
                    if k not in partition_cols
                }
                d = _os.path.join(
                    path,
                    *(f"{c}={v}" for c, v in zip(partition_cols, vals)),
                )
                _os.makedirs(d, exist_ok=True)
                w(sub, _os.path.join(d, f"part-{i:05d}.parquet"))

    def write_csv(self, path: str):
        self._write(
            path, lambda b, p: BlockAccessor(b).to_pandas().to_csv(p, index=False), "csv"
        )

    def write_json(self, path: str):
        self._write(
            path,
            lambda b, p: BlockAccessor(b)
            .to_pandas()
            .to_json(p, orient="records", lines=True),
            "json",
        )

    def write_numpy(self, path: str, column: str = "data"):
        self._write(path, lambda b, p: np.save(p, b[column]), "npy")

    def __repr__(self):
        return f"Dataset(plan={self._plan!r})"


class MaterializedDataset(Dataset):
    """Executed dataset: holds its blocks (reference: MaterializedDataset,
    which holds block refs)."""

    def __init__(self, blocks: list):
        super().__init__(L.LogicalPlan([L.InputBlocks(blocks)]))
        self._refs = blocks

    def num_blocks(self) -> int:
        return len(self._refs)

    def get_internal_block_refs(self) -> list:
        """The blocks themselves: the port has no object refs."""
        return list(self._refs)


class GroupedData:
    """Distributed hash-grouped aggregation (reference: ``grouped_data.py``
    over the shuffle-based aggregate plan).

    Two phases on driver threads: hash-partition each block by key (every
    group lands wholly in one bucket), then reduce each bucket with an exact
    local aggregate."""

    def __init__(self, ds: Dataset, key: str):
        self._ds = ds
        self._key = key

    def _buckets(self) -> list[list]:
        """[bucket][mapper] blocks from the hash-partition phase."""
        import builtins  # the module-level `range` is the Dataset constructor

        from ray_tpu_torch.data.execution import _hash_partition

        blocks = list(self._ds._blocks())
        if not blocks:
            return []
        n = len(blocks)
        parts = in_threads(_hash_partition, [(b, self._key, n) for b in blocks])
        if n == 1:
            return [[parts[0]]]
        return [
            [parts[m][b] for m in builtins.range(n)]
            for b in builtins.range(n)
        ]

    def _aggregate(self, aggs: list) -> Dataset:
        from ray_tpu_torch.data.execution import _group_aggregate

        return MaterializedDataset(in_threads(
            _group_aggregate, [(self._key, aggs, *bucket) for bucket in self._buckets()]))

    def count(self) -> Dataset:
        return self._aggregate([("count", None)])

    def sum(self, col: str) -> Dataset:
        return self._aggregate([("sum", col)])

    def mean(self, col: str) -> Dataset:
        return self._aggregate([("mean", col)])

    def min(self, col: str) -> Dataset:
        return self._aggregate([("min", col)])

    def max(self, col: str) -> Dataset:
        return self._aggregate([("max", col)])

    def std(self, col: str) -> Dataset:
        return self._aggregate([("std", col)])

    def aggregate(self, *aggs: tuple) -> Dataset:
        """Multiple aggregates in one pass: ``aggregate(("sum", "x"),
        ("max", "y"))`` → columns ``sum(x)``, ``max(y)``."""
        return self._aggregate(list(aggs))

    def map_groups(self, fn: Callable) -> Dataset:
        from ray_tpu_torch.data.execution import _group_map

        return MaterializedDataset(in_threads(
            _group_map, [(self._key, fn, *bucket) for bucket in self._buckets()]))


# -- constructors (read API) -------------------------------------------------


def _from_source(source, parallelism=-1) -> Dataset:
    return Dataset(L.LogicalPlan([L.Read(source, parallelism)]))


def range(n: int, *, parallelism: int = -1) -> Dataset:  # noqa: A001
    from ray_tpu_torch.data.datasource import RangeDatasource

    return _from_source(RangeDatasource(n), parallelism)


def range_tensor(n: int, *, shape: tuple = (1,), parallelism: int = -1) -> Dataset:
    from ray_tpu_torch.data.datasource import RangeDatasource

    return _from_source(RangeDatasource(n, tensor_shape=tuple(shape)), parallelism)


def from_items(items: list, *, parallelism: int = -1) -> Dataset:
    from ray_tpu_torch.data.datasource import ItemsDatasource

    return _from_source(ItemsDatasource(items), parallelism)


def from_numpy(arr) -> Dataset:
    from ray_tpu_torch.data.datasource import BlocksDatasource

    if isinstance(arr, list):
        return _from_source(BlocksDatasource(arr))
    return _from_source(BlocksDatasource([arr]))


def from_pandas(dfs) -> Dataset:
    from ray_tpu_torch.data.datasource import BlocksDatasource

    if not isinstance(dfs, list):
        dfs = [dfs]
    return _from_source(BlocksDatasource(dfs))


def from_arrow(tables) -> Dataset:
    from ray_tpu_torch.data.datasource import BlocksDatasource

    if not isinstance(tables, list):
        tables = [tables]
    return _from_source(BlocksDatasource(tables))


def read_csv(paths, **kwargs) -> Dataset:
    from ray_tpu_torch.data.datasource import CSVDatasource

    return _from_source(CSVDatasource(paths, **kwargs))


def read_json(paths, **kwargs) -> Dataset:
    from ray_tpu_torch.data.datasource import JSONDatasource

    return _from_source(JSONDatasource(paths, **kwargs))


def read_parquet(paths, **kwargs) -> Dataset:
    from ray_tpu_torch.data.datasource import ParquetDatasource

    return _from_source(ParquetDatasource(paths, **kwargs))


def read_numpy(paths, **kwargs) -> Dataset:
    from ray_tpu_torch.data.datasource import NumpyDatasource

    return _from_source(NumpyDatasource(paths, **kwargs))


def read_text(paths, **kwargs) -> Dataset:
    from ray_tpu_torch.data.datasource import TextDatasource

    return _from_source(TextDatasource(paths, **kwargs))


def read_binary_files(paths, **kwargs) -> Dataset:
    from ray_tpu_torch.data.datasource import BinaryDatasource

    return _from_source(BinaryDatasource(paths, **kwargs))


def read_images(paths, *, size=None, mode: str = "RGB", **kwargs) -> Dataset:
    from ray_tpu_torch.data.datasource import ImageDatasource

    return _from_source(ImageDatasource(paths, size=size, mode=mode, **kwargs))


def read_sql(sql: str, connection_factory=None, *, database: str = None) -> Dataset:
    from ray_tpu_torch.data.datasource import SQLDatasource

    return _from_source(
        SQLDatasource(sql, connection_factory=connection_factory, database=database)
    )


def from_generator(fn, *, num_tasks: int = 1) -> Dataset:
    """Lazy blocks from ``fn(task_index) -> Iterator[block]`` — each shard
    streams through a streaming read task."""
    from ray_tpu_torch.data.datasource import GeneratorDatasource

    return _from_source(GeneratorDatasource(fn, num_tasks=num_tasks))


def read_datasource(source, *, parallelism: int = -1) -> Dataset:
    return _from_source(source, parallelism)
