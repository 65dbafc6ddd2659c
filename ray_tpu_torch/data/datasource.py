"""Datasources: lazily-evaluated read tasks.

Reference: ``python/ray/data/datasource/`` + ``read_api.py`` — a
``Datasource`` plans ``ReadTask``s (serializable thunks, one per output
block); the executor runs them as tasks. File-based sources shard by file.

The port's copy of ``ray_tpu/data/datasource.py``: every datasource of
the reference, pandas, pyarrow, PIL and sqlite3 imported lazily.
"""

from __future__ import annotations

import glob as _glob
import os
from typing import Any, Callable, Iterable, Optional

import numpy as np

from ray_tpu_torch.data.block import Block, BlockAccessor


class ReadTask:
    """A serializable zero-arg callable producing one block."""

    streaming = False

    def __init__(self, fn: Callable[[], Block], metadata: Optional[dict] = None):
        self._fn = fn
        self.metadata = metadata or {}

    def __call__(self) -> Block:
        from ray_tpu_torch.data.block import _is_arrow_table

        out = self._fn()
        if _is_arrow_table(out):
            return out  # Arrow tables are first-class blocks — keep them
        return BlockAccessor.normalize(out)


class StreamingReadTask(ReadTask):
    """A read task producing MULTIPLE blocks lazily. The executor runs it as
    a streaming-generator task: each block seals into the store as the reader
    produces it, so one giant file never materializes as one giant block
    (reference: ReadTasks returning Iterable[Block], executed via streaming
    generators — ``python/ray/data/_internal/planner/plan_read_op.py``)."""

    streaming = True

    def iter_blocks(self):
        from ray_tpu_torch.data.block import _is_arrow_table

        for b in self._fn():
            yield b if _is_arrow_table(b) else BlockAccessor.normalize(b)


class Datasource:
    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        raise NotImplementedError

    def estimate_inmemory_data_size(self) -> Optional[int]:
        return None


class RangeDatasource(Datasource):
    def __init__(self, n: int, tensor_shape: Optional[tuple] = None, column: str = "id"):
        self.n = n
        self.tensor_shape = tensor_shape
        self.column = column

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        parallelism = max(1, min(parallelism, self.n or 1))
        chunk = (self.n + parallelism - 1) // parallelism if self.n else 0
        tasks = []
        for start in range(0, self.n, max(chunk, 1)):
            end = min(start + chunk, self.n)
            shape = self.tensor_shape

            def fn(start=start, end=end, shape=shape, col=self.column):
                ids = np.arange(start, end)
                if shape:
                    data = np.broadcast_to(
                        ids.reshape((-1,) + (1,) * len(shape)), (end - start,) + shape
                    ).copy()
                    return {"data": data}
                return {col: ids}

            tasks.append(ReadTask(fn, {"num_rows": end - start}))
        return tasks


class ItemsDatasource(Datasource):
    def __init__(self, items: list):
        self.items = list(items)

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        n = len(self.items)
        parallelism = max(1, min(parallelism, n or 1))
        chunk = (n + parallelism - 1) // parallelism if n else 0
        tasks = []
        for start in range(0, n, max(chunk, 1)):
            part = self.items[start : start + chunk]

            def fn(part=part):
                if part and isinstance(part[0], dict):
                    return BlockAccessor.from_rows(part)
                return {"item": np.asarray(part)}

            tasks.append(ReadTask(fn, {"num_rows": len(part)}))
        return tasks


class BlocksDatasource(Datasource):
    """Pre-materialized blocks (from_numpy / from_pandas / from_arrow)."""

    def __init__(self, blocks: list[Any]):
        self.blocks = blocks

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        return [
            ReadTask(lambda b=b: BlockAccessor.normalize(b)) for b in self.blocks
        ]


def _expand_paths(paths, recursive: bool = False) -> list[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: list[str] = []
    for p in paths:
        p = os.path.expanduser(p)
        if os.path.isdir(p):
            if recursive:
                # partitioned layouts nest files under key dirs
                for root, dirs, files in os.walk(p):
                    dirs.sort()
                    out.extend(
                        sorted(
                            os.path.join(root, f)
                            for f in files
                            if not f.startswith(".")
                        )
                    )
            else:
                out.extend(
                    sorted(
                        os.path.join(p, f)
                        for f in os.listdir(p)
                        if not f.startswith(".")
                    )
                )
        elif any(c in p for c in "*?["):
            out.extend(sorted(_glob.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no files matched: {paths}")
    return out


class FileBasedDatasource(Datasource):
    """One read task per file (reference: ``file_based_datasource.py``).

    ``partitioning`` (``data/partitioning.py``): partition fields parsed
    from each file's path are appended to its block as constant columns.
    ``partition_filter``: a ``PathPartitionFilter`` (or plain path
    predicate) pruning files BEFORE read tasks exist — partition pruning
    costs zero reads."""

    def __init__(self, paths, partitioning=None, partition_filter=None,
                 **reader_kwargs):
        from ray_tpu_torch.data.partitioning import PathPartitionFilter

        self.partitioning = partitioning
        if partition_filter is not None and not isinstance(
            partition_filter, PathPartitionFilter
        ):
            if partitioning is None:
                raise ValueError(
                    "a plain partition_filter callable needs partitioning= "
                    "to parse fields; pass a PathPartitionFilter otherwise"
                )
            partition_filter = PathPartitionFilter(
                partitioning, partition_filter
            )
        # partitioned layouts nest files under key dirs: recurse whenever
        # partition semantics are in play (a filter without partitioning=
        # still implies a partitioned tree)
        recursive = partitioning is not None or partition_filter is not None
        self.paths = _expand_paths(paths, recursive=recursive)
        if partition_filter is not None:
            self.paths = [p for p in self.paths if partition_filter(p)]
            if not self.paths:
                raise FileNotFoundError(
                    "partition_filter pruned every input file"
                )
        self.reader_kwargs = reader_kwargs

    def _read_file(self, path: str) -> Block:
        raise NotImplementedError

    def _read_with_partitions(self, path: str) -> Block:
        block = self._read_file(path)
        if self.partitioning is None:
            return block
        fields = self.partitioning.parse(path)
        if not fields:
            return block
        from ray_tpu_torch.data.block import BlockAccessor

        block = BlockAccessor.normalize(block)
        n = BlockAccessor(block).num_rows()
        for k, v in fields.items():
            if k not in block:
                block[k] = np.full(n, v)
        return block

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        return [
            ReadTask(lambda p=p: self._read_with_partitions(p), {"path": p})
            for p in self.paths
        ]


class CSVDatasource(FileBasedDatasource):
    """``chunk_rows=N`` streams each file as ceil(rows/N) blocks via a
    streaming read task instead of one block per file."""

    def __init__(self, paths, chunk_rows: Optional[int] = None, **reader_kwargs):
        super().__init__(paths, **reader_kwargs)
        self.chunk_rows = chunk_rows

    def _read_file(self, path: str) -> Block:
        import pandas as pd

        return BlockAccessor.normalize(pd.read_csv(path, **self.reader_kwargs))

    def _read_file_chunks(self, path: str):
        import pandas as pd

        with pd.read_csv(
            path, chunksize=self.chunk_rows, **self.reader_kwargs
        ) as reader:
            for df in reader:
                yield BlockAccessor.normalize(df)

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        if self.chunk_rows is None:
            return super().get_read_tasks(parallelism)
        return [
            StreamingReadTask(lambda p=p: self._read_file_chunks(p), {"path": p})
            for p in self.paths
        ]


class JSONDatasource(FileBasedDatasource):
    """JSON-lines files (reference reads jsonl via pyarrow)."""

    def _read_file(self, path: str) -> Block:
        import json

        rows = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    rows.append(json.loads(line))
        return BlockAccessor.from_rows(rows)


class ParquetDatasource(FileBasedDatasource):
    """Emits Arrow-table blocks natively (zero-copy from the parquet
    reader); row groups stream as separate blocks with ``stream_row_groups``."""

    def __init__(self, paths, stream_row_groups: bool = False, **reader_kwargs):
        super().__init__(paths, **reader_kwargs)
        self.stream_row_groups = stream_row_groups

    def _read_file(self, path: str) -> Block:
        import pyarrow.parquet as pq

        return pq.read_table(path, **self.reader_kwargs)

    def _read_row_groups(self, path: str):
        import pyarrow.parquet as pq

        f = pq.ParquetFile(path)
        for i in range(f.num_row_groups):
            yield f.read_row_group(i, **self.reader_kwargs)

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        if not self.stream_row_groups:
            return super().get_read_tasks(parallelism)

        def stream(p):
            fields = (
                self.partitioning.parse(p)
                if self.partitioning is not None
                else {}
            )
            for rg in self._read_row_groups(p):
                if fields:
                    from ray_tpu_torch.data.block import BlockAccessor

                    rg = BlockAccessor.normalize(rg)
                    n = BlockAccessor(rg).num_rows()
                    for k, v in fields.items():
                        rg.setdefault(k, np.full(n, v))
                yield rg

        return [
            StreamingReadTask(lambda p=p: stream(p), {"path": p})
            for p in self.paths
        ]


class NumpyDatasource(FileBasedDatasource):
    def _read_file(self, path: str) -> Block:
        arr = np.load(path, allow_pickle=False)
        return {"data": arr}


class BinaryDatasource(FileBasedDatasource):
    def _read_file(self, path: str) -> Block:
        with open(path, "rb") as f:
            data = f.read()
        return {"bytes": np.frombuffer(data, dtype=np.uint8).reshape(1, -1), }


class TextDatasource(FileBasedDatasource):
    def _read_file(self, path: str) -> Block:
        with open(path) as f:
            lines = [l.rstrip("\n") for l in f]
        return {"text": np.asarray(lines, dtype=object)}


class ImageDatasource(FileBasedDatasource):
    """Decoded images as [H, W, C] uint8 tensors (reference:
    ``datasource/image_datasource.py``); ``size=(h, w)`` resizes so blocks
    stack into one tensor column for ``iter_device_batches``."""

    def __init__(self, paths, size=None, mode: str = "RGB", **kw):
        super().__init__(paths, **kw)
        self.size = size
        self.mode = mode

    def _read_file(self, path: str) -> Block:
        from PIL import Image

        img = Image.open(path).convert(self.mode)
        if self.size is not None:
            img = img.resize((self.size[1], self.size[0]))
        arr = np.asarray(img, dtype=np.uint8)
        return {
            "image": arr[None],
            "path": np.asarray([path], dtype=object),
        }


class SQLDatasource(Datasource):
    """SQLite-backed SQL reads (reference: ``datasource/sql_datasource.py``
    — the reference takes a connection factory; here the stdlib sqlite3 is
    the zero-dependency default, same row→block semantics)."""

    def __init__(self, sql: str, connection_factory=None, database: str = None):
        if connection_factory is None:
            if database is None:
                raise ValueError("SQLDatasource needs connection_factory or database")
            import sqlite3

            connection_factory = lambda: sqlite3.connect(database)  # noqa: E731
        self.sql = sql
        self.connection_factory = connection_factory

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        sql, factory = self.sql, self.connection_factory

        def read():
            conn = factory()
            try:
                cur = conn.execute(sql)
                cols = [d[0] for d in cur.description]
                rows = cur.fetchall()
            finally:
                conn.close()
            if not rows:
                return {}
            return {
                c: np.asarray([r[i] for r in rows]) for i, c in enumerate(cols)
            }

        return [ReadTask(read, {"sql": sql})]


class GeneratorDatasource(Datasource):
    """Blocks from a user generator factory: each call of ``fn(task_index)``
    yields blocks lazily (streaming read task per shard)."""

    def __init__(self, fn, num_tasks: int = 1):
        self.fn = fn
        self.num_tasks = num_tasks

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        return [
            StreamingReadTask(lambda i=i: self.fn(i), {"shard": i})
            for i in range(self.num_tasks)
        ]
