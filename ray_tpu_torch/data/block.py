"""Block format + accessor.

Reference: ``python/ray/data/block.py`` + ``_internal/arrow_block.py`` /
``pandas_block.py``. The native block is a **columnar dict of numpy
arrays** — the zero-copy feed format for ``torch.from_numpy`` — with
Arrow/pandas as conversion boundaries rather than the internal
representation. Rows are plain dicts.

The port's copy of ``ray_tpu/data/block.py``; pandas and pyarrow are
imported lazily, where a block is converted.
"""

from __future__ import annotations

from typing import Any, Iterator, Optional

import numpy as np

from ray_tpu_torch.data.tensor_extension import RaggedArray

# A Block is dict[str, np.ndarray | RaggedArray]; all columns share length.
Block = dict

TENSOR_COLUMN = "data"  # single-tensor datasets use this column name


def _normalize(value):
    # variable-length sequences become a first-class RaggedArray column
    # (flat values + offsets), never an object-dtype ndarray (reference:
    # the tensor extension types under air/util/tensor_extensions)
    ragged = RaggedArray.maybe_from_column(value)
    if ragged is not None:
        return ragged
    arr = np.asarray(value)
    return arr


def _is_arrow_table(data) -> bool:
    return hasattr(data, "column_names") and hasattr(data, "combine_chunks")


def _is_pandas_df(data) -> bool:
    return (
        hasattr(data, "columns")
        and hasattr(data, "iloc")
        and hasattr(data, "to_numpy")
    )


class BlockAccessor:
    """Uniform view over a block (reference: ``BlockAccessor.for_block``)."""

    def __init__(self, block: Block):
        self._b = block

    @staticmethod
    def for_block(block) -> "BlockAccessor":
        if _is_arrow_table(block):
            return ArrowBlockAccessor(block)
        if _is_pandas_df(block):
            return PandasBlockAccessor(block)
        return BlockAccessor(BlockAccessor.normalize(block))

    # -- construction -------------------------------------------------------

    @staticmethod
    def normalize(data) -> Block:
        """Coerce rows/pandas/arrow/ndarray into the columnar numpy block.

        Arrow tables convert column-wise via ``to_numpy`` — zero-copy for
        non-null numeric columns (the device feed path), never through Python
        lists.
        """
        if isinstance(data, dict):
            return {k: _normalize(v) for k, v in data.items()}
        if isinstance(data, np.ndarray):
            return {TENSOR_COLUMN: data}
        if _is_arrow_table(data):  # pyarrow.Table
            t = data.combine_chunks()
            out = {}
            for name in t.column_names:
                col = t.column(name)
                ragged = RaggedArray.from_arrow(col)
                out[name] = (
                    ragged
                    if ragged is not None
                    else col.to_numpy(zero_copy_only=False)
                )
            return out
        if hasattr(data, "to_pydict") and hasattr(data, "schema"):
            # pyarrow.RecordBatch: column-wise, zero-copy where possible
            return {
                name: data.column(i).to_numpy(zero_copy_only=False)
                for i, name in enumerate(data.schema.names)
            }
        if hasattr(data, "columns") and hasattr(data, "to_numpy"):  # DataFrame
            # object columns of sequences become RaggedArray via _normalize
            return {c: _normalize(data[c].to_numpy()) for c in data.columns}
        if isinstance(data, list):  # rows
            return BlockAccessor.from_rows(data)
        raise TypeError(f"cannot interpret {type(data)} as a block")

    @staticmethod
    def from_rows(rows: list) -> Block:
        if not rows:
            return {}
        first = rows[0]
        if isinstance(first, dict):
            cols = {}
            for k in first:
                cols[k] = _normalize([r[k] for r in rows])
            return cols
        return {TENSOR_COLUMN: _normalize(rows)}

    @staticmethod
    def concat(blocks: list[Block]) -> Block:
        blocks = [
            b if isinstance(b, dict) else BlockAccessor.normalize(b)
            for b in blocks
        ]
        blocks = [b for b in blocks if b and BlockAccessor(b).num_rows()]
        if not blocks:
            return {}
        keys = blocks[0].keys()
        out = {}
        for k in keys:
            parts = [b[k] for b in blocks]
            if any(isinstance(p, RaggedArray) for p in parts):
                out[k] = RaggedArray.concat(
                    [
                        p
                        if isinstance(p, RaggedArray)
                        else RaggedArray.from_sequences(list(p))
                        for p in parts
                    ]
                )
            else:
                try:
                    out[k] = np.concatenate(parts)
                except ValueError:
                    # per-block uniform but cross-block ragged (e.g. one-row
                    # blocks of different sequence lengths): the column is
                    # ragged, the individual blocks just couldn't see it
                    out[k] = RaggedArray.concat(
                        [RaggedArray.from_sequences(list(p)) for p in parts]
                    )
        return out

    # -- inspection ---------------------------------------------------------

    def num_rows(self) -> int:
        if not self._b:
            return 0
        return len(next(iter(self._b.values())))

    def size_bytes(self) -> int:
        return sum(
            v.nbytes if isinstance(v, (np.ndarray, RaggedArray)) else 64
            for v in self._b.values()
        )

    def schema(self) -> dict[str, str]:
        return {
            k: (
                f"ragged<{v.dtype}>"
                if isinstance(v, RaggedArray)
                else str(v.dtype)
            )
            for k, v in self._b.items()
        }

    def columns(self) -> list[str]:
        return list(self._b.keys())

    # -- row/slice access ---------------------------------------------------

    def row(self, i: int) -> dict:
        return {k: v[i] for k, v in self._b.items()}

    def iter_rows(self) -> Iterator[dict]:
        for i in range(self.num_rows()):
            yield self.row(i)

    def slice(self, start: int, end: int) -> Block:
        return {k: v[start:end] for k, v in self._b.items()}

    def take_indices(self, idx: np.ndarray) -> Block:
        return {k: v[idx] for k, v in self._b.items()}

    # -- conversion ---------------------------------------------------------

    def to_numpy(self) -> dict[str, np.ndarray]:
        return dict(self._b)

    def to_pandas(self):
        import pandas as pd

        def col(v):
            if isinstance(v, RaggedArray):
                return v.to_list()
            return list(v) if v.ndim > 1 else v

        return pd.DataFrame({k: col(v) for k, v in self._b.items()})

    def to_arrow(self):
        import pyarrow as pa

        return pa.table(
            {
                k: (v.to_arrow() if isinstance(v, RaggedArray) else v)
                for k, v in self._b.items()
            }
        )

    def to_batch(self, batch_format: Optional[str]):
        if batch_format in (None, "numpy", "default"):
            b = dict(self._b)
            # single-tensor convenience: unwrap to the bare ndarray
            if set(b.keys()) == {TENSOR_COLUMN}:
                return b[TENSOR_COLUMN]
            return b
        if batch_format == "dict":
            return dict(self._b)
        if batch_format == "pandas":
            return self.to_pandas()
        if batch_format == "pyarrow":
            return self.to_arrow()
        raise ValueError(f"unknown batch_format: {batch_format}")


class ArrowBlockAccessor(BlockAccessor):
    """Accessor over a ``pyarrow.Table`` block — Arrow IS the block, no
    up-front conversion (reference: ``_internal/arrow_block.py``
    ``ArrowBlockAccessor``). Row-range ops (slice/take) are zero-copy table
    ops; ``to_numpy``/``to_batch`` convert lazily at the compute boundary,
    zero-copy for non-null numeric columns. Parquet reads produce these
    natively (``read_parquet``), so scan→slice→batch never round-trips
    through Python objects."""

    def __init__(self, table):
        self._b = table

    def num_rows(self) -> int:
        return self._b.num_rows

    def size_bytes(self) -> int:
        return self._b.nbytes

    def schema(self) -> dict[str, str]:
        return {
            f.name: str(f.type) for f in self._b.schema
        }

    def columns(self) -> list[str]:
        return list(self._b.column_names)

    def row(self, i: int) -> dict:
        return {
            name: self._b.column(name)[i].as_py()
            for name in self._b.column_names
        }

    def iter_rows(self) -> Iterator[dict]:
        for batch in self._b.to_batches():
            yield from batch.to_pylist()

    def slice(self, start: int, end: int):
        return self._b.slice(start, end - start)  # zero-copy view

    def take_indices(self, idx: np.ndarray):
        return self._b.take(idx)

    def to_numpy(self) -> dict[str, np.ndarray]:
        return BlockAccessor.normalize(self._b)

    def to_pandas(self):
        return self._b.to_pandas()

    def to_arrow(self):
        return self._b

    def to_batch(self, batch_format: Optional[str]):
        if batch_format == "pyarrow":
            return self._b
        if batch_format == "pandas":
            return self.to_pandas()
        if batch_format not in (None, "numpy", "default", "dict"):
            raise ValueError(f"unknown batch_format: {batch_format}")
        b = self.to_numpy()
        if batch_format != "dict" and set(b) == {TENSOR_COLUMN}:
            return b[TENSOR_COLUMN]
        return b


class PandasBlockAccessor(BlockAccessor):
    """Accessor over a ``pandas.DataFrame`` block — pandas IS the block
    (reference: ``_internal/pandas_block.py`` ``PandasBlockAccessor``).
    map_batches handlers that return DataFrames flow through slice/take/
    concat as DataFrames; conversion to the columnar numpy block happens
    lazily at the compute boundary (``to_numpy``/``to_batch``), where
    object-dtype columns of sequences become RaggedArray columns."""

    def __init__(self, df):
        self._b = df

    def num_rows(self) -> int:
        return len(self._b)

    def size_bytes(self) -> int:
        try:
            return int(self._b.memory_usage(index=False, deep=False).sum())
        except Exception:  # noqa: BLE001
            return 64 * len(self._b.columns)

    def schema(self) -> dict[str, str]:
        return {c: str(t) for c, t in self._b.dtypes.items()}

    def columns(self) -> list[str]:
        return list(self._b.columns)

    def row(self, i: int) -> dict:
        return {c: self._b[c].iloc[i] for c in self._b.columns}

    def iter_rows(self) -> Iterator[dict]:
        for rec in self._b.to_dict(orient="records"):
            yield rec

    def slice(self, start: int, end: int):
        return self._b.iloc[start:end]

    def take_indices(self, idx: np.ndarray):
        return self._b.iloc[np.asarray(idx)]

    def to_numpy(self) -> dict[str, np.ndarray]:
        return {c: _normalize(self._b[c].to_numpy()) for c in self._b.columns}

    def to_pandas(self):
        return self._b

    def to_arrow(self):
        import pyarrow as pa

        return pa.Table.from_pandas(self._b, preserve_index=False)

    def to_batch(self, batch_format: Optional[str]):
        if batch_format == "pandas":
            return self._b
        if batch_format == "pyarrow":
            return self.to_arrow()
        if batch_format not in (None, "numpy", "default", "dict"):
            raise ValueError(f"unknown batch_format: {batch_format}")
        b = self.to_numpy()
        if batch_format != "dict" and set(b) == {TENSOR_COLUMN}:
            return b[TENSOR_COLUMN]
        return b
