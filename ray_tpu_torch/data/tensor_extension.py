"""Tensor extension types for columnar blocks.

Reference: ``python/ray/air/util/tensor_extensions/`` — Arrow/pandas
extension arrays that store variable-shaped ("ragged") and multi-dim tensors
in columns without object-dtype boxing. The native representation is the
flat-values + offsets pair (exactly Arrow's List layout and exactly what a
bucketing/padding kernel wants), with numpy as the backing store —
``to_padded`` is the one materialization the device feed path needs
(static shapes, so a step's shapes stay within its buckets).

Used by the data layer for LLM batch inference over variable-length token
columns: tokenized prompts flow through map_batches/shuffle/sort as a
``RaggedArray`` column and reach ``iter_device_batches`` where they are
bucket-padded into dense ``[B, T]`` arrays plus a lengths vector.

The port's copy of ``ray_tpu/data/tensor_extension.py`` (framework-neutral:
numpy, with pyarrow and pandas imported lazily).
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np


class RaggedArray:
    """[N] rows of variable-length 1-D sequences, stored flat.

    ``values``: 1-D array holding all rows back to back.
    ``offsets``: int64 [N+1]; row i is ``values[offsets[i]:offsets[i+1]]``.
    """

    __slots__ = ("values", "offsets")

    def __init__(self, values: np.ndarray, offsets: np.ndarray):
        self.values = np.asarray(values)
        self.offsets = np.asarray(offsets, np.int64)
        if self.offsets.ndim != 1 or self.offsets.size == 0:
            raise ValueError("offsets must be 1-D with at least one entry")

    # -- construction -------------------------------------------------------

    @classmethod
    def from_sequences(cls, seqs: Iterable) -> "RaggedArray":
        seqs = [np.asarray(s) for s in seqs]
        lengths = np.asarray([len(s) for s in seqs], np.int64)
        offsets = np.zeros(len(seqs) + 1, np.int64)
        np.cumsum(lengths, out=offsets[1:])
        if seqs:
            values = np.concatenate([np.ravel(s) for s in seqs]) if offsets[-1] else np.empty(0, seqs[0].dtype)
        else:
            values = np.empty(0, np.int64)
        return cls(values, offsets)

    @staticmethod
    def maybe_from_column(value) -> Optional["RaggedArray"]:
        """Recognize a ragged column (list-of-sequences or object-dtype
        array of arrays); None when the value is rectangular."""
        if isinstance(value, RaggedArray):
            return value
        if isinstance(value, np.ndarray) and value.dtype != object:
            return None
        if isinstance(value, (list, tuple)) or (
            isinstance(value, np.ndarray) and value.dtype == object
        ):
            items = list(value)
            if items and all(
                isinstance(x, (list, tuple, np.ndarray)) for x in items
            ):
                lens = {len(x) for x in items}
                if len(lens) > 1:
                    return RaggedArray.from_sequences(items)
        return None

    # -- container protocol --------------------------------------------------

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def __getitem__(self, i):
        if isinstance(i, (int, np.integer)):
            return self.values[self.offsets[i]: self.offsets[i + 1]]
        if isinstance(i, slice):
            start, stop, step = i.indices(len(self))
            if step != 1:
                return self.take(np.arange(start, stop, step))
            off = self.offsets[start: stop + 1]
            return RaggedArray(
                self.values[off[0]: off[-1]] if off.size else self.values[:0],
                off - (off[0] if off.size else 0),
            )
        return self.take(np.asarray(i))

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __eq__(self, other):
        if not isinstance(other, RaggedArray):
            return NotImplemented
        return (
            np.array_equal(self.offsets, other.offsets)
            and np.array_equal(self.values, other.values)
        )

    def __repr__(self):
        return (
            f"RaggedArray(n={len(self)}, values={self.values.dtype}"
            f"[{self.values.size}])"
        )

    # -- numpy-ish surface ---------------------------------------------------

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def nbytes(self) -> int:
        return int(self.values.nbytes + self.offsets.nbytes)

    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    def take(self, idx: np.ndarray) -> "RaggedArray":
        idx = np.asarray(idx)
        lens = self.lengths()[idx]
        out_off = np.zeros(len(idx) + 1, np.int64)
        np.cumsum(lens, out=out_off[1:])
        out_vals = np.empty(int(out_off[-1]), self.values.dtype)
        for j, i in enumerate(idx):
            out_vals[out_off[j]: out_off[j + 1]] = self[int(i)]
        return RaggedArray(out_vals, out_off)

    @staticmethod
    def concat(parts: list["RaggedArray"]) -> "RaggedArray":
        values = np.concatenate([p.values for p in parts]) if parts else np.empty(0)
        offsets = [np.asarray([0], np.int64)]
        base = 0
        for p in parts:
            offsets.append(p.offsets[1:] + base)
            base += int(p.offsets[-1])
        return RaggedArray(values, np.concatenate(offsets))

    def to_list(self) -> list:
        return [self[i].tolist() for i in range(len(self))]

    # -- device feed path ----------------------------------------------------

    def to_padded(
        self,
        pad_value=0,
        width: Optional[int] = None,
        buckets: Optional[tuple] = None,
        multiple_of: int = 8,
    ):
        """Dense ``[N, T]`` + lengths ``[N]``. T = ``width`` if given, else
        the smallest of ``buckets`` covering the longest row, else the max
        length rounded up to ``multiple_of`` (static shapes for jit: a
        bounded bucket ladder keeps XLA specializations finite)."""
        lens = self.lengths()
        max_len = int(lens.max()) if lens.size else 0
        if width is not None:
            T = int(width)
        elif buckets:
            T = next((b for b in sorted(buckets) if b >= max_len), max(buckets))
        else:
            T = max(((max_len + multiple_of - 1) // multiple_of) * multiple_of, multiple_of)
        out = np.full((len(self), T), pad_value, self.values.dtype)
        for i in range(len(self)):
            row = self[i][:T]
            out[i, : len(row)] = row
        return out, np.minimum(lens, T)

    # -- conversion boundaries ----------------------------------------------

    def to_arrow(self):
        """Zero-copy into Arrow's List layout (same representation)."""
        import pyarrow as pa

        return pa.ListArray.from_arrays(
            pa.array(self.offsets, type=pa.int32())
            if self.offsets[-1] < 2**31
            else pa.array(self.offsets, type=pa.int64()),
            pa.array(self.values),
        )

    @staticmethod
    def from_arrow(column) -> Optional["RaggedArray"]:
        """From an Arrow List column (ChunkedArray or Array); None when the
        column isn't list-typed."""
        import pyarrow as pa

        if hasattr(column, "combine_chunks"):
            column = column.combine_chunks()
        if not pa.types.is_list(column.type) and not pa.types.is_large_list(
            column.type
        ):
            return None
        return RaggedArray(
            np.asarray(column.values),
            np.asarray(column.offsets, np.int64),
        )

    def to_pandas(self):
        import pandas as pd

        return pd.Series(self.to_list())
