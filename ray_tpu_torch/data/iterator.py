"""Batched consumption: ``DataIterator`` (the port's counterpart of
``ray_tpu/data/iterator.py:21-181``) and device-resident torch batches.

``DataIterator`` re-chunks a dataset's blocks into exact batch sizes
(``iter_batches``, ``iter_rows``, ``materialize_blocks``). Where the JAX
package has ``iter_jax_batches`` (:74), the port has ``iter_device_batches``
and ``iter_torch_batches``, both through ``iter_device_batches(source,
...)``. A ``DataIterator`` over a materialized shard pickles with its
blocks, so ``Dataset.streaming_split``'s iterators go to Train's rank
processes.

``iter_device_batches(source, ...)`` reads any object with
``iter_batches(batch_size=, batch_format="numpy", drop_last=)`` (a
``DataIterator`` or ``Dataset`` of the port, or any other with that
method: duck typed) and yields each batch as tensors on the rank's device:

- each array is copied from a pinned host buffer with
  ``non_blocking=True``, and ``prefetch`` batches are in flight ahead of
  the one yielded, the JAX iterator's deque (:160-167): the host-to-device
  copy of the next batch overlaps the step on this one;
- a ragged column (anything with ``to_padded(pad_value=, buckets=)``, as
  ``RaggedArray``) is padded to a bucket and gets a ``<col>_length`` int32
  column, as in the JAX iterator;
- with a ``mesh`` each rank keeps its slice of the global batch by
  ``spec`` (one entry per leading dim: a mesh axis, a tuple of axes or
  None), the shard that JAX's ``NamedSharding(mesh, spec)`` places on the
  rank's device. The default spec is the JAX iterator's
  ``PartitionSpec(mesh.axis_names[0])`` (:104);
- a train step's batch is cut by the step itself: with a ``mesh`` and the
  model's ``cfg`` each rank gets ``models.training.shard_batch(batch,
  mesh, cfg)``, the shard ``make_train_step(mesh=)`` takes (labels
  shifted before the sequence is cut over sp, rows laid out as the
  step's pipeline microbatches under pp). A ``spec`` shard equals it
  only without pp and with sp = 1, so ``cfg`` and ``spec`` exclude each
  other.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Iterator, Optional, Union

import numpy as np
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.data.block import TENSOR_COLUMN, Block, BlockAccessor


class DataIterator:
    """Iterates a dataset's blocks re-chunked into exact batch sizes.
    ``blocks_factory``: () -> an iterator of blocks (or futures of blocks),
    restartable for epochs; a dataset's bound ``_execute`` pickles with the
    dataset."""

    def __init__(self, blocks_factory, owner_repr: str = "dataset"):
        self._factory = blocks_factory
        self._owner_repr = owner_repr

    def _iter_blocks(self) -> Iterator[Block]:
        from ray_tpu_torch.data.execution import _resolve

        for item in self._factory():
            yield _resolve(item)

    def iter_batches(
        self,
        *,
        batch_size: Optional[int] = 256,
        batch_format: Optional[str] = "numpy",
        drop_last: bool = False,
        local_shuffle_buffer_size: Optional[int] = None,
        local_shuffle_seed: Optional[int] = None,
    ) -> Iterator[Any]:
        carry: Optional[Block] = None
        rng = (
            np.random.default_rng(local_shuffle_seed)
            if local_shuffle_buffer_size
            else None
        )
        for block in self._iter_blocks():
            block = BlockAccessor.normalize(block)
            if not BlockAccessor(block).num_rows():
                continue
            if rng is not None:
                perm = rng.permutation(BlockAccessor(block).num_rows())
                block = BlockAccessor(block).take_indices(perm)
            carry = (
                block if carry is None else BlockAccessor.concat([carry, block])
            )
            if batch_size is None:
                yield BlockAccessor(carry).to_batch(batch_format)
                carry = None
                continue
            while carry is not None and BlockAccessor(carry).num_rows() >= batch_size:
                acc = BlockAccessor(carry)
                yield BlockAccessor(acc.slice(0, batch_size)).to_batch(batch_format)
                rest = acc.slice(batch_size, acc.num_rows())
                carry = rest if BlockAccessor(rest).num_rows() else None
        if carry is not None and BlockAccessor(carry).num_rows() and not drop_last:
            yield BlockAccessor(carry).to_batch(batch_format)

    def iter_rows(self) -> Iterator[dict]:
        for block in self._iter_blocks():
            yield from BlockAccessor.for_block(block).iter_rows()

    def iter_device_batches(self, **kwargs) -> Iterator[Any]:
        """``iter_device_batches(self, **kwargs)``: batches as tensors on the
        card (or the ``device`` named), drop_last True by default."""
        return iter_device_batches(self, **kwargs)

    def iter_torch_batches(self, *, batch_size: Optional[int] = 256, drop_last: bool = False,
                           **kwargs) -> Iterator[Any]:
        """The reference's ``iter_torch_batches``: ``iter_device_batches``
        with its drop_last default (False); on the card unless ``device``
        names another."""
        return iter_device_batches(self, batch_size=batch_size, drop_last=drop_last, **kwargs)

    def materialize_blocks(self) -> list[Block]:
        return list(self._iter_blocks())

    def __repr__(self):
        return f"DataIterator({self._owner_repr})"


def iter_device_batches(
    source,
    *,
    batch_size: Optional[int] = 256,
    dtypes: Any = None,
    device: Union[str, torch.device, None] = None,
    mesh=None,
    spec: Optional[tuple] = None,
    cfg=None,
    drop_last: bool = True,
    prefetch: int = 1,
    ragged_pad_value=0,
    ragged_buckets: Optional[tuple] = None,
) -> Iterator[Any]:
    """Batches of ``source`` as tensors on ``device`` (CUDA unless the
    caller names another): a dict of columns, or one tensor for a
    bare-tensor batch. ``dtypes``: a numpy dtype for every column, or a
    dict by column name (``"data"`` for a bare-tensor batch). drop_last
    defaults True, as in the JAX iterator (a short last batch would change
    the step's shapes). ``cfg``: the model's ``LlamaConfig``, with a
    ``mesh``: each batch is a dict of columns cut as the train step cuts
    it (see the module's docstring)."""
    device = resolve_device(device)
    if cfg is not None and (mesh is None or spec is not None):
        raise ValueError("cfg cuts a train step's batch: it needs a mesh and takes no spec")
    if mesh is not None and spec is None:
        spec = (mesh.mesh_dim_names[0],)

    def dtype_of(name):
        return dtypes.get(name) if isinstance(dtypes, dict) else dtypes

    def cast(arr, dt) -> np.ndarray:
        arr = np.asarray(arr)
        return arr if dt is None else arr.astype(dt)

    def put(arr) -> torch.Tensor:
        if cfg is None and mesh is not None:
            from ray_tpu_torch.parallel.mesh import local_slice

            arr = arr[local_slice(mesh, tuple(spec[: arr.ndim]), arr.shape[: len(spec)])]
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    def to_device(batch):
        if not isinstance(batch, dict):
            return put(cast(batch, dtype_of(TENSOR_COLUMN)))
        host = {}
        for k, v in batch.items():
            if hasattr(v, "to_padded"):
                padded, lens = v.to_padded(pad_value=ragged_pad_value, buckets=ragged_buckets)
                host[k] = cast(padded, dtype_of(k))
                host[f"{k}_length"] = np.asarray(lens, np.int32)
            else:
                host[k] = cast(v, dtype_of(k))
        if cfg is not None:
            from ray_tpu_torch.models.training import shard_batch

            host = {k: v.numpy() for k, v in shard_batch(host, mesh, cfg).items()}
        return {k: put(v) for k, v in host.items()}

    window: deque = deque()
    for batch in source.iter_batches(batch_size=batch_size, batch_format="numpy",
                                     drop_last=drop_last):
        window.append(to_device(batch))  # the copy starts here
        if len(window) > prefetch:
            yield window.popleft()
    while window:
        yield window.popleft()
