"""Device-resident torch batches: the counterpart of
``ray_tpu/data/iterator.py:DataIterator.iter_jax_batches`` (:74).

``iter_device_batches(source, ...)`` reads any object with
``iter_batches(batch_size=, batch_format="numpy", drop_last=)`` (a ray_tpu
Dataset or DataIterator among them: duck typed, the port imports nothing
of ray_tpu) and yields each batch as tensors on the rank's device:

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

TENSOR_COLUMN = "data"  # the JAX package's column name of single-tensor datasets


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
