"""ray_tpu_torch.data — the port of ``ray_tpu/data/``: datasets feeding the
card's input pipelines.

The public surface of ``ray_tpu/data/__init__.py`` (the reference's
``ray.data``): a lazy ``Dataset`` over a logical plan, streaming execution
with backpressure on driver threads and actor pools of the port's own
processes, the datasources and batch iteration, with ``iter_torch_batches``
/ ``iter_device_batches`` (device-resident torch batches) where the JAX
package has ``iter_jax_batches``.
"""

from ray_tpu_torch.data.block import Block, BlockAccessor
from ray_tpu_torch.data.context import DataContext
from ray_tpu_torch.data.execution import ActorPoolStrategy
from ray_tpu_torch.data.dataset import (
    Dataset,
    GroupedData,
    MaterializedDataset,
    from_arrow,
    from_generator,
    from_items,
    from_numpy,
    from_pandas,
    range,
    range_tensor,
    read_binary_files,
    read_csv,
    read_datasource,
    read_images,
    read_json,
    read_numpy,
    read_parquet,
    read_sql,
    read_text,
)
from ray_tpu_torch.data.datasource import Datasource, ReadTask
from ray_tpu_torch.data.iterator import DataIterator, iter_device_batches
from ray_tpu_torch.data.logical import (
    EliminateRedundantOps,
    LimitPushdown,
    ProjectionPushdown,
    Rule,
)
from ray_tpu_torch.data.partitioning import Partitioning, PathPartitionFilter

__all__ = [
    "Block",
    "BlockAccessor",
    "DataContext",
    "ActorPoolStrategy",
    "DataIterator",
    "Dataset",
    "Datasource",
    "GroupedData",
    "MaterializedDataset",
    "Partitioning",
    "PathPartitionFilter",
    "ReadTask",
    "Rule",
    "EliminateRedundantOps",
    "LimitPushdown",
    "ProjectionPushdown",
    "from_arrow",
    "from_items",
    "from_numpy",
    "from_pandas",
    "range",
    "range_tensor",
    "read_binary_files",
    "read_csv",
    "read_images",
    "read_sql",
    "from_generator",
    "read_datasource",
    "read_json",
    "read_numpy",
    "read_parquet",
    "read_text",
    "iter_device_batches",
]
