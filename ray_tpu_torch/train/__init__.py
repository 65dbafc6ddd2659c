"""ray_tpu_torch.train — data-parallel training over a torch process group.

Counterpart of ``ray_tpu.train``: ``TorchTrainer``, the configs,
``Checkpoint`` (with ``save_state_dict`` / ``restore_state_dict`` in the JAX
package's checkpoint format), ``Result``, the in-loop session API
(``report`` / ``get_checkpoint`` / ``get_context`` / ``get_dataset_shard``,
and ``get_device``) and the loop's collectives (``barrier``,
``broadcast_from_rank_zero``).
"""

from ray_tpu_torch.train.checkpoint import (
    Checkpoint,
    restore_state_dict,
    save_state_dict,
)
from ray_tpu_torch.train.collective import barrier, broadcast_from_rank_zero
from ray_tpu_torch.train.config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train.context import TrainContext
from ray_tpu_torch.train.session import (
    get_checkpoint,
    get_context,
    get_dataset_shard,
    get_device,
    report,
)
from ray_tpu_torch.train.trainer import (
    BaseTrainer,
    DataParallelTrainer,
    Result,
    TorchTrainer,
)

__all__ = [
    "BaseTrainer",
    "Checkpoint",
    "CheckpointConfig",
    "DataParallelTrainer",
    "FailureConfig",
    "Result",
    "RunConfig",
    "ScalingConfig",
    "TorchTrainer",
    "TrainContext",
    "barrier",
    "broadcast_from_rank_zero",
    "get_checkpoint",
    "get_context",
    "get_dataset_shard",
    "get_device",
    "report",
    "restore_state_dict",
    "save_state_dict",
]
