"""Per-rank train context (reference: ``python/ray/train/context.py:117``);
the port's copy of ``ray_tpu/train/context.py``."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class TrainContext:
    world_size: int = 1
    world_rank: int = 0
    local_rank: int = 0
    local_world_size: int = 1
    node_rank: int = 0
    experiment_name: str = ""
    trial_name: str = ""
    trial_id: str = ""
    coordinator_address: Optional[str] = None

    def get_world_size(self) -> int:
        return self.world_size

    def get_world_rank(self) -> int:
        return self.world_rank

    def get_local_rank(self) -> int:
        return self.local_rank

    def get_local_world_size(self) -> int:
        return self.local_world_size

    def get_node_rank(self) -> int:
        return self.node_rank

    def get_experiment_name(self) -> str:
        return self.experiment_name

    def get_trial_name(self) -> str:
        return self.trial_name

    def get_trial_id(self) -> str:
        return self.trial_id
