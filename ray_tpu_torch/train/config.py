"""Train configuration dataclasses: the port's copy of ``ray_tpu/train/config.py``.

``CheckpointConfig``, ``FailureConfig`` and ``RunConfig`` are the JAX
package's, value for value. ``ScalingConfig`` speaks in GPU ranks on one
host: ``use_gpu`` (the default: entry points run on the card unless the
caller asks for the CPU) gives each rank one card; ``use_tpu``,
``topology`` and ``use_jax_distributed`` have no counterpart. The elastic
bounds are the reference's: ``min_workers`` makes the group elastic
(``train/_internal/controller.py:ElasticScalingPolicy``, sized by what the
host's card ledger has free) and ``max_workers`` is accepted and read
nowhere, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional


@dataclasses.dataclass
class ScalingConfig:
    """How many training ranks, with what resources.

    Reference contract: ``air/config.py`` ``ScalingConfig(num_workers,
    use_gpu, resources_per_worker, placement_strategy)``. The ranks are
    processes on this host; ``placement_strategy`` is kept for the
    reference's signature and places nothing here. ``min_workers``: the
    elastic range's floor (None: a fixed size); ``max_workers``: kept for
    the reference's signature."""

    num_workers: int = 1
    use_gpu: bool = True
    resources_per_worker: Optional[dict[str, float]] = None
    placement_strategy: str = "STRICT_PACK"
    min_workers: Optional[int] = None
    max_workers: Optional[int] = None

    def __post_init__(self):
        if self.num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        if self.min_workers is not None and self.min_workers > self.num_workers:
            raise ValueError("min_workers must be <= num_workers")

    @property
    def elastic(self) -> bool:
        return self.min_workers is not None

    def worker_resources(self) -> dict[str, float]:
        res = dict(self.resources_per_worker or {})
        if "CPU" not in res:
            res["CPU"] = 1.0
        if self.use_gpu and "GPU" not in res:
            res["GPU"] = 1.0
        return res


@dataclasses.dataclass
class CheckpointConfig:
    """Checkpoint retention policy (reference: ``air/config.py`` CheckpointConfig)."""

    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"
    checkpoint_frequency: int = 0
    checkpoint_at_end: bool = False

    def __post_init__(self):
        if self.checkpoint_score_order not in ("max", "min"):
            raise ValueError("checkpoint_score_order must be 'max' or 'min'")
        if self.num_to_keep is not None and self.num_to_keep <= 0:
            raise ValueError("num_to_keep must be positive or None")


@dataclasses.dataclass
class FailureConfig:
    """Retry policy for rank failures (reference: ``air/config.py``).

    ``max_failures``: -1 = infinite retries, 0 = fail fast, N = N restarts.
    """

    max_failures: int = 0


@dataclasses.dataclass
class RunConfig:
    """Experiment-level config (reference: ``air/config.py`` RunConfig)."""

    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: Optional[FailureConfig] = None
    checkpoint_config: Optional[CheckpointConfig] = None
    stop: Optional[dict[str, Any]] = None
    verbose: int = 1

    def __post_init__(self):
        if self.storage_path is None:
            self.storage_path = os.path.expanduser(
                os.environ.get("RAY_TPU_STORAGE_PATH", "~/ray_tpu_results")
            )
        if self.failure_config is None:
            self.failure_config = FailureConfig()
        if self.checkpoint_config is None:
            self.checkpoint_config = CheckpointConfig()
