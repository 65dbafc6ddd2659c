"""DataContext (reference: ``python/ray/data/context.py``); the port's copy
of ``ray_tpu/data/context.py``.

In the port a stage of stateless tasks runs on a pool of threads in the
driver (``execution.py``), ``max_tasks_in_flight`` of them at most: that
cap is the backpressure. ``block_max_retries`` and ``task_resources``
keep the reference's fields and have no effect there: a driver thread has
no host to lose and no node to be placed on.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional


@dataclasses.dataclass
class DataContext:
    """Execution knobs, read once per plan execution."""

    target_max_block_size: int = 128 * 1024 * 1024
    target_min_block_size: int = 1 * 1024 * 1024
    # backpressure: per-stage in-flight task caps. Each stage adapts its cap
    # inside [min, max] by observed starvation: a consumer blocking on an
    # unfinished head grows the cap; a stage running ahead shrinks it
    # (reference: ``_internal/execution/backpressure_policy/``).
    max_tasks_in_flight: int = 8
    min_tasks_in_flight: int = 2
    # rows per read task when a datasource doesn't decide for itself
    default_read_block_size: int = 1000
    preserve_order: bool = True
    # resources attached to each block task
    task_resources: Optional[dict] = None
    # crash-retry budget for block tasks (read/transform). Block tasks on a
    # preempted/killed node re-run from lineage instead of failing the
    # pipeline — on a preemptible fleet every stage must survive its host
    # (reference: ray.data's DEFAULT_TASK_MAX_RETRIES on block tasks)
    block_max_retries: int = 4
    # logical optimizer rules applied before physical planning, in order
    # (reference: _internal/logical/rules; append custom Rule instances)
    optimizer_rules: tuple = dataclasses.field(
        default_factory=lambda: _default_rules()
    )

    _instance = None
    _lock = threading.Lock()

    @classmethod
    def get_current(cls) -> "DataContext":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance


def _default_rules() -> tuple:
    from ray_tpu_torch.data.logical import DEFAULT_RULES

    return DEFAULT_RULES
