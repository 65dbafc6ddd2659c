"""Top-k checkpoint retention (reference: ``train/_internal/checkpoint_manager.py``);
the port's copy of ``ray_tpu/train/_internal/checkpoint_manager.py``."""

from __future__ import annotations

import shutil
from typing import Optional

from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import CheckpointConfig


class _TrackedCheckpoint:
    def __init__(
        self, checkpoint: Checkpoint, metrics: dict, index: int, protected: bool = False
    ):
        self.checkpoint = checkpoint
        self.metrics = dict(metrics)
        self.index = index
        # protected = externally-owned (e.g. resume_from_checkpoint): may be
        # dropped from tracking but its directory is never deleted
        self.protected = protected


class CheckpointManager:
    """Keeps the latest + top-k checkpoints per CheckpointConfig."""

    def __init__(self, config: CheckpointConfig):
        self.config = config
        self.tracked: list[_TrackedCheckpoint] = []
        self.latest: Optional[_TrackedCheckpoint] = None
        self._counter = 0

    def register(
        self, checkpoint: Checkpoint, metrics: dict, protected: bool = False
    ) -> None:
        tc = _TrackedCheckpoint(checkpoint, metrics, self._counter, protected)
        self._counter += 1
        self.latest = tc
        self.tracked.append(tc)
        self._enforce_retention()

    def _score(self, tc: _TrackedCheckpoint) -> float:
        attr = self.config.checkpoint_score_attribute
        if attr is None:
            return float(tc.index)  # recency
        v = tc.metrics.get(attr)
        if v is None:
            return float("-inf")
        return float(v) if self.config.checkpoint_score_order == "max" else -float(v)

    def _enforce_retention(self) -> None:
        k = self.config.num_to_keep
        if k is None or len(self.tracked) <= k:
            return
        self.tracked.sort(key=self._score, reverse=True)
        keep, drop = self.tracked[:k], self.tracked[k:]
        # never delete the latest (resume anchor), matching the reference
        for tc in drop:
            if tc is self.latest:
                keep.append(tc)
                continue
            if not tc.protected:
                shutil.rmtree(tc.checkpoint.path, ignore_errors=True)
        self.tracked = keep

    def best_checkpoint(self) -> Optional[Checkpoint]:
        if not self.tracked:
            return None
        return max(self.tracked, key=self._score).checkpoint

    def latest_checkpoint(self) -> Optional[Checkpoint]:
        return self.latest.checkpoint if self.latest else None
