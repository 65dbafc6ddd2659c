"""In-loop training session: ``report`` / ``get_checkpoint`` / ``get_context``.

The port's copy of ``ray_tpu/train/session.py`` (reference:
``python/ray/train/_internal/session.py``: ``report`` :672,
``get_checkpoint`` :786, ``get_dataset_shard`` :1114). Each rank is a
process of its own and runs its train loop on its main thread, so a process
holds at most one session. ``report`` persists a rank-0 checkpoint into the
attempt's storage directory (``checkpoint_NNNNNN``; a framework-owned
tempdir is moved there, any other copied) and sends the result to the
controller over the rank's pipe; other ranks report metrics only, and
their ephemeral checkpoints are deleted.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Optional

import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.context import TrainContext


class _TrainSession:
    def __init__(
        self,
        context: TrainContext,
        storage_dir: str,
        latest_checkpoint: Optional[Checkpoint],
        dataset_shards: dict[str, Any],
        conn,
        device: torch.device,
    ):
        self.context = context
        self.storage_dir = storage_dir
        self.latest_checkpoint = latest_checkpoint
        self.dataset_shards = dataset_shards
        self.device = device
        self.report_count = 0
        self._conn = conn  # the write end of this rank's pipe to the controller

    def report(self, metrics: dict, checkpoint: Optional[Checkpoint] = None):
        entry: dict[str, Any] = {"kind": "result", "rank": self.context.world_rank,
                                 "metrics": dict(metrics), "checkpoint_dir": None}
        if checkpoint is not None:
            if self.context.world_rank == 0:
                dst = os.path.join(self.storage_dir, f"checkpoint_{self.report_count:06d}")
                if os.path.abspath(checkpoint.path) != os.path.abspath(dst):
                    _persist(checkpoint, dst)
                entry["checkpoint_dir"] = dst
                self.latest_checkpoint = Checkpoint(dst)
            elif checkpoint._ephemeral:
                # framework-owned and unused off rank 0: reclaim it so
                # per-step reports don't pile up model-sized dirs in /tmp
                shutil.rmtree(checkpoint.path, ignore_errors=True)
        self.report_count += 1
        self._conn.send(entry)

    def get_checkpoint(self) -> Optional[Checkpoint]:
        return self.latest_checkpoint

    def get_dataset_shard(self, name: str = "train"):
        return self.dataset_shards.get(name)


def _persist(checkpoint: Checkpoint, dst: str) -> None:
    """Put ``checkpoint`` at ``dst``: an ephemeral one is moved (a rename on
    one filesystem, a copy then a delete across two), any other copied."""
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    if checkpoint._ephemeral:
        try:
            os.rename(checkpoint.path, dst)
            return
        except OSError:
            pass
    shutil.copytree(checkpoint.path, dst, dirs_exist_ok=True)
    if checkpoint._ephemeral:
        shutil.rmtree(checkpoint.path, ignore_errors=True)


_session: Optional[_TrainSession] = None  # this rank process's session


def _set_session(s: Optional[_TrainSession]) -> None:
    global _session
    _session = s


# -- public in-loop API ------------------------------------------------------


def report(metrics: dict, *, checkpoint: Optional[Checkpoint] = None) -> None:
    """Report metrics (and optionally a checkpoint) from the train loop."""
    if _session is None:
        raise RuntimeError("ray_tpu_torch.train.report() called outside a training session")
    _session.report(metrics, checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    return None if _session is None else _session.get_checkpoint()


def get_context() -> TrainContext:
    return TrainContext() if _session is None else _session.context


def get_dataset_shard(dataset_name: str = "train"):
    return None if _session is None else _session.get_dataset_shard(dataset_name)


def get_device() -> torch.device:
    """This rank's device: its one visible card under ``use_gpu``, else the
    CPU (reference: ``ray.train.torch.get_device``). Outside a session, the
    port's default (``resolve_device``: CUDA, or an error without a card)."""
    return resolve_device() if _session is None else _session.device
