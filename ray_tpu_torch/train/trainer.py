"""Trainers: ``TorchTrainer``, data-parallel training over a torch process group.

The port's counterpart of ``ray_tpu/train/trainer.py`` (``Result`` :28,
``BaseTrainer`` :60, ``DataParallelTrainer`` :116). Reference call stack:
``TorchTrainer(train_loop, scaling_config).fit()`` -> ``BaseTrainer.fit``
(``base_trainer.py:127``) -> worker group + process-group setup
(``backend_executor.py:146/230``, ``torch/config.py:153``). Here the ranks
are spawned processes on this host (``_internal/worker_group.py``), joined
in one process group (NCCL under ``use_gpu``, gloo on CPU ranks); the
train loop is user code calling ``ray_tpu_torch.train.report``.

``TorchTrainer`` is the port's own class, where the JAX package aliases the
name to ``JaxTrainer`` (:178). Two rules differ from the JAX trainer:

- the train function goes to the ranks with the standard ``pickle``, by
  reference, so it must be a module-level function: a closure or lambda
  raises ``TypeError`` at ``fit()`` (the JAX trainer cloudpickles it by
  value; the card's machine has no cloudpickle);
- ``ScalingConfig.use_gpu`` defaults to True and never falls back: without
  a card ``fit()`` raises, and CPU ranks are asked for with
  ``use_gpu=False``.
"""

from __future__ import annotations

import os
import pickle
import uuid
from typing import Any, Callable, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train._internal.controller import RunState, TrainController
from ray_tpu_torch.train._internal.worker_group import gpu_ids_per_rank


class Result:
    """Outcome of ``trainer.fit()`` (reference: ``air/result.py``)."""

    def __init__(
        self,
        metrics: dict,
        checkpoint: Optional[Checkpoint],
        error: Optional[str],
        path: str,
        metrics_history: Optional[list[dict]] = None,
        best_checkpoint: Optional[Checkpoint] = None,
    ):
        self.metrics = metrics
        self.checkpoint = checkpoint
        self.error = error
        self.path = path
        self.metrics_history = metrics_history or []
        self.best_checkpoint = best_checkpoint

    @property
    def metrics_dataframe(self):
        import pandas as pd  # optional; raises if pandas absent

        return pd.DataFrame(self.metrics_history)

    def __repr__(self):
        return f"Result(metrics={self.metrics}, error={self.error!r}, path={self.path!r})"


class BaseTrainer:
    """Shared fit() plumbing (reference: ``train/base_trainer.py:127``)."""

    def __init__(
        self,
        *,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[dict[str, Any]] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
    ):
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.datasets = datasets or {}
        self.resume_from_checkpoint = resume_from_checkpoint

    def _experiment_dir(self) -> str:
        name = self.run_config.name or f"{type(self).__name__}_{uuid.uuid4().hex[:8]}"
        self.run_config.name = name
        d = os.path.join(os.path.expanduser(self.run_config.storage_path), name)
        os.makedirs(d, exist_ok=True)
        return d

    def fit(self) -> Result:
        raise NotImplementedError


class DataParallelTrainer(BaseTrainer):
    """Runs one train function on N ranks (reference:
    ``train/data_parallel_trainer.py:26``)."""

    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[dict] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[dict[str, Any]] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
    ):
        super().__init__(
            scaling_config=scaling_config,
            run_config=run_config,
            datasets=datasets,
            resume_from_checkpoint=resume_from_checkpoint,
        )
        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = train_loop_config

    def fit(self) -> Result:
        try:
            pickle.dumps(self.train_loop_per_worker)
        except (pickle.PicklingError, AttributeError, TypeError) as e:
            raise TypeError(
                f"the train function {self.train_loop_per_worker!r} must be picklable by "
                "reference with the standard pickle (a module-level function, not a "
                f"closure or lambda): the ranks import it by name ({e})"
            ) from e
        # no card, or too few cards for the ranks: raise here, at once
        gpu_ids_per_rank(self.scaling_config, self.scaling_config.num_workers)
        exp_dir = self._experiment_dir()
        controller = TrainController(
            train_fn=self.train_loop_per_worker,
            train_fn_config=self.train_loop_config,
            scaling=self.scaling_config,
            run_config=self.run_config,
            experiment_dir=exp_dir,
            datasets=self.datasets,
            trial_id=uuid.uuid4().hex[:8],
        )
        if self.resume_from_checkpoint is not None:
            controller.checkpoint_manager.register(
                self.resume_from_checkpoint, {"resumed": True}, protected=True
            )
        self._controller = controller  # introspection (state, rank start-up)
        internal = controller.run()
        return Result(
            metrics=internal.metrics,
            checkpoint=internal.checkpoint,
            best_checkpoint=internal.best_checkpoint,
            error=internal.error if internal.state is RunState.ERRORED else None,
            path=exp_dir,
            metrics_history=internal.metrics_history,
        )


class TorchTrainer(DataParallelTrainer):
    """Data-parallel PyTorch training: one process per rank, a process
    group across them, and the user's loop calling ``report``. With
    ``use_gpu`` each rank owns one card (``train.get_device()``) and the
    group runs NCCL; the loop builds its step with
    ``make_train_step(cfg, dp_group=torch.distributed.group.WORLD)``."""
