"""Train controller: the state machine that drives a worker group.

The port's copy of ``ray_tpu/train/_internal/controller.py`` (reference:
``train/v2/_internal/execution/controller/controller.py:94``):
INITIALIZING -> SCHEDULING -> RUNNING -> (RESTARTING) -> FINISHED / ERRORED.
The restart granularity is the whole group: any rank's failure (an error in
its loop, a non-zero exit, a death) tears down every rank, and the group
restarts from the latest checkpoint while ``FailureConfig.max_failures``
allows. Elastic resizing is not ported (``config.py``).
"""

from __future__ import annotations

import enum
import logging
import os
from typing import Any, Callable, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train._internal.checkpoint_manager import CheckpointManager
from ray_tpu_torch.train._internal.worker_group import WorkerGroup

logger = logging.getLogger(__name__)


class RunState(enum.Enum):
    INITIALIZING = "INITIALIZING"
    SCHEDULING = "SCHEDULING"
    RUNNING = "RUNNING"
    RESTARTING = "RESTARTING"
    FINISHED = "FINISHED"
    ERRORED = "ERRORED"


class FailurePolicy:
    """max_failures accounting (reference: ``failure_handling/``)."""

    def __init__(self, max_failures: int):
        self.max_failures = max_failures
        self.failures = 0

    def should_retry(self) -> bool:
        self.failures += 1
        if self.max_failures < 0:
            return True
        return self.failures <= self.max_failures


class TrainController:
    """Runs one training job to completion."""

    def __init__(
        self,
        train_fn: Callable,
        train_fn_config: Optional[dict],
        scaling: ScalingConfig,
        run_config: RunConfig,
        experiment_dir: str,
        datasets: Optional[dict[str, Any]] = None,
        trial_id: str = "",
    ):
        self.train_fn = train_fn
        self.train_fn_config = train_fn_config
        self.scaling = scaling
        self.run_config = run_config
        self.experiment_dir = experiment_dir
        self.datasets = datasets or {}
        self.trial_id = trial_id
        self.state = RunState.INITIALIZING
        self.checkpoint_manager = CheckpointManager(run_config.checkpoint_config)
        self.failure_policy = FailurePolicy(run_config.failure_config.max_failures)
        self.metrics_history: list[dict] = []
        self.error: Optional[str] = None
        self._attempt = 0
        # per attempt, the slowest rank's seconds from its spawn to its
        # train loop's start (imports, rendezvous, session)
        self.rank_startup_s: list[float] = []

    # -- lifecycle ----------------------------------------------------------

    def run(self, poll_interval: float = 0.05) -> "TrainResultInternal":
        os.makedirs(self.experiment_dir, exist_ok=True)
        while True:
            group = self._start_group()
            if group is None:
                # a start-up failure is retryable under the same budget as
                # a failure while running
                if self.failure_policy.should_retry():
                    self.state = RunState.RESTARTING
                    self._attempt += 1
                    continue
                self.state = RunState.ERRORED
                break
            outcome = "failed"
            try:
                outcome = self._run_until_done(group, poll_interval)
            finally:
                # ranks that all finished get time to exit on their own
                group.shutdown(wait_s=30.0 if outcome == "done" else 0.0)
            if outcome in ("done", "stopped"):
                self.state = RunState.FINISHED
                break
            if not self.failure_policy.should_retry():
                self.state = RunState.ERRORED
                if self.error is None:
                    self.error = "training failed and retry budget exhausted"
                break
            self.state = RunState.RESTARTING
            self._attempt += 1
            logger.warning("train worker group failed; restarting (attempt %d)", self._attempt)
        return TrainResultInternal(
            metrics=self.metrics_history[-1] if self.metrics_history else {},
            metrics_history=self.metrics_history,
            checkpoint=self.checkpoint_manager.latest_checkpoint(),
            best_checkpoint=self.checkpoint_manager.best_checkpoint(),
            error=self.error,
            state=self.state,
        )

    def _start_group(self) -> Optional[WorkerGroup]:
        self.state = RunState.SCHEDULING
        group = WorkerGroup(self.scaling, experiment_name=self.run_config.name or "train",
                            trial_id=self.trial_id)
        latest = self.checkpoint_manager.latest_checkpoint()
        try:
            # attempt-scoped subdir: a restart must never reuse checkpoint
            # directory names from the failed attempt (clobber hazard)
            group.start(
                self.train_fn, self.train_fn_config,
                storage_dir=os.path.join(self.experiment_dir, f"attempt_{self._attempt:03d}"),
                latest_checkpoint_path=latest.path if latest else None,
                shards=self._dataset_shards(self.scaling.num_workers),
            )
        except Exception as e:  # a start-up failure
            group.shutdown()
            self.error = f"failed to start worker group: {e!r}"
            self.state = RunState.ERRORED
            return None
        self.state = RunState.RUNNING
        return group

    def _dataset_shards(self, n: int) -> list[dict]:
        """Each rank's datasets (the reference's DataConfig,
        ``train/_internal/data_config.py``): ``split(n)`` where the
        dataset has one, else the iterable replicated."""
        shards: list[dict] = [{} for _ in range(n)]
        for name, ds in self.datasets.items():
            parts = ds.split(n) if hasattr(ds, "split") else [ds] * n
            for rank, part in enumerate(parts):
                shards[rank][name] = part
        return shards

    def _run_until_done(self, group: WorkerGroup, poll_interval: float) -> str:
        """Poll loop. Returns 'done' (every rank finished its loop),
        'stopped' (a ``RunConfig.stop`` criterion was met) or 'failed'."""
        stop = self.run_config.stop or {}
        done: set[int] = set()
        startup: list[float] = []
        while True:
            msgs, exited = group.poll(poll_interval)
            errors = []
            # rank 0's results first: they may carry checkpoints already
            # persisted to storage, and a failure must not lose the anchor
            for m in msgs:
                kind, rank = m["kind"], m["rank"]
                if kind == "started":
                    startup.append(m["startup_s"])
                    if len(startup) == group.num_workers:
                        self.rank_startup_s.append(max(startup))
                elif kind == "done":
                    done.add(rank)
                elif kind == "error":
                    errors.append(m)
                elif rank == 0:  # a result: rank 0's drive the run
                    metrics = m["metrics"]
                    self.metrics_history.append(metrics)
                    if m["checkpoint_dir"]:
                        self.checkpoint_manager.register(Checkpoint(m["checkpoint_dir"]), metrics)
                    for key, bound in stop.items():
                        if key in metrics and metrics[key] >= bound:
                            return "stopped"
            if errors:
                self.error = f"rank {errors[0]['rank']} failed:\n{errors[0]['error']}"
                return "failed"
            if len(done) == group.num_workers:
                return "done"
            for rank, code in sorted(exited.items()):
                if rank not in done:
                    self.error = f"rank {rank} exited with code {code} before its loop finished"
                    return "failed"


class TrainResultInternal:
    def __init__(self, metrics, metrics_history, checkpoint, best_checkpoint, error, state):
        self.metrics = metrics
        self.metrics_history = metrics_history
        self.checkpoint = checkpoint
        self.best_checkpoint = best_checkpoint
        self.error = error
        self.state = state
