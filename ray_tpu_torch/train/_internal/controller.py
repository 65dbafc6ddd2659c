"""Train controller: the state machine that drives a worker group.

The port's copy of ``ray_tpu/train/_internal/controller.py`` (reference:
``train/v2/_internal/execution/controller/controller.py:94``):
INITIALIZING -> SCHEDULING -> RUNNING -> (RESTARTING) -> FINISHED / ERRORED.
The restart granularity is the whole group: any rank's failure (an error in
its loop, a non-zero exit, a death) tears down every rank, and the group
restarts from the latest checkpoint while ``FailureConfig.max_failures``
allows.

Elastic groups (``ScalingConfig(min_workers=...)``) follow the reference's
``ElasticScalingPolicy`` line for line: each attempt halves the size per
attempt before it (never below ``min_workers``) and starts with what can
be scheduled now, when that is at least ``min_workers``; while it runs,
the group grows back toward ``num_workers`` once the larger size has held
for 3 checks, 0.5 s apart, and only once a checkpoint exists. A resize
tears the group down and restarts it at the new size from the latest
checkpoint, uncharged to the failure budget. What "can be scheduled" is
read from the host's card ledger (``_private/cards.py``): free whole cards
for GPU ranks, free CPU slots for CPU ranks, where the reference reads
``ray_tpu.available_resources()``.
"""

from __future__ import annotations

import enum
import logging
import os
import time
from typing import Any, Callable, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train._internal.checkpoint_manager import CheckpointManager
from ray_tpu_torch._private.cards import default_ledger
from ray_tpu_torch.train._internal.worker_group import WorkerGroup, rank_request

logger = logging.getLogger(__name__)


class RunState(enum.Enum):
    INITIALIZING = "INITIALIZING"
    SCHEDULING = "SCHEDULING"
    RUNNING = "RUNNING"
    RESTARTING = "RESTARTING"
    FINISHED = "FINISHED"
    ERRORED = "ERRORED"


class ScalingPolicy:
    """Decides the group's size for each (re)start: ``num_workers``, or an
    elastic policy's (reference: ``train/v2/_internal/execution/
    scaling_policy/``)."""

    def __init__(self, scaling: ScalingConfig):
        self.scaling = scaling

    def group_size(self, attempt: int) -> int:
        return self.scaling.num_workers


class ElasticScalingPolicy(ScalingPolicy):
    def __init__(self, scaling: ScalingConfig):
        super().__init__(scaling)
        self._last_target: Optional[int] = None
        self._stable_polls = 0

    def group_size(self, attempt: int) -> int:
        n = self.scaling.num_workers
        lo = self.scaling.min_workers or n
        # back off by powers of two per failed attempt, never below min
        for _ in range(attempt):
            if n // 2 >= lo:
                n //= 2
        # start with what the host can schedule now, when that is at least
        # min_workers, rather than wait for the full size
        cap = self._capacity()
        if cap is not None and lo <= cap < n:
            n = cap
        return max(n, lo)

    def _per(self) -> dict:
        """One rank's demand (the reference's ``resources_per_worker or
        {"CPU": 1}``): what a rank leases."""
        return rank_request(self.scaling) or {"CPU": 1}

    def _available(self) -> Optional[dict]:
        """Free whole cards and CPU slots in the ledger, or None when it
        cannot be read."""
        try:
            free = default_ledger().free()
        except (OSError, ValueError):
            return None
        return {"GPU": free.cards, "CPU": free.cpus}

    def _capacity(self) -> Optional[int]:
        avail = self._available()
        if avail is None:
            return None
        cap = None
        for k, v in self._per().items():
            if v:
                fit = int(avail.get(k, 0) // v)
                cap = fit if cap is None else min(cap, fit)
        return cap

    def resize_decision(self, current_size: int) -> Optional[int]:
        """Mid-run growth: when the host has room again (another group or
        holder ended), grow back toward ``num_workers``. The target must
        hold for 3 consecutive checks, so a slot free for a moment does not
        restart the group. Shrinking goes through the failure path."""
        want = self.scaling.num_workers
        if current_size >= want:
            return None
        avail = self._available()
        if avail is None:
            return None
        headroom = want - current_size
        for k, v in self._per().items():
            if v:
                headroom = min(headroom, int(avail.get(k, 0) // v))
        target = min(want, current_size + max(headroom, 0))
        if target <= current_size:
            self._last_target = None
            self._stable_polls = 0
            return None
        if target == self._last_target:
            self._stable_polls += 1
        else:
            self._last_target = target
            self._stable_polls = 1
        if self._stable_polls >= 3:
            self._last_target = None
            self._stable_polls = 0
            return target
        return None


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
        self.scaling_policy = (
            ElasticScalingPolicy(scaling) if scaling.elastic else ScalingPolicy(scaling)
        )
        self.failure_policy = FailurePolicy(run_config.failure_config.max_failures)
        self.metrics_history: list[dict] = []
        self.error: Optional[str] = None
        self._attempt = 0
        self._resize_to: Optional[int] = None
        self.num_resizes = 0
        self.resize_checks = 0  # resize_decision calls
        # each attempt's size, how it ended, and the seconds its teardown took
        self.attempts: list[dict] = []
        # per attempt, the slowest rank's seconds from its spawn to its
        # train loop's start (imports, rendezvous, session)
        self.rank_startup_s: list[float] = []

    # -- lifecycle ----------------------------------------------------------

    def run(self, poll_interval: float = 0.05) -> "TrainResultInternal":
        os.makedirs(self.experiment_dir, exist_ok=True)
        while True:
            group = self._start_group()
            if group is None:
                self.attempts[-1]["outcome"] = "not started"
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
                t0 = time.monotonic()
                group.shutdown(wait_s=30.0 if outcome == "done" else 0.0)
                self.attempts[-1].update(outcome=outcome, teardown_s=time.monotonic() - t0)
            if outcome in ("done", "stopped"):
                self.state = RunState.FINISHED
                break
            if outcome == "resize":
                # restart at the new size from the latest checkpoint, not
                # charged to the failure budget, in a fresh attempt
                # directory (the torn-down group may have left a checkpoint
                # half written)
                self.state = RunState.RESTARTING
                self.num_resizes += 1
                self._attempt += 1
                logger.info("elastic resize: restarting the worker group at %d ranks",
                            self._resize_to)
                continue
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
        if self._resize_to is not None:
            n, self._resize_to = self._resize_to, None
        else:
            n = self.scaling_policy.group_size(self._attempt)
        self.attempts.append({"size": n})
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
                shards=self._dataset_shards(n),
                num_workers=n,
            )
        except Exception as e:  # a start-up failure (too few free cards among them)
            group.shutdown()
            self.error = f"failed to start worker group: {e!r}"
            self.state = RunState.ERRORED
            return None
        self.state = RunState.RUNNING
        return group

    def _dataset_shards(self, n: int) -> list[dict]:
        """Each rank's datasets (the reference's DataConfig,
        ``train/_internal/data_config.py``; ``_attach_datasets`` in the JAX
        package's controller): ``streaming_split(n, equal=True)`` where the
        dataset has one (a port ``Dataset``: iterators over disjoint
        materialized shards, which pickle into the ranks), else
        ``split(n)``, else the iterable replicated."""
        shards: list[dict] = [{} for _ in range(n)]
        for name, ds in self.datasets.items():
            if hasattr(ds, "streaming_split"):
                parts = ds.streaming_split(n, equal=True)
            elif hasattr(ds, "split"):
                parts = ds.split(n)
            else:
                parts = [ds] * n
            for rank, part in enumerate(parts):
                shards[rank][name] = part
        return shards

    def _run_until_done(self, group: WorkerGroup, poll_interval: float) -> str:
        """Poll loop. Returns 'done' (every rank finished its loop),
        'stopped' (a ``RunConfig.stop`` criterion was met), 'failed', or
        'resize' (an elastic group has room to grow)."""
        stop = self.run_config.stop or {}
        done: set[int] = set()
        startup: list[float] = []
        can_resize = isinstance(self.scaling_policy, ElasticScalingPolicy)
        last_resize_check = time.monotonic()
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
            if can_resize and time.monotonic() - last_resize_check >= 0.5:
                last_resize_check = time.monotonic()
                # only once a checkpoint exists: a restart without one
                # would replay the run from its start
                if self.checkpoint_manager.latest_checkpoint() is not None:
                    self.resize_checks += 1
                    target = self.scaling_policy.resize_decision(group.num_workers)
                    if target is not None:
                        self._resize_to = target
                        return "resize"


class TrainResultInternal:
    def __init__(self, metrics, metrics_history, checkpoint, best_checkpoint, error, state):
        self.metrics = metrics
        self.metrics_history = metrics_history
        self.checkpoint = checkpoint
        self.best_checkpoint = best_checkpoint
        self.error = error
        self.state = state
