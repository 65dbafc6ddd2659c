"""Tuner + trial controller, on the port's own processes.

The port's counterpart of ``ray_tpu/tune/tuner.py`` (reference call path:
``Tuner.fit`` (``tune/tuner.py:43/:312``) → ``TuneController`` event loop
(``tune/execution/tune_controller.py:68``)). ``TuneConfig``, the trial
table, the scheduler and searcher protocol, stop criteria, retries and the
experiment snapshot are the JAX package's; what differs is where a trial
runs:

- *A trial is a 1-rank process* of ``train/_internal/worker_group.py``
  (the JAX package's trial is a 1-rank ``TrainWorker`` actor), with the
  trial's context (``trial_id``, ``trial_name``) and a ``run_NNN`` storage
  directory for each start. Its reports come back over the rank's pipe; a
  trial process that dies is seen through its sentinel at once.
- *Leases.* Each trial holds a lease from the host's card ledger
  (``_private/cards.py``) for what ``with_resources`` names (default
  ``{"CPU": 1}``), taken by the controller through ``assign_cards`` and held
  by the trial process: ``{"GPU": 0.25}`` packs four trials onto one card.
  A trial whose lease cannot be granted now waits as PENDING; a request the
  host can never grant, or a GPU named on a host with no card, fails
  ``Tuner.fit`` at once, naming the counts. With no ``max_concurrent_trials``
  the cap is the ledger's capacity for every resource a trial names.
- *Nested processes.* The trial process leads a process group of its own
  and leases what it spawns (a ``TorchTrainer``'s ranks, an algorithm's
  learners) from the driver's ledger, which travels to it. Paused,
  restarted, stopped, failed or finished, the trial's whole group is ended
  (``spawn_env.end_process_group``), and its leases with it; if the driver
  dies, the trial ends its group itself.
- *Pickling.* The trainable travels by reference with the standard pickle
  (a module-level function, or a picklable object such as
  ``with_parameters``'s or ``as_trainable``'s): a closure raises
  ``TypeError`` at ``fit()``. The experiment snapshot behind
  ``Tuner.restore`` stores the trainable and the run config the same way,
  where the JAX package stores cloudpickle blobs.
"""

from __future__ import annotations

import enum
import logging
import os
import pickle
import time
import uuid
from multiprocessing.connection import wait
from typing import Callable, Optional

from ray_tpu_torch._private.cards import CardLedger, LedgerError, default_ledger
from ray_tpu_torch._private.spawn_env import assign_cards, end_process_group
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train._internal.worker_group import WorkerGroup
from ray_tpu_torch.tune.result_grid import ResultGrid, TrialResult
from ray_tpu_torch.tune.schedulers import FIFOScheduler, TrialScheduler
from ray_tpu_torch.tune.search import BasicVariantGenerator
from ray_tpu_torch.tune.search.searcher import Searcher

logger = logging.getLogger(__name__)


class TuneConfig:
    """Reference: ``tune/tune_config.py`` TuneConfig."""

    def __init__(
        self,
        metric: Optional[str] = None,
        mode: str = "max",
        num_samples: int = 1,
        max_concurrent_trials: Optional[int] = None,
        search_alg: Optional[Searcher] = None,
        scheduler: Optional[TrialScheduler] = None,
        seed: Optional[int] = None,
    ):
        if mode not in ("max", "min"):
            raise ValueError("mode must be 'max' or 'min'")
        self.metric = metric
        self.mode = mode
        self.num_samples = num_samples
        self.max_concurrent_trials = max_concurrent_trials
        self.search_alg = search_alg
        self.scheduler = scheduler
        self.seed = seed


class TrialStatus(enum.Enum):
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    PAUSED = "PAUSED"
    TERMINATED = "TERMINATED"
    ERROR = "ERROR"


class Trial:
    def __init__(self, trial_id: str, config: dict, storage_dir: str, resources: dict):
        self.trial_id = trial_id
        self.config = config
        self.storage_dir = storage_dir
        self.resources = resources
        self.status = TrialStatus.PENDING
        self.group: Optional[WorkerGroup] = None  # its process, while it runs
        self.last_result: dict = {}
        self.metrics_history: list[dict] = []
        self.iteration = 0
        self.checkpoint: Optional[Checkpoint] = None
        self.restore_checkpoint: Optional[Checkpoint] = None
        self.error: Optional[str] = None
        self.num_failures = 0
        self.num_starts = 0  # every (re)start gets a fresh storage subdir
        self.startup_s: list[float] = []  # each start: spawn to the trainable's start
        self.pids: list[int] = []  # each start's process (the leader of its group)


def trial_capacity(resources: dict, ledger: CardLedger) -> int:
    """How many trials of ``resources`` the ledger's host holds at once,
    counted for every resource they name: its CPU slots over the trial's,
    and its cards times the trials a card takes (1 / a share, or a card
    over whole cards). Raises ``ValueError`` for a request the ledger does
    not take, and ``RuntimeError`` naming the counts when a card is named
    and none is visible, or when one trial needs more than the host has:
    never a CPU fallback."""
    g, c = float(resources.get("GPU", 0)), float(resources.get("CPU", 0))
    if set(resources) - {"GPU", "CPU"} or g < 0 or c < 0 or (g > 1 and g != int(g)):
        raise ValueError(f"a trial takes {{'GPU': a share below 1 or whole cards, 'CPU': "
                         f"slots}}, got {resources}")
    caps = []
    if g:
        cards = len(ledger.card_ids())
        if cards == 0:
            raise RuntimeError(f"trials of {resources} need a CUDA device, but none is visible")
        cap = cards * int(1 / g + 1e-9) if g < 1 else cards // int(g)
        if cap == 0:
            raise RuntimeError(f"a trial of {resources} needs {g:g} cards, but {cards} are "
                               "visible")
        caps.append(cap)
    if c:
        total = ledger.cpu_total()
        if c > total + 1e-9:
            raise RuntimeError(f"a trial of {resources} needs {c:g} CPU slots, but the host "
                               f"has {total:g}")
        caps.append(int(total / c + 1e-9))
    return min(caps) if caps else max(1, int(ledger.cpu_total()))


class TuneController:
    """Event loop: launch trials up to the concurrency cap, poll, apply
    scheduler decisions, feed the searcher."""

    def __init__(
        self,
        trainable: Callable,
        param_space: dict,
        tune_config: TuneConfig,
        run_config: RunConfig,
        experiment_dir: str,
    ):
        self.trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config
        self.run_config = run_config
        self.experiment_dir = experiment_dir
        self.scheduler = tune_config.scheduler or FIFOScheduler()
        self.scheduler.set_search_properties(tune_config.metric, tune_config.mode)
        self.searcher = tune_config.search_alg or BasicVariantGenerator()
        consumed = self.searcher.set_search_properties(
            tune_config.metric, tune_config.mode, self.param_space,
            tune_config.num_samples,
        )
        if not consumed and not isinstance(self.searcher, BasicVariantGenerator):
            raise ValueError("search_alg did not accept the param_space")
        self.trials: list[Trial] = []
        self._exhausted = False
        self.resources = dict(getattr(trainable, "_tune_resources", {"CPU": 1}))
        ledger = default_ledger()
        # a request the host can never grant, or a card where none is
        # visible, raises here, before any trial starts
        self.capacity = trial_capacity(self.resources, ledger)
        # what travels to the trial processes: the cards resolved here
        self.ledger = CardLedger(ledger.root, cards=ledger.card_ids(), cpus=ledger.cpu_total())
        self._last_snapshot_t = 0.0
        # the scheduler's inputs and outputs in order: ("add", id),
        # ("result", id, result, decision), ("complete", id, result)
        self.events: list[tuple] = []

    # -- experiment-level fault tolerance ------------------------------------

    def save_state(self, throttle_s: float = 2.0):
        """Write the experiment snapshot (reference: the TuneController
        experiment checkpoints behind ``Tuner.restore``,
        ``tune/execution/tune_controller.py:68``). Trial table + enough of
        the tune spec to resume after driver death; the trainable and the
        run config pickled by reference."""
        now = time.monotonic()
        if throttle_s and now - self._last_snapshot_t < throttle_s:
            return
        self._last_snapshot_t = now
        state = {
            "version": 1,
            "trainable": pickle.dumps(self.trainable),
            "param_space": self.param_space,
            "metric": self.tune_config.metric,
            "mode": self.tune_config.mode,
            "num_samples": self.tune_config.num_samples,
            "max_concurrent_trials": self.tune_config.max_concurrent_trials,
            "run_config": pickle.dumps(self.run_config),
            "trials": [
                {
                    "trial_id": t.trial_id,
                    "config": t.config,
                    "status": t.status.value,
                    "iteration": t.iteration,
                    "last_result": t.last_result,
                    "metrics_history": t.metrics_history,
                    "checkpoint_dir": t.checkpoint.path if t.checkpoint else None,
                    "num_failures": t.num_failures,
                    "num_starts": t.num_starts,
                    "error": t.error,
                    "resources": t.resources,
                }
                for t in self.trials
            ],
        }
        path = os.path.join(self.experiment_dir, "experiment_state.pkl")
        tmp = path + f".tmp{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                pickle.dump(state, f)
            os.replace(tmp, path)
        except OSError:
            logger.warning("experiment snapshot failed", exc_info=True)

    def restore_trials(self, saved_trials: list[dict]):
        """Rebuild the trial table from a snapshot; interrupted trials
        (RUNNING/PAUSED/PENDING at crash time) restart from their last
        checkpoint. The searcher is fast-forwarded so it does not re-suggest
        restored configs."""
        for entry in saved_trials:
            t = Trial(
                entry["trial_id"],
                entry["config"],
                os.path.join(self.experiment_dir, entry["trial_id"]),
                entry.get("resources") or self.resources,
            )
            t.iteration = entry["iteration"]
            t.last_result = entry["last_result"]
            t.metrics_history = entry["metrics_history"]
            t.num_failures = entry["num_failures"]
            t.num_starts = entry["num_starts"]
            t.error = entry["error"]
            if entry["checkpoint_dir"]:
                t.checkpoint = Checkpoint(entry["checkpoint_dir"])
            status = TrialStatus(entry["status"])
            # fast-forward the searcher: consume one suggestion per restored
            # trial (discarding it — the SAVED config is authoritative)
            self.searcher.suggest(t.trial_id)
            if status in (TrialStatus.TERMINATED, TrialStatus.ERROR):
                t.status = status
                self.searcher.on_trial_complete(
                    t.trial_id, t.last_result, error=status is TrialStatus.ERROR
                )
            else:
                # interrupted mid-flight: resume from the last checkpoint
                t.status = TrialStatus.PENDING
                t.restore_checkpoint = t.checkpoint
            self.trials.append(t)
            self._add_to_scheduler(t)

    # -- trial lifecycle ----------------------------------------------------

    def _max_concurrent(self) -> int:
        return self.tune_config.max_concurrent_trials or self.capacity

    def _add_to_scheduler(self, trial: Trial):
        self.events.append(("add", trial.trial_id))
        self.scheduler.on_trial_add(trial)

    def _maybe_create_trial(self) -> Optional[Trial]:
        trial_id = f"trial_{len(self.trials):05d}_{uuid.uuid4().hex[:6]}"
        cfg = self.searcher.suggest(trial_id)
        if cfg is None:
            if not isinstance(self.searcher, BasicVariantGenerator):
                return None  # limiter backpressure or exhausted
            self._exhausted = True
            return None
        t = Trial(
            trial_id,
            cfg,
            os.path.join(self.experiment_dir, trial_id),
            self.resources,
        )
        self.trials.append(t)
        self._add_to_scheduler(t)
        return t

    def _start_trial(self, trial: Trial):
        """Lease what the trial names and spawn its process; ``LedgerError``
        (nothing started) when the lease cannot be granted now."""
        g = float(trial.resources.get("GPU", 0))
        lease, = assign_cards(1, g, "tune trial", cpu=float(trial.resources.get("CPU", 0)),
                              ledger=self.ledger)
        chk = trial.restore_checkpoint or trial.checkpoint
        group = WorkerGroup(ScalingConfig(num_workers=1, use_gpu=g > 0),
                            experiment_name=self.run_config.name or "tune",
                            trial_id=trial.trial_id)
        try:
            group.start(self.trainable, trial.config,
                        os.path.join(trial.storage_dir, f"run_{trial.num_starts:03d}"),
                        chk.path if chk else None, [{}], leases=[lease],
                        trial_name=trial.trial_id, ledger=self.ledger)
        except BaseException:
            group.shutdown()
            raise
        trial.group = group
        trial.pids.append(group.procs[0].pid)
        trial.num_starts += 1
        trial.restore_checkpoint = None
        trial.status = TrialStatus.RUNNING

    def _restart_or_wait(self, trial: Trial):
        """Start ``trial`` again now, or leave it PENDING (started when its
        lease can be granted) while the ledger is full."""
        try:
            self._start_trial(trial)
        except LedgerError:
            trial.status = TrialStatus.PENDING
            if trial.restore_checkpoint is None:
                trial.restore_checkpoint = trial.checkpoint

    def _end_process(self, trial: Trial, finished: bool = False):
        """End the trial's process and everything it spawned; its lease and
        theirs end with them. ``finished``: its trainable returned, so it is
        given time to exit on its own first."""
        group, trial.group = trial.group, None
        if group is None:
            return
        pid = group.procs[0].pid if group.procs else None
        if not finished and pid is not None:
            end_process_group(pid)
        group.shutdown(wait_s=30.0 if finished else 0.0)
        if pid is not None:
            left = end_process_group(pid)
            if left:
                logger.warning("trial %s: processes %s outlived its group's SIGKILL",
                               trial.trial_id, left)

    def _stop_trial(self, trial: Trial, status: TrialStatus, error: Optional[str] = None,
                    finished: bool = False):
        self._end_process(trial, finished)
        trial.status = status
        trial.error = error
        self.searcher.on_trial_complete(
            trial.trial_id, trial.last_result, error=status is TrialStatus.ERROR
        )
        self.events.append(("complete", trial.trial_id, trial.last_result))
        self.scheduler.on_trial_complete(trial, trial.last_result)

    # -- event loop ---------------------------------------------------------

    def run(self, poll_interval: float = 0.05) -> list[Trial]:
        while True:
            running = [t for t in self.trials if t.status is TrialStatus.RUNNING]
            # top up to the concurrency cap: scheduler-promoted paused
            # trials (HyperBand rung winners) resume before new trials start
            while len(running) < self._max_concurrent():
                # restored (interrupted) trials resume before anything new
                t = next(
                    (x for x in self.trials if x.status is TrialStatus.PENDING),
                    None,
                )
                if t is None:
                    t = self.scheduler.choose_trial_to_run(self.trials, exhausted=self._exhausted)
                if t is None:
                    if self._exhausted:
                        break
                    t = self._maybe_create_trial()
                    if t is None:
                        break
                try:
                    self._start_trial(t)
                    running.append(t)
                except LedgerError:
                    break  # t waits (PENDING, or PAUSED) until a lease frees
                except Exception as e:
                    # _stop_trial notifies searcher/scheduler so e.g. a
                    # ConcurrencyLimiter slot is released
                    self._stop_trial(
                        t, TrialStatus.ERROR, f"failed to start: {e!r}"
                    )
            self._drain_scheduler_stops()
            if not running:
                paused = [
                    t for t in self.trials if t.status is TrialStatus.PAUSED
                ]
                no_new = self._exhausted or all(
                    t.status is not TrialStatus.PENDING for t in self.trials
                )
                if no_new and not paused:
                    break
                if no_new and paused:
                    # nothing can start and the scheduler promoted nothing:
                    # a sync scheduler must resolve its cohort (it sees all
                    # statuses in choose_trial_to_run); if it still declines,
                    # finish the paused trials rather than spin forever
                    if self.scheduler.choose_trial_to_run(self.trials, exhausted=True) is None:
                        for t in paused:
                            self._stop_trial(t, TrialStatus.TERMINATED)
                        continue
                time.sleep(poll_interval)
                continue
            self._poll_running(running, poll_interval)
            self._drain_scheduler_stops()
            self.save_state()
        self.save_state(throttle_s=0)
        return self.trials

    def stop_all(self):
        """End every trial process (the driver's own error or interrupt)."""
        for t in self.trials:
            self._end_process(t)

    def _drain_scheduler_stops(self):
        """Stop trials the scheduler culled while they were PAUSED (a paused
        trial has no process to poll, so decisions arrive out of band)."""
        for t in self.scheduler.take_pending_stops():
            if t.status in (TrialStatus.PAUSED, TrialStatus.RUNNING):
                self._stop_trial(t, TrialStatus.TERMINATED)

    def _pause_trial(self, trial: Trial):
        self._end_process(trial)
        trial.status = TrialStatus.PAUSED

    def _read(self, trial: Trial) -> dict:
        """The trial's messages since the last poll: its results, whether
        its trainable returned, and its error (a trial process that exited
        without returning is one)."""
        msgs, exited = trial.group.poll(0)
        out = {"results": [], "done": False, "error": None}
        for m in msgs:
            if m["kind"] == "started":
                trial.startup_s.append(m["startup_s"])
            elif m["kind"] == "result":
                out["results"].append(m)
            elif m["kind"] == "done":
                out["done"] = True
            elif m["kind"] == "error":
                out["error"] = m["error"]
        if exited and not out["done"] and out["error"] is None:
            out["error"] = (f"trial process exited with code {exited[0]} before its "
                            "trainable returned")
        return out

    def _poll_running(self, running: list[Trial], timeout: float):
        wait([w for t in running for w in t.group.waitables()], timeout)
        for trial in running:
            poll = self._read(trial)
            decision = TrialScheduler.CONTINUE
            for entry in poll["results"]:
                self.iteration_result(trial, entry)
                if trial.status is not TrialStatus.RUNNING:
                    break  # stop-criteria hit inside iteration_result
                d = self.scheduler.on_trial_result(trial, trial.last_result)
                self.events.append(("result", trial.trial_id, trial.last_result, d))
                if d != TrialScheduler.CONTINUE:
                    # remaining queued entries are from after the cut point —
                    # a slow (real) trial would never have produced them
                    decision = d
                    break
            if trial.status is not TrialStatus.RUNNING:
                continue  # already terminated by stop criteria
            if poll["error"]:
                self._handle_failure(trial, poll["error"])
            elif decision == TrialScheduler.STOP:
                self._stop_trial(trial, TrialStatus.TERMINATED)
            elif decision == TrialScheduler.PAUSE:
                # sync schedulers (HyperBand) park a trial at a rung until
                # its cohort completes; resumed via choose_trial_to_run
                self._pause_trial(trial)
            elif decision == TrialScheduler.RESTART:
                # PBT exploit: restart with mutated config + donor checkpoint
                self._end_process(trial)
                try:
                    self._restart_or_wait(trial)
                except Exception as e:
                    self._handle_failure(trial, f"restart failed: {e!r}")
            elif poll["done"]:
                self._stop_trial(trial, TrialStatus.TERMINATED, finished=True)

    def iteration_result(self, trial: Trial, entry: dict):
        trial.iteration += 1
        metrics = dict(entry["metrics"])
        metrics.setdefault("training_iteration", trial.iteration)
        metrics.setdefault("trial_id", trial.trial_id)
        trial.last_result = metrics
        trial.metrics_history.append(metrics)
        if entry.get("checkpoint_dir"):
            trial.checkpoint = Checkpoint(entry["checkpoint_dir"])
        self.searcher.on_trial_result(trial.trial_id, metrics)
        stop = self.run_config.stop or {}
        for key, bound in stop.items():
            if key in metrics and metrics[key] >= bound:
                self._stop_trial(trial, TrialStatus.TERMINATED)

    def _handle_failure(self, trial: Trial, error: str):
        trial.num_failures += 1
        max_f = self.run_config.failure_config.max_failures
        self._end_process(trial)
        if max_f < 0 or trial.num_failures <= max_f:
            logger.warning("trial %s failed; restarting from last checkpoint", trial.trial_id)
            try:
                self._restart_or_wait(trial)
                return
            except Exception as e:
                error = f"{error}; restart failed: {e!r}"
        self._stop_trial(trial, TrialStatus.ERROR, error)


def _check_picklable(trainable) -> None:
    try:
        pickle.dumps(trainable)
    except (pickle.PicklingError, AttributeError, TypeError) as e:
        raise TypeError(
            f"the trainable {trainable!r} must be picklable by reference with the standard "
            "pickle (a module-level function, or an object such as with_parameters' or "
            f"as_trainable's, not a closure or lambda): trial processes import it by name ({e})"
        ) from e


class Tuner:
    """Public entry point (reference: ``tune/tuner.py:43``)."""

    def __init__(
        self,
        trainable: Callable,
        *,
        param_space: Optional[dict] = None,
        tune_config: Optional[TuneConfig] = None,
        run_config: Optional[RunConfig] = None,
    ):
        # trainers adapt through as_trainable() (reference BaseTrainer path)
        if hasattr(trainable, "as_trainable"):
            trainable = trainable.as_trainable()
        self.trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or RunConfig()

    @classmethod
    def restore(
        cls,
        path: str,
        trainable: Optional[Callable] = None,
        *,
        tune_config: Optional[TuneConfig] = None,
        run_config: Optional[RunConfig] = None,
    ) -> "Tuner":
        """Resume an experiment after driver death (reference:
        ``Tuner.restore`` over TuneController experiment snapshots,
        ``tune/execution/tune_controller.py:68``). ``path`` is the
        experiment directory. Finished trials keep their results;
        interrupted trials restart from their last checkpoint; the searcher
        continues from where the sweep stopped. Pass ``trainable`` when the
        saved one isn't importable in this process; pass ``tune_config`` to
        reattach a custom scheduler/searcher (their internal state restarts
        fresh — trial fast-forwarding keeps suggestions consistent)."""
        state_path = os.path.join(os.path.expanduser(path), "experiment_state.pkl")
        with open(state_path, "rb") as f:
            state = pickle.load(f)
        if trainable is None:
            trainable = pickle.loads(state["trainable"])
        if run_config is None:
            run_config = pickle.loads(state["run_config"])
        if tune_config is None:
            tune_config = TuneConfig(
                metric=state["metric"],
                mode=state["mode"],
                num_samples=state["num_samples"],
                max_concurrent_trials=state["max_concurrent_trials"],
            )
        tuner = cls(
            trainable,
            param_space=state["param_space"],
            tune_config=tune_config,
            run_config=run_config,
        )
        tuner._restore_dir = os.path.expanduser(path)
        tuner._restore_trials = state["trials"]
        return tuner

    def fit(self) -> ResultGrid:
        _check_picklable(self.trainable)
        restore_dir = getattr(self, "_restore_dir", None)
        if restore_dir is not None:
            exp_dir = restore_dir
            self.run_config.name = self.run_config.name or os.path.basename(exp_dir)
        else:
            name = self.run_config.name or f"tune_{uuid.uuid4().hex[:8]}"
            self.run_config.name = name
            exp_dir = os.path.join(
                os.path.expanduser(self.run_config.storage_path), name
            )
        controller = TuneController(
            self.trainable,
            self.param_space,
            self.tune_config,
            self.run_config,
            exp_dir,
        )
        os.makedirs(exp_dir, exist_ok=True)
        self._controller = controller  # introspection (events, trial start-up)
        if restore_dir is not None:
            controller.restore_trials(getattr(self, "_restore_trials", []))
        try:
            trials = controller.run()
        finally:
            controller.stop_all()
        results = [
            TrialResult(
                metrics=t.last_result,
                checkpoint=t.checkpoint,
                error=t.error,
                path=t.storage_dir,
                metrics_history=t.metrics_history,
                config=t.config,
                trial_id=t.trial_id,
            )
            for t in trials
        ]
        return ResultGrid(
            results, metric=self.tune_config.metric, mode=self.tune_config.mode
        )


class _WithParameters:
    """``fn(config, **kwargs)``: a picklable stand-in for the JAX package's
    closure (``ray_tpu/tune/tuner.py:522-532``); it travels by reference
    with its arguments."""

    def __init__(self, fn: Callable, kwargs: dict):
        self.fn = fn
        self.kwargs = kwargs
        self.__name__ = getattr(fn, "__name__", "trainable")
        if hasattr(fn, "_tune_resources"):
            self._tune_resources = fn._tune_resources

    def __call__(self, config):
        return self.fn(config, **self.kwargs)


def with_parameters(fn: Callable, **kwargs) -> Callable:
    """Bind large objects to a trainable (reference: ``tune/trainable/util.py``)."""
    return _WithParameters(fn, kwargs)


def with_resources(fn: Callable, resources: dict) -> Callable:
    """Attach per-trial resources (reference: ``tune/tune.py`` with_resources):
    what each trial's process leases from the host's card ledger."""
    fn._tune_resources = dict(resources)
    return fn
