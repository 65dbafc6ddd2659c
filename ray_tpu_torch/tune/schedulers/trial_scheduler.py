"""Trial scheduler interface (reference: ``tune/schedulers/trial_scheduler.py``).

The port's copy of ``ray_tpu/tune/schedulers/trial_scheduler.py``.

Decisions returned from ``on_trial_result``:
- CONTINUE: keep training
- STOP: early-stop the trial (counts as completed, not failed)
- PAUSE: suspend; controller may resume later
- RESTART: end the trial's process and start it again with the trial's
  (possibly mutated) ``config`` + ``restore_checkpoint`` — the primitive PBT
  exploitation uses (the JAX package's choice too; the reference pauses and
  restores).
"""

from __future__ import annotations


class TrialScheduler:
    CONTINUE = "CONTINUE"
    STOP = "STOP"
    PAUSE = "PAUSE"
    RESTART = "RESTART"

    def __init__(self, metric: str = None, mode: str = "max", time_attr: str = "training_iteration"):
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr

    def set_search_properties(self, metric, mode):
        if metric:
            self.metric = metric
        if mode:
            self.mode = mode

    def _score(self, result: dict) -> float:
        v = result.get(self.metric)
        if v is None:
            return float("-inf")
        return float(v) if self.mode == "max" else -float(v)

    def on_trial_add(self, trial) -> None:
        pass

    def on_trial_result(self, trial, result: dict) -> str:
        return self.CONTINUE

    def on_trial_complete(self, trial, result: dict) -> None:
        pass

    def on_trial_error(self, trial) -> None:
        pass

    def choose_trial_to_run(self, trials: list, exhausted: bool = False):
        """A PAUSED trial this scheduler wants resumed next (sync schedulers
        promote rung winners here). Must be idempotent: the controller may
        call it multiple times before starting the returned trial.
        ``exhausted``: no further trials will ever be created — sync
        schedulers may resolve under-filled cohorts."""
        return None

    def take_pending_stops(self) -> list:
        """Trials culled while PAUSED (they have no process to poll, so the
        decision is delivered out of band); drained by the controller."""
        return []


class FIFOScheduler(TrialScheduler):
    """No early stopping (reference default)."""
