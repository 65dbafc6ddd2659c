"""Synchronous HyperBand with real brackets and pause/resume.

The port's copy of ``ray_tpu/tune/schedulers/hyperband.py``.

Reference: ``python/ray/tune/schedulers/hyperband.py`` (HyperBandScheduler)
— Li et al.'s bracket schedule: bracket ``s`` admits
``ceil((s_max+1)/(s+1)) * eta^s`` trials at initial budget
``max_t * eta^-s``; at each rung every live trial of the bracket PAUSES
until the cohort has reported, then the top ``1/eta`` resume (from their
checkpoints) and the rest stop. Unlike ASHA (``async_hyperband.py``) the
halving decision sees the COMPLETE rung, trading stragglers' idle time for
exact cuts.
"""

from __future__ import annotations

import math

from ray_tpu_torch.tune.schedulers.trial_scheduler import TrialScheduler


class _SyncBracket:
    def __init__(self, s: int, s_max: int, eta: float, max_t: float):
        self.eta = eta
        self.capacity = int(math.ceil((s_max + 1) / (s + 1)) * eta**s)
        self.r0 = max(max_t * eta**-s, 1)
        self.max_t = max_t
        self.trial_ids: set[str] = set()
        self.live: set[str] = set()
        self.rung = 0  # completed halvings
        self.scores: dict[str, float] = {}  # this rung's reports
        self.promoted: set[str] = set()

    @property
    def milestone(self) -> float:
        return min(self.r0 * self.eta**self.rung, self.max_t)

    def full(self) -> bool:
        return len(self.trial_ids) >= self.capacity

    def add(self, trial_id: str):
        self.trial_ids.add(trial_id)
        self.live.add(trial_id)

    def cohort_complete(self) -> bool:
        # the rung must rank the FULL bracket: with lazy trial creation
        # (max_concurrent < capacity) early finishers wait paused until the
        # bracket fills; an under-filled bracket at experiment end resolves
        # through the scheduler's no-runnable-reporters guard instead
        return (
            len(self.trial_ids) >= self.capacity
            and bool(self.live)
            and self.scores.keys() >= self.live
        )

    def cut(self) -> tuple[set, set]:
        """Finish the rung: (survivors, culled). Survivors advance to the
        next milestone; the final rung (milestone == max_t) keeps only the
        best but stops everyone."""
        n_keep = max(1, int(len(self.scores) / self.eta))
        ranked = sorted(self.scores, key=self.scores.get, reverse=True)
        survivors, culled = set(ranked[:n_keep]), set(ranked[n_keep:])
        if self.milestone >= self.max_t:
            culled |= survivors
            survivors = set()
        self.live = set(survivors)
        self.promoted |= survivors
        self.scores = {}
        self.rung += 1
        return survivors, culled


class HyperBandScheduler(TrialScheduler):
    def __init__(
        self,
        time_attr: str = "training_iteration",
        metric: str = None,
        mode: str = "max",
        max_t: float = 81,
        reduction_factor: float = 3,
    ):
        super().__init__(metric=metric, mode=mode, time_attr=time_attr)
        self.eta = reduction_factor
        self.max_t = max_t
        self.s_max = int(math.floor(math.log(max_t) / math.log(reduction_factor)))
        self._brackets = [
            _SyncBracket(s, self.s_max, self.eta, max_t)
            for s in range(self.s_max, -1, -1)
        ]
        self._bracket_of: dict[str, _SyncBracket] = {}
        self._trials: dict[str, object] = {}
        self._pending_stops: list = []
        self._unbracketed: set[str] = set()

    def on_trial_add(self, trial):
        self._trials[trial.trial_id] = trial
        for b in self._brackets:  # fill brackets in order (reference policy)
            if not b.full():
                b.add(trial.trial_id)
                self._bracket_of[trial.trial_id] = b
                return
        # every bracket full: overflow trials run FIFO but still respect the
        # max_t budget cap
        self._unbracketed.add(trial.trial_id)

    def on_trial_result(self, trial, result: dict) -> str:
        t = result.get(self.time_attr, 0)
        if trial.trial_id in self._unbracketed:
            return self.STOP if t >= self.max_t else self.CONTINUE
        b = self._bracket_of.get(trial.trial_id)
        if b is None or trial.trial_id not in b.live:
            return self.CONTINUE
        if t < b.milestone:
            return self.CONTINUE
        b.scores[trial.trial_id] = self._score(result)
        if not b.cohort_complete():
            return self.PAUSE  # wait for the rung cohort
        return self._process_rung(b, reporting_id=trial.trial_id)

    def _process_rung(self, b: _SyncBracket, reporting_id: str = None) -> str:
        survivors, culled = b.cut()
        for tid in culled:
            if tid == reporting_id:
                continue
            t = self._trials.get(tid)
            if t is not None:
                self._pending_stops.append(t)
        if reporting_id is None:
            return self.CONTINUE
        return self.CONTINUE if reporting_id in survivors else self.STOP

    def on_trial_complete(self, trial, result: dict) -> None:
        self._forget(trial)

    def on_trial_error(self, trial) -> None:
        self._forget(trial)

    def _forget(self, trial):
        b = self._bracket_of.get(trial.trial_id)
        if b is None:
            return
        b.live.discard(trial.trial_id)
        b.scores.pop(trial.trial_id, None)
        b.promoted.discard(trial.trial_id)
        # its cohort may now be complete without it
        if b.cohort_complete():
            self._process_rung(b)

    def choose_trial_to_run(self, trials: list, exhausted: bool = False):
        from ray_tpu_torch.tune.tuner import TrialStatus

        by_id = {t.trial_id: t for t in trials}
        for b in self._brackets:
            for tid in list(b.promoted):
                t = by_id.get(tid)
                if t is None:
                    b.promoted.discard(tid)
                    continue
                if t.status is TrialStatus.PAUSED:
                    return t
                if t.status is TrialStatus.RUNNING:
                    b.promoted.discard(tid)  # resume took effect
        # deadlock guard: resolve a rung ONLY when its cohort can never
        # complete — the bracket must be unable to gain trials (full, or the
        # experiment is exhausted) AND no live unreported trial can still
        # report. Without the first condition this would cut early whenever
        # max_concurrent < capacity (paused early reporters look "complete").
        for b in self._brackets:
            if not b.scores or not (b.full() or exhausted):
                continue
            if not any(
                tid in b.live
                and tid not in b.scores
                and by_id.get(tid) is not None
                and by_id[tid].status
                in (TrialStatus.RUNNING, TrialStatus.PENDING, TrialStatus.PAUSED)
                for tid in set(b.live)
            ):
                self._process_rung(b)
                for tid in list(b.promoted):
                    t = by_id.get(tid)
                    if t is not None and t.status is TrialStatus.PAUSED:
                        return t
        return None

    def take_pending_stops(self) -> list:
        out, self._pending_stops = self._pending_stops, []
        return out
