"""Median stopping rule (reference: ``tune/schedulers/median_stopping_rule.py``).

The port's copy of ``ray_tpu/tune/schedulers/median_stopping.py``.
"""

from __future__ import annotations

from collections import defaultdict

from ray_tpu_torch.tune.schedulers.trial_scheduler import TrialScheduler


class MedianStoppingRule(TrialScheduler):
    """Stop a trial if its running-average score falls below the median of
    the running averages of all other trials at the same time step."""

    def __init__(
        self,
        time_attr: str = "training_iteration",
        metric: str = None,
        mode: str = "max",
        grace_period: float = 4,
        min_samples_required: int = 3,
    ):
        super().__init__(metric=metric, mode=mode, time_attr=time_attr)
        self.grace_period = grace_period
        self.min_samples_required = min_samples_required
        self._scores: dict[str, list[float]] = defaultdict(list)

    def _running_avg(self, trial_id: str) -> float:
        s = self._scores[trial_id]
        return sum(s) / len(s) if s else float("-inf")

    def on_trial_result(self, trial, result):
        t = result.get(self.time_attr, 0)
        self._scores[trial.trial_id].append(self._score(result))
        if t < self.grace_period:
            return self.CONTINUE
        others = [
            self._running_avg(tid)
            for tid in self._scores
            if tid != trial.trial_id and self._scores[tid]
        ]
        if len(others) < self.min_samples_required:
            return self.CONTINUE
        others.sort()
        median = others[len(others) // 2]
        if self._running_avg(trial.trial_id) < median:
            return self.STOP
        return self.CONTINUE
