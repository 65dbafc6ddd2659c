"""ASHA — asynchronous successive halving.

The port's copy of ``ray_tpu/tune/schedulers/async_hyperband.py``.

Reference: ``python/ray/tune/schedulers/async_hyperband.py:19``
(AsyncHyperBandScheduler). Rungs at ``grace_period * reduction_factor^k``;
when a trial reaches a rung its metric joins the rung's record, and the trial
stops unless it is in the top ``1/reduction_factor`` of that rung so far.
"""

from __future__ import annotations

import math

from ray_tpu_torch.tune.schedulers.trial_scheduler import TrialScheduler


class _Bracket:
    def __init__(self, min_t: float, max_t: float, reduction_factor: float, stop_last: bool):
        self.rf = reduction_factor
        self.rungs: list[tuple[float, dict]] = []  # (milestone, {trial_id: score}) high→low
        k = 0
        milestones = []
        while min_t * reduction_factor**k < max_t:
            milestones.append(min_t * reduction_factor**k)
            k += 1
        for m in reversed(milestones):
            self.rungs.append((m, {}))
        self.stop_last = stop_last

    def on_result(self, trial_id: str, t: float, score: float) -> bool:
        """Returns True to continue, False to stop."""
        keep = True
        for milestone, recorded in self.rungs:
            if t < milestone or trial_id in recorded:
                continue
            recorded[trial_id] = score
            scores = sorted(recorded.values(), reverse=True)
            cutoff_idx = max(0, int(math.ceil(len(scores) / self.rf)) - 1)
            cutoff = scores[cutoff_idx]
            if score < cutoff:
                keep = False
            break  # highest applicable rung only (async SHA)
        return keep


class AsyncHyperBandScheduler(TrialScheduler):
    def __init__(
        self,
        time_attr: str = "training_iteration",
        metric: str = None,
        mode: str = "max",
        max_t: float = 100,
        grace_period: float = 1,
        reduction_factor: float = 4,
        brackets: int = 1,
    ):
        super().__init__(metric=metric, mode=mode, time_attr=time_attr)
        self.max_t = max_t
        self.grace_period = grace_period
        self.rf = reduction_factor
        self._brackets = [
            _Bracket(
                grace_period * reduction_factor**i, max_t, reduction_factor, False
            )
            for i in range(brackets)
        ]
        self._trial_bracket: dict[str, _Bracket] = {}
        self._counter = 0

    def on_trial_add(self, trial):
        b = self._brackets[self._counter % len(self._brackets)]
        self._counter += 1
        self._trial_bracket[trial.trial_id] = b

    def on_trial_result(self, trial, result):
        t = result.get(self.time_attr, 0)
        if t >= self.max_t:
            return self.STOP
        bracket = self._trial_bracket.get(trial.trial_id)
        if bracket is None:
            return self.CONTINUE
        keep = bracket.on_result(trial.trial_id, t, self._score(result))
        return self.CONTINUE if keep else self.STOP


ASHAScheduler = AsyncHyperBandScheduler
