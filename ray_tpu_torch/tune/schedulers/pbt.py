"""Population Based Training.

The port's copy of ``ray_tpu/tune/schedulers/pbt.py``.

Reference: ``python/ray/tune/schedulers/pbt.py:221`` — at each
``perturbation_interval`` the bottom-quantile trials *exploit* (copy config +
checkpoint from a top-quantile trial) and *explore* (mutate hyperparameters:
resample with prob ``resample_probability``, else scale numerics by 1.2/0.8,
else step categorical neighbors).

As in the JAX package, exploitation is a restart of the trial's process
with the new hyperparameters, signalled to the controller by the RESTART
decision and ``trial.restore_checkpoint``.
"""

from __future__ import annotations

import random
from typing import Callable, Optional, Union

from ray_tpu_torch.tune.schedulers.trial_scheduler import TrialScheduler
from ray_tpu_torch.tune.search.sample import Domain


class PopulationBasedTraining(TrialScheduler):
    def __init__(
        self,
        time_attr: str = "training_iteration",
        metric: str = None,
        mode: str = "max",
        perturbation_interval: float = 10,
        hyperparam_mutations: Optional[dict[str, Union[list, Domain, Callable]]] = None,
        quantile_fraction: float = 0.25,
        resample_probability: float = 0.25,
        seed: Optional[int] = None,
    ):
        super().__init__(metric=metric, mode=mode, time_attr=time_attr)
        self.perturbation_interval = perturbation_interval
        self.hyperparam_mutations = hyperparam_mutations or {}
        self.quantile_fraction = quantile_fraction
        self.resample_probability = resample_probability
        self._rng = random.Random(seed)
        # trial_id -> (last perturbation time, latest score)
        self._last_perturb: dict[str, float] = {}
        self._scores: dict[str, float] = {}
        self._trials: dict[str, object] = {}

    def on_trial_add(self, trial):
        self._last_perturb[trial.trial_id] = 0
        self._trials[trial.trial_id] = trial

    def _quantiles(self) -> tuple[list[str], list[str]]:
        ids = [t for t in self._scores]
        if len(ids) < 2:
            return [], []
        ids.sort(key=lambda t: self._scores[t])
        n = max(1, int(len(ids) * self.quantile_fraction))
        return ids[:n], ids[-n:]  # (bottom, top)

    def _explore(self, config: dict) -> dict:
        new = dict(config)
        for key, mutation in self.hyperparam_mutations.items():
            old = new.get(key)
            if self._rng.random() < self.resample_probability or old is None:
                new[key] = self._sample(mutation)
            elif isinstance(old, (int, float)) and not isinstance(old, bool):
                factor = 1.2 if self._rng.random() > 0.5 else 0.8
                new[key] = type(old)(old * factor)
            elif isinstance(mutation, list) and old in mutation:
                i = mutation.index(old)
                shift = self._rng.choice([-1, 1])
                new[key] = mutation[max(0, min(len(mutation) - 1, i + shift))]
            else:
                new[key] = self._sample(mutation)
        return new

    def _sample(self, mutation):
        if isinstance(mutation, Domain):
            return mutation.sample(self._rng)
        if isinstance(mutation, list):
            return self._rng.choice(mutation)
        if callable(mutation):
            return mutation()
        return mutation

    def on_trial_result(self, trial, result):
        t = result.get(self.time_attr, 0)
        self._scores[trial.trial_id] = self._score(result)
        if t - self._last_perturb[trial.trial_id] < self.perturbation_interval:
            return self.CONTINUE
        self._last_perturb[trial.trial_id] = t
        bottom, top = self._quantiles()
        if trial.trial_id not in bottom or not top:
            return self.CONTINUE
        donor_id = self._rng.choice(top)
        donor = self._trials.get(donor_id)
        if donor is None or donor.checkpoint is None:
            return self.CONTINUE
        # exploit: donor's config + checkpoint; explore: mutate
        trial.config = self._explore(dict(donor.config))
        trial.restore_checkpoint = donor.checkpoint
        return self.RESTART

    def on_trial_complete(self, trial, result):
        self._scores.pop(trial.trial_id, None)
