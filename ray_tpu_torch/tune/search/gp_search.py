"""Native Bayesian-optimization searcher (GP-UCB).

The port's copy of ``ray_tpu/tune/search/gp_search.py``.

Reference role: the Bayesian searchers the reference integrates externally
(``python/ray/tune/search/bayesopt``, ``.../ax``, ``.../optuna``) — here a
self-contained numpy implementation over the same ``Searcher`` contract,
reusing PB2's RBF-kernel GP (``schedulers/pb2._GP``). Float/Integer domains
(log-aware) are modeled in a normalized unit cube; Categorical dimensions
fall back to random sampling (standard practice for small GP-BO).
"""

from __future__ import annotations

import math
import random
from typing import Optional

import numpy as np

from ray_tpu_torch.tune.schedulers.pb2 import suggest_ucb
from ray_tpu_torch.tune.search.sample import Categorical, Domain, Float, Integer
from ray_tpu_torch.tune.search.searcher import Searcher


class GPSearcher(Searcher):
    """Sequential model-based search: the first ``n_initial`` suggestions
    are random; afterwards each suggestion maximizes GP-UCB over random
    candidates, fit on all completed observations."""

    def __init__(
        self,
        metric: Optional[str] = None,
        mode: str = "max",
        n_initial: int = 5,
        ucb_kappa: float = 2.0,
        n_candidates: int = 512,
        seed: Optional[int] = None,
    ):
        super().__init__(metric=metric, mode=mode)
        self.n_initial = n_initial
        self.kappa = ucb_kappa
        self.n_candidates = n_candidates
        self._rng = random.Random(seed)
        self._np_rng = np.random.default_rng(seed)
        self._space: dict = {}
        self._num_samples = 1
        self._suggested = 0
        # trial_id -> unit-cube vector; completed observations (x, score)
        self._vectors: dict[str, np.ndarray] = {}
        self._X: list[np.ndarray] = []
        self._y: list[float] = []

    def set_search_properties(self, metric, mode, param_space, num_samples):
        if metric:
            self.metric = metric
        if mode:
            self.mode = mode
        self._space = param_space or {}
        self._num_samples = num_samples
        return True

    # -- domain <-> unit cube -----------------------------------------------

    def _dims(self):
        return [
            (k, d)
            for k, d in self._space.items()
            if isinstance(d, (Float, Integer))
        ]

    def _decode(self, u: np.ndarray) -> dict:
        cfg = {}
        i = 0
        for k, d in self._space.items():
            if isinstance(d, (Float, Integer)):
                t = float(u[i])
                i += 1
                if getattr(d, "log", False):
                    lo, hi = math.log(d.lower), math.log(d.upper)
                    v = math.exp(lo + t * (hi - lo))
                else:
                    v = d.lower + t * (d.upper - d.lower)
                if isinstance(d, Integer):
                    v = int(min(max(round(v), d.lower), d.upper - 1))
                elif getattr(d, "q", None):
                    v = round(v / d.q) * d.q
                cfg[k] = v
            elif isinstance(d, Domain):
                cfg[k] = d.sample(self._rng)
            else:
                cfg[k] = d
        return cfg

    def suggest(self, trial_id: str) -> Optional[dict]:
        if self._suggested >= self._num_samples:
            return None
        self._suggested += 1
        n_dims = len(self._dims())
        if n_dims == 0 or len(self._y) < max(self.n_initial, 3):
            u = self._np_rng.uniform(size=n_dims)
        else:
            X = np.stack(self._X)
            y = np.asarray(self._y)
            cand = self._np_rng.uniform(size=(self.n_candidates, n_dims))
            u = suggest_ucb(X, y, cand, kappa=self.kappa)
        self._vectors[trial_id] = u
        return self._decode(u)

    def on_trial_complete(self, trial_id: str, result=None, error: bool = False):
        u = self._vectors.pop(trial_id, None)
        if u is None or error or not result:
            return
        v = result.get(self.metric)
        if v is None:
            return
        score = float(v) if self.mode == "max" else -float(v)
        self._X.append(u)
        self._y.append(score)
