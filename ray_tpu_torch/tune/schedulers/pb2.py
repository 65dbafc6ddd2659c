"""PB2 — Population Based Bandits.

The port's copy of ``ray_tpu/tune/schedulers/pb2.py``.

Reference: ``python/ray/tune/schedulers/pb2.py`` (Parker-Holder et al.,
"Provably Efficient Online Hyperparameter Optimization with Population-Based
Bandits"): PBT's exploit step, but EXPLORE selects the next hyperparameters
by maximizing a GP-UCB acquisition fit on (time, hyperparams) → reward-change
observations, instead of random multiplicative perturbation. The reference
delegates the GP to GPy; here it is a self-contained numpy GP (RBF kernel,
jittered Cholesky) — ~40 lines is all a D<=4 population-bandit needs.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ray_tpu_torch.tune.schedulers.pbt import PopulationBasedTraining


class _GP:
    """Minimal RBF-kernel Gaussian process regressor."""

    def __init__(self, lengthscale: float = 0.3, noise: float = 1e-2):
        self.ls = lengthscale
        self.noise = noise
        self._X: Optional[np.ndarray] = None
        self._alpha: Optional[np.ndarray] = None
        self._L: Optional[np.ndarray] = None

    def _k(self, A: np.ndarray, B: np.ndarray) -> np.ndarray:
        d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d2 / (self.ls**2))

    def fit(self, X: np.ndarray, y: np.ndarray):
        self._X = X
        K = self._k(X, X) + (self.noise + 1e-8) * np.eye(len(X))
        self._L = np.linalg.cholesky(K)
        self._alpha = np.linalg.solve(
            self._L.T, np.linalg.solve(self._L, y)
        )

    def predict(self, Xs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        Ks = self._k(Xs, self._X)
        mu = Ks @ self._alpha
        v = np.linalg.solve(self._L, Ks.T)
        var = np.maximum(1.0 - (v**2).sum(0), 1e-12)
        return mu, np.sqrt(var)


def suggest_ucb(X, y, cand, kappa: float = 2.0):
    """argmax of the GP-UCB acquisition over ``cand`` rows, fit on (X, y);
    falls back to ``cand[0]`` if the kernel matrix is singular. Shared by
    PB2's explore step and the standalone GPSearcher."""
    y_n = (y - y.mean()) / (y.std() + 1e-8)
    try:
        gp = _GP()
        gp.fit(X, y_n)
        mu, sd = gp.predict(cand)
        return cand[int(np.argmax(mu + kappa * sd))]
    except np.linalg.LinAlgError:
        return cand[0]


class PB2(PopulationBasedTraining):
    def __init__(
        self,
        time_attr: str = "training_iteration",
        metric: str = None,
        mode: str = "max",
        perturbation_interval: float = 10,
        hyperparam_bounds: Optional[dict[str, list]] = None,
        quantile_fraction: float = 0.25,
        ucb_kappa: float = 2.0,
        n_candidates: int = 256,
        seed: Optional[int] = None,
    ):
        if not hyperparam_bounds:
            raise ValueError(
                "PB2 requires hyperparam_bounds={name: [low, high], ...} "
                "(continuous hyperparameters only, per the reference)"
            )
        super().__init__(
            time_attr=time_attr,
            metric=metric,
            mode=mode,
            perturbation_interval=perturbation_interval,
            hyperparam_mutations={},  # explore is GP-driven, not mutation
            quantile_fraction=quantile_fraction,
            seed=seed,
        )
        self.bounds = {k: (float(v[0]), float(v[1])) for k, v in hyperparam_bounds.items()}
        self.kappa = ucb_kappa
        self.n_candidates = n_candidates
        self._np_rng = np.random.default_rng(seed)
        # observations: (t, config_vector, score) per trial report; reward
        # CHANGES between consecutive reports are the GP targets
        self._history: list[tuple[float, np.ndarray, float]] = []
        self._prev_score: dict[str, tuple[float, float]] = {}  # id -> (t, score)

    # -- data collection -----------------------------------------------------

    def _vec(self, config: dict) -> np.ndarray:
        out = []
        for k, (lo, hi) in self.bounds.items():
            v = float(config.get(k, lo))
            out.append((v - lo) / max(hi - lo, 1e-12))
        return np.asarray(out)

    def on_trial_result(self, trial, result):
        t = float(result.get(self.time_attr, 0))
        score = self._score(result)
        prev = self._prev_score.get(trial.trial_id)
        if prev is not None and t > prev[0]:
            # normalized reward change per unit time — PB2's GP target
            dy = (score - prev[1]) / (t - prev[0])
            self._history.append((t, self._vec(trial.config), dy))
        self._prev_score[trial.trial_id] = (t, score)
        return super().on_trial_result(trial, result)

    # -- GP-driven explore ---------------------------------------------------

    def _explore(self, config: dict) -> dict:
        new = dict(config)
        names = list(self.bounds)
        cand = self._np_rng.uniform(size=(self.n_candidates, len(names)))
        if len(self._history) >= 4:
            recent = self._history[-200:]
            t_now = max(h[0] for h in recent)
            t_scale = max(t_now, 1.0)
            X = np.stack(
                [np.concatenate([[h[0] / t_scale], h[1]]) for h in recent]
            )
            y = np.asarray([h[2] for h in recent])
            Xs = np.concatenate(
                [np.full((len(cand), 1), t_now / t_scale), cand], axis=1
            )
            picked = suggest_ucb(X, y, Xs, kappa=self.kappa)
            pick = picked[1:]  # drop the time feature column
        else:
            pick = cand[0]  # cold start: uniform in bounds
        for i, k in enumerate(names):
            lo, hi = self.bounds[k]
            v = lo + float(pick[i]) * (hi - lo)
            if isinstance(config.get(k), int):
                v = int(round(v))
            new[k] = v
        return new
