"""Continuous-control environments (gymnasium-API-compatible, numpy-only).

A copy of ``ray_tpu/rllib/env/continuous.py``, kept so the port imports
nothing of ray_tpu. ``make_continuous_env("Pendulum-v1")`` builds
gymnasium's env where gymnasium imports and this module's ``Pendulum``
where it does not, as the JAX package chooses.

``Pendulum`` matches gymnasium's Pendulum-v1 dynamics (used when gymnasium
is unavailable); ``Reach`` is a deliberately easy 1-D target-reaching task
for fast algorithm smoke tests (converges in a few thousand steps — the
role CartPole plays for the discrete algorithms).
"""

from __future__ import annotations

import numpy as np


class _Box:
    def __init__(self, low, high, shape):
        self.low = np.asarray(low, np.float32)
        self.high = np.asarray(high, np.float32)
        self.shape = shape
        self.n = None


class Reach:
    """Drive a 1-D point to the origin. obs = [x], action in [-1, 1],
    x' = x + 0.2a, reward = -x^2 - 0.01 a^2, horizon 40."""

    max_steps = 40

    def __init__(self):
        self.observation_space = _Box(-2.0, 2.0, (1,))
        self.action_space = _Box(-1.0, 1.0, (1,))
        self._rng = np.random.default_rng(0)
        self._x = 0.0
        self._steps = 0

    def reset(self, seed=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._x = float(self._rng.uniform(-1.5, 1.5))
        self._steps = 0
        return np.array([self._x], np.float32), {}

    def step(self, action):
        a = float(np.clip(np.asarray(action).reshape(-1)[0], -1.0, 1.0))
        self._x = float(np.clip(self._x + 0.2 * a, -2.0, 2.0))
        self._steps += 1
        reward = -(self._x**2) - 0.01 * a * a
        truncated = self._steps >= self.max_steps
        return np.array([self._x], np.float32), reward, False, truncated, {}


class Pendulum:
    """Classic torque-limited pendulum swing-up (gymnasium Pendulum-v1
    physics: g=10, m=1, l=1, dt=0.05, torque in [-2, 2], horizon 200)."""

    max_steps = 200

    def __init__(self):
        self.observation_space = _Box(-8.0, 8.0, (3,))
        self.action_space = _Box(-2.0, 2.0, (1,))
        self._rng = np.random.default_rng(0)
        self._th = 0.0
        self._thdot = 0.0
        self._steps = 0

    def _obs(self):
        return np.array(
            [np.cos(self._th), np.sin(self._th), self._thdot], np.float32
        )

    def reset(self, seed=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._th = float(self._rng.uniform(-np.pi, np.pi))
        self._thdot = float(self._rng.uniform(-1.0, 1.0))
        self._steps = 0
        return self._obs(), {}

    def step(self, action):
        g, m, l, dt = 10.0, 1.0, 1.0, 0.05
        u = float(np.clip(np.asarray(action).reshape(-1)[0], -2.0, 2.0))
        th = ((self._th + np.pi) % (2 * np.pi)) - np.pi
        cost = th**2 + 0.1 * self._thdot**2 + 0.001 * u**2
        self._thdot += (
            3 * g / (2 * l) * np.sin(self._th) + 3.0 / (m * l**2) * u
        ) * dt
        self._thdot = float(np.clip(self._thdot, -8.0, 8.0))
        self._th += self._thdot * dt
        self._steps += 1
        truncated = self._steps >= self.max_steps
        return self._obs(), -cost, False, truncated, {}


def make_continuous_env(env_id: str, seed=None):
    if env_id == "Reach-v0":
        return Reach()
    if env_id == "Pendulum-v1":
        try:
            import gymnasium as gym

            return gym.make("Pendulum-v1")
        except ImportError:
            return Pendulum()
    import gymnasium as gym

    return gym.make(env_id)
