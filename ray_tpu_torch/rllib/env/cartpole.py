"""Pure-numpy CartPole (gymnasium-API-compatible fallback).

A copy of the JAX package's ``ray_tpu/rllib/env/cartpole.py``, which has no
JAX in it: the port keeps its own copy rather than import ray_tpu.

Physics match gymnasium's CartPole-v1 (the classic Barto-Sutton-Anderson
cart-pole); used when gymnasium isn't importable so the RL stack stays
hermetic (SURVEY §4 mocked-hardware test strategy).
"""

from __future__ import annotations

import numpy as np


class _Space:
    def __init__(self, shape=None, n=None):
        self.shape = shape
        self.n = n


class CartPole:
    max_steps = 500

    def __init__(self):
        self.observation_space = _Space(shape=(4,))
        self.action_space = _Space(n=2)
        self._rng = np.random.default_rng(0)
        self._state = None
        self._steps = 0

    def reset(self, seed=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._state = self._rng.uniform(-0.05, 0.05, size=4).astype(np.float32)
        self._steps = 0
        return self._state.copy(), {}

    def step(self, action: int):
        gravity, masscart, masspole = 9.8, 1.0, 0.1
        total_mass = masscart + masspole
        length = 0.5
        polemass_length = masspole * length
        force_mag, tau = 10.0, 0.02

        x, x_dot, theta, theta_dot = self._state
        force = force_mag if action == 1 else -force_mag
        costheta, sintheta = np.cos(theta), np.sin(theta)
        temp = (force + polemass_length * theta_dot**2 * sintheta) / total_mass
        thetaacc = (gravity * sintheta - costheta * temp) / (
            length * (4.0 / 3.0 - masspole * costheta**2 / total_mass)
        )
        xacc = temp - polemass_length * thetaacc * costheta / total_mass
        x = x + tau * x_dot
        x_dot = x_dot + tau * xacc
        theta = theta + tau * theta_dot
        theta_dot = theta_dot + tau * thetaacc
        self._state = np.array([x, x_dot, theta, theta_dot], np.float32)
        self._steps += 1

        terminated = bool(
            x < -2.4 or x > 2.4 or theta < -0.2095 or theta > 0.2095
        )
        truncated = self._steps >= self.max_steps
        return self._state.copy(), 1.0, terminated, truncated, {}

    def close(self):
        pass
