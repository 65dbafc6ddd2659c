"""Numpy-batched vector environments: one array op steps all N envs.

A copy of ``ray_tpu/rllib/env/vector.py`` (numpy only), kept so the port
imports nothing of ray_tpu.

Reference: ``rllib/env/vector_env.py`` + gymnasium's SyncVectorEnv — both
step sub-envs in a Python loop. For Atari-scale env-steps/sec the loop IS
the bottleneck (VERDICT r3 missing #6), so the in-repo envs are re-derived
as batched numpy physics: state lives in [N, ...] arrays and ``step``
executes masked array ops, touching Python per-env only at episode
boundaries (resets). Arbitrary gymnasium envs fall back to ``LoopVectorEnv``.

Autoreset contract (mirrors gymnasium's final-observation semantics, which
the runner's bootstrap logic needs): ``step`` returns the POST-reset obs for
ended envs, with the pre-reset successor in ``final_obs`` — value-based
learners bootstrap from the true transition, not the next episode's start.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from ray_tpu_torch.rllib.env.cartpole import _Space


class VectorEnv:
    """N synchronized envs. ``reset(seed) -> obs [N, ...]``;
    ``step(actions [N]) -> (obs, rewards, terms, truncs, final_obs)``."""

    num_envs: int
    observation_space: _Space
    action_space: _Space

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        raise NotImplementedError

    def step(self, actions: np.ndarray):
        raise NotImplementedError

    def close(self):
        pass


class LoopVectorEnv(VectorEnv):
    """Fallback for arbitrary gymnasium-API envs (per-env Python loop)."""

    def __init__(self, env_fns: list[Callable]):
        self.envs = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)
        self.observation_space = self.envs[0].observation_space
        self.action_space = self.envs[0].action_space

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        obs = []
        for i, e in enumerate(self.envs):
            o, _ = e.reset(seed=None if seed is None else seed + i)
            obs.append(np.asarray(o, np.float32))
        return np.stack(obs)

    def step(self, actions: np.ndarray):
        N = self.num_envs
        obs_l, rew, term, trunc, final = [], np.zeros(N, np.float32), np.zeros(N, bool), np.zeros(N, bool), []
        for i, e in enumerate(self.envs):
            o2, r, tm, tr, _ = e.step(int(actions[i]))
            o2 = np.asarray(o2, np.float32)
            final.append(o2)
            rew[i], term[i], trunc[i] = r, tm, tr
            if tm or tr:
                o2, _ = e.reset()
                o2 = np.asarray(o2, np.float32)
            obs_l.append(o2)
        return np.stack(obs_l), rew, term, trunc, np.stack(final)

    def close(self):
        for e in self.envs:
            if hasattr(e, "close"):
                e.close()


class VecCartPole(VectorEnv):
    """Batched CartPole-v1 physics (same constants as the scalar fallback
    ``env/cartpole.py`` / gymnasium): state [N, 4], one fused numpy update
    per step for all envs."""

    max_steps = 500

    def __init__(self, num_envs: int):
        self.num_envs = num_envs
        self.observation_space = _Space(shape=(4,))
        self.action_space = _Space(n=2)
        self._rngs = [np.random.default_rng(i) for i in range(num_envs)]
        self._state = np.zeros((num_envs, 4), np.float32)
        self._steps = np.zeros(num_envs, np.int64)

    def _reset_index(self, i: int):
        self._state[i] = self._rngs[i].uniform(-0.05, 0.05, size=4)
        self._steps[i] = 0

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self._rngs = [
                np.random.default_rng(seed + i) for i in range(self.num_envs)
            ]
        for i in range(self.num_envs):
            self._reset_index(i)
        return self._state.copy()

    def step(self, actions: np.ndarray):
        gravity, masscart, masspole = 9.8, 1.0, 0.1
        total_mass = masscart + masspole
        length = 0.5
        polemass_length = masspole * length
        force_mag, tau = 10.0, 0.02

        # float32 throughout, like the scalar env (numpy-2 weak promotion
        # keeps python-float constants from upcasting) — the parity test
        # pins the two bitwise
        s = self._state
        x, x_dot, theta, theta_dot = s[:, 0], s[:, 1], s[:, 2], s[:, 3]
        force = np.where(
            np.asarray(actions) == 1, np.float32(force_mag), np.float32(-force_mag)
        )
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
        self._state = np.stack([x, x_dot, theta, theta_dot], axis=1).astype(
            np.float32
        )
        self._steps += 1

        term = (np.abs(x) > 2.4) | (np.abs(theta) > 0.2095)
        trunc = self._steps >= self.max_steps
        rew = np.ones(self.num_envs, np.float32)
        final = self._state.copy()
        for i in np.nonzero(term | trunc)[0]:
            self._reset_index(i)
        return self._state.copy(), rew, term, trunc, final


class VecMiniBreakout(VectorEnv):
    """Batched MiniBreakout (``env/breakout.py``): bricks [N, R, W], ball
    and paddle positions as [N] int arrays, collision logic as boolean
    masks. Semantics pinned step-for-step to the scalar env by test
    (``tests/test_rllib.py``)."""

    def __init__(
        self,
        num_envs: int,
        height: int = 24,
        width: int = 24,
        brick_rows: int = 3,
        paddle_width: int = 5,
        max_steps: int = 400,
    ):
        self.num_envs = num_envs
        self.h, self.w = height, width
        self.brick_rows = brick_rows
        self.paddle_width = paddle_width
        self.max_steps = max_steps
        self.observation_space = _Space(shape=(height, width, 1))
        self.action_space = _Space(n=3)
        self._rngs = [np.random.default_rng(i) for i in range(num_envs)]
        N = num_envs
        self.bricks = np.ones((N, brick_rows, width), bool)
        self.paddle_x = np.full(N, width // 2, np.int64)
        self.ball_x = np.zeros(N, np.int64)
        self.ball_y = np.zeros(N, np.int64)
        self.dx = np.zeros(N, np.int64)
        self.dy = np.ones(N, np.int64)
        self.steps = np.zeros(N, np.int64)
        self.reset()

    def _reset_index(self, i: int):
        self.bricks[i] = True
        self.paddle_x[i] = self.w // 2
        self.ball_x[i] = int(self._rngs[i].integers(2, self.w - 2))
        self.ball_y[i] = self.brick_rows + 2
        self.dx[i] = int(self._rngs[i].choice([-1, 1]))
        self.dy[i] = 1
        self.steps[i] = 0

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self._rngs = [
                np.random.default_rng(seed + i) for i in range(self.num_envs)
            ]
        for i in range(self.num_envs):
            self._reset_index(i)
        return self._obs()

    def step(self, actions: np.ndarray):
        N = self.num_envs
        a = np.asarray(actions)
        self.steps += 1
        half = self.paddle_width // 2
        self.paddle_x = np.clip(
            self.paddle_x + (a == 2).astype(np.int64) - (a == 0).astype(np.int64),
            half,
            self.w - 1 - half,
        )

        rew = np.zeros(N, np.float32)
        term = np.zeros(N, bool)

        # ball step with wall bounces
        nx = self.ball_x + self.dx
        wall = (nx < 0) | (nx >= self.w)
        self.dx = np.where(wall, -self.dx, self.dx)
        nx = np.where(wall, self.ball_x + self.dx, nx)
        ny = self.ball_y + self.dy
        ceil = ny < 0
        self.dy = np.where(ceil, 1, self.dy)
        ny = np.where(ceil, self.ball_y + self.dy, ny)

        # brick collision (ny in brick band AND that brick alive)
        in_band = (ny >= 0) & (ny < self.brick_rows)
        idx = np.arange(N)
        safe_ny = np.clip(ny, 0, self.brick_rows - 1)
        hit = in_band & self.bricks[idx, safe_ny, np.clip(nx, 0, self.w - 1)]
        if hit.any():
            hi = np.nonzero(hit)[0]
            self.bricks[hi, ny[hi], nx[hi]] = False
            rew[hi] += 1.0
            self.dy = np.where(hit, -self.dy, self.dy)
            ny = np.where(hit, np.maximum(self.ball_y + self.dy, 0), ny)

        # paddle / floor
        floor = ny >= self.h - 1
        caught = floor & (np.abs(nx - self.paddle_x) <= half)
        missed = floor & ~caught
        self.dy = np.where(caught, -1, self.dy)
        self.dx = np.where(
            caught & (nx < self.paddle_x), -1,
            np.where(caught & (nx > self.paddle_x), 1, self.dx),
        )
        ny = np.where(caught, self.h - 2, ny)
        rew = np.where(missed, rew - 1.0, rew)
        term |= missed

        self.ball_x = np.clip(nx, 0, self.w - 1)
        self.ball_y = np.clip(ny, 0, self.h - 1)
        term |= ~self.bricks.any(axis=(1, 2))  # board cleared
        trunc = self.steps >= self.max_steps

        final = self._obs()
        done = term | trunc
        done_idx = np.nonzero(done)[0]
        for i in done_idx:
            self._reset_index(i)
        obs = final
        if done_idx.size:
            # rendering dominates step cost: patch only the reset rows
            # instead of re-rendering all N frames
            obs = final.copy()
            obs[done_idx] = self._obs(done_idx)
        return obs, rew, term, trunc, final

    def _obs(self, idx: Optional[np.ndarray] = None) -> np.ndarray:
        """Render frames for env indices ``idx`` (all envs when None)."""
        if idx is None:
            idx = np.arange(self.num_envs)
        n = len(idx)
        img = np.zeros((n, self.h, self.w, 1), np.float32)
        img[:, : self.brick_rows, :, 0] = (
            self.bricks[idx].astype(np.float32) * 0.5
        )
        img[np.arange(n), self.ball_y[idx], self.ball_x[idx], 0] = 1.0
        half = self.paddle_width // 2
        # paddle row: vectorized range mask
        cols = np.arange(self.w)[None, :]
        pmask = np.abs(cols - self.paddle_x[idx, None]) <= half
        img[:, self.h - 1, :, 0] = np.where(
            pmask, 0.8, img[:, self.h - 1, :, 0]
        )
        return img


def make_vector_env(
    env_id: str, num_envs: int, seed: Optional[int] = None
):
    """Vectorized envs for the in-repo ids; LoopVectorEnv otherwise.
    Returns (env, initial obs from the seeded reset)."""
    from ray_tpu_torch.rllib.env.env_runner import _make_env

    if env_id in ("MiniBreakout-v0", "MiniBreakout"):
        env = VecMiniBreakout(num_envs)
    elif env_id == "CartPole-v1":
        env = VecCartPole(num_envs)
    else:
        env = LoopVectorEnv(
            [lambda: _make_env(env_id) for _ in range(num_envs)]
        )
    return env, env.reset(seed=seed)
