"""MiniBreakout: a procedural, dependency-free Breakout-class pixel env.

A copy of ``ray_tpu/rllib/env/breakout.py`` (numpy only), kept so the port
imports nothing of ray_tpu.

Reference north star: PPO on Atari Breakout (``rllib/tuned_examples/ppo``).
ALE isn't in the image, so this is a faithful structural stand-in: pixel
observations [H, W, 1], ball/paddle/brick dynamics, reward per brick,
episode ends on ball loss or board clear — exercising the conv RLModule and
the full pixel pipeline at a size CPU tests can learn on.

Gymnasium-compatible surface: ``reset(seed=...) -> (obs, info)``,
``step(a) -> (obs, reward, terminated, truncated, info)``,
``observation_space.shape``, ``action_space.n``.
"""

from __future__ import annotations

import numpy as np


class _Space:
    def __init__(self, shape=None, n=None):
        self.shape = shape
        self.n = n


class MiniBreakout:
    """Grid-physics breakout on an H x W single-channel image.

    Layout (rows): bricks at the top (brick_rows), free space, paddle on
    the bottom row. Actions: 0 = left, 1 = stay, 2 = right. The ball moves
    one cell per step on diagonals; paddle bounces flip dy and nudge dx
    toward the hit side, brick hits remove the brick (+1 reward), losing
    the ball terminates with -1.
    """

    def __init__(
        self,
        height: int = 24,
        width: int = 24,
        brick_rows: int = 3,
        paddle_width: int = 5,
        max_steps: int = 400,
    ):
        self.h, self.w = height, width
        self.brick_rows = brick_rows
        self.paddle_width = paddle_width
        self.max_steps = max_steps
        self.observation_space = _Space(shape=(height, width, 1))
        self.action_space = _Space(n=3)
        self._rng = np.random.default_rng(0)
        self.reset()

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self.bricks = np.ones((self.brick_rows, self.w), dtype=bool)
        self.paddle_x = self.w // 2
        self.ball_x = int(self._rng.integers(2, self.w - 2))
        self.ball_y = self.brick_rows + 2
        self.dx = int(self._rng.choice([-1, 1]))
        self.dy = 1
        self.steps = 0
        return self._obs(), {}

    def step(self, action: int):
        self.steps += 1
        half = self.paddle_width // 2
        if action == 0:
            self.paddle_x = max(half, self.paddle_x - 1)
        elif action == 2:
            self.paddle_x = min(self.w - 1 - half, self.paddle_x + 1)

        reward = 0.0
        terminated = False

        # ball step with wall bounces
        nx, ny = self.ball_x + self.dx, self.ball_y + self.dy
        if nx < 0 or nx >= self.w:
            self.dx = -self.dx
            nx = self.ball_x + self.dx
        if ny < 0:
            self.dy = 1
            ny = self.ball_y + self.dy
        # brick collision
        if 0 <= ny < self.brick_rows and self.bricks[ny, nx]:
            self.bricks[ny, nx] = False
            reward += 1.0
            self.dy = -self.dy
            ny = self.ball_y + self.dy
            ny = max(ny, 0)
        # paddle / floor
        if ny >= self.h - 1:
            if abs(nx - self.paddle_x) <= half:
                self.dy = -1
                # nudge horizontal direction toward the hit side
                if nx < self.paddle_x:
                    self.dx = -1
                elif nx > self.paddle_x:
                    self.dx = 1
                ny = self.h - 2
            else:
                reward -= 1.0
                terminated = True
        self.ball_x, self.ball_y = int(np.clip(nx, 0, self.w - 1)), int(
            np.clip(ny, 0, self.h - 1)
        )
        if not self.bricks.any():
            terminated = True  # board cleared
        truncated = self.steps >= self.max_steps
        return self._obs(), reward, terminated, truncated, {}

    def _obs(self) -> np.ndarray:
        img = np.zeros((self.h, self.w, 1), np.float32)
        img[: self.brick_rows, :, 0] = self.bricks.astype(np.float32) * 0.5
        img[self.ball_y, self.ball_x, 0] = 1.0
        half = self.paddle_width // 2
        img[
            self.h - 1,
            self.paddle_x - half : self.paddle_x + half + 1,
            0,
        ] = 0.8
        return img

    def close(self):
        pass
