"""ConnectorV2: pluggable obs/action transformation pipelines.

A copy of ``ray_tpu/rllib/connectors.py`` (numpy only), kept so the port
imports nothing of ray_tpu. The pieces transform host arrays before the
runner's CPU module sees them.

Reference: ``rllib/connectors/connector_v2.py`` + the piece library under
``rllib/connectors/env_to_module/`` (flatten_observations, frame_stacking,
mean_std_filter, prev_actions_prev_rewards). TPU-first delta: the reference
pieces transform per-episode lists; here every piece is a NUMPY-BATCHED
transform over the vectorized runner's [N, ...] arrays (one array op per
step for the whole env gang, matching ``env/vector.py``), with explicit
state so stacks/filters survive checkpoints.

Piece API: ``transform(obs, update=False, dones=None, initial=False)``.
``update=False`` is a pure peek (used for the pre-reset bootstrap
observation, which must see the stack/filter as-if-continuing);
``update=True`` advances internal state — ``dones`` marks envs whose
episode ended at this step (stacks re-seed), ``initial=True`` seeds all.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class ConnectorV2:
    """One connector piece. Stateless by default."""

    def transform(
        self,
        obs: np.ndarray,
        update: bool = False,
        dones: Optional[np.ndarray] = None,
        initial: bool = False,
    ) -> np.ndarray:
        return obs

    def transform_obs_shape(self, shape: tuple) -> tuple:
        """Shape a module sees after this piece (sizes the RLModuleSpec)."""
        return shape

    def get_state(self) -> dict:
        return {}

    def set_state(self, state: dict) -> None:
        pass


class EnvToModulePipeline(ConnectorV2):
    """Compose pieces; itself a ConnectorV2 (reference:
    ``connector_pipeline_v2.py`` — a pipeline is a piece)."""

    def __init__(self, *pieces: ConnectorV2):
        self.pieces = [p for p in pieces if p is not None]

    def transform(self, obs, update=False, dones=None, initial=False):
        for p in self.pieces:
            obs = p.transform(obs, update=update, dones=dones, initial=initial)
        return obs

    def note_step(self, actions, rewards, dones):
        """Forward step context to every piece that wants it (a pipeline is
        a piece: nested pipelines must relay, not swallow)."""
        for p in self.pieces:
            if hasattr(p, "note_step"):
                p.note_step(actions, rewards, dones)

    def transform_obs_shape(self, shape):
        for p in self.pieces:
            shape = p.transform_obs_shape(shape)
        return shape

    def get_state(self):
        return {str(i): p.get_state() for i, p in enumerate(self.pieces)}

    def set_state(self, state):
        for i, p in enumerate(self.pieces):
            p.set_state(state.get(str(i), {}))


def as_pipeline(obj) -> "EnvToModulePipeline":
    """Factory result (piece | list of pieces | pipeline) -> pipeline."""
    if isinstance(obj, EnvToModulePipeline):
        return obj
    if isinstance(obj, ConnectorV2):
        return EnvToModulePipeline(obj)
    if isinstance(obj, (list, tuple)):
        return EnvToModulePipeline(*obj)
    raise TypeError(
        f"env_to_module_connector factory must return ConnectorV2 piece(s), "
        f"got {type(obj).__name__}"
    )


class FlattenObservations(ConnectorV2):
    """[N, ...] -> [N, D] (reference: flatten_observations.py)."""

    def transform(self, obs, update=False, dones=None, initial=False):
        return np.asarray(obs, np.float32).reshape(obs.shape[0], -1)

    def transform_obs_shape(self, shape):
        return (int(np.prod(shape)),)


class FrameStack(ConnectorV2):
    """Stack the last k frames on the channel axis (reference:
    frame_stacking.py; the classic Atari temporal context). Pixel obs
    [N, H, W, C] -> [N, H, W, C*k]; episode ends re-seed that env's stack
    with its reset frame."""

    def __init__(self, k: int = 4):
        self.k = k
        self._stack: Optional[np.ndarray] = None  # [N, H, W, C*k]
        self._c = None

    def _shifted(self, stack, obs):
        out = np.concatenate([stack[..., self._c:], obs], axis=-1)
        return out

    def transform(self, obs, update=False, dones=None, initial=False):
        obs = np.asarray(obs, np.float32)
        if obs.ndim != 4:
            raise ValueError(f"FrameStack expects [N, H, W, C], got {obs.shape}")
        self._c = obs.shape[-1]
        if self._stack is None or initial:
            # frame-BLOCKED layout [f1|f2|..|fk] (np.tile), matching
            # _shifted's drop-first-C/append-C — np.repeat would interleave
            # per channel and scramble multi-channel stacks
            seeded = np.tile(obs, (1, 1, 1, self.k))
            if update:  # a peek NEVER seeds state (pure by contract)
                self._stack = seeded
            return seeded
        out = self._shifted(self._stack, obs)
        if update:
            if dones is not None and dones.any():
                # ended envs: obs is the post-reset frame — re-seed
                reseed = np.tile(obs, (1, 1, 1, self.k))
                out = np.where(
                    dones.reshape(-1, *([1] * (obs.ndim - 1))), reseed, out
                )
            self._stack = out
        return out

    def transform_obs_shape(self, shape):
        h, w, c = shape
        return (h, w, c * self.k)

    def get_state(self):
        return {"stack": self._stack}

    def set_state(self, state):
        self._stack = state.get("stack")


class MeanStdFilter(ConnectorV2):
    """Running mean/std observation normalization (reference:
    mean_std_filter.py; Welford accumulation, clipped output)."""

    def __init__(self, clip: float = 10.0, eps: float = 1e-8):
        self.clip = clip
        self.eps = eps
        self._count = 0.0
        self._mean: Optional[np.ndarray] = None
        self._m2: Optional[np.ndarray] = None

    def transform(self, obs, update=False, dones=None, initial=False):
        obs = np.asarray(obs, np.float64)
        if self._mean is None:
            self._mean = np.zeros(obs.shape[1:])
            self._m2 = np.zeros(obs.shape[1:])
        if update:
            # batched Welford (Chan et al. parallel merge)
            n_b = obs.shape[0]
            mean_b = obs.mean(axis=0)
            m2_b = ((obs - mean_b) ** 2).sum(axis=0)
            delta = mean_b - self._mean
            total = self._count + n_b
            self._mean = self._mean + delta * (n_b / total)
            self._m2 = self._m2 + m2_b + delta**2 * (self._count * n_b / total)
            self._count = total
        std = np.sqrt(self._m2 / max(self._count, 1.0)) + self.eps
        out = np.clip((obs - self._mean) / std, -self.clip, self.clip)
        return out.astype(np.float32)

    def get_state(self):
        return {"count": self._count, "mean": self._mean, "m2": self._m2}

    def set_state(self, state):
        if state.get("mean") is not None:
            self._count = state["count"]
            self._mean = state["mean"]
            self._m2 = state["m2"]


class PrevActionsPrevRewards(ConnectorV2):
    """Append one-hot previous action + previous reward to vector obs
    (reference: prev_actions_prev_rewards.py; POMDP context for memoryless
    policies). Runner feeds state via ``note_step``."""

    def __init__(self, action_dim: int):
        self.action_dim = action_dim
        self._prev_act: Optional[np.ndarray] = None
        self._prev_rew: Optional[np.ndarray] = None
        # step context staged by note_step, consumed at the next transform:
        # raw (as-if-continuing) for bootstrap peeks, done-masked for the
        # post-step update — a truncation-bootstrap next_obs must carry the
        # action/reward JUST taken, while the post-reset obs starts fresh
        self._staged_raw = None
        self._staged_masked = None

    def note_step(self, actions: np.ndarray, rewards: np.ndarray, dones: np.ndarray):
        actions = np.asarray(actions, np.int64)
        rewards = np.asarray(rewards, np.float32)
        self._staged_raw = (actions, rewards)
        self._staged_masked = (
            np.where(dones, -1, actions),
            np.where(dones, 0.0, rewards).astype(np.float32),
        )

    def transform(self, obs, update=False, dones=None, initial=False):
        obs = np.asarray(obs, np.float32)
        if obs.ndim != 2:
            raise ValueError("PrevActionsPrevRewards needs flat [N, D] obs")
        N = obs.shape[0]
        if self._prev_act is None or initial:
            self._prev_act = np.full(N, -1, np.int64)
            self._prev_rew = np.zeros(N, np.float32)
            self._staged_raw = self._staged_masked = None
        if update:
            if self._staged_masked is not None:
                self._prev_act, self._prev_rew = self._staged_masked
                self._staged_raw = self._staged_masked = None
            act, rew = self._prev_act, self._prev_rew
        elif self._staged_raw is not None:
            act, rew = self._staged_raw  # bootstrap peek: continuing context
        else:
            act, rew = self._prev_act, self._prev_rew
        onehot = np.zeros((N, self.action_dim), np.float32)
        valid = act >= 0
        onehot[np.arange(N)[valid], act[valid]] = 1.0
        return np.concatenate(
            [obs, onehot, rew.reshape(N, 1).astype(np.float32)], axis=1
        )

    def transform_obs_shape(self, shape):
        (d,) = shape
        return (d + self.action_dim + 1,)

    def get_state(self):
        return {"prev_act": self._prev_act, "prev_rew": self._prev_rew}

    def set_state(self, state):
        if state.get("prev_act") is not None:
            self._prev_act = state["prev_act"]
            self._prev_rew = state["prev_rew"]
