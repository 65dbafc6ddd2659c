"""Env runners: collect experience with the current policy.

Counterpart of ``ray_tpu/rllib/env/env_runner.py`` (reference:
``rllib/env/env_runner.py:33``, ``single_agent_env_runner.py:68``,
``env_runner_group.py:71``). The runner's module runs on the CPU by
design, not as a fallback: policy inference inside a runner is host-side
in the reference too (its docstring: "chips stay dedicated to the
learner"), one small forward per env step over numpy observations. The
learner alone holds the card.

With ``num_env_runners > 0`` the group's runners are spawned CPU processes
(``_private/process_actor.py``) in place of the JAX package's actors, with
its fault handling: a runner whose call fails is replaced, and its sample
dropped. The connector factory goes to them with the standard pickle, by
reference (a class, a module-level function or a ``functools.partial``),
where the JAX package cloudpickles it; a lambda raises ``TypeError`` when
the group is built.

``_make_env("CartPole-v1")`` builds ``gymnasium.make("CartPole-v1")`` where
gymnasium imports and ``env/cartpole.py:CartPole`` where it does not, the
JAX package's choice; sampling goes through ``make_vector_env`` ->
``VecCartPole`` either way, so the rollouts are the same on a host with
gymnasium and on one without.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Optional

import numpy as np

from ray_tpu_torch._private.process_actor import (ActorError, ProcessActor, get,
                                                  require_picklable, start_all)
from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec


def _make_env(env_id: str, seed: Optional[int] = None):
    if env_id in ("MiniBreakout-v0", "MiniBreakout"):
        from ray_tpu_torch.rllib.env.breakout import MiniBreakout

        return MiniBreakout()
    if env_id == "CartPole-v1":
        try:
            import gymnasium as gym

            return gym.make("CartPole-v1")
        except ImportError:
            from ray_tpu_torch.rllib.env.cartpole import CartPole

            return CartPole()
    import gymnasium as gym

    return gym.make(env_id)


def env_dims(env_id: str) -> tuple[int, int]:
    env = _make_env(env_id)
    obs_dim = int(np.prod(env.observation_space.shape))
    act_dim = int(env.action_space.n)
    env.close() if hasattr(env, "close") else None
    return obs_dim, act_dim


def env_spec(env_id: str) -> tuple[tuple, int]:
    """(observation shape, action count) — shape-preserving (pixel envs)."""
    env = _make_env(env_id)
    shape = tuple(env.observation_space.shape)
    act_dim = int(env.action_space.n)
    env.close() if hasattr(env, "close") else None
    return shape, act_dim


class SingleAgentEnvRunner:
    """Steps ``num_envs`` environments with the current module weights.

    ``env_to_module_connector`` is a zero-argument factory returning
    ConnectorV2 piece(s), built here (the JAX runner takes it pickled)."""

    def __init__(
        self,
        env_id: str,
        module_spec: RLModuleSpec,
        *,
        num_envs: int = 1,
        rollout_fragment_length: int = 200,
        gamma: float = 0.99,
        lambda_: float = 0.95,
        seed: int = 0,
        emit_sequences: bool = False,
        env_to_module_connector: Optional[Callable] = None,
    ):
        from ray_tpu_torch.rllib.env.vector import make_vector_env

        self.module = module_spec.build(seed, device="cpu")
        # MLP modules consume flat vectors even from pixel envs; conv
        # modules keep [H, W, C]
        self._flatten = not module_spec.conv_filters
        self.venv, self._initial_obs = make_vector_env(env_id, num_envs, seed=seed)
        self.rollout_fragment_length = rollout_fragment_length
        self.gamma = gamma
        self.lambda_ = lambda_
        # time-major [T, N] sequences for off-policy-corrected learners
        # (IMPALA's V-trace needs per-step behavior logp in trajectory order)
        self.emit_sequences = emit_sequences
        self._rng = np.random.default_rng(seed)
        self.connectors = None
        if env_to_module_connector is not None:
            from ray_tpu_torch.rllib.connectors import as_pipeline

            self.connectors = as_pipeline(env_to_module_connector())
        # connectors see RAW env shapes (FrameStack needs [N, H, W, C]);
        # the MLP flatten happens after
        self._obs = self._to_obs(
            self._apply_connectors(self._initial_obs, update=True, initial=True)
        )
        self._ep_return = np.zeros(num_envs)
        self._ep_len = np.zeros(num_envs, np.int64)
        # bounded: long runs must not grow runner memory per episode
        self.completed_returns: "deque[float]" = deque(maxlen=500)
        self.completed_lengths: "deque[int]" = deque(maxlen=500)
        self._episodes_this_sample = 0

    def _to_obs(self, o) -> np.ndarray:
        """[N, ...] batch -> flattened [N, D] for MLP modules."""
        a = np.asarray(o, np.float32)
        return a.reshape(a.shape[0], -1) if self._flatten else a

    def _apply_connectors(self, obs, update=False, dones=None, initial=False):
        if self.connectors is None:
            return obs
        return self.connectors.transform(obs, update=update, dones=dones, initial=initial)

    def set_weights(self, weights: dict) -> bool:
        self.module.set_state(weights)
        return True

    def get_connector_state(self):
        return self.connectors.get_state() if self.connectors else None

    def set_connector_state(self, state) -> bool:
        if self.connectors is not None and state is not None:
            self.connectors.set_state(state)
        return True

    def sample(self) -> dict:
        """Collect one fragment per env; returns a GAE-processed batch plus
        episode metrics."""
        T, N = self.rollout_fragment_length, self.venv.num_envs
        obs_shape = self._obs.shape[1:]  # vector OR pixel [H, W, C]
        obs_buf = np.zeros((T, N, *obs_shape), np.float32)
        next_obs_buf = np.zeros((T, N, *obs_shape), np.float32)
        act_buf = np.zeros((T, N), np.int64)
        rew_buf = np.zeros((T, N), np.float32)
        term_buf = np.zeros((T, N), np.float32)  # true termination: boot 0
        end_buf = np.zeros((T, N), np.float32)  # term OR trunc: cuts GAE
        trunc_only = np.zeros((T, N), bool)  # trunc & ~term: V(final obs)
        logp_buf = np.zeros((T, N), np.float32)
        val_buf = np.zeros((T + 1, N), np.float32)

        for t in range(T):
            obs = self._obs  # [N, ...]
            logits, values = self.module.forward_exploration(obs)
            # vectorized categorical sampling via the Gumbel trick: one
            # argmax over [N, A] replaces N rng.choice calls
            logp_all = logits - _logsumexp(logits)
            gumbel = -np.log(-np.log(self._rng.random(logits.shape) + 1e-12) + 1e-12)
            actions = np.argmax(logp_all + gumbel, axis=-1).astype(np.int64)
            logp = logp_all[np.arange(N), actions]
            obs_buf[t] = obs
            act_buf[t] = actions
            logp_buf[t] = logp
            val_buf[t] = values

            o2, r, term, trunc, final = self.venv.step(actions)
            done = term | trunc
            # stage this step's context FIRST: the bootstrap peek below
            # must see the action/reward just taken (as-if-continuing)
            if self.connectors is not None:
                self.connectors.note_step(actions, r, done)
            # pre-reset successor: value-based learners (DQN) need the true
            # transition even at episode boundaries; the connector PEEKS
            next_obs_buf[t] = self._to_obs(self._apply_connectors(final))
            o2 = self._to_obs(self._apply_connectors(o2, update=True, dones=done))
            rew_buf[t] = r
            self._ep_return += r
            self._ep_len += 1
            term_buf[t] = term.astype(np.float32)
            end_buf[t] = done.astype(np.float32)
            trunc_only[t] = trunc & ~term
            # python only at episode boundaries (rare), never per step
            for i in np.nonzero(done)[0]:
                self.completed_returns.append(float(self._ep_return[i]))
                self.completed_lengths.append(int(self._ep_len[i]))
                self._episodes_this_sample += 1
                self._ep_return[i] = 0.0
                self._ep_len[i] = 0
            self._obs = o2
        # bootstrap values for the final obs
        _, last_vals = self.module.forward_inference(self._obs)
        val_buf[T] = last_vals

        # next-step value per transition: V(s_{t+1}) by default; 0 on
        # termination, V(pre-reset obs) on truncation
        next_val = val_buf[1:].copy()
        if trunc_only.any():
            ts, is_ = np.nonzero(trunc_only)
            _, boot_vals = self.module.forward_inference(next_obs_buf[ts, is_])
            next_val[ts, is_] = boot_vals
        next_val = next_val * (1.0 - term_buf)

        adv = np.zeros((T, N), np.float32)
        last_gae = np.zeros(N, np.float32)
        for t in reversed(range(T)):
            not_end = 1.0 - end_buf[t]
            delta = rew_buf[t] + self.gamma * next_val[t] - val_buf[t]
            last_gae = delta + self.gamma * self.lambda_ * not_end * last_gae
            adv[t] = last_gae
        value_targets = adv + val_buf[:T]
        adv = (adv - adv.mean()) / (adv.std() + 1e-8)

        recent_returns = list(self.completed_returns)[-100:]
        recent_lengths = list(self.completed_lengths)[-100:]
        episodes_this_sample = self._episodes_this_sample
        self._episodes_this_sample = 0
        metrics = {
            "episode_return_mean": (
                float(np.mean(recent_returns)) if recent_returns else float("nan")
            ),
            "episode_len_mean": (
                float(np.mean(recent_lengths)) if recent_lengths else float("nan")
            ),
            "num_env_steps": T * N,
            "num_episodes": episodes_this_sample,  # per-fragment, not lifetime
        }
        out = {
            "batch": {
                # pixel obs keep [B, H, W, C]; vector obs stay [B, D]
                "obs": obs_buf.reshape(T * N, *obs_shape),
                "actions": act_buf.reshape(-1),
                "logp_old": logp_buf.reshape(-1),
                "advantages": adv.reshape(-1),
                "value_targets": value_targets.reshape(-1),
                # raw transitions for value-based learners (DQN replay)
                "rewards": rew_buf.reshape(-1),
                "next_obs": next_obs_buf.reshape(T * N, *obs_shape),
                "terminals": term_buf.reshape(-1),
            },
            "metrics": metrics,
        }
        if self.emit_sequences:
            out["seq"] = {
                "obs": obs_buf,  # [T, N, D]
                "next_obs": next_obs_buf,
                "actions": act_buf,  # [T, N]
                "rewards": rew_buf,
                "terminals": term_buf,  # true termination: V(s') = 0
                "ends": end_buf,  # term OR trunc: cuts the v-trace scan
                "logp_behavior": logp_buf,
            }
        return out


def _softmax(x: np.ndarray) -> np.ndarray:
    z = x - x.max(axis=-1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=-1, keepdims=True)


def _logsumexp(x: np.ndarray) -> np.ndarray:
    m = x.max(axis=-1, keepdims=True)
    return m + np.log(np.exp(x - m).sum(axis=-1, keepdims=True))


class RunnerProcesses:
    """What the single- and multi-agent groups share: one local runner, or
    ``num_env_runners`` processes, runner i ``cls(*args, seed=seed + i,
    **kwargs)``, each replaced when a call to it fails."""

    _name = "runner"

    def _start(self, cls, args: tuple, kwargs: dict, seed: int, num_env_runners: int):
        self._cls, self._args, self._kwargs, self._seed = cls, args, kwargs, seed
        self._local, self._remote = None, []
        if num_env_runners <= 0:
            self._local = cls(*args, seed=seed, **kwargs)
        else:
            self._remote = start_all([self._spawn(i) for i in range(num_env_runners)])

    def _spawn(self, index: int) -> ProcessActor:
        return ProcessActor(self._cls, self._args, dict(self._kwargs, seed=self._seed + index),
                            name=f"{self._name}-{index}")

    @property
    def runners(self) -> list:
        """The runner processes (empty in local mode)."""
        return self._remote

    @property
    def local_runner(self):
        return self._local

    def replace_runner(self, index: int) -> ProcessActor:
        """Respawn runner ``index`` in place and return it (IMPALA manages
        its own in-flight calls). The old process is killed first: a
        caller replaces on any error, and an application error would
        otherwise leave a live runner behind."""
        self._remote[index].kill()
        self._remote[index] = self._spawn(index)
        return self._remote[index]

    def _fan_out(self, weights: Optional[dict], push_to_replacement: bool) -> list:
        """Push ``weights`` to every runner process, then sample each; the
        outputs of those that answered, in index order. A runner whose call
        fails is replaced and its sample dropped; the replacement gets the
        weights only with ``push_to_replacement``."""
        runners = list(self._remote)
        # the weights land before the sample: one process runs its calls in order
        pushes = [r.call("set_weights", weights) if weights is not None else None
                  for r in runners]
        samples = [r.call("sample") for r in runners]
        outs = []
        for i, (push, ref) in enumerate(zip(pushes, samples)):
            try:
                if push is not None:
                    get(push)
                outs.append(get(ref))
            except ActorError:
                runner = self.replace_runner(i)
                if push_to_replacement and weights is not None:
                    try:
                        get(runner.call("set_weights", weights), timeout=60)
                    except ActorError:
                        pass
        return outs

    def shutdown(self):
        for r in self._remote:
            r.kill()


class EnvRunnerGroup(RunnerProcesses):
    """The local env runner, or ``num_env_runners`` runner processes with
    fault-aware fan-out (runner i seeded ``seed + i``)."""

    _name = "env-runner"

    def __init__(
        self,
        env_id: str,
        module_spec: RLModuleSpec,
        *,
        num_env_runners: int = 0,
        num_envs_per_runner: int = 1,
        rollout_fragment_length: int = 200,
        gamma: float = 0.99,
        lambda_: float = 0.95,
        seed: int = 0,
        emit_sequences: bool = False,
        env_to_module_connector=None,
    ):
        self.num_env_runners = num_env_runners
        if num_env_runners > 0 and env_to_module_connector is not None:
            require_picklable(env_to_module_connector, "env_to_module_connector")
        kwargs = dict(
            num_envs=num_envs_per_runner,
            rollout_fragment_length=rollout_fragment_length,
            gamma=gamma,
            lambda_=lambda_,
            emit_sequences=emit_sequences,
            env_to_module_connector=env_to_module_connector,
        )
        self._start(SingleAgentEnvRunner, (env_id, module_spec), kwargs, seed, num_env_runners)

    def sample(self, weights: Optional[dict] = None) -> tuple[dict, dict]:
        """Returns (concatenated batch, aggregated metrics)."""
        if self._local is not None:
            if weights is not None:
                self._local.set_weights(weights)
            out = self._local.sample()
            return out["batch"], out["metrics"]
        good = self._fan_out(weights, push_to_replacement=True)
        if not good:
            raise RuntimeError("all env runners failed")
        batch = {k: np.concatenate([o["batch"][k] for o in good]) for k in good[0]["batch"]}
        ms = [o["metrics"] for o in good]
        metrics = {
            "episode_return_mean": float(np.nanmean([m["episode_return_mean"] for m in ms])),
            "episode_len_mean": float(np.nanmean([m["episode_len_mean"] for m in ms])),
            "num_env_steps": int(sum(m["num_env_steps"] for m in ms)),
            "num_episodes": int(sum(m["num_episodes"] for m in ms)),
            "num_healthy_runners": len(good),
        }
        return batch, metrics

    def get_connector_state(self):
        """Connector pipeline state for checkpoints (the local runner's, or
        the first healthy runner's: runners converge on the same stream)."""
        if self._local is not None:
            return self._local.get_connector_state()
        for r in self._remote:
            try:
                return get(r.call("get_connector_state"), timeout=60)
            except ActorError:
                continue
        return None

    def set_connector_state(self, state):
        if state is None:
            return
        if self._local is not None:
            self._local.set_connector_state(state)
            return
        for r in self._remote:
            try:
                get(r.call("set_connector_state", state), timeout=60)
            except ActorError:
                pass
