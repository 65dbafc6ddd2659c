"""DQN: counterpart of ``ray_tpu/rllib/algorithms/dqn.py`` (reference:
``rllib/algorithms/dqn/dqn.py``).

Double-DQN with a target network and a uniform replay buffer:
training_step = sample fragments -> append real transitions to replay ->
K Q-updates on minibatches (on the algorithm's device, on the learner
group's weights, which are set back after them) -> periodic target sync.
Exploration: the env runner samples actions from a softmax over the
Q-head (Boltzmann exploration); the epsilon schedule is computed for
parity/telemetry with the reference's epsilon-greedy default.
``ReplayBuffer`` is a copy (numpy).
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import adam, grad_step, on_device, take, to_device
from ray_tpu_torch.rllib.core.rl_module import forward


class ReplayBuffer:
    """Uniform FIFO replay (reference: ``utils/replay_buffers``).
    ``act_shape``/``act_dtype`` parameterize the action column so the same
    ring serves discrete (DQN) and continuous (SAC) learners."""

    def __init__(
        self,
        capacity: int,
        obs_dim: int,
        act_shape: tuple = (),
        act_dtype=np.int64,
    ):
        self.capacity = capacity
        self.obs = np.zeros((capacity, obs_dim), np.float32)
        self.next_obs = np.zeros((capacity, obs_dim), np.float32)
        self.actions = np.zeros((capacity, *act_shape), act_dtype)
        self.rewards = np.zeros(capacity, np.float32)
        self.terminals = np.zeros(capacity, np.float32)
        self.size = 0
        self._next = 0

    def add(self, obs, action, reward, next_obs, terminal):
        j = self._next
        self.obs[j], self.actions[j] = obs, action
        self.rewards[j], self.next_obs[j] = reward, next_obs
        self.terminals[j] = terminal
        self._next = (self._next + 1) % self.capacity
        self.size = min(self.size + 1, self.capacity)

    def add_batch(self, obs, actions, rewards, next_obs, terminals):
        for i in range(len(obs)):
            self.add(obs[i], actions[i], rewards[i], next_obs[i], terminals[i])

    def sample(self, n: int, rng) -> dict:
        idx = rng.integers(0, self.size, n)
        return {
            "obs": self.obs[idx],
            "actions": self.actions[idx],
            "rewards": self.rewards[idx],
            "next_obs": self.next_obs[idx],
            "terminals": self.terminals[idx],
        }


class DQNConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=DQN)
        self.replay_buffer_capacity = 50_000
        self.num_steps_sampled_before_learning_starts = 1000
        self.target_network_update_freq = 500  # in learner updates
        self.train_batch_size = 64
        self.num_updates_per_iteration = 64
        self.epsilon = [1.0, 0.05]  # linear from->to
        self.epsilon_timesteps = 10_000
        self.double_q = True
        self.lr = 1e-3


def _clone(params) -> dict:
    return {k: v.detach().clone() for k, v in params.items()}


class DQN(Algorithm):
    def __init__(self, config: DQNConfig, device=None):
        super().__init__(config, device)
        self._rng = np.random.default_rng(config.seed)
        obs_dim = self.module_spec.observation_dim
        self.replay = ReplayBuffer(config.replay_buffer_capacity, obs_dim)
        # online net: the learner group's weights, taken each iteration and
        # set back after its updates (the group may be processes); target here
        self._params = on_device(self.learner_group.get_weights(), self.device)
        self._target = _clone(self._params)
        self._updates = 0
        self.optimizer = adam(config.lr)
        self._opt_state = None
        self._update_fn = self._build_update()

    def _build_update(self):
        n_hidden = len(self.module_spec.hidden)
        gamma = self.config.gamma
        double_q = self.config.double_q
        optimizer = self.optimizer

        def loss_fn(params, target_params, batch):
            q, _ = forward(params, batch["obs"], n_hidden)
            q_sel = take(q, batch["actions"])
            with torch.no_grad():
                q_next_t, _ = forward(target_params, batch["next_obs"], n_hidden)
                if double_q:
                    q_next_online, _ = forward(params, batch["next_obs"], n_hidden)
                    best = torch.argmax(q_next_online, dim=1)
                else:
                    best = torch.argmax(q_next_t, dim=1)
                q_target = take(q_next_t, best)
                td_target = batch["rewards"] + gamma * (1 - batch["terminals"]) * q_target
            return torch.mean((q_sel - td_target) ** 2), None

        def update(params, opt_state, target_params, batch):
            """One TD step in place; returns (params, opt_state, loss)."""
            loss, _, _ = grad_step(loss_fn, params, optimizer, opt_state, target_params, batch)
            return params, opt_state, loss

        return update

    def _epsilon(self) -> float:
        hi, lo = self.config.epsilon
        frac = min(1.0, self._total_env_steps / max(self.config.epsilon_timesteps, 1))
        return hi + (lo - hi) * frac

    def training_step(self) -> dict:
        # 1) sample: the env runner draws actions from a softmax over the
        # Q-head (Boltzmann exploration; the epsilon schedule is reported)
        weights = self.learner_group.get_weights()
        eps = self._epsilon()
        batch, env_metrics = self.env_runner_group.sample(weights=weights)
        self.replay.add_batch(
            batch["obs"],
            batch["actions"],
            batch["rewards"],
            batch["next_obs"],
            batch["terminals"],
        )

        stats = {"epsilon": eps}
        if self.replay.size >= self.config.num_steps_sampled_before_learning_starts:
            params = self._params = on_device(weights, self.device)
            if self._opt_state is None:
                self._opt_state = self.optimizer.init(params)
            loss = torch.zeros(())
            for _ in range(self.config.num_updates_per_iteration):
                mb = self.replay.sample(self.config.train_batch_size, self._rng)
                params, self._opt_state, loss = self._update_fn(
                    params, self._opt_state, self._target, to_device(mb, self.device)
                )
                self._updates += 1
                if self._updates % self.config.target_network_update_freq == 0:
                    self._target = _clone(params)
            self.learner_group.set_weights(params)
            stats["td_loss"] = float(loss)
        return {
            "env_runners": env_metrics,
            "learner": stats,
            "episode_return_mean": env_metrics["episode_return_mean"],
            "num_env_steps_sampled": env_metrics["num_env_steps"],
            "replay_size": self.replay.size,
        }
