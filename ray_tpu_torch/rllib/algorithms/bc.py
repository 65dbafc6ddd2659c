"""Offline RL: behavior cloning and MARWIL.

Counterpart of ``ray_tpu/rllib/algorithms/bc.py`` (reference:
``rllib/algorithms/bc/bc.py`` + ``rllib/algorithms/marwil/``): learn a
policy from logged experience with NO environment interaction during
training; the environment appears only for periodic evaluation.

MARWIL is BC with exponential advantage weighting ``exp(beta * A)`` (Wang
et al.); ``beta=0`` reduces exactly to BC. ``record_experience`` returns
``ExperienceRows`` (the JAX package returns a ray_tpu Dataset, which the
port does not import); ``offline_data`` takes any object with
``iter_rows()``, a ray_tpu Dataset included.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import adam, grad_step, take, to_device
from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec, forward


class ExperienceRows:
    """Logged rows {obs, actions, advantages, logp_old}: ``iter_rows()``
    and ``count()``, the part of a Dataset that BC reads."""

    def __init__(self, rows: list):
        self._rows = rows

    def iter_rows(self):
        return iter(self._rows)

    def count(self) -> int:
        return len(self._rows)


def record_experience(
    env_id: str,
    *,
    num_fragments: int = 10,
    num_envs: int = 4,
    rollout_fragment_length: int = 100,
    weights: Optional[dict] = None,
    hidden=(64, 64),
    seed: int = 0,
) -> ExperienceRows:
    """Collect logged experience (reference: ``rllib/offline`` output
    writers) with a CPU env runner. With ``weights=None`` the behavior
    policy is a random-init module."""
    from ray_tpu_torch.rllib.env.env_runner import SingleAgentEnvRunner, env_dims

    obs_dim, act_dim = env_dims(env_id)
    spec = RLModuleSpec(observation_dim=obs_dim, action_dim=act_dim, hidden=hidden)
    runner = SingleAgentEnvRunner(
        env_id,
        spec,
        num_envs=num_envs,
        rollout_fragment_length=rollout_fragment_length,
        seed=seed,
    )
    if weights is not None:
        runner.set_weights(weights)
    rows = []
    for _ in range(num_fragments):
        batch = runner.sample()["batch"]
        for i in range(len(batch["actions"])):
            rows.append(
                {
                    "obs": batch["obs"][i],
                    "actions": int(batch["actions"][i]),
                    "advantages": float(batch["advantages"][i]),
                    "logp_old": float(batch["logp_old"][i]),
                }
            )
    return ExperienceRows(rows)


class BCConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=BC)
        self.beta = 0.0  # 0 = plain BC; >0 = MARWIL advantage weighting
        self.lr = 1e-3
        self.train_batch_size = 256
        self.num_updates_per_iteration = 50
        self.evaluation_interval = 1  # env-eval every N train() calls
        self.dataset = None

    def offline_data(self, dataset) -> "BCConfig":
        """The logged experience (rows with obs/actions[/advantages])."""
        self.dataset = dataset
        return self


class MARWILConfig(BCConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = MARWIL
        self.beta = 1.0


class BC(Algorithm):
    """Trains purely from the dataset; the env runner exists only for
    evaluation rollouts (reference: BC's evaluation workers)."""

    def __init__(self, config: BCConfig, device=None):
        super().__init__(config, device)
        if config.dataset is None:
            raise ValueError("BCConfig.offline_data(dataset) is required")
        self.optimizer = adam(config.lr)
        self._pull_params()
        self._update_fn = self._build_update()
        self._rng = np.random.default_rng(config.seed)
        self._rows = self._load_rows(config.dataset)
        self._dev_rows = to_device(self._rows, self.device)

    def set_state(self, state: dict):
        """The parameters come back from the restored learner group; the
        optimizer moments restart fresh, as IMPALA's do."""
        super().set_state(state)
        self._pull_params()

    @staticmethod
    def _load_rows(dataset) -> dict:
        """Materialize the offline dataset into host arrays once."""
        obs, actions, advs = [], [], []
        for row in dataset.iter_rows():
            obs.append(np.asarray(row["obs"], np.float32))
            actions.append(int(row["actions"]))
            advs.append(float(row.get("advantages", 0.0)))
        return {
            "obs": np.stack(obs),
            "actions": np.asarray(actions, np.int64),
            "advantages": np.asarray(advs, np.float32),
        }

    def _build_update(self):
        n_hidden = len(self.module_spec.hidden)
        beta = self.config.beta
        optimizer = self.optimizer

        def loss_fn(params, batch):
            logits, _ = forward(params, batch["obs"], n_hidden)
            act_logp = take(F.log_softmax(logits, dim=-1), batch["actions"])
            if beta > 0.0:
                # MARWIL: advantage-exponential imitation weights, clipped
                # for stability (reference marwil.py c=20)
                w = torch.exp(torch.clamp(beta * batch["advantages"], -20.0, 20.0))
                return -torch.mean(w * act_logp), None
            return -torch.mean(act_logp), None

        def update(params, opt_state, batch):
            """One imitation step in place; (params, opt_state, loss)."""
            loss, _, _ = grad_step(loss_fn, params, optimizer, opt_state, batch)
            return params, opt_state, loss

        return update

    def training_step(self) -> dict:
        n = len(self._rows["actions"])
        loss = torch.zeros(())
        for _ in range(self.config.num_updates_per_iteration):
            idx = self._rng.integers(0, n, self.config.train_batch_size)
            idx = torch.from_numpy(idx).to(self.device)
            mb = {k: v[idx] for k, v in self._dev_rows.items()}
            _, self._opt_state, loss = self._update_fn(self._params, self._opt_state, mb)
        self.learner_group.set_weights(self._params)

        result: dict[str, Any] = {
            "learner": {"imitation_loss": float(loss)},
            "num_env_steps_sampled": 0,  # offline: no env interaction
            "dataset_size": n,
            "episode_return_mean": float("nan"),
        }
        if (
            self.config.evaluation_interval
            and (self.iteration + 1) % self.config.evaluation_interval == 0
        ):
            _, metrics = self.env_runner_group.sample(weights=self.learner_group.get_weights())
            result["episode_return_mean"] = metrics["episode_return_mean"]
            result["evaluation"] = metrics
        return result


class MARWIL(BC):
    pass
