"""PPO: counterpart of ``ray_tpu/rllib/algorithms/ppo.py`` (reference:
``rllib/algorithms/ppo/ppo.py:388`` training_step).

training_step = sample (the local env runner, GAE in the runner) → learner update
(minibatch SGD epochs over the clipped surrogate) → weight sync back to the
runners. The loss lives in ``core/learner.py``.
"""

from __future__ import annotations

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig


class PPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=PPO)
        self.clip_param = 0.2
        self.vf_coeff = 0.5
        self.entropy_coeff = 0.0
        self.grad_clip = 0.5
        self.vf_clip_param = 10.0
        self.lambda_ = 0.95


class PPO(Algorithm):
    supports_pixel_obs = True  # the PPO learner uses the spec's conv arch

    def _learner_kwargs(self) -> dict:
        c = self.config
        return {
            "lr": c.lr,
            "clip_param": getattr(c, "clip_param", 0.2),
            "vf_coeff": getattr(c, "vf_coeff", 0.5),
            "entropy_coeff": getattr(c, "entropy_coeff", 0.0),
            "grad_clip": getattr(c, "grad_clip", 0.5),
            "vf_clip_param": getattr(c, "vf_clip_param", 10.0),
            "seed": c.seed,
        }

    def training_step(self) -> dict:
        if self.is_multi_agent:
            return self._multi_agent_training_step()
        weights = self.learner_group.get_weights()
        batch, env_metrics = self.env_runner_group.sample(weights=weights)
        learner_stats = self.learner_group.update_from_batch(
            batch,
            minibatch_size=self.config.minibatch_size,
            num_epochs=self.config.num_epochs,
        )
        return {
            "env_runners": env_metrics,
            "learner": learner_stats,
            "episode_return_mean": env_metrics["episode_return_mean"],
            "num_env_steps_sampled": env_metrics["num_env_steps"],
        }

    def _multi_agent_training_step(self) -> dict:
        """Per-policy PPO updates over one multi-agent sample (reference:
        the multi-module Learner update, ``multi_rl_module.py``)."""
        weights = {
            pid: lg.get_weights() for pid, lg in self.learner_groups.items()
        }
        batches, env_metrics = self.env_runner_group.sample(weights=weights)
        learner_stats = {}
        for pid, batch in batches.items():
            learner_stats[pid] = self.learner_groups[pid].update_from_batch(
                batch,
                minibatch_size=self.config.minibatch_size,
                num_epochs=self.config.num_epochs,
            )
        return {
            "env_runners": env_metrics,
            "learner": learner_stats,
            "episode_return_mean": env_metrics["episode_return_mean"],
            "num_env_steps_sampled": env_metrics["num_env_steps"],
        }
