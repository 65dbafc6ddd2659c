"""APPO: IMPALA's learner with PPO's clipped surrogate.

Counterpart of ``ray_tpu/rllib/algorithms/appo.py`` (reference:
``rllib/algorithms/appo/appo.py`` and ``appo/default_appo_rl_module.py``,
the target-network half). The update changes from IMPALA's:

- V-trace targets are computed under the TARGET network (a periodic
  snapshot of the learner), with importance ratios pi_target/pi_behavior.
- The policy gradient is PPO's clipped surrogate on ratio
  pi_current/pi_behavior against those V-trace advantages.
- Optionally a KL(target || current) penalty (``use_kl_loss``).

It runs IMPALA's asynchronous pipeline over runner processes, or its
synchronous path with ``num_env_runners=0``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ray_tpu_torch.rllib.algorithms.impala import IMPALA, IMPALAConfig, vtrace_targets
from ray_tpu_torch.rllib.core.learner import grad_step, take
from ray_tpu_torch.rllib.core.rl_module import forward


class APPOConfig(IMPALAConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = APPO
        # reference defaults: appo.py (clip 0.4; target net refreshed on a
        # cadence of learner updates)
        self.clip_param = 0.4
        self.target_network_update_freq = 4  # in learner updates
        self.use_kl_loss = False
        self.kl_coeff = 0.2
        self.lr = 5e-4


class APPO(IMPALA):
    _target_params = None
    _updates_since_target = 0

    def _build_update(self):
        n_hidden = len(self.module_spec.hidden)
        gamma = self.config.gamma
        rho_clip = self.config.vtrace_clip_rho_threshold
        pg_rho_clip = self.config.vtrace_clip_pg_rho_threshold
        clip = self.config.clip_param
        ent_c = self.config.entropy_coeff
        vf_c = self.config.vf_loss_coeff
        use_kl = self.config.use_kl_loss
        kl_c = self.config.kl_coeff
        optimizer = self.optimizer

        def loss_fn(params, target_params, seq):
            T, N, D = seq["obs"].shape
            obs = seq["obs"].reshape(T * N, D)
            logits, values = forward(params, obs, n_hidden)
            logits = logits.reshape(T, N, -1)
            values = values.reshape(T, N)
            logp_all = F.log_softmax(logits, dim=-1)
            logp = take(logp_all, seq["actions"])
            with torch.no_grad():
                # target network: V-trace targets + IS ratios live under the
                # snapshot, so the regression target doesn't chase the learner
                t_logits, t_values = forward(target_params, obs, n_hidden)
                t_logp_all = F.log_softmax(t_logits.reshape(T, N, -1), dim=-1)
                t_values = t_values.reshape(T, N)
                _, t_next_values = forward(target_params, seq["next_obs"].reshape(T * N, D),
                                           n_hidden)
                t_next_values = t_next_values.reshape(T, N) * (1.0 - seq["terminals"])
                vs, adv, _ = vtrace_targets(
                    t_values, t_next_values, seq["rewards"], seq["logp_behavior"],
                    take(t_logp_all, seq["actions"]), seq["ends"], gamma, rho_clip, pg_rho_clip)

            # PPO clipped surrogate on the current/behavior ratio
            ratio = torch.exp(logp - seq["logp_behavior"])
            surrogate = torch.minimum(ratio * adv, torch.clamp(ratio, 1.0 - clip, 1.0 + clip) * adv)
            pg_loss = -torch.mean(surrogate)
            vf_loss = 0.5 * torch.mean((vs - values) ** 2)
            entropy = -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, dim=-1))
            total = pg_loss + vf_c * vf_loss - ent_c * entropy
            if use_kl:
                kl = torch.mean(torch.sum(torch.exp(t_logp_all) * (t_logp_all - logp_all), dim=-1))
                total = total + kl_c * kl
            return total, (pg_loss.detach(), vf_loss.detach(), entropy.detach(),
                           torch.mean(ratio.detach()))

        def wrapped(params, opt_state, seq):
            """One step in place against the target snapshot, which is taken
            before the first update and every ``target_network_update_freq``
            updates; (params, opt_state, loss, aux)."""
            if self._target_params is None:
                self._target_params = {k: v.detach().clone() for k, v in params.items()}
            loss, aux, _ = grad_step(loss_fn, params, optimizer, opt_state,
                                     self._target_params, seq)
            self._updates_since_target += 1
            if self._updates_since_target >= self.config.target_network_update_freq:
                self._target_params = {k: v.detach().clone() for k, v in params.items()}
                self._updates_since_target = 0
            return params, opt_state, loss, aux

        return wrapped

    def set_state(self, state: dict):
        super().set_state(state)
        # re-snapshot: a restored learner must not chase a stale target
        self._target_params = None
        self._updates_since_target = 0

    def _result(self, losses: list, metrics_list: list) -> dict:
        out = super()._result(losses, metrics_list)
        out["learner"]["target_updates_pending"] = self._updates_since_target
        return out
