"""IMPALA: the V-trace-corrected learner.

Counterpart of ``ray_tpu/rllib/algorithms/impala.py`` (reference:
``rllib/algorithms/impala/impala.py:599`` and the V-trace importance
weighting of Espeholt et al., ``rllib/algorithms/impala/vtrace``). Only the
synchronous path is ported (the JAX package's ``_training_step_sync``,
``num_env_runners=0``): sample a fragment locally, one V-trace update on the
learner's device. The asynchronous pipeline keeps one sample in flight per
remote runner, actors of ray_tpu's runtime, and raises here.

The reverse ``lax.scan`` of the targets is a loop over T on detached
tensors: the targets enter the loss only under ``stop_gradient``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import adam, grad_step, take, to_device
from ray_tpu_torch.rllib.core.learner_group import remote_not_ported
from ray_tpu_torch.rllib.core.rl_module import forward


class IMPALAConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=IMPALA)
        self.num_env_runners = 2
        self.rollout_fragment_length = 50
        self.lr = 5e-4
        self.grad_clip = 40.0
        self.vtrace_clip_rho_threshold = 1.0
        self.vtrace_clip_pg_rho_threshold = 1.0
        self.entropy_coeff = 0.01
        self.vf_loss_coeff = 0.5
        self._emit_sequences = True


def vtrace_targets(values, next_values, rewards, logp_behavior, logp_target, ends, gamma,
                   rho_clip, pg_rho_clip):
    """(vs, pg_adv) of Espeholt et al. eq. 1, on detached [T, N] tensors:
    acc_t = delta_t + gamma c_t not_end_t acc_{t+1}, vs_t = V_t + acc_t, and
    the boundary-aware vs_{t+1} (the next step's vs inside the fragment;
    at fragment or episode end the ``next_values`` bootstrap)."""
    rho = torch.exp(logp_target - logp_behavior)
    rho_bar = torch.clamp(rho, max=rho_clip)
    c_bar = torch.clamp(rho, max=1.0)
    not_end = 1.0 - ends
    delta = rho_bar * (rewards + gamma * next_values - values)
    coef = gamma * c_bar * not_end
    acc = torch.zeros_like(values[0])
    accs = [acc] * len(values)
    for t in reversed(range(len(values))):
        acc = torch.addcmul(delta[t], coef[t], acc)
        accs[t] = acc
    vs = values + torch.stack(accs)
    vs_tp1 = torch.cat([vs[1:], next_values[-1:]], dim=0)
    vs_tp1 = torch.where(ends > 0, next_values, vs_tp1)
    pg_adv = torch.clamp(rho, max=pg_rho_clip) * (rewards + gamma * vs_tp1 - values)
    return vs, pg_adv, rho


class IMPALA(Algorithm):
    def __init__(self, config: IMPALAConfig, device=None):
        if config.num_env_runners > 0:
            raise remote_not_ported(
                f"{type(self).__name__}'s asynchronous pipeline over remote env runners "
                "(num_env_runners > 0; set 0 for the synchronous path)")
        super().__init__(config, device)
        # the learner's module, updated in place by this algorithm's update
        self._params = self.learner_group.learner.module.params
        self.optimizer = adam(config.lr, grad_clip=config.grad_clip)
        self._opt_state = self.optimizer.init(self._params)
        self._update_fn = self._build_update()
        self._batches_consumed = 0

    # -- v-trace update ------------------------------------------------------

    def _build_update(self):
        n_hidden = len(self.module_spec.hidden)
        gamma = self.config.gamma
        rho_clip = self.config.vtrace_clip_rho_threshold
        pg_rho_clip = self.config.vtrace_clip_pg_rho_threshold
        ent_c = self.config.entropy_coeff
        vf_c = self.config.vf_loss_coeff
        optimizer = self.optimizer

        def loss_fn(params, seq):
            T, N, D = seq["obs"].shape
            logits, values = forward(params, seq["obs"].reshape(T * N, D), n_hidden)
            logits = logits.reshape(T, N, -1)
            values = values.reshape(T, N)
            logp_all = F.log_softmax(logits, dim=-1)
            logp = take(logp_all, seq["actions"])
            with torch.no_grad():
                _, next_values = forward(params, seq["next_obs"].reshape(T * N, D), n_hidden)
                # V(s') is 0 past a true termination; for truncation next_obs
                # is the pre-reset state, so its value is the bootstrap
                next_values = next_values.reshape(T, N) * (1.0 - seq["terminals"])
                vs, pg_adv, rho = vtrace_targets(
                    values.detach(), next_values, seq["rewards"], seq["logp_behavior"],
                    logp.detach(), seq["ends"], gamma, rho_clip, pg_rho_clip)
            pg_loss = -torch.mean(pg_adv * logp)
            vf_loss = 0.5 * torch.mean((vs - values) ** 2)
            entropy = -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, dim=-1))
            total = pg_loss + vf_c * vf_loss - ent_c * entropy
            return total, (pg_loss.detach(), vf_loss.detach(), entropy.detach(), torch.mean(rho))

        def update(params, opt_state, seq):
            """One V-trace step in place; (params, opt_state, loss, aux)."""
            loss, aux, _ = grad_step(loss_fn, params, optimizer, opt_state, seq)
            return params, opt_state, loss, aux

        return update

    def training_step(self) -> dict:
        """Local sampling, one V-trace update per fragment (the JAX
        package's ``_training_step_sync``)."""
        runner = self.env_runner_group.local_runner
        runner.set_weights(self.learner_group.get_weights())
        out = runner.sample()
        _, self._opt_state, loss, _ = self._update_fn(
            self._params, self._opt_state, to_device(out["seq"], self.device)
        )
        self._batches_consumed += 1
        return self._result(float(loss), out["metrics"])

    def _result(self, loss: float, metrics: dict) -> dict:
        return {
            "learner": {
                "total_loss": loss,
                "num_batches_consumed_lifetime": self._batches_consumed,
            },
            "episode_return_mean": metrics["episode_return_mean"],
            "num_env_steps_sampled": metrics["num_env_steps"],
        }

    def set_state(self, state: dict):
        """The learner's weights come back in place; the optimizer moments
        restart fresh, as the JAX package's do (its pytree checkpoint keeps
        no IMPALA optimizer state)."""
        super().set_state(state)
        self._opt_state = self.optimizer.init(self._params)
        self._batches_consumed = int(state.get("batches_consumed", 0))

    def get_state(self) -> dict:
        state = super().get_state()
        state["batches_consumed"] = self._batches_consumed
        return state
