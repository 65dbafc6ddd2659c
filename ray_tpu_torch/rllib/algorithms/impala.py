"""IMPALA: asynchronous sampling with a V-trace-corrected learner.

Counterpart of ``ray_tpu/rllib/algorithms/impala.py`` (reference:
``rllib/algorithms/impala/impala.py:599``, the async sample -> learner
pipeline, and the V-trace importance weighting of Espeholt et al.,
``rllib/algorithms/impala/vtrace``).

The pipeline is the JAX package's: one outstanding ``sample`` per runner
process (``env/env_runner.py:EnvRunnerGroup``). ``training_step`` waits
for whichever runner finishes first, resubmits it AT ONCE (pushing the
current weights every ``broadcast_interval`` batches), and only then runs
the V-trace update on the algorithm's device (the card unless
``device="cpu"``), so every update overlaps the runners' sampling. The
lag that makes is what V-trace's clipped ratios correct for. With
``num_env_runners=0`` it samples locally, one update per fragment.

The algorithm's parameters are its own tensors, taken from the learner
group at the start and after a restore and set back on it after every
iteration, as in the JAX package; the runners get host copies, made once
per push (one for all runners at the first submit).

The reverse ``lax.scan`` of the targets is a loop over T on detached
tensors: the targets enter the loss only under ``stop_gradient``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._private.process_actor import ActorError, get, wait
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import adam, grad_step, host_copy, take, to_device
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
        # batches consumed per training_step and weight-push cadence
        self.num_batches_per_iteration = 8
        self.broadcast_interval = 1
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
        super().__init__(config, device)
        self.optimizer = adam(config.lr, grad_clip=config.grad_clip)
        self._pull_params()
        self._update_fn = self._build_update()
        self._batches_consumed = 0
        # pending sample -> runner index: the one in flight per runner
        self._inflight: dict = {}

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

    # -- async pipeline ------------------------------------------------------

    def _runners(self) -> list:
        return self.env_runner_group.runners

    def _submit(self, i: int, weights: Optional[dict] = None):
        """Send runner ``i`` a sample, after ``weights`` (host copies) when
        given."""
        runner = self._runners()[i]
        if weights is not None:
            runner.call("set_weights", weights)
        self._inflight[runner.call("sample")] = i

    def _next_batch(self, timeout: float = 300.0) -> Optional[dict]:
        """Async consume: wait for ANY runner, resubmit it at once (so it
        samples during the coming update), return its output."""
        for _ in range(3):
            ready, _ = wait(list(self._inflight), num_returns=1, timeout=timeout)
            if not ready:
                raise TimeoutError("no env-runner batch within timeout")
            i = self._inflight.pop(ready[0])
            push = self._batches_consumed % self.config.broadcast_interval == 0
            try:
                out = get(ready[0])
            except ActorError:
                # fault tolerance: replace the runner, keep the pipeline full
                self.env_runner_group.replace_runner(i)
                self._submit(i, host_copy(self._params))
                continue
            self._submit(i, host_copy(self._params) if push else None)
            return out
        return None

    def _update(self, out: dict) -> float:
        _, self._opt_state, loss, _ = self._update_fn(
            self._params, self._opt_state, to_device(out["seq"], self.device))
        self._batches_consumed += 1
        return float(loss)

    def training_step(self) -> dict:
        if not self._runners():
            return self._training_step_sync()
        if not self._inflight:
            weights = host_copy(self._params)
            for i in range(len(self._runners())):
                self._submit(i, weights)
        losses, metrics_list = [], []
        for _ in range(self.config.num_batches_per_iteration):
            out = self._next_batch()
            if out is None:
                continue
            losses.append(self._update(out))
            metrics_list.append(out["metrics"])
        self.learner_group.set_weights(self._params)
        return self._result(losses, metrics_list)

    def _training_step_sync(self) -> dict:
        """``num_env_runners=0``: local sampling, one V-trace update."""
        runner = self.env_runner_group.local_runner
        runner.set_weights(host_copy(self._params))
        out = runner.sample()
        loss = self._update(out)
        self.learner_group.set_weights(self._params)
        return self._result([loss], [out["metrics"]])

    def _result(self, losses: list, metrics_list: list) -> dict:
        returns = [m["episode_return_mean"] for m in metrics_list
                   if not np.isnan(m["episode_return_mean"])]
        return {
            "learner": {
                "total_loss": float(np.mean(losses)) if losses else float("nan"),
                "num_batches_consumed_lifetime": self._batches_consumed,
            },
            "episode_return_mean": float(np.mean(returns)) if returns else float("nan"),
            "num_env_steps_sampled": sum(m["num_env_steps"] for m in metrics_list),
            "num_in_flight_samples": len(self._inflight),
        }

    def set_state(self, state: dict):
        """The parameters come back from the learner group (each iteration
        pushes them there, so stale ones would wipe a restored checkpoint);
        the optimizer moments restart fresh, as the JAX package's do (its
        pytree checkpoint keeps no IMPALA optimizer state)."""
        super().set_state(state)
        self._pull_params()
        self._batches_consumed = int(state.get("batches_consumed", 0))

    def get_state(self) -> dict:
        state = super().get_state()
        state["batches_consumed"] = self._batches_consumed
        return state

    def stop(self):
        self._inflight.clear()
        super().stop()
