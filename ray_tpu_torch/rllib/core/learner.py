"""TorchLearner: the PPO gradient step.

Counterpart of ``ray_tpu/rllib/core/learner.py:JaxLearner`` (reference:
``rllib/core/learner/learner.py:107`` + ``torch_learner.py:67``). Eager
PyTorch on the learner's device (the card unless the caller asks for the
CPU): the PPO loss, ``torch.autograd.grad``, then ``adam``'s update in
place.

``adam`` is ``optax.chain(clip_by_global_norm(grad_clip), adam(lr))`` as
the JAX algorithms build it: the train step's ``AdamWClipped``
(``models/training.py``) at a constant rate and no weight decay, not
``torch.optim.Adam`` with ``clip_grad_norm_``, whose clip divides by
``norm + 1e-6``. Its state is ``{"count", "mu", "nu"}`` in optax's terms,
whose sorted keys flatten in the order of optax's ``(EmptyState(),
(ScaleByAdamState(count, mu, nu), EmptyState()))``; the count is a host
int that ``get_state`` hands out as optax's int32 0-d array. So a JAX PPO
checkpoint restores into the port through ``train/checkpoint.py``'s
template.

With ``mesh=`` (``parallel/mesh.py:build_mesh(MeshSpec(dp=n))``) every dp
rank takes its contiguous rows of each minibatch, as JAX's
``NamedSharding(mesh, PartitionSpec("dp"))`` places them; the loss is the
global mean (each rank's mean over equal shares, averaged), the gradients
are all-reduced over ``dp`` before the clip and the parameters stay
replicated: what ``JaxLearner(mesh=)`` gets from GSPMD.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models.training import AdamWClipped, apply_updates, global_norm
from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec, forward

PPO_KEYS = ("obs", "actions", "logp_old", "advantages", "value_targets")


# optax.adam's defaults, which every RL algorithm takes
ADAM_B1, ADAM_B2 = 0.9, 0.999


def adam(lr: float, grad_clip: Optional[float] = None) -> AdamWClipped:
    """``optax.chain(clip_by_global_norm(grad_clip), adam(lr))``, as the JAX
    algorithms build it (no clip when ``grad_clip`` is None): the train
    step's ``AdamWClipped`` at a constant rate and no weight decay."""
    return AdamWClipped(lambda count: lr, ADAM_B1, ADAM_B2, weight_decay=0.0, grad_clip=grad_clip)


def opt_state_to_host(state: dict) -> dict:
    """numpy copies in optax's terms: the count an int32 0-d array."""
    return {
        "count": np.asarray(state["count"], dtype=np.int32),
        "mu": {k: v.detach().cpu().numpy().copy() for k, v in state["mu"].items()},
        "nu": {k: v.detach().cpu().numpy().copy() for k, v in state["nu"].items()},
    }


def opt_state_from_host(state: dict, device) -> dict:
    """The inverse of ``opt_state_to_host`` (the count back to a host int)."""
    def t(v):
        return torch.as_tensor(np.asarray(v)).to(device=device, dtype=torch.float32).clone()

    return {"count": int(state["count"]),
            "mu": {k: t(v) for k, v in state["mu"].items()},
            "nu": {k: t(v) for k, v in state["nu"].items()}}


def grad_step(loss_fn, params: dict, optimizer: AdamWClipped, opt_state: dict, *args,
              group=None, group_size: int = 1):
    """``loss_fn(params, *args) -> (loss, aux)``; its gradient with respect
    to ``params`` (all-reduced and averaged over ``group`` when there is
    one) goes through ``optimizer``, updating ``params`` and ``opt_state``
    in place. Returns (loss, aux, the gradients' global norm before the
    clip)."""
    leaves = [p if p.requires_grad else p.requires_grad_() for p in params.values()]
    loss, aux = loss_fn(params, *args)
    # a leaf the loss does not reach (DQN's and BC's value head) gets a
    # zero gradient, as jax.grad gives it
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    if group is not None:
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        flat /= group_size
        grads = [g.view_as(p) for g, p in zip(flat.split([p.numel() for p in leaves]), leaves)]
    grads = dict(zip(params, grads))
    norm = global_norm(grads.values())
    updates, new_state = optimizer.update(grads, opt_state, params, g_norm=norm)
    apply_updates(params, updates)
    opt_state["count"] = new_state["count"]  # the moments were updated in place
    return loss.detach(), aux, norm


def take(logp_all: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(logp_all, actions[..., None], -1)[..., 0]``."""
    return logp_all.gather(-1, actions.long().unsqueeze(-1)).squeeze(-1)


def ppo_loss(params, batch: dict, arch, hp: dict):
    """The JAX learner's loss (``learner.py:59-93``): clipped surrogate,
    clipped value error, entropy, mean KL. Returns (total, stats)."""
    logits, value = forward(params, batch["obs"], arch)
    logp_all = F.log_softmax(logits, dim=-1)
    logp = take(logp_all, batch["actions"])
    ratio = torch.exp(logp - batch["logp_old"])
    adv = batch["advantages"]
    clip = hp["clip_param"]
    surr = torch.minimum(ratio * adv, torch.clamp(ratio, 1 - clip, 1 + clip) * adv)
    policy_loss = -torch.mean(surr)
    vf_err = torch.clamp(value - batch["value_targets"], -hp["vf_clip_param"], hp["vf_clip_param"])
    vf_loss = torch.mean(vf_err**2)
    entropy = -torch.mean(torch.sum(F.softmax(logits, dim=-1) * logp_all, dim=-1))
    total = policy_loss + hp["vf_coeff"] * vf_loss - hp["entropy_coeff"] * entropy
    stats = {
        "policy_loss": policy_loss,
        "vf_loss": vf_loss,
        "entropy": entropy,
        "mean_kl": torch.mean(batch["logp_old"] - logp),
        "total_loss": total,
    }
    return total, stats


def on_device(weights: dict, device) -> dict:
    """Host weights as new tensors on ``device``: an algorithm's own
    parameters, taken from its learner group."""
    return {k: torch.tensor(np.asarray(v), device=device) for k, v in weights.items()}


def host_copy(params: dict) -> dict:
    """One numpy copy of each tensor: what goes to a learner group or a
    runner process."""
    return {k: v.detach().to("cpu", copy=True).numpy() for k, v in params.items()}


def to_device(arrays: dict, device) -> dict:
    """Host arrays as tensors on ``device`` (integer columns as int64)."""
    out = {}
    for k, v in arrays.items():
        a = np.asarray(v)
        a = a.astype(np.int64) if a.dtype.kind in "iub" else a.astype(np.float32, copy=False)
        out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out


class TorchLearner:
    def __init__(
        self,
        module_spec: RLModuleSpec,
        *,
        lr: float = 3e-4,
        clip_param: float = 0.2,
        vf_coeff: float = 0.5,
        entropy_coeff: float = 0.0,
        grad_clip: float = 0.5,
        vf_clip_param: float = 10.0,
        seed: int = 0,
        mesh=None,
        device=None,
    ):
        if device is None and mesh is not None:
            device = mesh.device_type
        self.device = resolve_device(device)
        self.module = module_spec.build(seed, device=self.device)
        self.spec = module_spec
        self._group, self._dp, self._dp_rank = None, 1, 0
        if mesh is not None:
            self._group = mesh.get_group("dp")
            self._dp = dist.get_world_size(self._group)
            self._dp_rank = dist.get_rank(self._group)
        self.optimizer = adam(lr, grad_clip=grad_clip)
        self.opt_state = self.optimizer.init(self.module.params)
        self.hparams = dict(
            clip_param=clip_param,
            vf_coeff=vf_coeff,
            entropy_coeff=entropy_coeff,
            vf_clip_param=vf_clip_param,
        )
        self._rng = np.random.default_rng(seed)
        self._update = self._build_update()

    def _build_update(self):
        arch = self.spec.arch()
        hp = self.hparams
        optimizer = self.optimizer
        group, dp, rank = self._group, self._dp, self._dp_rank

        def update(params, opt_state, batch):
            """One minibatch step in place; ``batch`` is the global
            minibatch (a dp rank keeps its rows). Returns the stats as 0-d
            tensors, their global means on a mesh."""
            if group is not None:
                n = len(batch["obs"])
                if n % dp:
                    raise ValueError(f"minibatch of {n} rows does not split over dp={dp}")
                rows = slice(rank * n // dp, (rank + 1) * n // dp)
                batch = {k: v[rows] for k, v in batch.items()}
            _, stats, norm = grad_step(lambda p, b: ppo_loss(p, b, arch, hp), params,
                                       optimizer, opt_state, batch, group=group, group_size=dp)
            stats = {k: v.detach() for k, v in stats.items()}
            if group is not None:
                keys = list(stats)
                vals = torch.stack([stats[k] for k in keys])
                dist.all_reduce(vals, group=group)
                stats = dict(zip(keys, vals / dp))
            stats["grad_norm"] = norm
            return params, opt_state, stats

        return update

    # -- public -------------------------------------------------------------

    def update_from_batch(
        self, batch: dict, minibatch_size: Optional[int] = None, num_epochs: int = 1
    ) -> dict:
        n = len(batch["obs"])
        if n == 0:
            return {}
        # env runners attach extra transition keys (rewards/next_obs/...)
        # for value-based learners; the PPO loss consumes exactly these five
        dev = to_device({k: batch[k] for k in PPO_KEYS if k in batch}, self.device)
        minibatch_size = min(minibatch_size or n, n)
        rng = self._rng  # persistent: fresh permutations every iteration
        perms = torch.from_numpy(np.stack([rng.permutation(n) for _ in range(num_epochs)]))
        perms = perms.to(self.device)
        stats = {}
        for e in range(num_epochs):
            shuffled = {k: v[perms[e]] for k, v in dev.items()}
            for s in range(0, n - minibatch_size + 1, minibatch_size):
                mb = {k: v[s : s + minibatch_size] for k, v in shuffled.items()}
                _, _, stats = self._update(self.module.params, self.opt_state, mb)
        if not stats:
            return {}
        keys = list(stats)
        vals = torch.stack([stats[k].float() for k in keys]).cpu().tolist()
        return dict(zip(keys, vals))

    def get_weights(self) -> dict:
        return self.module.get_state()

    def set_weights(self, weights: dict):
        self.module.set_state(weights)

    def get_state(self) -> dict:
        return {
            "weights": self.get_weights(),
            "opt_state": opt_state_to_host(self.opt_state),
        }

    def set_state(self, state: dict):
        self.set_weights(state["weights"])
        self.opt_state = opt_state_from_host(state["opt_state"], self.device)

    def placement(self) -> list:
        """The device types holding the parameters and Adam's moments."""
        tensors = [*self.module.params.values(), *self.opt_state["mu"].values(),
                   *self.opt_state["nu"].values()]
        return sorted({t.device.type for t in tensors})
