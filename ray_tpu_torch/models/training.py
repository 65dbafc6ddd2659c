"""Train-step builder: the counterpart of ``ray_tpu/models/training.py``.

One device per rank, and data parallelism over a torch process group
(``dp_group``), the counterpart of the JAX step over ``MeshSpec(dp=-1)``;
the fsdp/tensor axes come with the port's multi-device slice. The step is
eager PyTorch: ``loss_fn``'s forward (per-layer ``torch.utils.checkpoint``
when ``cfg.remat``), ``torch.autograd.grad``, then ``default_optimizer``'s
update applied to the params in place.

Under a group of more than one rank the loss is the global batch's masked
mean, as XLA computes it over the global batch: the mask sums are
all-reduced first, each rank divides its local masked sum by that count,
and the gradients are all-reduced (SUM) before the clip. The clip and
AdamW then see the same global gradients on every rank, so the params stay
equal across ranks. (A mean of per-rank means would be wrong when the
masks differ.)

``default_optimizer`` mirrors the optax chain the JAX package builds,
value for value and step for step: ``warmup_cosine_decay_schedule`` ->
``clip_by_global_norm`` -> ``adamw`` (b1 0.9, b2 0.95, eps 1e-8, eps_root
0, decoupled weight decay on every leaf, moments in each param's dtype).
It is a small functional ``init(params)`` / ``update(grads, state, params)``
in plain torch, not ``torch.optim.AdamW``, whose bias correction, epsilon
placement and clipping (``clip_grad_norm_`` adds 1e-6 to the norm) differ.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Union

import torch
import torch.distributed as dist

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models.llama import LlamaConfig, init_params, loss_fn

H100_BF16_DENSE_FLOPS = 989e12  # H100 SXM data sheet, dense bf16, at 700 W


def warmup_cosine_decay_schedule(
    init_value: float, peak_value: float, warmup_steps: int, decay_steps: int,
    end_value: float = 0.0, exponent: float = 1.0,
) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule: linear from ``init_value`` to
    ``peak_value`` over ``warmup_steps``, then cosine decay to
    ``end_value`` over ``decay_steps - warmup_steps`` (``decay_steps``
    counts the warmup)."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed warmup_steps {warmup_steps}")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, cos_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * c / cos_steps))
        return peak_value * ((1 - alpha) * cosine**exponent + alpha)

    return schedule


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, as an fp32 0-d tensor
    (optax.global_norm; summed in fp32 for bf16 leaves too)."""
    sq = [torch.linalg.vector_norm(t, dtype=torch.float32).square() for t in tensors]
    return torch.stack(sq).sum().sqrt()


class AdamWClipped:
    """optax.chain(clip_by_global_norm(grad_clip), adamw(schedule, b1, b2,
    weight_decay=...)) with optax's eps 1e-8 and eps_root 0, as a functional
    pair. ``update`` returns (updates, state); the caller adds the updates
    to the params (``apply_updates``). A caller that has already taken the
    gradients' global norm passes it as ``g_norm``, so it is reduced once. The update count is a host integer,
    so the schedule costs no device round trip. Every operation runs in the
    params' dtype, one torch op per optax op, except the clip's norm, which
    is summed in fp32."""

    EPS = 1e-8

    def __init__(self, schedule: Callable[[int], float], b1: float, b2: float,
                 weight_decay: float, grad_clip: float):
        self.schedule = schedule
        self.b1, self.b2 = b1, b2
        self.weight_decay, self.grad_clip = weight_decay, grad_clip

    def init(self, params: dict) -> dict:
        with torch.no_grad():
            return {
                "count": 0,
                "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()},
            }

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict,
               g_norm: Optional[torch.Tensor] = None):
        names = list(grads)
        if g_norm is None:
            g_norm = global_norm(grads[k] for k in names)
        # clip_by_global_norm: where(norm < clip, g, g / norm * clip)
        keep = g_norm < self.grad_clip
        gs = [torch.where(keep, g, g / g_norm.to(g.dtype) * self.grad_clip)
              for g in (grads[k] for k in names)]
        mus = [state["mu"][k] for k in names]
        nus = [state["nu"][k] for k in names]
        # new moments, in place: (1 - b) * g^order + b * m
        torch._foreach_mul_(mus, self.b1)
        torch._foreach_add_(mus, gs, alpha=1 - self.b1)
        torch._foreach_mul_(nus, self.b2)
        torch._foreach_addcmul_(nus, gs, gs, value=1 - self.b2)
        count = state["count"]
        count_inc = count + 1
        bc1, bc2 = 1 - self.b1**count_inc, 1 - self.b2**count_inc
        lr = self.schedule(count)  # optax evaluates it at the count before the update
        updates = {}
        for k, mu, nu in zip(names, mus, nus):
            u = mu / torch.tensor(bc1, dtype=mu.dtype)
            u = u / ((nu / torch.tensor(bc2, dtype=nu.dtype)).sqrt_().add_(self.EPS))
            u = u + self.weight_decay * params[k]
            updates[k] = torch.tensor(-lr, dtype=u.dtype) * u
        return updates, {"count": count_inc, "mu": state["mu"], "nu": state["nu"]}


def apply_updates(params: dict, updates: dict) -> None:
    """params += updates, in place (optax.apply_updates, without a copy)."""
    with torch.no_grad():
        for k, u in updates.items():
            params[k].add_(u)


def default_optimizer(
    learning_rate: float = 3e-4,
    weight_decay: float = 0.1,
    warmup_steps: int = 100,
    total_steps: int = 10000,
    b1: float = 0.9,
    b2: float = 0.95,
    grad_clip: float = 1.0,
) -> AdamWClipped:
    sched = warmup_cosine_decay_schedule(
        0.0, learning_rate, warmup_steps, max(total_steps, warmup_steps + 1)
    )
    return AdamWClipped(sched, b1=b1, b2=b2, weight_decay=weight_decay, grad_clip=grad_clip)


class TrainState:
    """params (dict of tensors), opt_state, step (a host integer)."""

    def __init__(self, params: dict, opt_state, step: int = 0):
        self.params = params
        self.opt_state = opt_state
        self.step = step

    def state_dict(self) -> dict:
        """{"params", "opt_state", "step"}: what ``train.save_state_dict``
        stores and ``from_state_dict`` takes back."""
        return {"params": self.params, "opt_state": self.opt_state, "step": self.step}

    @classmethod
    def from_state_dict(cls, d: dict) -> "TrainState":
        return cls(d["params"], d["opt_state"], d["step"])


def _mask_count(batch, device) -> torch.Tensor:
    """The count ``loss_fn`` divides by, before its clamp: the mask's sum
    over the predicted positions, else their number (fp32, 0-d)."""
    mask = batch.get("mask")
    if "labels" in batch:
        n = batch["labels"].shape
    else:
        n = (batch["tokens"].shape[0], batch["tokens"].shape[1] - 1)
        mask = None if mask is None else mask[:, 1:]
    if mask is None:
        return torch.tensor(float(n[0] * n[1]), device=device)
    return torch.as_tensor(mask, device=device).float().sum()


def make_train_step(
    cfg: LlamaConfig,
    optimizer=None,
    loss: Optional[Callable] = None,
    device: Union[str, torch.device, None] = None,
    dp_group: Optional["dist.ProcessGroup"] = None,
):
    """Returns (init_fn(seed) -> TrainState, step_fn(state, batch) -> (state,
    metrics)).

    ``dp_group``: the data-parallel process group (each rank passes its own
    shard of the global batch), or None for one device. With more than one
    rank the step is the global batch's (module docstring); ``loss`` is
    then called with ``denom=`` the global count, and ``metrics["loss"]``
    is the global loss. MoE raises under more than one rank: the Switch aux
    loss is a product of global routing statistics, which belongs to the
    multi-device slice.

    ``metrics`` holds ``loss`` (0-d tensor), ``grad_norm`` (the global norm
    of the gradients before clipping, 0-d fp32 tensor) and ``step``. The
    step updates ``state.params`` and the optimizer's moments IN PLACE and
    returns the same state object: the port's counterpart of the JAX
    step's donated buffers. Nothing in the step waits for the device;
    reading ``metrics["loss"]`` does. ``device`` (for ``init_fn``) is CUDA
    unless the caller names another (``resolve_device``); the step runs
    where the params are."""
    optimizer = optimizer or default_optimizer()
    loss = loss or loss_fn
    dp = dp_group is not None and dist.get_world_size(dp_group) > 1
    if dp and cfg.moe_experts:
        raise NotImplementedError(
            "MoE under data parallelism is not ported: the aux loss needs the global "
            "routing statistics (ray_tpu/parallel/moe.py:_route), a multi-device slice"
        )

    def init_fn(seed: int = 0) -> TrainState:
        params = init_params(cfg, seed, resolve_device(device))
        return TrainState(params, optimizer.init(params), 0)

    def step_fn(state: TrainState, batch):
        names = list(state.params)
        leaves = [state.params[k].requires_grad_(True) for k in names]
        if dp:
            count = _mask_count(batch, leaves[0].device)
            dist.all_reduce(count, group=dp_group)
            lval = loss(state.params, batch, cfg, denom=count.clamp(min=1))
        else:
            lval = loss(state.params, batch, cfg)
        grads = dict(zip(names, torch.autograd.grad(lval, leaves)))
        lval = lval.detach()
        if dp:
            for g in grads.values():
                dist.all_reduce(g, group=dp_group)
            dist.all_reduce(lval, group=dp_group)
        gnorm = global_norm(grads.values())
        updates, state.opt_state = optimizer.update(grads, state.opt_state, state.params,
                                                    g_norm=gnorm)
        apply_updates(state.params, updates)
        state.step += 1
        return state, {"loss": lval, "grad_norm": gnorm, "step": state.step}

    return init_fn, step_fn


def tokens_per_step(cfg: LlamaConfig, batch_size: int, seq_len: int) -> int:
    return batch_size * seq_len


def flops_per_token(cfg: LlamaConfig) -> float:
    """Approximate train FLOPs/token (fwd+bwd ~ 6 x params + attention)."""
    attn = 12 * cfg.n_layers * cfg.d_model * cfg.max_seq_len  # per token, rough
    return 6.0 * cfg.num_params() + attn


def mfu(cfg: LlamaConfig, tokens_per_sec: float, n_chips: int,
        peak_flops: float = H100_BF16_DENSE_FLOPS) -> float:
    """Model FLOPs utilization against the card's peak (default: the H100
    SXM's dense bf16 989 TFLOP/s)."""
    return tokens_per_sec * flops_per_token(cfg) / (n_chips * peak_flops)
