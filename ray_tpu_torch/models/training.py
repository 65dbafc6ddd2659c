"""Train-step builder: the counterpart of ``ray_tpu/models/training.py``.

One device per rank. Without a mesh the step runs on one device; with a
mesh (``parallel/mesh.py``: dp, fsdp, ep, pp, sp, tp) every rank runs it on
its shards, the counterpart of the JAX step over the same mesh. The step
is eager PyTorch: ``loss_fn``'s forward (per-layer
``torch.utils.checkpoint`` when ``cfg.remat``), ``torch.autograd.grad``,
then ``default_optimizer``'s update applied to the params in place.

On a mesh the loss is the global batch's masked mean, as XLA computes it
over the global batch: the mask sums are all-reduced first and each rank
back-propagates its share of the loss (a mean of per-rank means would be
wrong when the masks differ); each leaf's gradient is then summed over
the ranks that hold a copy of it, before the clip. The clip and AdamW see
the same global gradients on every copy, so copies stay equal.

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
from ray_tpu_torch.models.llama import LlamaConfig, init_params, loss_fn, param_specs
from ray_tpu_torch.parallel import mesh as pmesh

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


# Leaves of at most this many elements go through foreach ops, larger ones
# through one op a leaf: a foreach op saves launches over many small leaves
# (an RL update's, launch-bound), but its kernel moves a large bf16 leaf's
# bytes ~25% slower than the per-leaf kernel (tools/train_bench.py on the
# 1.2 B-param train config, one H100: every op foreach cost +4.3 ms a step).
FOREACH_MAX_NUMEL = 1 << 20


def _foreach_ok(t: torch.Tensor) -> bool:
    return t.numel() <= FOREACH_MAX_NUMEL


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, as an fp32 0-d tensor
    (optax.global_norm; summed in fp32 for bf16 leaves too)."""
    ts = list(tensors)
    small = [t for t in ts if _foreach_ok(t)]
    sq = [torch.linalg.vector_norm(t, dtype=torch.float32).square()
          for t in ts if not _foreach_ok(t)]
    if small:
        sq.append(torch.stack(torch._foreach_norm(small, 2, dtype=torch.float32)).square().sum())
    return torch.stack(sq).sum().sqrt()


class AdamWClipped:
    """optax.chain(clip_by_global_norm(grad_clip), adamw(schedule, b1, b2,
    weight_decay=...)) with optax's eps 1e-8 and eps_root 0, as a functional
    pair. ``update`` returns (updates, state); the caller adds the updates
    to the params (``apply_updates``). A caller that has already taken the
    gradients' global norm passes it as ``g_norm``, so it is reduced once. The update count is a host integer,
    so the schedule costs no device round trip. Every operation runs in the
    params' dtype, one torch op per optax op (a foreach op over the small
    leaves of a dtype, see ``FOREACH_MAX_NUMEL``), except the clip's norm,
    which is summed in fp32. ``grad_clip=None`` drops the clip and
    ``weight_decay=0`` the decay term: then it is optax's plain ``adam``,
    the RL algorithms' optimizer (``rllib/core/learner.py:adam``)."""

    EPS = 1e-8

    def __init__(self, schedule: Callable[[int], float], b1: float, b2: float,
                 weight_decay: float, grad_clip: Optional[float]):
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
        if self.grad_clip is not None:
            if g_norm is None:
                g_norm = global_norm(grads[k] for k in names)
            keep = g_norm < self.grad_clip
        count = state["count"]
        count_inc = count + 1
        bc1, bc2 = 1 - self.b1**count_inc, 1 - self.b2**count_inc
        lr = self.schedule(count)  # optax evaluates it at the count before the update
        groups: dict = {}
        for k in names:
            groups.setdefault((grads[k].dtype, _foreach_ok(grads[k])), []).append(k)
        updates = {}
        for (dtype, foreach), keys in groups.items():
            # optax casts each scalar to the leaf's dtype
            c1, c2, step = (torch.tensor(x, dtype=dtype) for x in (bc1, bc2, -lr))
            gs = [grads[k] for k in keys]
            if self.grad_clip is not None:
                # clip_by_global_norm: where(norm < clip, g, g / norm * clip)
                if foreach:
                    clipped = torch._foreach_div(gs, g_norm.to(dtype))
                    torch._foreach_mul_(clipped, self.grad_clip)
                else:
                    clipped = [g / g_norm.to(dtype) * self.grad_clip for g in gs]
                gs = [torch.where(keep, g, c) for g, c in zip(gs, clipped)]
            mus = [state["mu"][k] for k in keys]
            nus = [state["nu"][k] for k in keys]
            # new moments, in place: (1 - b) * g^order + b * m
            torch._foreach_mul_(mus, self.b1)
            torch._foreach_add_(mus, gs, alpha=1 - self.b1)
            torch._foreach_mul_(nus, self.b2)
            torch._foreach_addcmul_(nus, gs, gs, value=1 - self.b2)
            ps = [params[k] for k in keys]
            if foreach:  # the same ops; the scalars as python floats of the cast values
                u = torch._foreach_div(mus, c1.item())
                den = torch._foreach_div(nus, c2.item())
                torch._foreach_sqrt_(den)
                torch._foreach_add_(den, self.EPS)
                torch._foreach_div_(u, den)
                if self.weight_decay:
                    torch._foreach_add_(u, torch._foreach_mul(ps, self.weight_decay))
                torch._foreach_mul_(u, step.item())
            else:
                u = [mu / c1 / (nu / c2).sqrt_().add_(self.EPS) for mu, nu in zip(mus, nus)]
                if self.weight_decay:
                    u = [x + self.weight_decay * p for x, p in zip(u, ps)]
                u = [step * x for x in u]
            updates.update(zip(keys, u))
        return updates, {"count": count_inc, "mu": state["mu"], "nu": state["nu"]}


def apply_updates(params: dict, updates: dict) -> None:
    """params += updates, in place (optax.apply_updates, without a copy)."""
    with torch.no_grad():
        small = [k for k, u in updates.items() if _foreach_ok(u)]
        if small:
            torch._foreach_add_([params[k] for k in small], [updates[k] for k in small])
        for k, u in updates.items():
            if not _foreach_ok(u):
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


def batch_spec(mesh) -> tuple:
    """The input batch's PartitionSpec: batch over (dp, fsdp), sequence over
    sp (the JAX package's ``batch_sharding``, :42)."""
    return pmesh.logical_pspec(mesh, "batch", "seq")


def batch_index(mesh, cfg: LlamaConfig, B: int, T: int) -> tuple[torch.Tensor, slice]:
    """This rank's rows (a LongTensor) and sequence slice of a global [B, T]
    batch (``shard_batch``)."""
    sizes = pmesh.mesh_sizes(mesh)
    n = sizes["dp"] * sizes["fsdp"]
    M = (cfg.pp_microbatches or 2 * sizes["pp"]) if sizes["pp"] > 1 else 1
    if B % (M * n) or T % sizes["sp"]:
        raise ValueError(f"batch [{B}, {T}] does not split into {M} microbatches over {n} "
                         f"batch shards and {sizes['sp']} sequence shards")
    mb, d, t = B // (M * n), pmesh.axis_index(mesh, ("dp", "fsdp")), T // sizes["sp"]
    rows = torch.cat([torch.arange(m * (B // M) + d * mb, m * (B // M) + (d + 1) * mb)
                      for m in range(M)])
    j = mesh.get_local_rank("sp")
    return rows, slice(j * t, (j + 1) * t)


def shard_batch(batch: dict, mesh, cfg: LlamaConfig) -> dict:
    """This rank's shard of a global batch, as ``loss_fn(mesh=)`` takes it:
    {'tokens', 'labels'[, 'mask']} (labels shifted before the sequence is
    cut), rows over (dp, fsdp) and the sequence over sp. Under pp the rows
    are laid out as the JAX step's microbatches are sharded: microbatch m
    holds global rows [m B / M, (m + 1) B / M), each shard of (dp, fsdp)
    its slice of them; without pp that is the contiguous block
    ``batch_spec`` gives. The layout matters only where rows interact (MoE
    routing); a dense model gets the same loss from any assignment of rows."""
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    if "labels" not in batch:
        tok = batch["tokens"]
        batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:],
                 **({"mask": batch["mask"][:, 1:]} if "mask" in batch else {})}
    rows, cols = batch_index(mesh, cfg, *batch["tokens"].shape)
    return {k: v[rows][:, cols].contiguous() for k, v in batch.items()}


def _replicated_axes(spec: tuple, sizes: dict) -> tuple:
    """The mesh axes (size > 1) that a leaf of this spec is copied over."""
    used = {a for entry in spec for a in pmesh.spec_axes(entry)}
    return tuple(a for a in pmesh.AXIS_ORDER if sizes[a] > 1 and a not in used)


def make_train_step(
    cfg: LlamaConfig,
    optimizer=None,
    loss: Optional[Callable] = None,
    device: Union[str, torch.device, None] = None,
    dp_group: Optional["dist.ProcessGroup"] = None,
    mesh=None,
):
    """Returns (init_fn(seed) -> TrainState, step_fn(state, batch) -> (state,
    metrics)).

    ``mesh`` (``parallel.mesh.build_mesh``): every rank of it builds the
    step and calls it with its batch shard (``shard_batch``); ``init_fn``
    gives each rank its param shard (``init_params(mesh=)``) and AdamW's
    moments of the same shapes. The step back-propagates the rank's share
    of the loss (``loss_fn(mesh=)``), then sums each leaf's gradient over
    the mesh axes it is copied over (dp and fsdp for the data; pp for
    ``embed``, ``unembed`` and ``final_norm``, which every stage holds;
    tp, sp and ep where the leaf is not split), so every copy of a leaf
    steps identically. The clip's global norm counts each element once:
    each rank's squared norms over the copies of each leaf, summed over
    the world. ``metrics["loss"]`` is the global loss on every rank.

    ``dp_group``: a shorthand for ``MeshSpec(dp=world)`` over the default
    group (each rank passes its shard of the global batch; ``{'tokens':
    [B, T+1]}`` rows need no ``shard_batch``); None with no mesh is one
    device.

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
    if mesh is None and dp_group is not None and dist.get_world_size(dp_group) > 1:
        if dist.get_world_size(dp_group) != dist.get_world_size():
            raise ValueError("dp_group must span the default process group")
        mesh = pmesh.build_mesh(pmesh.MeshSpec(dp=-1), resolve_device(device).type)
    if mesh is not None:
        return _sharded_step(cfg, optimizer, loss, device, mesh)

    def init_fn(seed: int = 0) -> TrainState:
        params = init_params(cfg, seed, resolve_device(device))
        return TrainState(params, optimizer.init(params), 0)

    def step_fn(state: TrainState, batch):
        names = list(state.params)
        leaves = [state.params[k].requires_grad_(True) for k in names]
        lval = loss(state.params, batch, cfg)
        grads = dict(zip(names, torch.autograd.grad(lval, leaves)))
        gnorm = global_norm(grads.values())
        updates, state.opt_state = optimizer.update(grads, state.opt_state, state.params,
                                                    g_norm=gnorm)
        apply_updates(state.params, updates)
        state.step += 1
        return state, {"loss": lval.detach(), "grad_norm": gnorm, "step": state.step}

    return init_fn, step_fn


def _sharded_step(cfg: LlamaConfig, optimizer, loss: Callable, device, mesh):
    sizes = pmesh.mesh_sizes(mesh)
    specs = param_specs(cfg, mesh)
    copied = {k: _replicated_axes(s, sizes) for k, s in specs.items()}

    def init_fn(seed: int = 0) -> TrainState:
        params = init_params(cfg, seed, resolve_device(device), mesh=mesh)
        return TrainState(params, optimizer.init(params), 0)

    def step_fn(state: TrainState, batch):
        names = list(state.params)
        leaves = [state.params[k].requires_grad_(True) for k in names]
        share = loss(state.params, batch, cfg, mesh=mesh)
        grads = dict(zip(names, torch.autograd.grad(share, leaves)))
        sq = []
        for k in names:
            for axis in copied[k]:  # one axis at a time: copies end bit-equal
                dist.all_reduce(grads[k], group=pmesh.axis_group(mesh, axis))
            copies = math.prod(sizes[a] for a in copied[k])
            sq.append(torch.linalg.vector_norm(grads[k], dtype=torch.float32).square() / copies)
        norm_sq = torch.stack(sq).sum()
        lval = share.detach().clone()
        dist.all_reduce(norm_sq)
        dist.all_reduce(lval)
        gnorm = norm_sq.sqrt()
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
