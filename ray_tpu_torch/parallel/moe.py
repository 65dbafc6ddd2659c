"""Routed mixture-of-experts on one device: the counterpart of the
single-device half of ``ray_tpu/parallel/moe.py``.

Top-k routing with a fixed expert capacity (Switch-Transformer style):
each token's k chosen experts take it in token-major order until an
expert's C slots are full, and the overflow is dropped. ``_route`` gives
the JAX package's one-hot dispatch and combine tensors [G, E, C];
``moe_dense`` computes the same function with gathers instead of their
einsums: a [G, E, C] one-hot at the train shape (8192 x 8 x 2560) holds
168 M entries and its two products cost about as much as the expert
FFN, while the gather reads each kept token once and the combine sums at
most k rows per token.

The expert-parallel ``moe_layer`` (all-to-all over a mesh axis) comes
with the port's multi-device slice.
"""

from __future__ import annotations

from typing import Union

import torch
import torch.nn.functional as F

from ray_tpu_torch import resolve_device


def moe_init(
    num_experts: int, d_model: int, d_ff: int, seed: int = 0,
    dtype: torch.dtype = torch.float32, device: Union[str, torch.device, None] = None,
) -> dict[str, torch.Tensor]:
    """Params of a SwiGLU expert bank and its router, N(0, 1) x fan_in^-1/2
    as in the JAX package (the random bits differ)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    shapes = {
        "router": ((d_model, num_experts), d_model),
        "w_gate": ((num_experts, d_model, d_ff), d_model),
        "w_up": ((num_experts, d_model, d_ff), d_model),
        "w_down": ((num_experts, d_ff, d_model), d_ff),
    }
    return {
        name: torch.randn(shape, generator=gen, device=device, dtype=dtype) * fan_in**-0.5
        for name, (shape, fan_in) in shapes.items()
    }


def _expert_ffn(params, x):
    """x: [E, C, d] -> SwiGLU of each expert on its own C rows."""
    gate = torch.einsum("ecd,edf->ecf", x, params["w_gate"])
    up = torch.einsum("ecd,edf->ecf", x, params["w_up"])
    return torch.einsum("ecf,efd->ecd", F.silu(gate) * up, params["w_down"])


def topk_gates(params, x, top_k: int):
    """Router probabilities and the renormalised top-k gates, the single
    source of the gate math for training (``moe_dense``) and serving
    (``models/llama._moe_decode_ffn``).

    On ties the lower expert index comes first, as ``jax.lax.top_k`` keeps
    it: the first k of a stable descending sort (``torch.topk`` promises
    no order among equal values).

    Returns (probs [G, E] fp32, gate_vals [G, k] fp32, gate_idx [G, k])."""
    probs = torch.softmax((x @ params["router"]).float(), dim=-1)
    gate_idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :top_k]
    gate_vals = probs.gather(-1, gate_idx)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_vals, gate_idx


def _slots(gate_idx, num_experts: int, capacity: int):
    """Each (token, choice)'s slot in its expert's buffer: the count of
    earlier choices of that expert, the [G, k] choices flattened
    token-major. Returns (pos [G, k], keep [G, k] bool: pos < capacity)."""
    onehot = F.one_hot(gate_idx, num_experts).to(torch.int32)  # [G, k, E]
    flat = onehot.flatten(0, 1)
    # the running count per expert, scanned along contiguous rows: the scan
    # down the narrow [G*k, E] columns took 2.9 ms a call at the train
    # shape (G*k 16384, E 8) on an H100
    count = flat.t().contiguous().cumsum(1).t()
    pos = ((count - flat).view_as(onehot) * onehot).sum(-1)
    return pos, pos < capacity


def _aux_loss(probs, gate_idx, num_experts: int):
    """Switch load-balancing loss: E x sum_e mean_prob_e x mean_choices_e."""
    me = probs.mean(0)
    ce = F.one_hot(gate_idx, num_experts).float().sum(1).mean(0)
    return (me * ce).sum() * num_experts


def _route(params, x, num_experts: int, top_k: int, capacity: int):
    """The JAX package's routing tensors: disp [G, E, C] (token g holds
    slot c of expert e), comb [G, E, C] (the same, weighted by the gate) in
    x's dtype, and the aux loss."""
    E, C = num_experts, capacity
    probs, gate_vals, gate_idx = topk_gates(params, x, top_k)
    pos, keep = _slots(gate_idx, E, C)
    keep = keep.to(x.dtype)
    oe = F.one_hot(gate_idx, E).to(x.dtype)  # [G, k, E]
    oc = F.one_hot(pos.clamp(max=C), C + 1)[..., :C].to(x.dtype)  # [G, k, C]; overflow: no slot
    disp = torch.einsum("gke,gkc,gk->gec", oe, oc, keep)
    comb = torch.einsum("gke,gkc,gk->gec", oe, oc, keep * gate_vals.to(x.dtype))
    return disp, comb, _aux_loss(probs, gate_idx, E)


def moe_dense(params, x, *, num_experts: int, top_k: int = 2, capacity_factor: float = 1.25):
    """Single-device routed MoE, with the capacity of the JAX package's
    ``moe_dense``: C = max(1, int(cf * G * k / E)).

    x: [G, d] -> (y [G, d], aux). The same function as the one-hot
    einsums of ``_route``: expert slot (e, c) gathers the token that holds
    it (an empty slot reads a zero row), and each token sums its kept
    choices' expert outputs times their gates, in x's dtype."""
    G, d = x.shape
    E = num_experts
    C = max(1, int(capacity_factor * G * top_k / E))
    probs, gate_vals, gate_idx = topk_gates(params, x, top_k)
    pos, keep = _slots(gate_idx, E, C)
    # flat slot e * C + c of each kept choice; a dropped one goes to the
    # spare index E * C, which no expert reads
    slot = torch.where(keep, gate_idx * C + pos, E * C)
    token = torch.arange(G, device=x.device).unsqueeze(1).expand_as(slot)
    holder = torch.full((E * C + 1,), G, dtype=torch.long, device=x.device)
    holder.scatter_(0, slot.flatten(), token.flatten())  # kept slots are unique
    # index_select, not indexing: its backward is an index_add (each row
    # sums at most k terms), where indexing's sorts the indices
    x_pad = torch.cat([x, x.new_zeros(1, d)])
    out = _expert_ffn(params, x_pad.index_select(0, holder[: E * C]).view(E, C, d))
    picked = out.reshape(E * C, d).index_select(0, slot.clamp(max=E * C - 1).flatten())
    w = (keep * gate_vals).to(x.dtype)
    y = torch.einsum("gkd,gk->gd", picked.view(G, -1, d), w)
    return y, _aux_loss(probs, gate_idx, E)

