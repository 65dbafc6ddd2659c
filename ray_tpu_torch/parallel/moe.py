"""Routed mixture-of-experts: the counterpart of ``ray_tpu/parallel/moe.py``.

Top-k routing with a fixed expert capacity (Switch-Transformer style):
each token's k chosen experts take it in token-major order until an
expert's C slots are full, and the overflow is dropped. ``_route`` gives
the JAX package's one-hot dispatch and combine tensors [G, E, C];
``moe_dense`` computes the same function with gathers instead of their
einsums: a [G, E, C] one-hot at the train shape (8192 x 8 x 2560) holds
168 M entries and its two products cost about as much as the expert
FFN, while the gather reads each kept token once and the combine sums at
most k rows per token.

``moe_layer`` is the expert-parallel form (experts sharded over ``ep``,
token buffers exchanged with all-to-alls); ``moe_dense`` with a mesh is
the form the model runs at ep = 1 on a sharded batch.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Union

import numpy as np
import torch
import torch.distributed as dist
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


def _gather_slots(x, gate_idx, pos, keep, num_experts: int, capacity: int):
    """Expert slot (e, c) gathers the token that holds it (an empty slot
    reads a zero row): (expert_in [E, C, d], slot [G, k], the flat slot
    e * C + c of each choice, E * C for a dropped one)."""
    G, d = x.shape
    E, C = num_experts, capacity
    slot = torch.where(keep, gate_idx * C + pos, E * C)
    token = torch.arange(G, device=x.device).unsqueeze(1).expand_as(slot)
    holder = torch.full((E * C + 1,), G, dtype=torch.long, device=x.device)
    holder.scatter_(0, slot.flatten(), token.flatten())  # kept slots are unique
    # index_select, not indexing: its backward is an index_add (each row
    # sums at most k terms), where indexing's sorts the indices
    x_pad = torch.cat([x, x.new_zeros(1, d)])
    return x_pad.index_select(0, holder[: E * C]).view(E, C, d), slot


def _combine(out, slot, keep, gate_vals, dtype):
    """Each token's kept choices' expert outputs times their gates, summed:
    out [E, C, d] -> y [G, d] in ``dtype``."""
    E, C, d = out.shape
    G = slot.shape[0]
    picked = out.reshape(E * C, d).index_select(0, slot.clamp(max=E * C - 1).flatten())
    w = (keep * gate_vals).to(dtype)
    return torch.einsum("gkd,gk->gd", picked.view(G, -1, d), w)


def moe_dense(params, x, *, num_experts: int, top_k: int = 2, capacity_factor: float = 1.25,
              mesh=None, row_len: Optional[int] = None):
    """Routed MoE with every expert on this rank, with the capacity of the
    JAX package's ``moe_dense``: C = max(1, int(cf * G * k / E)).

    x: [G, d] -> (y [G, d], aux). The same function as the one-hot
    einsums of ``_route``: expert slot (e, c) gathers the token that holds
    it (an empty slot reads a zero row), and each token sums its kept
    choices' expert outputs times their gates, in x's dtype.

    With a ``mesh`` whose token axes (dp, fsdp, sp) hold more than one rank,
    x is this rank's share of one global token set, the JAX package's MoE
    at ep = 1 on a sharded batch, where XLA computes the unsharded
    function: rows of ``row_len`` tokens (this rank's batch rows, its
    sequence shard of each). Capacity comes from the global token count,
    each choice's position in its expert counts every earlier token of the
    global (row, position) order (the counts of earlier shards are
    all-gathered), and the aux loss is the product of global means."""
    from ray_tpu_torch.parallel.mesh import axis_group

    group = None if mesh is None else axis_group(mesh, ("dp", "fsdp", "sp"))
    if group is not None:
        return _moe_global(params, x, num_experts, top_k, capacity_factor, mesh, group, row_len)
    G, d = x.shape
    E = num_experts
    C = max(1, int(capacity_factor * G * top_k / E))
    probs, gate_vals, gate_idx = topk_gates(params, x, top_k)
    pos, keep = _slots(gate_idx, E, C)
    expert_in, slot = _gather_slots(x, gate_idx, pos, keep, E, C)
    y = _combine(_expert_ffn(params, expert_in), slot, keep, gate_vals, x.dtype)
    return y, _aux_loss(probs, gate_idx, E)


def _moe_global(params, x, E, top_k, capacity_factor, mesh, group, row_len):
    """``moe_dense`` over a token set sharded on the (dp, fsdp, sp) group."""
    from ray_tpu_torch.parallel.mesh import all_reduce, axis_index, mesh_sizes

    G, d = x.shape
    R = G // row_len
    n = dist.get_world_size(group)
    sp = mesh_sizes(mesh)["sp"]
    G_all = G * n
    C = max(1, int(capacity_factor * G_all * top_k / E))
    probs, gate_vals, gate_idx = topk_gates(params, x, top_k)
    onehot = F.one_hot(gate_idx, E).to(torch.int64)  # [G, k, E]
    seg = onehot.view(R, row_len * top_k, E)  # each row's choices, token-major
    counts = seg.sum(1)  # [R, E]
    every = [torch.empty_like(counts) for _ in range(n)]
    dist.all_gather(every, counts.contiguous(), group=group)
    # group rank = batch shard * sp + sequence shard; the global order of
    # the segments is (batch shard, row, sequence shard)
    order = torch.stack(every).view(n // sp, sp, R, E).permute(0, 2, 1, 3).reshape(-1, E)
    before = (order.cumsum(0) - order).view(n // sp, R, sp, E)
    offset = before[axis_index(mesh, ("dp", "fsdp")), :, mesh.get_local_rank("sp")]  # [R, E]
    pos = ((seg.cumsum(1) - seg + offset[:, None, :]) * seg).sum(-1).view(G, top_k)
    keep = pos < C
    # this rank's kept choices, packed into buffers of its own
    kept = (onehot * keep[..., None]).flatten(0, 1)
    local = ((kept.t().cumsum(1).t() - kept).view_as(onehot) * onehot).sum(-1)
    C_buf = max(1, min(C, G * top_k))
    expert_in, slot = _gather_slots(x, gate_idx, local, keep, E, C_buf)
    y = _combine(_expert_ffn(params, expert_in), slot, keep, gate_vals, x.dtype)
    me = all_reduce(probs.sum(0), group) / G_all
    ce = torch.stack(every).sum((0, 1)).float() / G_all
    return y, (me * ce).sum() * E


@functools.lru_cache(maxsize=64)
def _chunk_moves(rows: int, t_local: int, sp: int, s: int, device: torch.device) -> tuple:
    """The token moves between rank ``s``'s sequence shard of ``rows`` rows
    ([rows, t_local] tokens at positions s t_local onwards) and chunk ``s``
    of the group's flattened [rows, sp t_local] tokens, one direction and
    the other: each (rows to send in order, send counts, the received rows'
    order to take, receive counts). A token goes to the chunk its flat
    index falls in; a chunk receives from each source in flat order."""
    T, N = t_local * sp, rows * t_local
    flat = (np.arange(rows)[:, None] * T + s * t_local + np.arange(t_local)[None, :]).ravel()
    dest = flat // N
    src = ((s * N + np.arange(N)) % T) // t_local
    by_dest = np.argsort(dest, kind="stable")  # shard rows, grouped by chunk
    by_src = np.argsort(src, kind="stable")  # chunk rows, grouped by source shard
    n_dest = np.bincount(dest, minlength=sp).tolist()
    n_src = np.bincount(src, minlength=sp).tolist()

    def idx(a):
        return torch.as_tensor(a, device=device)

    return ((idx(by_dest), n_dest, idx(np.argsort(by_src)), n_src),
            (idx(by_src), n_src, idx(np.argsort(by_dest)), n_dest))


def token_chunks(x, mesh, rows: int, inverse: bool = False):
    """Lay this rank's tokens out as the JAX package's MoE takes them on a
    mesh with sp > 1, and back (``inverse``).

    The JAX ``_moe_ffn`` flattens [B, T, e] to [B T, e] and shard_maps the
    token dim over (dp, fsdp, sp): each rank then routes a contiguous chunk
    of its (dp, fsdp) group's flattened rows, not its sequence shard. Here
    x [rows t_local, e] is this rank's sequence shard of its group's
    ``rows`` rows, row-major; one all-to-all over sp gives chunk ``s`` of
    the group's [rows T, e] on sp rank ``s`` (the same count of tokens),
    and ``inverse`` moves a chunk's rows back. The two layouts agree only
    at rows = 1. The all-to-all's backward is its transpose."""
    from torch.distributed.nn.functional import all_to_all_single

    from ray_tpu_torch.parallel.mesh import axis_group, mesh_sizes

    moves = _chunk_moves(rows, x.shape[0] // rows, mesh_sizes(mesh)["sp"],
                         mesh.get_local_rank("sp"), x.device)
    send, n_send, take, n_recv = moves[1 if inverse else 0]
    moved = all_to_all_single(x.new_empty(x.shape), x.index_select(0, send),
                              output_split_sizes=n_recv, input_split_sizes=n_send,
                              group=axis_group(mesh, "sp"))
    return moved.index_select(0, take)


def moe_layer(params, x, mesh, *, axis_name: str = "ep", num_experts: int, top_k: int = 2,
              capacity_factor: float = 1.25, tokens_axis_names: tuple = ("dp", "sp")):
    """Expert-parallel MoE FFN: the counterpart of the JAX package's
    ``moe_layer`` (:150, body ``_moe_local`` :90).

    params: the router (whole) and this rank's experts, [E / ep, ...] of
    each bank, expert e on rank e // (E / ep) of ``axis_name``. x: this
    rank's tokens [G_local, d] (its shard of ``tokens_axis_names``; tokens
    are replicated over ``axis_name``). Routing is local to the token
    shard: the capacity comes from the local token count (JAX :176-180),
    buffers [ep, E / ep, C, d] go to the experts' ranks and back with
    ``all_to_all_single``, and the aux loss is the mean of the shards'
    local values over the token axes (JAX's ``pmean``). Returns (y
    [G_local, d], aux)."""
    from torch.distributed.nn.functional import all_to_all_single

    from ray_tpu_torch.parallel.mesh import all_reduce, axis_group, mesh_sizes

    sizes = mesh_sizes(mesh)
    ep = sizes[axis_name]
    if num_experts % ep:
        raise ValueError(f"num_experts {num_experts} not divisible by {axis_name}={ep}")
    G, d = x.shape
    E, E_l = num_experts, num_experts // ep
    C = max(1, int(capacity_factor * G * top_k / E))
    probs, gate_vals, gate_idx = topk_gates(params, x, top_k)
    pos, keep = _slots(gate_idx, E, C)
    expert_in, slot = _gather_slots(x, gate_idx, pos, keep, E, C)  # [E, C, d]
    group = axis_group(mesh, axis_name)
    if group is None:
        out = _expert_ffn(params, expert_in)
    else:
        a = expert_in.reshape(ep, E_l, C, d)  # by destination rank
        b = all_to_all_single(torch.empty_like(a), a, group=group)  # by source rank
        out = _expert_ffn(params, b.transpose(0, 1).reshape(E_l, ep * C, d))
        back = out.reshape(E_l, ep, C, d).transpose(0, 1).contiguous()
        out = all_to_all_single(torch.empty_like(back), back, group=group).reshape(E, C, d)
    y = _combine(out, slot, keep, gate_vals, x.dtype)
    aux = _aux_loss(probs, gate_idx, E)
    token_axes = tuple(a for a in tokens_axis_names if sizes.get(a, 1) > 1)
    if token_axes:
        n_shards = math.prod(sizes[a] for a in token_axes)
        aux = all_reduce(aux, axis_group(mesh, token_axes)) / n_shards
    return y, aux
