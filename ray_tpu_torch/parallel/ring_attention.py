"""Ring attention over the sequence-parallel axis, and the dense functions:
the counterpart of ``ray_tpu/parallel/ring_attention.py``.

``ring_attention(q, k, v, mesh)`` takes each rank's sequence shard
``[B, T_local, H, D]`` (K/V ``[B, T_local, KV, D]``, GQA) of the ``sp``
axis. K/V blocks travel around the ring (``dist.batch_isend_irecv`` to the
next rank, from the previous one, the transfer overlapping the block's
compute), and each rank attends its queries to every block it holds:

- each block is one call of the flash-attention forward on the card
  (``ops/flash_attention.py``: the kernel, its (O, LSE) per block) and of
  its plain twin on the CPU; the blocks' outputs merge by their LSEs;
- global positions decide the masks, as in the JAX package's masked
  ``scan`` (``_ring_attention_local`` :51): the rank's own block is causal,
  a block from an earlier rank is whole (``causal=False``), and a later
  rank's block is skipped, so a causal ring of P ranks computes
  P (P + 1) / 2 blocks;
- the backward (a ``torch.autograd.Function``) runs the backward kernels,
  or their twins, on each block with the merged O and LSE, so the dQ
  kernel's delta = rowsum(O dO) is the whole row's; dQ accumulates on the
  rank, and each block's dK/dV buffer travels with its K/V block and comes
  home after P hops.

The per-block steps (``ring_steps``, ``block_forward``, ``merge_blocks``,
``block_backward``) are the functions ``chip_smoke.py`` runs on one card
for each simulated rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

_NEG_INF = -1e30


def _causal_mask(T: int, S: int, device) -> torch.Tensor:
    return torch.arange(T, device=device)[:, None] >= torch.arange(S, device=device)[None, :]


def full_attention_reference(q, k, v, causal: bool = True):
    """Dense reference (correctness harness only): fp32 throughout, equal
    head counts. q, k, v: [B, T, H, D] -> [B, T, H, D] in q's dtype."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        s = s.masked_fill(~_causal_mask(q.shape[1], k.shape[1], q.device), _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def gqa_scores(q, k, scale: float, causal: bool) -> torch.Tensor:
    """fp32 scores [B, KV, G, T, S] of q [B, T, H, D] against k [B, S, KV, D],
    from the exact fp32 products of the input-dtype operands (as
    preferred_element_type=float32 gives them in JAX), times ``scale`` and
    masked with -1e30 above the diagonal when causal. q is reshaped to
    [B, T, KV, G, D] and contracted against the shared kv head, which is
    never repeated."""
    B, T, H, D = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, T, KV, H // KV, D).float()
    s = torch.einsum("btkgd,bskd->bkgts", qg, k.float()) * scale
    if causal:
        s = s.masked_fill(~_causal_mask(T, k.shape[1], q.device), _NEG_INF)
    return s


def dense_attention(q, k, v, causal: bool = True):
    """Dense attention with fp32 scores and an fp32 softmax; the
    probabilities are cast to the input dtype before the PV product, which
    accumulates in fp32 and rounds once to the input dtype (the JAX
    package's bf16-operand, fp32-accumulation mode).

    GQA-native: q [B, T, H, D] may have more heads than k/v [B, S, KV, D]
    (``gqa_scores``); K/V are never repeated."""
    B, T, H, D = q.shape
    p = torch.softmax(gqa_scores(q, k, D**-0.5, causal), dim=-1).to(q.dtype)
    o = torch.einsum("bkgts,bskd->btkgd", p, v)
    return o.reshape(B, T, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# The ring's per-block steps
# ---------------------------------------------------------------------------


def ring_steps(rank: int, size: int, causal: bool) -> list[tuple[int, object]]:
    """(source rank of the K/V block held, its mask) at each of the ring's
    ``size`` steps on ``rank``: True = causal (the own block), False =
    whole (an earlier rank's, or every block when not causal), None =
    skipped (a later rank's block under the causal mask)."""
    out = []
    for s in range(size):
        src = (rank - s) % size
        mode = (True if src == rank else False if src < rank else None) if causal else False
        out.append((src, mode))
    return out


def block_forward(q, k, v, causal: bool, scale: float):
    """One block's (o [B, T, H, D] in q's dtype, lse [B, H, T] fp32): the
    forward kernel for a CUDA tensor, its plain twin for a CPU tensor."""
    from ray_tpu_torch.ops.flash_attention import (
        flash_attention_fwd_kernel, flash_attention_fwd_plain)

    if q.device.type == "cuda":
        return flash_attention_fwd_kernel(q, k, v, scale, causal)
    return flash_attention_fwd_plain(q, k, v, scale, causal)


def merge_blocks(o_acc, lse_acc, o_b, lse_b):
    """Fold a block's (o, lse) into the running (fp32 o, lse): the softmax
    over the union of the key blocks."""
    if o_acc is None:
        return o_b.float(), lse_b
    lse = torch.logaddexp(lse_acc, lse_b)
    w_acc = torch.exp(lse_acc - lse).transpose(1, 2)[..., None]  # [B, T, H, 1]
    w_b = torch.exp(lse_b - lse).transpose(1, 2)[..., None]
    return o_acc * w_acc + o_b.float() * w_b, lse


def block_backward(q, k, v, o, lse, do, causal: bool, scale: float):
    """One block's (dq, dk, dv) from the merged o and lse: the backward
    kernels for CUDA tensors, their plain twin for CPU tensors."""
    from ray_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_kernel, flash_attention_bwd_plain)

    if q.device.type == "cuda":
        return flash_attention_bwd_kernel(q, k, v, o, lse, do, scale, causal)
    return flash_attention_bwd_plain(q, k, v, o, lse, do, scale, causal)


def _exchange(tensors, group, nxt: int, prev: int):
    """Send ``tensors`` to ``nxt`` and receive as many of the same shapes
    from ``prev``; returns (received, pending requests)."""
    got = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t, nxt, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, t, prev, group) for t in got]
    return got, dist.batch_isend_irecv(ops)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, rank, size, nxt, prev, causal, scale):
        k, v = k.contiguous(), v.contiguous()
        o_acc = lse = None
        k_cur, v_cur = k, v
        for step, (_, mode) in enumerate(ring_steps(rank, size, causal)):
            reqs = []
            if step < size - 1:  # the next block travels while this one computes
                (k_nxt, v_nxt), reqs = _exchange([k_cur, v_cur], group, nxt, prev)
            if mode is not None:
                o_acc, lse = merge_blocks(o_acc, lse, *block_forward(q, k_cur, v_cur, mode, scale))
            for r in reqs:
                r.wait()
            if reqs:
                k_cur, v_cur = k_nxt, v_nxt
        o = o_acc.to(q.dtype)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.ring = (group, rank, size, nxt, prev, causal, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        group, rank, size, nxt, prev, causal, scale = ctx.ring
        do = do.contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        k_cur, v_cur = k, v
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        for step, (_, mode) in enumerate(ring_steps(rank, size, causal)):
            if mode is not None:
                dq_b, dk_b, dv_b = block_backward(q, k_cur, v_cur, o, lse, do, mode, scale)
                dq += dq_b
                dk += dk_b
                dv += dv_b
            # K/V move on with their dK/dV buffers; the last hop takes each
            # buffer home (P hops in all)
            travel = [dk, dv] if step == size - 1 else [k_cur, v_cur, dk, dv]
            got, reqs = _exchange(travel, group, nxt, prev)
            for r in reqs:
                r.wait()
            if step < size - 1:
                k_cur, v_cur, dk, dv = got
            else:
                dk, dv = got
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)) + (None,) * 7


def ring_attention(q, k, v, mesh, *, axis_name: str = "sp", causal: bool = True):
    """Ring attention over sequence-sharded q [B, T_local, H, D] and k/v
    [B, T_local, KV, D] (this rank's shard of the ``axis_name`` axis, in
    order); returns this rank's [B, T_local, H, D]."""
    from ray_tpu_torch.parallel.mesh import axis_group, mesh_sizes, peer_rank

    size = mesh_sizes(mesh)[axis_name]
    rank = mesh.get_local_rank(axis_name)
    scale = q.shape[-1] ** -0.5
    if size == 1:
        from ray_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal)
    return _RingAttention.apply(
        q, k, v, axis_group(mesh, axis_name), rank, size,
        peer_rank(mesh, axis_name, (rank + 1) % size),
        peer_rank(mesh, axis_name, (rank - 1) % size), bool(causal), scale,
    )
