"""Fused (blockwise) cross-entropy over a large vocabulary.

Counterpart of ``ray_tpu/ops/cross_entropy.py:fused_cross_entropy``. There
it is XLA code (a ``lax.scan`` over ``jax.checkpoint``-ed chunks), not a
Pallas kernel, so here it is plain PyTorch: a loop over token chunks, each
under ``torch.utils.checkpoint``. A chunk's fp32 logits ``[C, V]`` live
only inside its step and are recomputed in the backward pass; the full
``[B, S, V]`` logits are never built, and the unembed's gradient
accumulates over the chunks.

On a mesh the unembedding's vocabulary may be split over a tensor-parallel
group: each rank then holds logits for its vocabulary ids only, and the
log-sum-exp and the target's logit are combined over the group inside each
chunk, so every rank gets the whole softmax's NLL.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.parallel.mesh import all_reduce, all_reduce_max


class _MatmulFp32Out(torch.autograd.Function):
    """x [..., E] @ w [E, V] -> fp32 [..., V] from operands in x's dtype:
    fp32 accumulation and an fp32 result, never rounded to bf16 (JAX's
    preferred_element_type=float32). On the card a bf16 product goes
    through cuBLAS with an fp32 output (``torch.mm(..., out_dtype=)``), so
    neither operand is copied to fp32; on the CPU the operands are upcast
    (exact). The backward casts the fp32 gradient to the operands' dtype
    and runs two products in that dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if x.dtype == torch.float32:
            return x @ w
        if x.device.type == "cuda":
            y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
            return y.reshape(*x.shape[:-1], w.shape[-1])
        return x.float() @ w.float()

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = g @ w.t() if ctx.needs_input_grad[0] else None
        dw = None
        if ctx.needs_input_grad[1]:
            dw = x.reshape(-1, x.shape[-1]).t() @ g.reshape(-1, g.shape[-1])
        return dx, dw


def matmul_fp32_out(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """fp32 logits x @ w from operands of one dtype (see _MatmulFp32Out)."""
    if x.dtype != w.dtype:
        raise TypeError(f"matmul_fp32_out: operands must share a dtype, got {x.dtype} and {w.dtype}")
    return _MatmulFp32Out.apply(x, w)


def _chunk_nll(xc, w, lc, mc, first: int, group):
    """One chunk's masked NLL sum. ``w`` holds vocabulary ids ``first`` ..
    ``first + w.shape[1] - 1``; the rest live on the other ranks of
    ``group`` (None: ``w`` is the whole vocabulary and every reduction over
    the group is the identity, the log-sum-exp's bit for bit)."""
    logits = matmul_fp32_out(xc, w)
    lse = torch.logsumexp(logits, dim=-1)
    # the whole vocabulary's log-sum-exp from each rank's: the max is only
    # a shift, so it carries no gradient
    m = all_reduce_max(lse, group)
    lse = all_reduce((lse - m).exp(), group).log() + m
    n = logits.shape[1]
    local = lc.long() - first
    inside = (local >= 0) & (local < n)
    ll = logits.gather(1, local.clamp(0, n - 1)[:, None])[:, 0] * inside
    return ((lse - all_reduce(ll, group)) * mc).sum()


def fused_nll_sum(
    x: torch.Tensor,
    unembed: torch.Tensor,
    labels: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    chunk_size: Optional[int] = 1024,
    group=None,
    first: int = 0,
) -> torch.Tensor:
    """The masked next-token NLL SUM (fp32 scalar) without materializing
    [B, S, V] logits. x: [B, S, E]; unembed: [E, V_local], vocabulary ids
    from ``first`` (the rest on the other ranks of ``group``, a process
    group or None); labels: int [B, S]; mask: optional [B, S] 0/1 weights.
    chunk_size: tokens a checkpointed step; None takes every token in one
    step with the logits kept for the backward (the unfused loss)."""
    B, S, E = x.shape
    n = B * S
    xf = x.reshape(n, E)
    lf = labels.reshape(n)
    mf = (mask.reshape(n).float() if mask is not None
          else torch.ones((n,), dtype=torch.float32, device=x.device))
    w = unembed.to(x.dtype)
    if chunk_size is None:
        return _chunk_nll(xf, w, lf, mf, first, group)
    chunk = max(1, min(chunk_size, n))
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for start in range(0, n, chunk):
        sl = slice(start, start + chunk)
        total = total + checkpoint(_chunk_nll, xf[sl], w, lf[sl], mf[sl], first, group,
                                   use_reentrant=False)
    return total


def fused_cross_entropy(
    x: torch.Tensor,
    unembed: torch.Tensor,
    labels: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    chunk_size: int = 1024,
) -> torch.Tensor:
    """Mean next-token NLL without materializing [B, S, V] logits.

    x: final hidden states [B, S, E]; unembed: [E, V]; labels: int [B, S];
    mask: optional [B, S] 0/1 weights, the mean is over the mask sum
    (clamped at 1). chunk_size: tokens a step. Returns a scalar fp32 loss.
    The last chunk is shorter when B*S is not a multiple of chunk_size (the
    JAX code pads it with masked rows instead: the same sum)."""
    total = fused_nll_sum(x, unembed, labels, mask, chunk_size)
    count = (mask.float().sum().clamp(min=1.0) if mask is not None
             else float(labels.numel()))
    return total / count
