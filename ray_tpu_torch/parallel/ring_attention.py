"""Dense attention: the single-device functions of
``ray_tpu/parallel/ring_attention.py``.

``ring_attention`` itself (K/V blocks passed around a ring of devices) needs
the multi-device layer and is not ported yet; with one device the model
uses ``dense_attention``, as the JAX package does when its mesh has sp = 1.
"""

from __future__ import annotations

import torch

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
