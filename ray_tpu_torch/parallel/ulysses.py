"""Ulysses sequence parallelism: the counterpart of
``ray_tpu/parallel/ulysses.py``.

q/k/v arrive as each rank's sequence shard [B, T/P, H, D]; an all-to-all
over the ``sp`` group (``torch.distributed.nn.functional.all_to_all_single``,
which carries autograd) gathers the whole sequence while scattering the
heads, [B, T, H/P, D]; each rank runs causal attention over its heads (the
flash-attention kernels on the card, their plain twin on the CPU); a second
all-to-all restores the sequence sharding. GQA: K/V keep their kv head
count through the exchange.
"""

from __future__ import annotations

import torch
from torch.distributed.nn.functional import all_to_all_single


def _seq_to_heads(x: torch.Tensor, group, P: int) -> torch.Tensor:
    """[B, T/P, H, D] -> [B, T, H/P, D]: head chunk j goes to rank j; the
    sequence chunks arrive in rank order."""
    B, t, H, D = x.shape
    send = x.reshape(B, t, P, H // P, D).permute(2, 0, 1, 3, 4).contiguous()
    recv = all_to_all_single(torch.empty_like(send), send, group=group)  # [P(src), B, t, H/P, D]
    return recv.permute(1, 0, 2, 3, 4).reshape(B, P * t, H // P, D)


def _heads_to_seq(x: torch.Tensor, group, P: int) -> torch.Tensor:
    """[B, T, H/P, D] -> [B, T/P, H, D], the inverse of ``_seq_to_heads``."""
    B, T, h, D = x.shape
    send = x.reshape(B, P, T // P, h, D).permute(1, 0, 2, 3, 4).contiguous()
    # [P (the source's heads), B, t, h, D]
    recv = all_to_all_single(torch.empty_like(send), send, group=group)
    return recv.permute(1, 2, 0, 3, 4).reshape(B, T // P, P * h, D)


def ulysses_attention(q, k, v, mesh, *, axis_name: str = "sp", causal: bool = True):
    """All-to-all sequence-parallel attention over this rank's sequence
    shards q [B, T/P, H, D], k/v [B, T/P, KV, D]; returns [B, T/P, H, D].
    Needs H and KV divisible by the axis size (the JAX package's errors)."""
    from ray_tpu_torch.ops.flash_attention import flash_attention
    from ray_tpu_torch.parallel.mesh import axis_group, mesh_sizes

    sp = mesh_sizes(mesh)[axis_name]
    if q.shape[2] % sp:
        raise ValueError(f"ulysses needs heads ({q.shape[2]}) divisible by {axis_name}={sp}")
    if k.shape[2] % sp:
        raise ValueError(
            f"ulysses needs kv heads ({k.shape[2]}) divisible by {axis_name}={sp}"
            " (repeat kv heads to a multiple first)"
        )
    if sp == 1:
        return flash_attention(q, k, v, causal=causal)
    group = axis_group(mesh, axis_name)
    qh, kh, vh = (_seq_to_heads(t, group, sp) for t in (q, k, v))
    return _heads_to_seq(flash_attention(qh, kh, vh, causal=causal), group, sp)
