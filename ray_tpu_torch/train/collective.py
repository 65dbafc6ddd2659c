"""Train-loop collectives over the ranks' process group.

Counterpart of ``ray_tpu/train/collective.py`` (``broadcast_from_rank_zero``
:55, ``barrier`` :102; reference:
``python/ray/train/collective/collectives.py``). The JAX package carries
them over the runtime's KV store; the port has a process group already
(``init_process_group`` in every rank), so they are its collectives: NCCL
on the card, gloo on CPU ranks. Every rank must call each one, in the same
order. Outside a training session (no process group) they return at once.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist


def _nccl() -> bool:
    return dist.get_backend() == "nccl"


def broadcast_from_rank_zero(data: Any = None) -> Any:
    """Rank 0 provides ``data`` (picklable); every rank returns rank 0's
    value. Non-zero ranks' ``data`` is ignored."""
    if not dist.is_initialized():
        return data
    box = [data if dist.get_rank() == 0 else None]
    device = torch.device("cuda", torch.cuda.current_device()) if _nccl() else None
    dist.broadcast_object_list(box, src=0, device=device)
    return box[0]


def barrier() -> None:
    """Block until every rank reaches this barrier."""
    if not dist.is_initialized():
        return
    if _nccl():
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()
