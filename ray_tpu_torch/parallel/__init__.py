"""ray_tpu_torch.parallel — the single-device functions of the parallel
layer: dense attention (``dense_attention``, ``full_attention_reference``)
and the routed mixture-of-experts (``moe``: ``moe_init``, ``topk_gates``,
``moe_dense``). Ring and Ulysses attention and the expert-parallel
``moe_layer`` over several cards come with the multi-device slice.
"""

from ray_tpu_torch.parallel.moe import moe_dense, moe_init, topk_gates
from ray_tpu_torch.parallel.ring_attention import dense_attention, full_attention_reference

__all__ = ["dense_attention", "full_attention_reference", "moe_dense", "moe_init", "topk_gates"]
