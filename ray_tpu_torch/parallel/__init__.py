"""ray_tpu_torch.parallel — attention functions of the parallel layer.

This slice holds the single-device functions the model needs
(``dense_attention``, ``full_attention_reference``); ring and Ulysses
attention over several cards come with the multi-device slice.
"""

from ray_tpu_torch.parallel.ring_attention import dense_attention, full_attention_reference

__all__ = ["dense_attention", "full_attention_reference"]
