"""ray_tpu_torch.parallel — the parallel layer over torch.distributed: the
counterpart of ``ray_tpu.parallel``.

- ``mesh``: named DeviceMeshes (dp/fsdp/ep/pp/sp/tp axes), logical
  sharding rules, param sharding, collectives that carry autograd;
- ``ring_attention``: ring attention over the sp axis (and the dense
  functions ``dense_attention``, ``full_attention_reference``);
- ``ulysses``: all-to-all head/sequence parallelism;
- ``pipeline``: a GPipe pipeline over the pp axis;
- ``moe``: routed mixture-of-experts, on one device or over a sharded
  batch (``moe_dense``) and expert-parallel over ep (``moe_layer``).
"""

from ray_tpu_torch.parallel.mesh import DEFAULT_RULES, MeshSpec, build_mesh, logical_pspec
from ray_tpu_torch.parallel.moe import moe_dense, moe_init, moe_layer, topk_gates
from ray_tpu_torch.parallel.pipeline import pipeline_apply
from ray_tpu_torch.parallel.ring_attention import (
    dense_attention, full_attention_reference, ring_attention)
from ray_tpu_torch.parallel.ulysses import ulysses_attention

__all__ = [
    "DEFAULT_RULES", "MeshSpec", "build_mesh", "dense_attention", "full_attention_reference",
    "logical_pspec", "moe_dense", "moe_init", "moe_layer", "pipeline_apply", "ring_attention",
    "topk_gates", "ulysses_attention",
]
