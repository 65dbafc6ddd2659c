"""ray_tpu_torch.ops — hand-written Hopper kernels for the hot ops, and the
plain-PyTorch fused cross-entropy.

Each kernel keeps its plain PyTorch version beside it: a CPU tensor runs
the plain version, a CUDA tensor runs the kernel or raises.
"""

from ray_tpu_torch.ops.cross_entropy import fused_cross_entropy
from ray_tpu_torch.ops.flash_attention import flash_attention
from ray_tpu_torch.ops.quant import dequantize_int8, quantize_int8
from ray_tpu_torch.ops.rmsnorm import rmsnorm

__all__ = ["dequantize_int8", "flash_attention", "fused_cross_entropy", "quantize_int8", "rmsnorm"]
