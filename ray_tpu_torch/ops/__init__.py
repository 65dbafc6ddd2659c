"""ray_tpu_torch.ops — hand-written Hopper kernels for the hot ops.

Each op keeps its plain PyTorch version beside the kernel: a CPU tensor runs
the plain version, a CUDA tensor runs the kernel or raises.
"""

from ray_tpu_torch.ops.rmsnorm import rmsnorm

__all__ = ["rmsnorm"]
