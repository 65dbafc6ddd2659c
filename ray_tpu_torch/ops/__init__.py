"""ray_tpu_torch.ops — hand-written Hopper kernels for the hot ops, and the
plain-PyTorch fused cross-entropy.

Each kernel keeps its plain PyTorch version beside it: a CPU tensor runs
the plain version, a CUDA tensor runs the kernel or raises. Each wrapper
counts its kernel's launches; ``launch_counts`` reads every counter.
"""

from ray_tpu_torch.ops.cross_entropy import fused_cross_entropy
from ray_tpu_torch.ops.flash_attention import flash_attention
from ray_tpu_torch.ops.quant import dequantize_int8, quantize_int8
from ray_tpu_torch.ops.rmsnorm import add_rmsnorm, rmsnorm

__all__ = [
    "add_launch_counts", "add_rmsnorm", "dequantize_int8", "flash_attention", "fused_cross_entropy",
    "launch_counts", "quantize_int8", "rmsnorm",
]

# every kernel's launch counter: kernel name -> (wrapper, attribute)
_COUNTERS = {
    "rmsnorm": (rmsnorm, "launches"),
    "quantize_int8": (quantize_int8, "launches"),
    "dequantize_int8": (dequantize_int8, "launches"),
    "flash_attention_fwd": (flash_attention, "launches_fwd"),
    "flash_attention_bwd_dq": (flash_attention, "launches_bwd_dq"),
    "flash_attention_bwd_dkdv": (flash_attention, "launches_bwd_dkdv"),
}


def launch_counts() -> dict[str, int]:
    """Every kernel's launch count so far, by kernel name."""
    return {name: getattr(fn, attr) for name, (fn, attr) in _COUNTERS.items()}


def add_launch_counts(delta: dict[str, int]) -> None:
    """Add ``delta`` (kernel name -> launches, e.g. the difference of two
    ``launch_counts``) to the counters."""
    for name, n in delta.items():
        fn, attr = _COUNTERS[name]
        setattr(fn, attr, getattr(fn, attr) + n)
