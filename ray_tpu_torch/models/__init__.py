"""ray_tpu_torch.models — the Llama decoder in PyTorch (serving half)."""

from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.llama import (
    LlamaConfig,
    decode_step,
    init_kv_cache,
    init_params,
    prefill,
)

__all__ = [
    "LlamaConfig",
    "decode_step",
    "init_kv_cache",
    "init_params",
    "params_from_jax",
    "prefill",
]
