"""ray_tpu_torch.models — the Llama decoder in PyTorch (dense or MoE): its
training forward and loss, the train step (``models.training``) and the
serving half with stacked multi-LoRA adapters."""

from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.llama import (
    LlamaConfig,
    decode_step,
    forward,
    forward_hidden,
    init_kv_cache,
    init_lora_stack,
    init_params,
    loss_fn,
    prefill,
)

__all__ = [
    "LlamaConfig",
    "decode_step",
    "forward",
    "forward_hidden",
    "init_kv_cache",
    "init_lora_stack",
    "init_params",
    "loss_fn",
    "params_from_jax",
    "prefill",
]
