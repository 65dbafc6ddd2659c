"""ray_tpu_torch.llm — LLM serving on one CUDA device.

Counterpart of ``ray_tpu.llm``: the continuous-batching ``TorchEngine``
and the OpenAI-shaped ``LLMServer`` over it, with the JAX package's config
dataclasses (own copies).
"""

from ray_tpu_torch.llm.config import (
    EngineConfig,
    LLMConfig,
    ModelConfig,
    SamplingParams,
)
from ray_tpu_torch.llm.engine import RequestOutput, TorchEngine
from ray_tpu_torch.llm.server import LLMServer

__all__ = [
    "EngineConfig",
    "LLMConfig",
    "LLMServer",
    "ModelConfig",
    "RequestOutput",
    "SamplingParams",
    "TorchEngine",
]
