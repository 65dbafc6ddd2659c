"""ray_tpu_torch.llm — LLM serving on CUDA devices.

Counterpart of ``ray_tpu.llm``: the continuous-batching ``TorchEngine``
and the OpenAI-shaped ``LLMServer`` over it, on one card; for a tensor- or
sequence-parallel config, a gang of rank processes, one a card
(``GangLLMServer``, ``llm/gang.py``) running the lockstep SPMD engine
(``SPMDGenerator``, ``llm/spmd.py``), behind the same surfaces;
prefill/decode disaggregation (``PrefillWorker``, ``DecodeWorker``,
``DisaggRouter``, ``llm/disagg.py``) and offline batch inference
(``build_llm_processor``, ``llm/batch.py``); with the JAX package's config
dataclasses (own copies).
"""

from ray_tpu_torch.llm.batch import ProcessorConfig, build_llm_processor
from ray_tpu_torch.llm.config import (
    EngineConfig,
    LLMConfig,
    ModelConfig,
    SamplingParams,
)
from ray_tpu_torch.llm.disagg import DecodeWorker, DisaggRouter, PrefillWorker
from ray_tpu_torch.llm.engine import RequestOutput, TorchEngine
from ray_tpu_torch.llm.gang import GangLLMServer
from ray_tpu_torch.llm.server import LLMServer
from ray_tpu_torch.llm.spmd import SPMDGenerator

__all__ = [
    "DecodeWorker",
    "DisaggRouter",
    "EngineConfig",
    "GangLLMServer",
    "LLMConfig",
    "LLMServer",
    "ModelConfig",
    "PrefillWorker",
    "ProcessorConfig",
    "RequestOutput",
    "SPMDGenerator",
    "SamplingParams",
    "TorchEngine",
    "build_llm_processor",
]
