"""ray_tpu_torch.llm — LLM serving on CUDA devices.

Counterpart of ``ray_tpu.llm``: the continuous-batching ``TorchEngine``
and the OpenAI-shaped ``LLMServer`` over it, on one card; for a tensor- or
sequence-parallel config, a gang of rank processes, one a card
(``GangLLMServer``, ``llm/gang.py``) running the lockstep SPMD engine
(``SPMDGenerator``, ``llm/spmd.py``), behind the same surfaces;
prefill/decode disaggregation (``PrefillWorker``, ``DecodeWorker``,
``DisaggRouter``, ``llm/disagg.py``) and offline batch inference
(``build_llm_processor``, ``llm/batch.py``); the OpenAI app
(``build_openai_app`` over ``OpenAIRouter``, ``llm/openai_api.py``) and the
deployment builders (``build_llm_deployment``, ``build_gang_deployment``,
``llm/builders.py``) on the port's Serve; with the JAX package's config
dataclasses (own copies).
"""

from ray_tpu_torch.llm.batch import ProcessorConfig, build_llm_processor
from ray_tpu_torch.llm.builders import (build_gang_deployment, build_llm_deployment,
                                        build_openai_app)
from ray_tpu_torch.llm.config import (
    EngineConfig,
    LLMConfig,
    ModelConfig,
    SamplingParams,
)
from ray_tpu_torch.llm.disagg import DecodeWorker, DisaggRouter, PrefillWorker
from ray_tpu_torch.llm.engine import RequestOutput, TorchEngine
from ray_tpu_torch.llm.gang import GangLLMServer
from ray_tpu_torch.llm.openai_api import OpenAIRouter
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
    "OpenAIRouter",
    "PrefillWorker",
    "ProcessorConfig",
    "RequestOutput",
    "SPMDGenerator",
    "SamplingParams",
    "TorchEngine",
    "build_gang_deployment",
    "build_llm_deployment",
    "build_llm_processor",
    "build_openai_app",
]
