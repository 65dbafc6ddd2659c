"""Application builders: the port's own copy of ``ray_tpu/llm/builders.py``
(reference: ``llm/_internal/serve/builders/application_builders.py:55``).

Each builder takes ``device``, the port's way to ask for the CPU
(``LLMServer(device=)``, ``ProcessorConfig.device``), and passes it to the
server: ``None`` builds the engine on the replica's card, which it leases
from the card ledger as ``ray_actor_options["resources"]`` names; a
replica that leases no card cannot build it there and the deployment stays
short (``serve.status()`` says why), never on the CPU in its place.
``"cpu"`` runs it on the CPU.
"""

from __future__ import annotations

from typing import Union

from ray_tpu_torch import serve
from ray_tpu_torch.llm.config import LLMConfig
from ray_tpu_torch.llm.openai_api import OpenAIRouter
from ray_tpu_torch.llm.server import LLMServer


def build_llm_deployment(llm_config: LLMConfig, device=None) -> "serve.Application":
    d = serve.deployment(
        LLMServer,
        name=f"llm:{llm_config.served_name}",
        num_replicas=llm_config.num_replicas,
        max_ongoing_requests=llm_config.engine.max_num_seqs * 2,
        ray_actor_options=llm_config.ray_actor_options,
        autoscaling_config=llm_config.autoscaling_config,
        # a replica's start-up builds its engine (and, on the card, captures
        # its decode graphs): STARTING is bounded by the config's start-up
        # budget instead of serve's generic grace
        initial_health_grace_s=llm_config.compile_budget_s(),
    )
    return d.bind(llm_config, device=device)


def build_gang_deployment(llm_config: LLMConfig, num_workers: int = 2, device=None,
                          **gang_kwargs) -> "serve.Application":
    """A deployment whose replica is a gang: one ``GangLLMServer`` that
    spawns ``num_workers`` rank processes on this host (one a card under
    NCCL, or gloo ranks with ``device="cpu"``). The replica leases nothing;
    its ranks lease their cards from the driver's ledger and end with the
    replica's process group. The start-up grace covers the ranks' spawn,
    rendezvous and engine build (the config's start-up budget)."""
    from ray_tpu_torch.llm.gang import GangLLMServer

    d = serve.deployment(
        GangLLMServer,
        name=f"gang:{llm_config.served_name}",
        max_ongoing_requests=llm_config.engine.max_num_seqs,
        initial_health_grace_s=llm_config.compile_budget_s(),
    )
    return d.bind(llm_config, num_workers=num_workers, device=device, **gang_kwargs)


def build_openai_app(llm_configs: Union[LLMConfig, list[LLMConfig]],
                     device=None) -> "serve.Application":
    """One OpenAI-compatible app over one model deployment a config."""
    if isinstance(llm_configs, LLMConfig):
        llm_configs = [llm_configs]
    handles = {cfg.served_name: build_llm_deployment(cfg, device=device) for cfg in llm_configs}
    router = serve.deployment(OpenAIRouter, name="openai-router", max_ongoing_requests=64)
    return router.bind(**handles)
