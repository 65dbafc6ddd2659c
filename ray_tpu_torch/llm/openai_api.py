"""OpenAI-compatible HTTP router over LLM deployments; the port's own copy
of ``ray_tpu/llm/openai_api.py``.

Reference: ``python/ray/llm/_internal/serve/routers/`` (the OpenAI router)
and ``builders/application_builders.py:55`` (``build_openai_app``). The
router is itself a deployment, the application's ingress: it holds a
``DeploymentHandle`` to each model deployment (an ``LLMServer``, or a
``GangLLMServer``) by served name and answers ``/v1/models``,
``/v1/chat/completions`` and ``/v1/completions``. Its replica is a process
of its own, so each handle call, and each stream, goes through the
driver's router (``serve/controller.py:RouterServer``) to a model replica;
with ``"stream": true`` the model's chunks are relayed back as SSE events
(``data: {...}``, then ``data: [DONE]``) as they arrive, each waited for at
most ``CHUNK_TIMEOUT_S``. A model id ``"<base>:<adapter>"`` routes to the
base deployment with ``body["_lora"] = adapter``.
"""

from __future__ import annotations

import json
from typing import Any

# the unary reply's and each streamed chunk's deadline
CHUNK_TIMEOUT_S = 600.0


class OpenAIRouter:
    """Ingress deployment: routes OpenAI API requests to model deployments."""

    def __init__(self, **model_handles):
        # served model name -> DeploymentHandle of its deployment
        self._models = model_handles

    def __call__(self, request) -> Any:
        path = request.path
        if path.endswith("/v1/models") or path == "/models":
            return {
                "object": "list",
                "data": [
                    {"id": name, "object": "model", "owned_by": "ray_tpu"}
                    for name in self._models
                ],
            }
        try:
            body = request.json()
        except Exception:  # noqa: BLE001 — any unparsable body is the client's error
            return {"error": {"message": "invalid JSON body", "code": 400}}
        model = (body or {}).get("model")
        handle = self._models.get(model)
        if handle is None and model and ":" in model:
            # a multi-LoRA model id "<base>:<adapter>": the base deployment
            # serves it, the engine picks the adapter
            base, _, adapter = model.partition(":")
            handle = self._models.get(base)
            if handle is not None:
                body["_lora"] = adapter
        if handle is None:
            if len(self._models) == 1 and model is None:
                handle = next(iter(self._models.values()))
            else:
                return {"error": {"message": f"model {model!r} not found", "code": 404}}
        if path.endswith("/chat/completions"):
            if body.get("stream"):
                return self._sse(handle.options(stream=True).chat_stream.remote(body))
            return handle.chat.remote(body).result(timeout_s=CHUNK_TIMEOUT_S)
        if path.endswith("/completions"):
            if body.get("stream"):
                return self._sse(handle.options(stream=True).completions_stream.remote(body))
            return handle.completions.remote(body).result(timeout_s=CHUNK_TIMEOUT_S)
        return {"error": {"message": f"unknown route {path}", "code": 404}}

    @staticmethod
    def _sse(chunks):
        """The model deployment's chunks as an SSE stream: the router's own
        generator streams through its replica, so tokens flow model replica
        -> the driver's router -> router replica -> proxy -> socket, chunk
        by chunk. Dropping this generator cancels the model's stream."""
        from ray_tpu_torch.serve.streaming import StreamStart

        def gen():
            try:
                yield StreamStart("text/event-stream")
                while True:
                    try:
                        chunk = chunks.next(timeout_s=CHUNK_TIMEOUT_S)
                    except StopIteration:
                        break
                    yield f"data: {json.dumps(chunk)}\n\n"
                yield "data: [DONE]\n\n"
            finally:
                chunks.cancel()

        return gen()
