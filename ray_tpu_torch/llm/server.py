"""LLMServer: OpenAI-shaped methods over one TorchEngine.

Counterpart of ``ray_tpu/llm/server.py``: the same request and reply
shapes, hosted on the port's engine. A replica = one engine = one CUDA
device. Loading LoRA adapters comes with the port's LoRA slice; until then
a request naming an adapter gets the OpenAI-style 404 that an unknown
adapter gets.
"""

from __future__ import annotations

import time

from ray_tpu_torch.llm.config import LLMConfig, SamplingParams
from ray_tpu_torch.llm.engine import TorchEngine


def _sampling(body: dict) -> SamplingParams:
    """A request body's sampling fields. Besides the JAX server's
    max_tokens/temperature/top_k, ``ignore_eos`` passes through (an extra
    field vLLM's OpenAI server also takes), so a client can ask for a fixed
    number of tokens."""
    return SamplingParams(
        max_tokens=body.get("max_tokens", 64),
        temperature=body.get("temperature", 0.0),
        top_k=body.get("top_k", 50),
        ignore_eos=bool(body.get("ignore_eos", False)),
    )


class LLMServer:
    def __init__(self, llm_config: LLMConfig, device=None):
        if llm_config.lora_adapters:
            raise NotImplementedError(
                "LoRA adapters are not ported yet (a later slice of the port)"
            )
        self.llm_config = llm_config
        self.engine = TorchEngine(llm_config, device=device)

    def _lora_error(self, body: dict):
        """OpenAI-style 404 for an adapter this replica does not serve (no
        adapter is loadable before the LoRA slice)."""
        lora = body.get("_lora")
        if lora:
            return {
                "error": {
                    "message": f"LoRA adapter {lora!r} not found on "
                    f"{self.llm_config.served_name}",
                    "code": 404,
                }
            }
        return None

    # -- OpenAI-shaped methods ----------------------------------------------

    def completions(self, body: dict) -> dict:
        err = self._lora_error(body)
        if err is not None:
            return err
        prompt = body.get("prompt", "")
        params = _sampling(body)
        out = self.engine.generate(prompt, sampling_params=params)
        return {
            "id": f"cmpl-{out.request_id}",
            "object": "text_completion",
            "created": int(time.time()),
            "model": self.llm_config.served_name,
            "choices": [
                {
                    "index": 0,
                    "text": out.text,
                    "finish_reason": out.finish_reason,
                }
            ],
            "usage": {
                "prompt_tokens": len(out.prompt_token_ids),
                "completion_tokens": len(out.token_ids),
                "total_tokens": len(out.prompt_token_ids) + len(out.token_ids),
            },
        }

    def chat(self, body: dict) -> dict:
        err = self._lora_error(body)
        if err is not None:
            return err
        messages = body.get("messages", [])
        prompt = self._render_chat(messages)
        params = _sampling(body)
        out = self.engine.generate(prompt, sampling_params=params)
        return {
            "id": f"chatcmpl-{out.request_id}",
            "object": "chat.completion",
            "created": int(time.time()),
            "model": self.llm_config.served_name,
            "choices": [
                {
                    "index": 0,
                    "message": {"role": "assistant", "content": out.text},
                    "finish_reason": out.finish_reason,
                }
            ],
            "usage": {
                "prompt_tokens": len(out.prompt_token_ids),
                "completion_tokens": len(out.token_ids),
                "total_tokens": len(out.prompt_token_ids) + len(out.token_ids),
            },
        }

    def completions_stream(self, body: dict):
        """Generator of OpenAI ``text_completion`` chunk dicts — one per
        generated token as the engine emits it (reference: the vLLM-engine
        streaming path in ``llm/_internal/serve/deployments/llm/llm_server.py``)."""
        err = self._lora_error(body)
        if err is not None:
            yield err
            return
        prompt = body.get("prompt", "")
        params = _sampling(body)
        req = self.engine.submit(prompt, sampling_params=params)
        created = int(time.time())
        for inc in self.engine.drain(req):
            yield {
                "id": f"cmpl-{req.request_id}",
                "object": "text_completion",
                "created": created,
                "model": self.llm_config.served_name,
                "choices": [
                    {"index": 0, "text": inc["text"], "finish_reason": None}
                ],
            }
        yield {
            "id": f"cmpl-{req.request_id}",
            "object": "text_completion",
            "created": created,
            "model": self.llm_config.served_name,
            "choices": [
                {"index": 0, "text": "", "finish_reason": req.finish_reason}
            ],
        }

    def chat_stream(self, body: dict):
        """Generator of OpenAI ``chat.completion.chunk`` dicts."""
        err = self._lora_error(body)
        if err is not None:
            yield err
            return
        prompt = self._render_chat(body.get("messages", []))
        params = _sampling(body)
        req = self.engine.submit(prompt, sampling_params=params)
        created = int(time.time())
        first = True
        for inc in self.engine.drain(req):
            delta = {"content": inc["text"]}
            if first:
                delta["role"] = "assistant"
                first = False
            yield {
                "id": f"chatcmpl-{req.request_id}",
                "object": "chat.completion.chunk",
                "created": created,
                "model": self.llm_config.served_name,
                "choices": [{"index": 0, "delta": delta, "finish_reason": None}],
            }
        yield {
            "id": f"chatcmpl-{req.request_id}",
            "object": "chat.completion.chunk",
            "created": created,
            "model": self.llm_config.served_name,
            "choices": [
                {"index": 0, "delta": {}, "finish_reason": req.finish_reason}
            ],
        }

    @staticmethod
    def _render_chat(messages: list[dict]) -> str:
        parts = []
        for m in messages:
            parts.append(f"<|{m.get('role', 'user')}|>{m.get('content', '')}")
        parts.append("<|assistant|>")
        return "".join(parts)

    # -- ops ----------------------------------------------------------------

    def model_info(self) -> dict:
        return {
            "id": self.llm_config.served_name,
            "object": "model",
            "owned_by": "ray_tpu_torch",
        }

    def stats(self) -> dict:
        return self.engine.get_stats()

    def check_health(self):
        if not self.engine._thread.is_alive():
            raise RuntimeError("engine loop died")
