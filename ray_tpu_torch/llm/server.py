"""LLMServer: OpenAI-shaped methods over one TorchEngine.

Counterpart of ``ray_tpu/llm/server.py``: the same request and reply
shapes, hosted on the port's engine. A replica = one engine = one CUDA
device, or, for a tensor- or sequence-parallel config, a gang of rank
processes, one a card (``TorchEngine`` gives a ``llm/gang.py:GangEngine``
then, adapters included). ``GangLLMServer``'s OpenAI methods are this
class's over its gang. LoRA adapters load from in-memory weights or from a checkpoint
path (the port's or the JAX package's format, ``train/checkpoint.py``); a
request picks one with ``"_lora"`` and gets an OpenAI-style 404 for an
adapter the replica does not serve.
"""

from __future__ import annotations

import time

import torch

from ray_tpu_torch.llm.config import LLMConfig, SamplingParams
from ray_tpu_torch.llm.engine import TorchEngine
from ray_tpu_torch.train.checkpoint import read_manifest, restore_state_dict, torch_dtype


def _sampling(body: dict) -> SamplingParams:
    """A request body's sampling fields. Besides the JAX server's
    max_tokens/temperature/top_k, ``ignore_eos`` passes through (an extra
    field vLLM's OpenAI server also takes), so a client can ask for a fixed
    number of tokens, and ``seed`` as the JAX package's gang server takes it."""
    return SamplingParams(
        max_tokens=body.get("max_tokens", 64),
        temperature=body.get("temperature", 0.0),
        top_k=body.get("top_k", 50),
        ignore_eos=bool(body.get("ignore_eos", False)),
        seed=body.get("seed"),
    )


def _error_reply(e: BaseException) -> dict:
    return {"error": {"message": str(e), "code": 400}}


class LLMServer:
    """``engine`` serves an engine built elsewhere (``GangLLMServer`` passes
    its ``GangEngine``); the server shuts it down if an adapter fails to
    load. ``reply_errors`` are the exceptions of submitting or waiting that
    the OpenAI methods answer with a 400 reply instead of raising (the
    gang's: a rank group that is down or shut down, a timed-out wait)."""

    def __init__(self, llm_config: LLMConfig, device=None, *, engine=None,
                 reply_errors: tuple = ()):
        self.llm_config = llm_config
        self.reply_errors = reply_errors
        self.engine = TorchEngine(llm_config, device=device) if engine is None else engine
        try:
            for name, weights in (llm_config.lora_adapters or {}).items():
                self.load_lora(name, weights)
        except BaseException:
            self.engine.shutdown()
            raise

    # -- multi-LoRA ----------------------------------------------------------

    def load_lora(self, name: str, path_or_weights) -> bool:
        """Load an adapter into this replica's engine stack. Weights are a
        dict {wq_a, wq_b, wv_a, wv_b} of tensors or numpy arrays
        (``TorchEngine.add_lora``), or a checkpoint path
        (``ray_tpu/llm/server.py:39-43``), read against the engine's adapter
        shapes in the dtype it was saved in; ``add_lora`` casts, as the JAX
        engine does."""
        weights = path_or_weights
        if isinstance(path_or_weights, str):
            if self.engine.loras is None:
                raise ValueError("engine built with max_loras=0")
            metas = read_manifest(path_or_weights)["leaves"]
            # a flat dict's leaves are its keys in sorted order
            like = {k: torch.empty(v.shape[:1] + v.shape[2:], dtype=torch_dtype(m["dtype"]),
                                   device="meta")
                    for (k, v), m in zip(sorted(self.engine.loras.items()), metas)}
            weights = restore_state_dict(path_or_weights, like=like)
        self.engine.add_lora(name, weights)
        return True

    def unload_lora(self, name: str) -> bool:
        self.engine.remove_lora(name)
        return True

    def list_loras(self) -> list[str]:
        return self.engine.list_loras()

    def _lora_error(self, body: dict):
        """OpenAI-style 404 for an unknown adapter, instead of a raw
        KeyError escaping as a 500."""
        lora = body.get("_lora")
        if lora and lora not in self.engine.list_loras():
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
        try:
            out = self.engine.generate(prompt, sampling_params=params, lora=body.get("_lora"))
        except self.reply_errors as e:
            return _error_reply(e)
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
        try:
            out = self.engine.generate(prompt, sampling_params=params, lora=body.get("_lora"))
        except self.reply_errors as e:
            return _error_reply(e)
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
        try:
            req = self.engine.submit(prompt, sampling_params=params, lora=body.get("_lora"))
        except self.reply_errors as e:
            yield _error_reply(e)
            return
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
        try:
            req = self.engine.submit(prompt, sampling_params=params, lora=body.get("_lora"))
        except self.reply_errors as e:
            yield _error_reply(e)
            return
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
