"""Prefill/decode disaggregated serving: the port's counterpart of
``ray_tpu/llm/disagg.py``.

Prefill and decode run in separate workers, sized independently (prefill
is compute-bound, decode memory-bound), and the KV cache is handed from
one to the other through host memory, as the reference's object plane
carries it: ``PrefillWorker.prefill`` returns the whole cache of one
request, [L, 1, KV, S, D] per k and v, on the host, and
``DecodeWorker.decode`` copies it into its own device cache and decodes.

A bf16 cache crosses as a CPU ``torch`` tensor (numpy holds no bf16), any
other dtype as a numpy array; ``decode`` takes either, so a handoff from
the JAX package's ``PrefillWorker`` decodes here too.

``DisaggRouter`` takes two kinds of handle by duck typing: objects whose
``prefill``/``decode`` are plain methods (both workers in one process), or
serve deployment handles (``.prefill.remote(...)`` returning a response
with ``.result(timeout_s=)``), so the port's classes can sit behind a serve
runtime without this module importing one. The reference's
``build_pd_disagg_app`` is serve wiring and has no counterpart here.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.llm.config import LLMConfig
from ray_tpu_torch.llm.engine import DecodeGraph, build_model
from ray_tpu_torch.llm.tokenizer import get_tokenizer
from ray_tpu_torch.models.llama import decode_step, init_kv_cache, prefill


def _to_host(t: torch.Tensor):
    """A device tensor on the host: a numpy array, or a CPU tensor for a
    dtype numpy does not hold (bf16). From a card it lands in pinned
    memory, which the decode side copies back without staging."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.device.type == "cuda")
    host.copy_(t)
    return host if host.dtype == torch.bfloat16 else host.numpy()


class PrefillWorker:
    """Prompt -> KV handoff: the reference's bucketed one-shot prefill
    (``ray_tpu/llm/disagg.py:25-74``) on ``device`` (CUDA unless the caller
    names another)."""

    def __init__(self, llm_config: LLMConfig, device=None):
        self.config = llm_config
        self.device = resolve_device(device)
        self.tokenizer = get_tokenizer(llm_config.model.tokenizer)
        self.model_cfg, self.params = build_model(llm_config, self.tokenizer, self.device)
        # the last call's times (ms) and handoff size
        self.last: dict = {}

    def prefill(self, prompt: str) -> dict:
        """{k, v, length, first_token, prompt_token_ids}: the prompt's last
        max_seq_len - 1 tokens, padded to the first prefill bucket that
        fits, prefilled into a fresh one-row cache; the first token is the
        argmax of the last logits."""
        ec = self.config.engine
        ids = self.tokenizer.encode(prompt)[-(ec.max_seq_len - 1):]
        bucket = next((b for b in ec.prefill_buckets if b >= len(ids)), ec.max_seq_len)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, : len(ids)] = ids
        t0 = time.perf_counter()
        with torch.inference_mode():
            cache = init_kv_cache(self.model_cfg, 1, ec.max_seq_len, self.device)
            last, cache = prefill(self.params, cache, torch.from_numpy(toks).to(self.device),
                                  self.model_cfg,
                                  lengths=torch.tensor([len(ids)], dtype=torch.int32,
                                                       device=self.device))
            first = int(last[0].argmax())  # waits for the prefill
            t1 = time.perf_counter()
            k, v = _to_host(cache["k"]), _to_host(cache["v"])
        t2 = time.perf_counter()
        nbytes = 2 * cache["k"].numel() * cache["k"].element_size()
        self.last = {"prefill_ms": (t1 - t0) * 1e3, "to_host_ms": (t2 - t1) * 1e3,
                     "handoff_bytes": nbytes, "bucket": bucket}
        return {"k": k, "v": v, "length": len(ids), "first_token": first,
                "prompt_token_ids": list(ids)}


class DecodeWorker:
    """KV handoff -> generated tokens (``ray_tpu/llm/disagg.py:77-130``):
    greedy decode of one request at a time over the worker's own one-row
    cache of max_seq_len positions. On CUDA the step is one ``DecodeGraph``
    over that cache, captured at construction on the empty cache (the
    reference jit-compiles its B = 1 step) and replayed once per step; each
    handoff is copied into the same cache and its length and first token
    are written in place, so no earlier request's cache stays alive. On the
    CPU the step runs eagerly. Calls are serialised: there is one cache."""

    def __init__(self, llm_config: LLMConfig, device=None):
        self.config = llm_config
        self.device = resolve_device(device)
        self.tokenizer = get_tokenizer(llm_config.model.tokenizer)
        self.model_cfg, self.params = build_model(llm_config, self.tokenizer, self.device)
        self.cache = init_kv_cache(self.model_cfg, 1, llm_config.engine.max_seq_len, self.device)
        self.tokens = torch.zeros((1,), dtype=torch.int32, device=self.device)
        self.graph = None
        if self.device.type == "cuda":
            with torch.cuda.device(self.device), torch.inference_mode():
                self.graph = DecodeGraph(self.params, self.cache, self.tokens, self.model_cfg)
        self._lock = threading.Lock()
        self.counts = {"decode_steps": 0, "decode_graph_replays": 0}
        # the last call's times (ms)
        self.last: dict = {}

    def _adopt(self, handoff: dict) -> None:
        """The handoff's cache into this worker's, in place."""
        for name in ("k", "v"):
            src = handoff[name]
            if not torch.is_tensor(src):
                src = np.asarray(src)  # a JAX array or numpy; a read-only one is copied
                src = torch.from_numpy(src if src.flags.writeable else src.copy())
            if tuple(src.shape) != tuple(self.cache[name].shape):
                raise ValueError(f"handoff {name}: shape {tuple(src.shape)} != this worker's "
                                 f"cache {tuple(self.cache[name].shape)}")
            self.cache[name].copy_(src)
        self.cache["length"].fill_(int(handoff["length"]))

    def decode(self, handoff: dict, max_tokens: int = 64) -> dict:
        """{token_ids, text}: the first token, then greedy steps until EOS
        (not kept), ``max_tokens`` tokens, or the prompt and the tokens
        filling max_seq_len, as the reference stops (``:118-126``; it
        ignores ``ignore_eos`` here, and so does this)."""
        with self._lock, torch.inference_mode():
            t0 = time.perf_counter()
            self._adopt(handoff)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t1 = time.perf_counter()
            out = [int(handoff["first_token"])]
            self.tokens.fill_(out[0])
            eos = self.tokenizer.eos_id
            steps = 0
            for _ in range(max_tokens - 1):
                if self.graph is not None:
                    logits = self.graph.replay()
                    self.counts["decode_graph_replays"] += 1
                else:
                    logits, _ = decode_step(self.params, self.cache, self.tokens, self.model_cfg)
                steps += 1
                nxt = logits[0].argmax().to(torch.int32)
                self.tokens.copy_(nxt.view(1))
                tok = int(nxt)
                if tok == eos:
                    break
                out.append(tok)
                if handoff["length"] + len(out) >= self.config.engine.max_seq_len:
                    break
            t2 = time.perf_counter()
            self.counts["decode_steps"] += steps
            self.last = {"to_device_ms": (t1 - t0) * 1e3, "decode_ms": (t2 - t1) * 1e3,
                         "decode_steps": steps}
        return {"token_ids": out, "text": self.tokenizer.decode(out)}


def _call(handle, method: str, *args):
    """``handle.method(*args)``: a plain method's result, or a serve
    handle's response (``.method.remote(*args)``), left unresolved."""
    fn = getattr(handle, method)
    remote = getattr(fn, "remote", None)
    return fn(*args) if remote is None else remote(*args)


class DisaggRouter:
    """Ingress: prefill -> KV handoff -> decode
    (``ray_tpu/llm/disagg.py:133-151``). A request is a body dict or has
    ``.json()``: {prompt, max_tokens (64)}. With serve handles the prefill
    response goes to decode unresolved, so the runtime forwards the handoff
    from replica to replica, as in the reference."""

    def __init__(self, prefill_handle, decode_handle):
        self.prefill = prefill_handle
        self.decode = decode_handle

    def __call__(self, request) -> dict:
        body = request.json() if hasattr(request, "json") else request
        prompt = body.get("prompt", "")
        max_tokens = int(body.get("max_tokens", 64))
        handoff = _call(self.prefill, "prefill", prompt)
        result = _call(self.decode, "decode", handoff, max_tokens)
        if hasattr(result, "result"):
            result = result.result(timeout_s=600)
        return {"text": result["text"], "num_tokens": len(result["token_ids"])}
