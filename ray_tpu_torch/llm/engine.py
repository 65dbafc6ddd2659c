"""TorchEngine: continuous-batching LLM inference on one CUDA device.

Counterpart of ``ray_tpu/llm/engine.py:JaxEngine``, with the same public
surface and the same host logic:

- a fixed decode batch of slots per KV stripe pool (``_Pool``), each slot
  owning one stripe of the head-major cache; short requests route to short
  pools;
- chunked prefill into a scratch stripe (mid-chunks skip the LM head), the
  final chunk sampling the first token and copying the stripe into the
  pool slot;
- a bucket-aligned prefix cache;
- K decode steps per program (``decode_steps``, a Python loop here where
  JAX scans) with up to ``decode_runahead`` programs in flight. On CUDA
  each pool's decode step is one CUDA graph (``DecodeGraph``), captured
  when the pool is built and replayed once per step, as JAX runs the step
  as one compiled program; sampling runs eagerly between replays. On the
  CPU the step runs eagerly;
- greedy / top-k / temperature sampling on the device with one
  ``torch.Generator`` per slot, seeded per request, so a seeded request
  draws the same tokens whatever shares its batch;
- MoE models (the dropless serving FFN) and multi-LoRA serving: adapters
  live stacked on the device and each slot reads its own by index, so one
  decode graph serves any mix of adapters.

Nothing on the launch path waits for the device: token ids, lengths and
positions reach the device through pinned non-blocking copies or fill
kernels, and results come back through a non-blocking copy into pinned host
memory plus a recorded CUDA event (``_Fetch``). The loop reads a result once
its event has completed, and waits on one only when run-ahead is used up.

``ModelConfig.checkpoint_path`` names a checkpoint of the params (written
by the port's ``train.save_state_dict`` or the JAX package's
``save_pytree``): it is read against a meta template of ``init_params``'
shapes and copied to the device leaf by leaf, so the device holds one copy
of the params. Tensor/sequence parallelism raises ``NotImplementedError``:
it comes with the multi-device slice.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import queue
import random
import threading
import time
import uuid
from collections import OrderedDict, deque
from typing import Iterator, Optional, Union

import numpy as np
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.llm.config import LLMConfig, SamplingParams, resolve_llama_config
from ray_tpu_torch.llm.pacing import TokenPacer
from ray_tpu_torch.llm.tokenizer import get_tokenizer
from ray_tpu_torch.models.convert import _to_tensor
from ray_tpu_torch.models.llama import (
    decode_step,
    init_kv_cache,
    init_lora_stack,
    init_params,
    param_template,
    prefill,
)
from ray_tpu_torch.ops import add_launch_counts, launch_counts
from ray_tpu_torch.train.checkpoint import restore_state_dict

logger = logging.getLogger(__name__)

_LATER = "is not ported yet (a later slice of the port)"


@dataclasses.dataclass
class RequestOutput:
    request_id: str
    prompt_token_ids: list
    token_ids: list
    text: str
    finish_reason: str  # "stop" | "length"
    metrics: dict


class _Request:
    def __init__(self, request_id: str, token_ids: list[int], params: SamplingParams,
                 lora_idx: int = 0):
        self.request_id = request_id
        self.lora_idx = lora_idx  # adapter stack slot; 0 = the base model
        self.prompt_token_ids = token_ids
        self.params = params
        self.out_tokens: list[int] = []
        self.finish_reason: Optional[str] = None
        self.done = threading.Event()
        self.stream_queue: "queue.Queue" = queue.Queue()
        self.submitted_t = time.time()
        self.first_token_t: Optional[float] = None
        self.error: Optional[BaseException] = None
        self.prefix_hit_tokens = 0
        self.pacer = TokenPacer()  # smooths multi-step token bursts for SSE


class _Admission:
    """Chunked-prefill state for one slot being filled."""

    def __init__(self, req: _Request, slot: int, one, chunks: list):
        self.req = req
        self.slot = slot
        self.one = one  # scratch cache [L, 1, K, stripe, D] being extended
        self.chunks = chunks  # [(tokens_np [1, C], eff_len, start, is_final)]
        self.idx = 0


class _Fetch:
    """A small device result the host reads later, without a sync at launch.

    On CUDA: a non-blocking copy into pinned host memory and an event
    recorded after it; ``ready`` polls the event, ``result`` waits on it.
    On the CPU the result is already there. ``start`` (an event recorded
    before the work) gives the work's device time."""

    __slots__ = ("host", "event", "start")

    def __init__(self, t: torch.Tensor, start: Optional["torch.cuda.Event"] = None):
        self.start = start
        if t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event(enable_timing=start is not None)
            self.event.record()
        else:
            self.host = t.clone()
            self.event = None

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def result(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()

    def device_ms(self) -> Optional[float]:
        if self.start is None or self.event is None:
            return None
        return self.start.elapsed_time(self.event)


class DecodeGraph:
    """One ``decode_step`` over a fixed cache, captured as a CUDA graph.

    ``tokens`` [B] int32 is the graph's input and ``logits`` [B, V] fp32 its
    output. Both stay at fixed addresses, as do the params and the cache the
    graph reads: write the next tokens with ``tokens.copy_`` and read
    ``logits`` before the next replay (stream order does both). With
    ``loras`` the graph also reads the adapter stacks and ``adapter_ids``
    [B], written in place the same way.

    The warm-up calls before the capture really run: they write K/V at the
    cache's positions ``length`` onwards, where no live entry is, and
    ``length`` is restored after them. The capture records kernels without
    running them, so the launches the kernel wrappers counted during it are
    taken back, and each replay adds them again: the counters
    (``ops.launch_counts``) count kernels that ran. A capture or replay
    that fails raises."""

    def __init__(self, params, cache, tokens, cfg, loras=None, adapter_ids=None):
        device = tokens.device
        length = cache["length"].clone()
        lora_kw = {} if loras is None else {"loras": loras, "adapter_ids": adapter_ids}
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(2):
                decode_step(params, cache, tokens, cfg, **lora_kw)
        torch.cuda.current_stream(device).wait_stream(side)
        before = launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.logits, _ = decode_step(params, cache, tokens, cfg, **lora_kw)
        after = launch_counts()
        # kernel name -> launches of one replay
        self.launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        add_launch_counts({k: -n for k, n in self.launches.items()})
        cache["length"].copy_(length)

    def replay(self) -> torch.Tensor:
        """One decode step: the logits of ``tokens`` at each row's position."""
        self.graph.replay()
        add_launch_counts(self.launches)
        return self.logits


class _Pool:
    """One KV stripe class: ``n_slots`` decode slots of ``stripe_len``
    positions each. Short requests route to short pools so they never pin
    max_seq_len-sized KV memory."""

    def __init__(self, stripe_len: int, n_slots: int, model_cfg, device):
        self.stripe_len = stripe_len
        self.n_slots = n_slots
        self.cache = init_kv_cache(model_cfg, n_slots, stripe_len, device)
        self.slots: list[Optional[_Request]] = [None] * n_slots
        self.temps = np.zeros((n_slots,), np.float32)
        self.top_ks = np.full((n_slots,), 50, np.int32)
        # per-slot sampling generators, replaced at each admission
        self.gens: list[Optional[torch.Generator]] = [None] * n_slots
        # device-resident next-token inputs: decode programs chain on these
        # without a host round trip (run-ahead); the decode graph's input,
        # so only ever written in place
        self.dev_tokens = torch.zeros((n_slots,), dtype=torch.int32, device=device)
        # each slot's adapter (0 = base), read by the decode graph like
        # dev_tokens, and its host copy
        self.adapter_ids = torch.zeros((n_slots,), dtype=torch.int32, device=device)
        self.adapter_host = np.zeros((n_slots,), np.int32)
        self.graph: Optional[DecodeGraph] = None  # CUDA only
        self.admitting: dict[int, _Admission] = {}
        # launched work whose results are still on their way to the host, in
        # launch order: ("first", slot, req, fetch) for a final prefill
        # chunk's first token, ("decode", {slot: req} binding, fetch) for a
        # decode program's [K, slots] tokens
        self.inflight: "deque" = deque()

    def decodes_inflight(self) -> int:
        return sum(1 for item in self.inflight if item[0] == "decode")


class TorchEngine:
    """On CUDA the decode graphs read ``params``, the LoRA stacks and each
    pool's cache at the addresses they had when the engine was built:
    update weights in place (``copy_``). Assigning ``params`` raises once a
    graph exists."""

    def __init__(self, config: LLMConfig, device: Union[str, torch.device, None] = None):
        self.device = resolve_device(device)
        self.config = config
        ec = config.engine
        if ec.tensor_parallel_degree > 1 or ec.sequence_parallel_degree > 1:
            raise NotImplementedError(f"tensor/sequence-parallel serving {_LATER}")
        self.tokenizer = get_tokenizer(config.model.tokenizer)
        self._build_model()
        # multi-LoRA: stacked adapters (slot 0 = base, all zero) and the
        # name -> slot registry. None at max_loras=0: the decode graph then
        # has no adapter inputs at all.
        self.loras = (
            init_lora_stack(self.model_cfg, ec.max_loras, ec.lora_rank, self.device)
            if ec.max_loras > 0 else None
        )
        self._lora_ids: dict[str, int] = {}
        # held by the loop while it launches device work, and by add_lora /
        # remove_lora while they write the stacks, so a write never lands
        # between the launches of one step
        self._launch_lock = threading.Lock()
        self._build_pools()
        for pool in self._pools:
            self._capture(pool)
        # one static top-K for the decode sampler AND the first-token sampler
        self._top_k_static = min(64, self.model_cfg.vocab_size)
        self._ranks = torch.arange(self._top_k_static, device=self.device)
        self._decode_n_steps = max(1, ec.decode_steps)
        # draws the seed of every request that does not bring its own
        self._seed_rng = random.Random(config.model.seed)
        self._waiting: "queue.Queue[_Request]" = queue.Queue()
        self._backlog: list[_Request] = []  # engine-thread-owned FIFO
        self._stop = threading.Event()
        # prefix cache: sha1(prompt[:bucket]) -> {k, v} device stripes
        self._prefix_cache: "OrderedDict[bytes, dict]" = OrderedDict()
        self._prefix_bytes = 0
        self._prefix_hits = 0
        self._prefix_misses = 0
        # work counters (read by get_stats; the kernel launch count of a run
        # follows from them)
        self._counts = {
            "decode_programs": 0, "decode_steps": 0, "decode_graph_replays": 0,
            "prefill_mid_chunks": 0, "prefill_final_chunks": 0,
            # device time of decode programs whose results reached the host
            # (CUDA events; stays 0 on the CPU)
            "decode_device_ms": 0.0, "decode_programs_timed": 0,
        }
        self._thread = threading.Thread(
            target=self._engine_loop, daemon=True, name="llm-engine"
        )
        self._thread.start()

    def _build_pools(self):
        ec = self.config.engine
        buckets = tuple(ec.seq_len_buckets) or (ec.max_seq_len,)
        if sorted(buckets)[-1] != ec.max_seq_len:
            raise ValueError(f"seq_len_buckets must end at max_seq_len={ec.max_seq_len}")
        if ec.seqs_per_bucket:
            counts = tuple(ec.seqs_per_bucket)
            if len(counts) != len(buckets) or sum(counts) != ec.max_num_seqs:
                raise ValueError(
                    "seqs_per_bucket must parallel seq_len_buckets and sum to max_num_seqs"
                )
        else:
            base = ec.max_num_seqs // len(buckets)
            counts = list(
                base + (1 if i < ec.max_num_seqs % len(buckets) else 0)
                for i in range(len(buckets))
            )
            # the max_seq_len class must always exist: without it, long
            # requests silently truncate to a shorter stripe
            ordered = sorted(range(len(buckets)), key=lambda i: buckets[i])
            if counts[ordered[-1]] == 0:
                donor = max(ordered, key=lambda i: counts[i])
                counts[donor] -= 1
                counts[ordered[-1]] = 1
        if dict(zip(buckets, counts)).get(ec.max_seq_len, 0) <= 0:
            raise ValueError(
                "seqs_per_bucket must give the max_seq_len bucket at least one slot "
                "(long requests would silently truncate)"
            )
        self._pools = [
            _Pool(b, n, self.model_cfg, self.device)
            for b, n in sorted(zip(buckets, counts))
            if n > 0
        ]

    # -- model setup --------------------------------------------------------

    @property
    def params(self) -> dict:
        return self._params

    @params.setter
    def params(self, params: dict) -> None:
        if any(pool.graph is not None for pool in getattr(self, "_pools", ())):
            raise RuntimeError(
                "the decode graphs read the params they were captured with: update the "
                "tensors in place (copy_) instead of assigning new ones"
            )
        self._params = params

    def _build_model(self):
        mc, ec = self.config.model, self.config.engine
        self.model_cfg = resolve_llama_config(mc, ec, min_vocab=self.tokenizer.vocab_size)
        if mc.checkpoint_path:
            # the JAX engine's restore_pytree (ray_tpu/llm/engine.py:207-208),
            # checked leaf by leaf against the served config's shapes
            self.params = restore_state_dict(
                mc.checkpoint_path, like=param_template(self.model_cfg), device=self.device
            )
        else:
            self.params = init_params(self.model_cfg, seed=mc.seed, device=self.device)

    # -- device helpers -----------------------------------------------------

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without waiting for the device: a
        pageable copy would synchronise the stream."""
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _int_vec(self, v: int) -> torch.Tensor:
        return torch.full((1,), v, dtype=torch.int32, device=self.device)

    def _sample(self, logits: torch.Tensor, hot: list) -> torch.Tensor:
        """Tokens [n] int32 from fp32 logits [n, V]: argmax for every row,
        except rows in ``hot`` [(row, temp, top_k, generator)] (temp > 0),
        which draw from the static top-K, masked to ``top_k`` ranks and
        scaled by 1/temp (Gumbel-max with the row's own generator)."""
        toks = logits.argmax(dim=-1).to(torch.int32)
        if not hot:
            return toks
        vals, idxs = torch.topk(logits, self._top_k_static, dim=-1)
        for row, temp, top_k, gen in hot:
            scaled = torch.where(
                self._ranks < top_k, vals[row] / max(temp, 1e-6), -float("inf")
            )
            # Exp(1) noise, kept off 0 so a masked -inf rank never meets
            # log(0) = -inf (that would give NaN, which argmax picks)
            noise = torch.empty_like(scaled).exponential_(generator=gen).clamp_min_(1e-30)
            choice = torch.argmax(scaled - noise.log()).view(1)
            toks[row : row + 1].copy_(idxs[row].gather(0, choice))
        return toks

    def _capture(self, pool: _Pool) -> None:
        """On CUDA, the pool's decode step as one graph over its cache, which
        must hold no live request (it is new, or reset by ``_fail_pool``)."""
        if self.device.type != "cuda":
            return
        with torch.cuda.device(self.device), torch.inference_mode():
            pool.graph = DecodeGraph(self.params, pool.cache, pool.dev_tokens, self.model_cfg,
                                     **self._lora_kw(pool.adapter_ids))

    def _lora_kw(self, adapter_ids: torch.Tensor) -> dict:
        """decode_step/prefill keywords of the adapter path; none without
        LoRA, so the no-LoRA programs take no adapter inputs."""
        if self.loras is None:
            return {}
        return {"loras": self.loras, "adapter_ids": adapter_ids}

    def _decode(self, pool: _Pool, hot: list) -> torch.Tensor:
        """K decode steps chained on the pool's device-resident tokens ->
        [K, slots]: on CUDA a replay of the pool's graph each, on the CPU
        an eager ``decode_step``. Each step's tokens are sampled from its
        logits before the next step overwrites them."""
        cuda = self.device.type == "cuda"
        if cuda and pool.graph is None:
            raise RuntimeError("this pool has no decode graph: its capture failed")
        outs = []
        for _ in range(self._decode_n_steps):
            if cuda:
                logits = pool.graph.replay()
                self._counts["decode_graph_replays"] += 1
            else:
                logits, _ = decode_step(self.params, pool.cache, pool.dev_tokens, self.model_cfg,
                                        **self._lora_kw(pool.adapter_ids))
            toks = self._sample(logits, hot)
            pool.dev_tokens.copy_(toks)
            outs.append(toks)
        return torch.stack(outs)

    # -- prefix cache --------------------------------------------------------

    def _prefix_key(self, ids: list[int], m: int) -> bytes:
        return hashlib.sha1(np.asarray(ids[:m], np.int32).tobytes()).digest()

    def _prefix_lookup(self, ids: list[int]):
        """Longest bucket-aligned cached prefix strictly shorter than the
        prompt (>=1 suffix token must remain to produce last-logits)."""
        if not self.config.engine.enable_prefix_caching:
            return None, 0
        for b in sorted(self.config.engine.prefill_buckets, reverse=True):
            if b >= len(ids):
                continue
            key = self._prefix_key(ids, b)
            entry = self._prefix_cache.get(key)
            if entry is not None:
                self._prefix_cache.move_to_end(key)
                self._prefix_hits += 1
                return entry, b
        self._prefix_misses += 1
        return None, 0

    def _prefix_store(self, pool: _Pool, slot: int, ids: list[int]):
        """After a miss prefill: cache this prompt's KV at every bucket
        length it covers, bounded by an entry count and a byte budget. The
        entries are copies: the pool's cache is updated in place."""
        ec = self.config.engine
        if not ec.enable_prefix_caching:
            return
        for b in ec.prefill_buckets:
            if b >= len(ids) or b > pool.stripe_len:
                continue
            key = self._prefix_key(ids, b)
            if key in self._prefix_cache:
                self._prefix_cache.move_to_end(key)
                continue
            k = pool.cache["k"][:, slot, :, :b].clone()  # [L, K, b, D]
            v = pool.cache["v"][:, slot, :, :b].clone()
            nbytes = 2 * k.numel() * k.element_size()
            self._prefix_cache[key] = {"k": k, "v": v, "nbytes": nbytes}
            self._prefix_bytes += nbytes
        while self._prefix_cache and (
            len(self._prefix_cache) > ec.prefix_cache_entries
            or self._prefix_bytes > ec.prefix_cache_max_bytes
        ):
            _, old = self._prefix_cache.popitem(last=False)
            self._prefix_bytes -= old["nbytes"]

    # -- multi-LoRA ----------------------------------------------------------

    def add_lora(self, name: str, adapters: dict) -> int:
        """Load an adapter into a free stack slot and return the slot.
        ``adapters``: {wq_a: [L, e, r], wq_b: [L, r, h, hd], wv_a: [L, e, r],
        wv_b: [L, r, kv, hd]} (tensors or numpy arrays). The stacks are
        written in place: the decode graphs read them where they are."""
        if self.loras is None:
            raise ValueError("engine built with max_loras=0")
        if name in self._lora_ids:
            return self._lora_ids[name]
        used = set(self._lora_ids.values())
        free = [i for i in range(1, self.config.engine.max_loras + 1) if i not in used]
        if not free:
            raise RuntimeError(f"all {self.config.engine.max_loras} LoRA slots in use")
        idx = free[0]
        new = {}
        for k, stack in self.loras.items():
            a = adapters[k] if torch.is_tensor(adapters[k]) else _to_tensor(adapters[k])
            want = stack.shape[:1] + stack.shape[2:]
            if a.shape != want:
                raise ValueError(f"{name}.{k}: shape {tuple(a.shape)} != {tuple(want)}")
            new[k] = a.to(device=self.device, dtype=stack.dtype)
        with self._launch_lock, torch.no_grad():
            for k, stack in self.loras.items():
                stack[:, idx].copy_(new[k])
        self._lora_ids[name] = idx
        return idx

    def remove_lora(self, name: str) -> None:
        idx = self._lora_ids.pop(name, None)
        if idx is None:
            return
        with self._launch_lock, torch.no_grad():
            for stack in self.loras.values():
                stack[:, idx].zero_()

    def list_loras(self) -> list[str]:
        return sorted(self._lora_ids)

    # -- public API ---------------------------------------------------------

    def generate(
        self,
        prompt: Optional[str] = None,
        *,
        prompt_token_ids: Optional[list[int]] = None,
        sampling_params: Optional[SamplingParams] = None,
        lora: Optional[str] = None,
    ) -> RequestOutput:
        req = self.submit(
            prompt, prompt_token_ids=prompt_token_ids,
            sampling_params=sampling_params, lora=lora,
        )
        self._await_done(req)
        if req.error is not None:
            raise req.error
        return self._output(req)

    def generate_stream(
        self,
        prompt: Optional[str] = None,
        *,
        prompt_token_ids: Optional[list[int]] = None,
        sampling_params: Optional[SamplingParams] = None,
        lora: Optional[str] = None,
    ) -> Iterator[dict]:
        """Yields {'token_id', 'text', 'done'} increments."""
        req = self.submit(
            prompt, prompt_token_ids=prompt_token_ids,
            sampling_params=sampling_params, lora=lora,
        )
        yield from self.drain(req)

    def drain(self, req: _Request) -> Iterator[dict]:
        """Token increments of a submitted request until its end sentinel;
        raises the request's error, if any, after the stream ends. Bursts
        from multi-step decode are paced into spaced emissions."""
        while True:
            try:
                item = req.stream_queue.get(timeout=1.0)
            except queue.Empty:
                # a dead or stopped loop never pushes the end sentinel
                if not (self._stop.is_set() or not self._thread.is_alive()):
                    continue
                try:
                    # the loop may have pushed on its way out — sweep once
                    item = req.stream_queue.get_nowait()
                except queue.Empty:
                    if req.error is None:
                        req.error = RuntimeError("engine decode loop exited mid-stream")
                    break
            if item is None:
                break
            req.pacer.gate(backlog=not req.stream_queue.empty())
            yield item
        if req.error is not None:
            raise req.error

    def submit(self, prompt=None, *, prompt_token_ids=None, sampling_params=None,
               lora: Optional[str] = None) -> _Request:
        lora_idx = 0
        if lora:
            if lora not in self._lora_ids:
                raise KeyError(f"unknown LoRA adapter: {lora!r}")
            lora_idx = self._lora_ids[lora]
        if prompt_token_ids is None:
            if prompt is None:
                raise ValueError("prompt or prompt_token_ids required")
            prompt_token_ids = self.tokenizer.encode(prompt)
        max_prompt = self.config.engine.max_seq_len - 1
        if len(prompt_token_ids) > max_prompt:
            prompt_token_ids = prompt_token_ids[-max_prompt:]
        req = _Request(
            uuid.uuid4().hex[:12], list(prompt_token_ids), sampling_params or SamplingParams(),
            lora_idx,
        )
        self._waiting.put(req)
        return req

    def _output(self, req: _Request) -> RequestOutput:
        return RequestOutput(
            request_id=req.request_id,
            prompt_token_ids=req.prompt_token_ids,
            token_ids=list(req.out_tokens),
            text=self.tokenizer.decode(req.out_tokens),
            finish_reason=req.finish_reason or "stop",
            metrics={
                "ttft_s": (req.first_token_t or time.time()) - req.submitted_t,
                "num_generated": len(req.out_tokens),
                "prefix_hit_tokens": req.prefix_hit_tokens,
            },
        )

    def shutdown(self):
        self._stop.set()
        self._thread.join(timeout=5)

    def _await_done(self, req) -> None:
        """Bounded wait with a liveness re-check: a dead or stopped decode
        loop surfaces as a request error, never as a hang."""
        while not req.done.wait(1.0):
            if self._stop.is_set() or not self._thread.is_alive():
                # the loop may have finished THIS request on its way out
                if req.done.wait(0.1):
                    return
                if req.error is None:
                    req.error = RuntimeError(
                        "engine decode loop exited while the request was pending"
                    )
                req.done.set()
                return

    def get_stats(self) -> dict:
        return {
            "active_slots": sum(s is not None for p in self._pools for s in p.slots),
            "admitting": sum(len(p.admitting) for p in self._pools),
            "waiting": self._waiting.qsize() + len(self._backlog),
            "max_num_seqs": sum(p.n_slots for p in self._pools),
            "pools": [
                {"stripe_len": p.stripe_len, "n_slots": p.n_slots,
                 "active": sum(s is not None for s in p.slots)}
                for p in self._pools
            ],
            "prefix_cache_hits": self._prefix_hits,
            "prefix_cache_misses": self._prefix_misses,
            "prefix_cache_entries": len(self._prefix_cache),
            **self._counts,
        }

    # -- engine loop --------------------------------------------------------

    def _bucket(self, n: int) -> int:
        for b in self.config.engine.prefill_buckets:
            if n <= b and b <= self.config.engine.max_seq_len:
                return b
        return self.config.engine.max_seq_len

    def _pool_for(self, req: _Request) -> _Pool:
        """Smallest stripe class covering prompt + generation budget; if
        none fits, the largest pool (out_of_room truncates there)."""
        budget = len(req.prompt_token_ids) + req.params.max_tokens + 1
        for pool in self._pools:  # sorted ascending by stripe_len
            if pool.stripe_len >= budget:
                return pool
        return self._pools[-1]

    def _start_admission(self, pool: _Pool, slot: int, req: _Request) -> None:
        """Build the chunked-prefill plan for a slot (device work starts on
        the next _advance_admissions pass)."""
        ids = req.prompt_token_ids
        if len(ids) > pool.stripe_len - 1:
            ids = ids[-(pool.stripe_len - 1):]
            req.prompt_token_ids = ids
        # an adapted request neither reuses base-model KV (its V carries the
        # adapter's delta) nor stores its own
        prefix, m = self._prefix_lookup(ids) if req.lora_idx == 0 else (None, 0)
        suffix = ids[m:]
        req.prefix_hit_tokens = m
        chunk = self.config.engine.prefill_chunk or len(suffix)
        pieces = [suffix[i : i + chunk] for i in range(0, len(suffix), chunk)]
        chunks = []
        start = m
        for j, piece in enumerate(pieces):
            is_final = j == len(pieces) - 1
            width = min(self._bucket(len(piece)), pool.stripe_len) if is_final else len(piece)
            toks = np.zeros((1, width), np.int32)
            toks[0, : len(piece)] = piece
            chunks.append((toks, len(piece), start, is_final))
            start += len(piece)
        one = init_kv_cache(self.model_cfg, 1, pool.stripe_len, self.device)
        if prefix is not None:
            one["k"][:, 0, :, :m].copy_(prefix["k"])
            one["v"][:, 0, :, :m].copy_(prefix["v"])
        pool.admitting[slot] = _Admission(req, slot, one, chunks)

    def _advance_admission(self, pool: _Pool, adm: _Admission) -> None:
        """Dispatch ONE prompt chunk (device-async). The final chunk
        samples the first token on the device and activates the slot."""
        toks, eff_len, start, is_final = adm.chunks[adm.idx]
        adm.idx += 1
        req = adm.req
        t = self._to_device(toks)
        l, s = self._int_vec(eff_len), self._int_vec(start)
        lora_kw = self._lora_kw(self._int_vec(req.lora_idx))
        if not is_final:
            prefill(self.params, adm.one, t, self.model_cfg, lengths=l, start_pos=s,
                    with_logits=False, **lora_kw)
            self._counts["prefill_mid_chunks"] += 1
            return
        last_logits, one = prefill(
            self.params, adm.one, t, self.model_cfg, lengths=l, start_pos=s, **lora_kw
        )
        self._counts["prefill_final_chunks"] += 1
        slot = adm.slot
        # copy the finished stripe into the pool slot, in place
        pool.cache["k"][:, slot].copy_(one["k"][:, 0])
        pool.cache["v"][:, slot].copy_(one["v"][:, 0])
        pool.cache["length"][slot] = start + eff_len
        seed = req.params.seed if req.params.seed is not None else self._seed_rng.getrandbits(63)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        # decode samples from the static top-K; clamp here so the first
        # token and all later tokens agree
        top_k = min(max(1, req.params.top_k), self._top_k_static)
        temp = float(req.params.temperature)
        hot = [(0, temp, top_k, gen)] if temp > 0.0 else []
        first_tok = self._sample(last_logits, hot)
        pool.gens[slot] = gen
        pool.dev_tokens[slot : slot + 1].copy_(first_tok)
        self._set_adapter(pool, slot, req.lora_idx)
        pool.slots[slot] = req
        pool.temps[slot] = temp
        pool.top_ks[slot] = top_k
        del pool.admitting[slot]
        if req.prefix_hit_tokens == 0 and req.lora_idx == 0:
            self._prefix_store(pool, slot, req.prompt_token_ids)
        pool.inflight.append(("first", slot, req, _Fetch(first_tok)))

    @staticmethod
    def _set_adapter(pool: _Pool, slot: int, idx: int) -> None:
        """The slot's adapter id, written in place (a fill kernel: no sync)
        only when it changes."""
        if pool.adapter_host[slot] != idx:
            pool.adapter_host[slot] = idx
            pool.adapter_ids[slot].fill_(idx)

    def _fail_admission(self, pool: _Pool, adm: _Admission, e: BaseException):
        pool.admitting.pop(adm.slot, None)
        adm.req.error = e
        adm.req.done.set()
        adm.req.stream_queue.put(None)

    def _pull_waiting(self) -> bool:
        """Route waiting requests to free slots and build admission plans.
        The backlog is order-preserving: a head request whose stripe class
        is full must NOT starve shorter requests that fit other pools."""
        try:
            while True:
                self._backlog.append(self._waiting.get_nowait())
        except queue.Empty:
            pass
        if not self._backlog:
            return False
        progressed = False
        still_waiting = []
        for req in self._backlog:
            preferred = self._pool_for(req)
            budget = len(req.prompt_token_ids) + req.params.max_tokens + 1
            target = None
            candidates = [preferred] + [
                p for p in self._pools
                if p is not preferred and p.stripe_len >= min(budget, preferred.stripe_len)
            ]
            for pool in candidates:
                # cap concurrent admissions: each holds a stripe-sized
                # scratch KV, and per-pass prefill work must stay bounded
                if len(pool.admitting) >= self.config.engine.max_concurrent_admissions:
                    continue
                for slot in range(pool.n_slots):
                    if pool.slots[slot] is None and slot not in pool.admitting:
                        target = (pool, slot)
                        break
                if target:
                    break
            if target is None:
                still_waiting.append(req)
                continue
            try:
                self._start_admission(target[0], target[1], req)
                progressed = True
            except Exception as e:  # noqa: BLE001 — fail the request, keep serving
                logger.exception("admission failed")
                req.error = e
                req.done.set()
                req.stream_queue.put(None)
        self._backlog = still_waiting
        return progressed

    def _advance_admissions(self) -> bool:
        progressed = False
        for pool in self._pools:
            for adm in list(pool.admitting.values()):
                try:
                    self._advance_admission(pool, adm)
                    progressed = True
                except Exception as e:  # noqa: BLE001
                    logger.exception("prefill failed")
                    self._fail_admission(pool, adm, e)
        return progressed

    def _launch_decodes(self) -> bool:
        """One decode program per pool with active slots, chained on
        device-resident tokens (no host sync on the launch path)."""
        launched = False
        runahead = max(0, self.config.engine.decode_runahead)
        cuda = self.device.type == "cuda"
        for pool in self._pools:
            active = {s: r for s, r in enumerate(pool.slots) if r is not None}
            if not active or pool.decodes_inflight() > runahead:
                continue
            try:
                hot = [
                    (s, float(pool.temps[s]), int(pool.top_ks[s]), pool.gens[s])
                    for s in active if pool.temps[s] > 0.0
                ]
                start = None
                if cuda:
                    start = torch.cuda.Event(enable_timing=True)
                    start.record()
                out = self._decode(pool, hot)
                pool.inflight.append(("decode", active, _Fetch(out, start)))
                self._counts["decode_programs"] += 1
                self._counts["decode_steps"] += self._decode_n_steps
                launched = True
            except Exception as e:  # noqa: BLE001 — device failure
                self._fail_pool(pool, e)
        return launched

    def _fail_pool(self, pool: _Pool, e: BaseException):
        """Device failure: fail every in-flight request of THIS pool
        (callers must never hang on a dead engine loop) and reset it."""
        logger.error("decode step failed: %r", e)
        for slot, req in enumerate(pool.slots):
            if req is not None:
                pool.slots[slot] = None
                req.error = e
                req.stream_queue.put(None)
                req.done.set()
        for adm in list(pool.admitting.values()):
            self._fail_admission(pool, adm, e)
        pool.inflight.clear()
        pool.cache = init_kv_cache(self.model_cfg, pool.n_slots, pool.stripe_len, self.device)
        pool.dev_tokens.zero_()
        pool.adapter_ids.zero_()
        pool.adapter_host[:] = 0
        pool.gens = [None] * pool.n_slots
        # a new graph over the fresh cache (the capture synchronises the
        # device before the old graph is dropped); if it fails, the pool's
        # decodes raise: it never decodes eagerly on the card
        try:
            self._capture(pool)
        except Exception:  # noqa: BLE001 — reported; the pool stays unusable
            pool.graph = None
            logger.exception("decode graph capture failed")

    def _drain(self) -> bool:
        """Hand arrived results (first tokens, decode programs) to their
        requests, in launch order. A result is read once it is ready; the
        loop waits on the oldest only while more than ``decode_runahead``
        decode programs are in flight. Over-decoded tokens of finished or
        re-admitted slots are dropped via each program's binding snapshot."""
        progressed = False
        runahead = max(0, self.config.engine.decode_runahead)
        for pool in self._pools:
            keep = runahead if any(r is not None for r in pool.slots) else 0
            while pool.inflight:
                must_wait = pool.decodes_inflight() > keep
                item = pool.inflight[0]
                fetch = item[-1]
                if not (must_wait or fetch.ready()):
                    break
                pool.inflight.popleft()
                try:
                    arr = fetch.result()
                except Exception as e:  # noqa: BLE001 — device failure
                    self._fail_pool(pool, e)
                    break
                progressed = True
                if item[0] == "first":
                    _, slot, req, _ = item
                    if pool.slots[slot] is req:
                        req.first_token_t = time.time()
                        self._emit(pool, slot, int(arr[0]))
                    continue
                binding = item[1]
                ms = fetch.device_ms()
                if ms is not None:
                    self._counts["decode_device_ms"] += ms
                    self._counts["decode_programs_timed"] += 1
                applied: dict[int, list] = {}
                for k in range(arr.shape[0]):
                    for slot, req in binding.items():
                        if pool.slots[slot] is req:
                            self._emit(pool, slot, int(arr[k, slot]))
                            entry = applied.setdefault(id(req), [req, 0])
                            entry[1] += 1
                for req, n in applied.values():
                    req.pacer.note_block(n)
        return progressed

    def _engine_loop(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        # inference mode is thread-local: enter it on the loop's own thread
        with torch.inference_mode():
            while not self._stop.is_set():
                progressed = self._pull_waiting()
                with self._launch_lock:
                    progressed |= self._advance_admissions()
                    progressed |= self._launch_decodes()
                progressed |= self._drain()
                if not progressed:
                    time.sleep(0.002)

    def _emit(self, pool: _Pool, slot: int, token: int):
        """Record a generated token for the request in `slot`; finish on
        eos/max_tokens/stripe-full."""
        req = pool.slots[slot]
        if req is None:
            return
        p = req.params
        stop_ids = set(p.stop_token_ids or [])
        if not p.ignore_eos:
            stop_ids.add(self.tokenizer.eos_id)
        is_stop = token in stop_ids
        if not is_stop:
            req.out_tokens.append(token)
            req.stream_queue.put(
                {"token_id": token, "text": self.tokenizer.decode([token]), "done": False}
            )
        total = len(req.prompt_token_ids) + len(req.out_tokens)
        out_of_room = total >= pool.stripe_len
        if is_stop or len(req.out_tokens) >= p.max_tokens or out_of_room:
            req.finish_reason = "stop" if is_stop else "length"
            pool.slots[slot] = None
            self._set_adapter(pool, slot, 0)
            req.stream_queue.put(None)
            req.done.set()
