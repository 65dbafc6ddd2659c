"""Lockstep SPMD generation for gang (multi-process) LLM serving: the port's
counterpart of ``ray_tpu/llm/spmd.py``.

Every process of a gang is one rank of a ``torch.distributed`` world (one
card a rank, NCCL; or gloo on the CPU) and runs the same model program
over its shard of the params and the KV cache (``models/llama.py``'s
serving-mesh path: tp splits heads, kv heads, mlp and vocab; sp and dp
ranks compute what their tp group computes). The JAX package runs one
SPMD program over a global mesh; here each rank issues its own kernels and
the collectives between them.

The lockstep rule carries over unchanged: every rank issues the same
programs in the same order, with the same host control flow, which is a
pure function of the plan stream (``SPMDEngineWorker.step``) or of the
inputs (``SPMDGenerator.generate_batch``). A collective that one rank
skips hangs the gang, it does not fail it.

Sampling is seeded per (request seed, token index): each sampled row draws
with a ``torch.Generator`` seeded from the key pair the plan carries, so a
request's stream does not depend on the batch it shares, on
``decode_steps``, or on a replay after a rebuild. The bits differ from
JAX's threefry, so only greedy tokens compare across the packages. Every
rank samples, then the tokens of world rank 0 are broadcast to all ranks
(one [S] int32 broadcast a step): two ranks can never decode from
different tokens, whatever the last bits of their logits.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch import resolve_device
from ray_tpu_torch.llm.config import LLMConfig, SamplingParams, resolve_llama_config
from ray_tpu_torch.llm.engine import DecodeGraph, sample_tokens
from ray_tpu_torch.llm.tokenizer import get_tokenizer
from ray_tpu_torch.models.llama import (
    decode_step,
    init_kv_cache,
    init_lora_stack,
    init_params,
    param_specs,
    param_template,
    prefill,
)
from ray_tpu_torch.parallel import mesh as pmesh
from ray_tpu_torch.train.checkpoint import restore_state_dict

logger = logging.getLogger(__name__)


def _pad_bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


_M64 = (1 << 64) - 1


def _key_seed(key) -> int:
    """A plan's key pair (seed, token index), as uint32s, mixed into one
    64-bit generator seed (splitmix64's finalizer): the CPU generator keeps
    only the low 32 bits of its seed, so both halves must reach them."""
    x = (((int(key[0]) << 32) | int(key[1])) + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def serving_mesh(config: LLMConfig, device: torch.device):
    """The gang's mesh over the default process group, or None without
    one (one process, no mesh). tp x sp must cover the world; tp = 1 on a
    world of several ranks is the reference's replicated dp mesh
    (``ray_tpu/llm/spmd.py:59-83``)."""
    ec = config.engine
    if not dist.is_initialized():
        if ec.tensor_parallel_degree * ec.sequence_parallel_degree > 1:
            raise ValueError("tensor/sequence-parallel serving runs on a process group of "
                             "tp x sp ranks: serve it as a gang (llm/gang.py)")
        return None
    n = dist.get_world_size()
    if n > 1 and ec.tensor_parallel_degree == 1 and ec.sequence_parallel_degree == 1:
        # tp=1 on a multi-rank world = REPLICATED lockstep: every rank
        # computes the identical full batch over a pure data axis (params
        # and cache replicate; no per-step collective but the token
        # broadcast). Log the choice, so a gang that NEEDS sharding to fit
        # is told which knob gives it instead of running out of memory.
        logger.warning("tp=1 on %d ranks: building a REPLICATED (dp=%d) mesh; set "
                       "tensor_parallel_degree>1 to shard params/KV across the gang", n, n)
        spec = pmesh.MeshSpec(dp=n)
    else:
        spec = pmesh.MeshSpec(tp=ec.tensor_parallel_degree or -1,
                              sp=ec.sequence_parallel_degree)
        try:
            spec = spec.resolve(n)
        except ValueError:
            spec = pmesh.MeshSpec(tp=-1).resolve(n)
    return pmesh.build_mesh(spec, "cpu" if device.type == "cpu" else None)


class SPMDGenerator:
    """Deterministic batched prefill + decode over a (possibly multi-rank)
    serving mesh. Host logic is a pure function of the inputs, so N ranks
    stay in lockstep. ``device`` is CUDA unless the caller names another;
    ``mesh`` defaults to ``serving_mesh`` over the process group."""

    def __init__(self, config: LLMConfig, mesh=None, device=None):
        mc, ec = config.model, config.engine
        self.config = config
        self.device = resolve_device(device)
        self.tokenizer = get_tokenizer(mc.tokenizer)
        self.model_cfg = resolve_llama_config(mc, ec, min_vocab=self.tokenizer.vocab_size)
        self.mesh = mesh if mesh is not None else serving_mesh(config, self.device)
        self.max_seq_len = ec.max_seq_len
        self.prefill_buckets = tuple(ec.prefill_buckets)
        self.params = self._load_params()
        self._ranks = torch.arange(min(64, self.model_cfg.vocab_size), device=self.device)
        self._world = dist.get_world_size() if dist.is_initialized() else 1

    def _load_params(self) -> dict:
        """This rank's shard: drawn as ``init_params(mesh=)`` draws it (the
        numbers of the unsharded init), or cut from the whole checkpoint
        read into host memory (the JAX package's ``save_pytree`` format or
        the port's), leaf by leaf."""
        cfg, mc = self.model_cfg, self.config.model
        if not mc.checkpoint_path:
            return init_params(cfg, seed=mc.seed, device=self.device, mesh=self.mesh)
        whole = restore_state_dict(mc.checkpoint_path, like=param_template(cfg))
        specs = None if self.mesh is None else param_specs(cfg, self.mesh)
        params = {}
        for name in sorted(whole):
            t = whole.pop(name)
            if specs is not None:
                t = t[pmesh.local_slice(self.mesh, specs[name], t.shape)].clone()
            params[name] = t.to(self.device)
        return params

    def to_device(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without waiting for the device."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def sample(self, logits: torch.Tensor, temps, top_ks, keys) -> torch.Tensor:
        """[S] int32 tokens from [S, V] fp32 logits: argmax where
        ``temps`` <= 0, else a draw from the static top-K with a generator
        seeded from the row's key pair ``keys[i]`` (``sample_tokens``).
        World rank 0's tokens are broadcast to every rank."""
        hot = [(i, float(temps[i]), int(top_ks[i]),
                torch.Generator(device=self.device).manual_seed(_key_seed(keys[i])))
               for i in range(len(temps)) if temps[i] > 0.0]
        toks = sample_tokens(logits, hot, self._ranks)
        if self._world > 1:
            dist.broadcast(toks, src=0)
        return toks

    @torch.inference_mode()
    def generate_batch(
        self,
        token_lists: list[list[int]],
        sampling_params: Optional[SamplingParams] = None,
    ) -> list[list[int]]:
        """Generate completions for a batch of prompts, lockstep across the
        gang. Returns per-prompt generated token ids (prompt excluded)."""
        p = sampling_params or SamplingParams()
        cfg = self.model_cfg
        B = len(token_lists)
        lengths = [len(t) for t in token_lists]
        limit = min(self.prefill_buckets[-1], self.max_seq_len - 1)
        if max(lengths) > limit:
            # reject, don't crash the lockstep batch: the caller surfaces
            # this as a 400 (vLLM's prompt-too-long contract)
            raise ValueError(
                f"prompt length {max(lengths)} exceeds the maximum "
                f"{limit} (largest prefill bucket / max_seq_len)"
            )
        T = _pad_bucket(max(lengths), self.prefill_buckets)
        # KV length from the bucket ladder, not T + max_tokens: shapes stay
        # independent of the request (the JAX program's compile rule)
        max_len = self.max_seq_len
        for b in self.prefill_buckets:
            if T + p.max_tokens <= b:
                max_len = min(b, self.max_seq_len)
                break
        toks = np.zeros((B, T), np.int32)
        for i, t in enumerate(token_lists):
            toks[i, : len(t)] = t

        cache = init_kv_cache(cfg, B, max_len, self.device, self.mesh)
        logits, cache = prefill(self.params, cache, self.to_device(toks), cfg,
                                lengths=self.to_device(np.asarray(lengths, np.int32)),
                                mesh=self.mesh)
        seed = (p.seed if p.seed is not None else 0) & 0xFFFFFFFF
        temps = np.full((B,), p.temperature, np.float32)
        top_ks = np.full((B,), p.top_k, np.int32)
        nxt = self.sample(logits, temps, top_ks, [(seed, 0)] * B)

        eos = self.tokenizer.eos_id
        stop = set(p.stop_token_ids or ())
        out: list[list[int]] = [[] for _ in range(B)]
        finished = [False] * B
        steps = min(p.max_tokens, max_len - max(lengths))
        for step in range(steps):
            host_tok = nxt.cpu().tolist()
            for i in range(B):
                if finished[i]:
                    continue
                t = host_tok[i]
                # ignore_eos exempts only EOS, never user stop tokens
                if (t == eos and not p.ignore_eos) or t in stop:
                    finished[i] = True
                    continue
                out[i].append(t)
                if len(out[i]) >= p.max_tokens:
                    finished[i] = True
            if all(finished) or step == steps - 1:
                break
            logits, cache = decode_step(self.params, cache, nxt, cfg, mesh=self.mesh)
            nxt = self.sample(logits, temps, top_ks, [(seed, step + 1)] * B)
        return out


class SPMDEngineWorker:
    """Per-rank half of the gang's continuous-batching engine.

    The single-process ``TorchEngine`` makes admission, chunk and sampling
    decisions in its own loop; in a gang that loop must not exist on the
    ranks, since every rank has to issue the same programs in the same
    order. So the gang's server (``GangLLMServer``) runs the scheduler and
    sends one plan per lockstep iteration; each rank executes the plan's
    programs against its shard of the slot cache, and rank 0 reports the
    sampled tokens back. Chunked prefill, the prefix cache and slot state
    evolve identically on all ranks because they are pure functions of the
    plan stream.

    Decode steps chain on device-resident tokens (``_dev_toks``): the
    server may send plan N+1 before plan N's tokens reach it. On CUDA each
    step is a replay of one ``DecodeGraph`` over the slot cache, captured
    at construction, as ``TorchEngine`` runs its pools; on the CPU it runs
    eagerly. Determinism rule: sampling keys arrive IN the plan, derived
    from (request seed, token index).

    Multi-LoRA (``max_loras`` > 0), as ``TorchEngine`` serves it: every
    rank holds the whole adapter stacks (``_decode_forward`` cuts the B
    matrices to the rank's heads), written in place by ``set_lora`` so the
    captured graph stays valid; an admission names its adapter, every chunk
    of it prefills with that adapter, and its final chunk writes the
    slot's id into ``adapter_ids``, which the decode graph reads.
    """

    def __init__(self, config: LLMConfig, generator: SPMDGenerator):
        ec = config.engine
        self.config = config
        self.gen = generator
        self.params = generator.params
        self.model_cfg = generator.model_cfg
        self.mesh = generator.mesh
        self.device = generator.device
        self.n_slots = ec.max_num_seqs
        self.max_len = ec.max_seq_len
        self.chunk = min(ec.prefill_buckets)
        self._prefix: dict[str, tuple] = {}  # key -> (k, v) stripes of this rank's heads
        # per-slot scratch stripes: one per in-flight chunked admission
        self._ones: dict[int, dict] = {}
        self.cache = init_kv_cache(self.model_cfg, self.n_slots, self.max_len, self.device,
                                   self.mesh)
        # device-resident next-token inputs (the decode graph's input: only
        # ever written in place)
        self._dev_toks = torch.zeros((self.n_slots,), dtype=torch.int32, device=self.device)
        # adapter stacks (slot 0 zero, the base model) and each decode
        # slot's adapter, read by the decode graph; None at max_loras=0
        self.loras = (init_lora_stack(self.model_cfg, ec.max_loras, ec.lora_rank, self.device)
                      if ec.max_loras > 0 else None)
        self.adapter_ids = torch.zeros((self.n_slots,), dtype=torch.int32, device=self.device)
        # work counters; the kernel launch count of a run follows from them
        self.counts = {
            "decode_programs": 0, "decode_steps": 0, "decode_graph_replays": 0,
            "prefill_mid_chunks": 0, "prefill_final_chunks": 0,
            "decode_device_ms": 0.0, "decode_programs_timed": 0,
            # the graph replays' own device time within decode_device_ms
            # (the rest: sampling and the token broadcast between replays)
            "decode_replay_ms": 0.0,
        }
        self.graph: Optional[DecodeGraph] = None
        if self.device.type == "cuda":
            with torch.cuda.device(self.device), torch.inference_mode():
                self.graph = DecodeGraph(self.params, self.cache, self._dev_toks,
                                         self.model_cfg, mesh=self.mesh,
                                         **self._lora_kw(self.adapter_ids))

    def _int_vec(self, v: int) -> torch.Tensor:
        return torch.full((1,), v, dtype=torch.int32, device=self.device)

    def _lora_kw(self, adapter_ids: torch.Tensor) -> dict:
        """The adapter keywords of prefill/decode_step: none without LoRA."""
        if self.loras is None:
            return {}
        return {"loras": self.loras, "adapter_ids": adapter_ids}

    @torch.inference_mode()
    def set_lora(self, idx: int, weights: Optional[dict]) -> None:
        """Write adapter ``weights`` ({wq_a, wq_b, wv_a, wv_b}, whole, the
        server checked their shapes) into stack slot ``idx``, or zero the
        slot (None), in place."""
        for k, stack in self.loras.items():
            if weights is None:
                stack[:, idx].zero_()
            else:
                stack[:, idx].copy_(weights[k].to(device=self.device, dtype=stack.dtype))

    @torch.inference_mode()
    def step(self, plan: dict) -> dict:
        """Execute one lockstep plan; returns the sampled tokens
        {"admit_toks": {slot: int}, "toks": [K][n_slots] | None} (every
        rank computes them, only rank 0's copy is read).

        Plan sections execute in a fixed order every rank shares: evict,
        stores, admits, decode. ``stores`` precedes ``admits`` so a plan
        that both snapshots a finished prompt's prefix KV and admits a new
        request into the same (just freed) slot reads the OLD stripe. Each
        ``admits`` entry is one chunk of one in-flight admission. ``decode``
        runs K steps chained on the device-resident tokens."""
        cfg, mesh = self.model_cfg, self.mesh
        for key in plan.get("evict", ()):
            self._prefix.pop(key, None)
        # several admissions can finalize in one plan, so stores is a list
        for store in plan.get("stores", ()):
            if store["key"] not in self._prefix:
                slot, m = store["slot"], store["m"]
                self._prefix[store["key"]] = (self.cache["k"][:, slot, :, :m].clone(),
                                              self.cache["v"][:, slot, :, :m].clone())
        admit_toks: dict[int, torch.Tensor] = {}
        for adm in plan.get("admits", ()):
            slot = adm["slot"]
            if adm.get("fresh"):
                one = init_kv_cache(cfg, 1, self.max_len, self.device, mesh)
                pref = adm.get("seed_prefix")
                if pref is not None and pref in self._prefix:
                    pk, pv = self._prefix[pref]
                    one["k"][:, 0, :, : pk.shape[2]].copy_(pk)
                    one["v"][:, 0, :, : pv.shape[2]].copy_(pv)
                self._ones[slot] = one
            tokens = self.gen.to_device(adm["tokens"])
            eff, start = self._int_vec(adm["eff"]), self._int_vec(adm["start"])
            lora = adm["lora"]
            lora_kw = self._lora_kw(self._int_vec(lora))
            if not adm["final"]:
                prefill(self.params, self._ones[slot], tokens, cfg, lengths=eff, start_pos=start,
                        with_logits=False, mesh=mesh, **lora_kw)
                self.counts["prefill_mid_chunks"] += 1
                continue
            one = self._ones.pop(slot)
            last, _ = prefill(self.params, one, tokens, cfg, lengths=eff, start_pos=start,
                              mesh=mesh, **lora_kw)
            if self.loras is not None:
                self.adapter_ids[slot].fill_(lora)
            self.counts["prefill_final_chunks"] += 1
            self.cache["k"][:, slot].copy_(one["k"][:, 0])
            self.cache["v"][:, slot].copy_(one["v"][:, 0])
            self.cache["length"][slot] = adm["start"] + adm["eff"]
            tok = self.gen.sample(last, [adm["temp"]], [adm["top_k"]], [adm["key"]])
            # chain the first sampled token into the decode inputs ON DEVICE:
            # the next decode plan may already be queued behind this one
            self._dev_toks[slot : slot + 1].copy_(tok)
            admit_toks[slot] = tok
        dec = plan.get("decode")
        steps, timing = self._decode(dec) if dec is not None else ([], None)
        # one host sync for the plan's tokens
        parts = list(admit_toks.values()) + steps
        host = torch.cat(parts).cpu().tolist() if parts else []
        out = {"admit_toks": dict(zip(admit_toks, host[: len(admit_toks)])), "toks": None}
        if dec is not None:
            S = self.n_slots
            flat = host[len(admit_toks):]
            out["toks"] = [flat[k * S:(k + 1) * S] for k in range(dec["steps"])]
            if timing is not None:
                self.counts["decode_device_ms"] += timing[0].elapsed_time(timing[1])
                self.counts["decode_replay_ms"] += sum(a.elapsed_time(b) for a, b in timing[2])
                self.counts["decode_programs_timed"] += 1
        return out

    def _decode(self, dec: dict) -> tuple:
        """K decode steps -> (K [S] token tensors, CUDA events or None: around
        the K steps, and around each replay): a graph replay each on CUDA,
        an eager ``decode_step`` on the CPU; each step's tokens are sampled
        from its logits before the next step overwrites them."""
        cuda = self.graph is not None

        def event():
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e

        timing = (event(), None, []) if cuda else None
        outs = []
        for k in range(dec["steps"]):
            if cuda:
                start = event()
                logits = self.graph.replay()
                timing[2].append((start, event()))
                self.counts["decode_graph_replays"] += 1
            else:
                logits, _ = decode_step(self.params, self.cache, self._dev_toks, self.model_cfg,
                                        mesh=self.mesh, **self._lora_kw(self.adapter_ids))
            toks = self.gen.sample(logits, dec["temps"], dec["top_ks"], dec["keys"][k])
            self._dev_toks.copy_(toks)
            outs.append(toks)
        if cuda:
            timing = (timing[0], event(), timing[2])
        self.counts["decode_programs"] += 1
        self.counts["decode_steps"] += dec["steps"]
        return outs, timing
