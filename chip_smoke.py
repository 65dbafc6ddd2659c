#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (ray_tpu_torch): its serving path.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, one JSON line each; any failing phase exits non-zero:
  1. device   — needs CUDA; the card's name and power limit; TF32 off.
  2. build    — nvcc builds every kernel from ray_tpu_torch/ops/csrc/.
  3. kernels  — each kernel against its plain PyTorch version on the card,
                at the serving path's shapes, with its times and bound.
  4. serve    — ray_tpu_torch.llm.LLMServer serves llama3.2-3b (full depth,
                seeded random weights) with the fused RMSNorm, greedy and
                seeded sampled requests; kernel launch counts are reset
                just before and read just after.
  5. numerics — a 2-layer model at full 3B width on the card through the
                kernel (fp32 and bf16), against the same weights in fp32
                through the plain path on the CPU, and a broken control
                that the bf16 limit must refuse.
Then the kernels summary line, the nvidia-smi line, and, last,
{"ok": true, "device": {...}}.

Imports nothing of JAX and nothing of the ray_tpu package.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import threading
import time

L_3B = 28


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def phase_kernels(torch, card: str) -> dict:
    """RMSNorm kernel vs rmsnorm_plain at serving's shapes. bf16 must agree
    within one bf16 rounding step (rtol 2^-7, atol 1e-6, compared in fp32):
    both compute in fp32 and round once, so they differ by at most the
    rounding of a last-ulp fp32 difference. fp32 within 1e-5."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops import rmsnorm
    from ray_tpu_torch.ops.rmsnorm import rmsnorm_plain
    from ray_tpu_torch.tools.decode_profile import HBM_BYTES_PER_S, graph_us, timed

    def call_us(fn):
        return timed(fn, 200, warmup=10)[1] * 1e3

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [
        ("decode", (16, 3072), torch.bfloat16, True),
        ("prefill_chunk", (256, 3072), torch.bfloat16, True),
        ("ragged", (15, 3072), torch.bfloat16, False),
        ("fp32", (64, 128), torch.float32, False),
    ]
    rows_out, max_err = [], 0.0
    for tag, shape, dt, measured in cases:
        x = torch.randn(shape, generator=gen, device="cuda").to(dt)
        w = (1.0 + 0.1 * torch.randn(shape[-1], generator=gen, device="cuda")).to(dt)
        before = rmsnorm.launches
        out = rmsnorm(x, w, 1e-5)
        torch.cuda.synchronize()
        if rmsnorm.launches != before + 1:
            raise AssertionError("rmsnorm wrapper did not launch its kernel")
        ref = rmsnorm_plain(x, w, 1e-5)
        rtol, atol = (2**-7, 1e-6) if dt == torch.bfloat16 else (1e-5, 1e-5)
        torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=atol)
        err = (out.float() - ref.float()).abs().max().item()
        max_err = max(max_err, err)
        row = {"shape": list(shape), "dtype": str(dt).split(".")[-1], "max_abs_err": err,
               "rtol": rtol, "atol": atol}
        if measured:
            nbytes = 2 * x.numel() * x.element_size() + w.numel() * w.element_size()
            lib = (lambda: F.rms_norm(x, (shape[-1],), w, 1e-5)) if hasattr(F, "rms_norm") else None
            row.update(
                bytes=nbytes,
                bound_us=nbytes / HBM_BYTES_PER_S * 1e6,
                kernel_us=graph_us(lambda: rmsnorm(x, w, 1e-5)),
                plain_us=graph_us(lambda: rmsnorm_plain(x, w, 1e-5)),
                library_us=graph_us(lib) if lib else None,
                kernel_call_us=call_us(lambda: rmsnorm(x, w, 1e-5)),
                plain_call_us=call_us(lambda: rmsnorm_plain(x, w, 1e-5)),
                # wrapper launches for this shape: the check, the graph
                # captures and the eager loop (graph replays do not call it)
                launches=rmsnorm.launches - before,
            )
        rows_out.append({"case": tag, **row})
    emit({"phase": "kernels", "card": card, "rmsnorm": rows_out,
          "timing": "kernel_us/plain_us/library_us: device time per call from a "
                    "replayed CUDA graph; *_call_us: eager calls back to back"})
    return {"max_abs_err": max_err, "rows": rows_out}


def phase_serve(torch, card: str) -> dict:
    import numpy as np

    from ray_tpu_torch.llm import EngineConfig, LLMConfig, LLMServer, ModelConfig, SamplingParams
    from ray_tpu_torch.ops import rmsnorm
    from ray_tpu_torch.tools.decode_profile import HBM_BYTES_PER_S

    cfg = LLMConfig(
        model=ModelConfig(model_id="llama3.2-3b", tokenizer="byte", seed=0,
                          model_kwargs={"fused_rmsnorm": True}),
        engine=EngineConfig(
            max_num_seqs=16, max_seq_len=1024,
            prefill_buckets=(32, 64, 128, 256, 512, 1024),
            prefill_chunk=256, decode_steps=8, decode_runahead=1,
        ),
    )
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server = LLMServer(cfg)
    init_s = time.perf_counter() - t0
    eng = server.engine
    try:
        mcfg = eng.model_cfg
        if (mcfg.d_model, mcfg.n_layers, mcfg.n_heads, mcfg.n_kv_heads, mcfg.d_ff,
                mcfg.vocab_size) != (3072, L_3B, 24, 8, 8192, 128256):
            raise AssertionError(f"not the 3B shape: {mcfg}")
        # ~700 tokens: chunks [0, 256), [256, 512), then the rest. A repeat
        # hits the cached 512-token prefix and prefills the same last chunk
        # at the same shapes as the cold run, so its tokens must be equal.
        long_prompt = "".join(f"[{i:03d}] the port serves a long shared preamble. " for i in range(14))
        # warm-up: allocator growth, cuBLAS handles, each prefill shape used
        # (another long prompt, so the measured one starts cold)
        server.completions({"prompt": "warm up " * 12, "max_tokens": 16, "ignore_eos": True})
        eng.generate("W" + long_prompt, sampling_params=SamplingParams(max_tokens=4, ignore_eos=True))

        stats0 = eng.get_stats()
        rmsnorm.launches = 0  # counts from here on are the main path's

        # 16 concurrent greedy completions, distinct ~100-byte prompts
        prompts = [f"Request {i:02d}: " + "write a short note about serving a model on one card. " * 2
                   for i in range(16)]
        prompts = [p[:100] for p in prompts]
        replies = [None] * 16
        # TTFT of these same requests: the engine's own per-request ttft_s,
        # read from the outputs that the server's generate calls return
        outs = []
        generate = eng.generate

        def observed(*args, **kwargs):
            out = generate(*args, **kwargs)
            outs.append(out)
            return out

        def one(i):
            replies[i] = server.completions(
                {"prompt": prompts[i], "max_tokens": 64, "temperature": 0.0, "ignore_eos": True}
            )

        eng.generate = observed
        try:
            t0 = time.perf_counter()
            threads = [threading.Thread(target=one, args=(i,)) for i in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            wall = time.perf_counter() - t0
        finally:
            del eng.generate  # back to the class's method
        for i, r in enumerate(replies):
            if r is None or r["usage"]["completion_tokens"] != 64:
                raise AssertionError(f"completion {i} did not return 64 tokens: {r}")
        ttft = np.asarray([o.metrics["ttft_s"] for o in outs]) * 1e3
        if len(ttft) != 16:
            raise AssertionError(f"{len(ttft)} engine outputs for 16 completions")

        chat = server.chat({"messages": [{"role": "user", "content": "Say hello."}],
                            "max_tokens": 32, "ignore_eos": True})
        if chat["usage"]["completion_tokens"] != 32 or chat["object"] != "chat.completion":
            raise AssertionError(f"chat: {chat}")
        chunks = list(server.completions_stream({"prompt": "Stream this.", "max_tokens": 24,
                                                 "ignore_eos": True}))
        if len(chunks) != 25 or chunks[-1]["choices"][0]["finish_reason"] != "length":
            raise AssertionError(f"stream gave {len(chunks)} chunks")

        sp = SamplingParams(max_tokens=64, temperature=0.0, ignore_eos=True)
        # a seeded sampled request gives the same tokens whatever shares its
        # batch: alone, then beside a greedy request
        hot = SamplingParams(max_tokens=32, temperature=0.8, top_k=50, seed=7, ignore_eos=True)
        s1 = eng.generate("Sample this.", sampling_params=hot)
        other = eng.submit("Something else entirely.", sampling_params=sp)
        s2 = eng.generate("Sample this.", sampling_params=hot)
        if not other.done.wait(600) or other.error is not None:
            raise AssertionError(f"greedy request beside the sampled one failed: {other.error!r}")
        if len(s1.token_ids) != 32 or s1.token_ids != s2.token_ids:
            raise AssertionError("a seeded sampled request changed its tokens")
        greedy = eng.generate("Sample this.", sampling_params=sp)
        sampled_equal_greedy = sum(x == y for x, y in zip(s1.token_ids, greedy.token_ids))

        # shorter than the smallest prefix bucket: both runs are cold
        a = eng.generate("Repeat after me.", sampling_params=sp)
        b = eng.generate("Repeat after me.", sampling_params=sp)
        if a.metrics["prefix_hit_tokens"] or a.token_ids != b.token_ids:
            raise AssertionError("a repeated greedy prompt changed its tokens")
        hits0 = eng.get_stats()["prefix_cache_hits"]
        c = eng.generate(long_prompt + "Q?", sampling_params=sp)
        d = eng.generate(long_prompt + "Q?", sampling_params=sp)
        if (c.metrics["prefix_hit_tokens"] or eng.get_stats()["prefix_cache_hits"] <= hits0
                or d.metrics["prefix_hit_tokens"] != 512):
            raise AssertionError("the repeated long prompt missed the prefix cache")
        if c.token_ids != d.token_ids:
            raise AssertionError("a prefix-cache hit changed the greedy tokens")

        launches = rmsnorm.launches
        stats = eng.get_stats()
        delta = {k: stats[k] - stats0[k] for k in
                 ("decode_programs", "decode_steps", "prefill_mid_chunks", "prefill_final_chunks",
                  "decode_device_ms", "decode_programs_timed")}
        n_norms = 2 * L_3B + 1
        expected = (n_norms * (delta["decode_steps"] + delta["prefill_final_chunks"])
                    + (n_norms - 1) * delta["prefill_mid_chunks"])
        if launches < n_norms * delta["decode_programs"] or launches != expected:
            raise AssertionError(f"rmsnorm launches {launches} != expected {expected} ({delta})")

        weight_bytes = sum(p.numel() * p.element_size() for p in eng.params.values())
        kv_bytes = sum(2 * pool.cache["k"].numel() * pool.cache["k"].element_size()
                       for pool in eng._pools)
        step_bound_ms = (weight_bytes + kv_bytes) / HBM_BYTES_PER_S * 1e3
        result = {
            "phase": "serve", "card": card, "model": "llama3.2-3b",
            "params": sum(p.numel() for p in eng.params.values()),
            "engine_init_s": init_s,
            "wall_s_16x64": wall,
            "out_tok_per_s": 16 * 64 / wall,
            "ttft_ms_p50": float(np.percentile(ttft, 50)),
            "ttft_ms_p99": float(np.percentile(ttft, 99)),
            "decode_program_ms_mean": delta["decode_device_ms"] / delta["decode_programs_timed"],
            "decode_steps_per_program": cfg.engine.decode_steps,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "decode_step_bytes": weight_bytes + kv_bytes,
            "decode_step_bound_ms": step_bound_ms,
            "decode_bound_tok_per_s": 16 / (step_bound_ms / 1e3),
            "rmsnorm_launches": launches, "rmsnorm_launches_expected": expected, **delta,
            "prefix_hit_tokens": d.metrics["prefix_hit_tokens"],
            "sampled_tokens": len(s1.token_ids), "sampled_equal_greedy": sampled_equal_greedy,
        }
        emit(result)
        return result
    finally:
        eng.shutdown()


def _conditioned_params(torch, cfg, seed: int) -> dict:
    """Weights on the card in ``cfg.dtype`` whose activations stay O(1):
    every matmul weight N(0, 1) x its input width^-1/2, the (tied)
    embedding N(0, 1) x d_model^-1/2, norms 1 + 0.1 N(0, 1). The engine's
    init mirrors the JAX package's, which draws wq/wk/wv with fan_in = head
    count: attention scores of O(100), where bf16 alone puts ~20% error on
    the logits and a numerics check cannot tell a sound run from a broken
    one."""
    from ray_tpu_torch.models.llama import _param_shapes

    gen = torch.Generator(device="cuda").manual_seed(seed)
    width = {"embed": cfg.d_model, "wq": cfg.d_model, "wk": cfg.d_model, "wv": cfg.d_model,
             "wo": cfg.n_heads * cfg.head_dim, "w_gate": cfg.d_model, "w_up": cfg.d_model,
             "w_down": cfg.d_ff}
    params = {}
    for name, shape in sorted(_param_shapes(cfg).items()):
        t = torch.randn(shape, generator=gen, device="cuda",
                        dtype=torch.float32 if "norm" in name else cfg.dtype)
        params[name] = (1.0 + 0.1 * t).to(cfg.dtype) if "norm" in name else t * width[name] ** -0.5
    return params


def phase_numerics(torch, card: str) -> dict:
    """2 layers at full 3B width, prefill of 2 x 64 tokens, last-token
    logits against the same weights upcast to fp32 through the plain path
    on the CPU (TF32 is off, so fp32 matmuls on the card are full fp32).
    Limits, on the RMS logit error relative to the RMS logit:

    - fp32 on the card through the kernel: 1e-4. Only summation order
      differs (cuBLAS vs the CPU, the kernel's reduction vs torch's).
    - bf16 on the card through the kernel: 5e-2. bf16 weights and
      activations keep 8 significant bits; through 2 layers and a
      3072-wide LM head that reads ~1.7e-2 on these weights.
    - a broken control, the bf16 run with every norm weight rolled by one
      element (a kernel reading w one element off), must read above the
      bf16 limit: the check can tell a fault from bf16 rounding."""
    from ray_tpu_torch.models.llama import LlamaConfig, init_kv_cache, prefill

    bf16 = LlamaConfig.llama32_3b(n_layers=2, max_seq_len=128, fused_rmsnorm=True)
    fp32 = dataclasses.replace(bf16, dtype=torch.float32)
    params = _conditioned_params(torch, bf16, seed=1)
    tokens = torch.randint(0, bf16.vocab_size, (2, 64), generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32)

    def logits(cfg, device, dtype, p=params):
        p = {k: v.to(device=device, dtype=dtype) for k, v in p.items()}
        with torch.inference_mode():
            out, _ = prefill(p, init_kv_cache(cfg, 2, 64, device), tokens.to(device), cfg)
        if not torch.isfinite(out).all() or out.shape != (2, cfg.vocab_size):
            raise AssertionError(f"logits on {device} in {dtype}: wrong shape or not finite")
        return out.float().cpu()

    def rel_rms(a, b):
        return ((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt()).item()

    rolled = {k: torch.roll(v, 1, dims=-1) if "norm" in k else v for k, v in params.items()}
    ref = logits(dataclasses.replace(fp32, fused_rmsnorm=False), "cpu", torch.float32)
    card32 = logits(fp32, "cuda", torch.float32)
    card16 = logits(bf16, "cuda", torch.bfloat16)
    control = logits(bf16, "cuda", torch.bfloat16, rolled)
    out = {
        "phase": "numerics", "card": card, "layers": 2, "d_model": bf16.d_model,
        "vocab": bf16.vocab_size, "tokens": list(tokens.shape), "ref_rms": ref.pow(2).mean().sqrt().item(),
        "fp32_rel_rms_err": rel_rms(card32, ref), "fp32_limit": 1e-4,
        "fp32_max_abs_err": (card32 - ref).abs().max().item(),
        "fp32_top1_agreement": (card32.argmax(-1) == ref.argmax(-1)).float().mean().item(),
        "bf16_rel_rms_err": rel_rms(card16, ref), "bf16_limit": 5e-2,
        "bf16_max_abs_err": (card16 - ref).abs().max().item(),
        "bf16_top1_agreement": (card16.argmax(-1) == ref.argmax(-1)).float().mean().item(),
        "bf16_min_cosine": torch.nn.functional.cosine_similarity(card16, ref, dim=-1).min().item(),
        "control_rel_rms_err": rel_rms(control, ref),
    }
    emit(out)
    if out["fp32_rel_rms_err"] > out["fp32_limit"]:
        raise AssertionError(f"fp32 slice on the card: {out['fp32_rel_rms_err']} > {out['fp32_limit']}")
    if out["bf16_rel_rms_err"] > out["bf16_limit"]:
        raise AssertionError(f"bf16 slice on the card: {out['bf16_rel_rms_err']} > {out['bf16_limit']}")
    if out["control_rel_rms_err"] <= out["bf16_limit"]:
        raise AssertionError(f"the broken control passed: {out['control_rel_rms_err']}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card", file=sys.stderr)
        return 2
    import ray_tpu_torch  # noqa: F401 — fails here outside a checkout of the repo
    from ray_tpu_torch._native import build
    from ray_tpu_torch.tools.decode_profile import card as nvidia_smi

    smi = nvidia_smi()
    card = f"{torch.cuda.get_device_name(0)} ({smi})"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
          "count": torch.cuda.device_count(), "tf32": "off (matmul and cudnn)"})

    t0 = time.perf_counter()
    build.build()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for name in build.sources() for ln in build.build_log(name).splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": build_s, "sources": build.sources(), "ptxas": ptxas})

    k = phase_kernels(torch, card)
    serve = phase_serve(torch, card)
    phase_numerics(torch, card)

    decode = next(r for r in k["rows"] if r["case"] == "decode")
    emit({"kernels": [{
        "name": "rmsnorm",
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/rmsnorm.cu",
        "replaces": "ray_tpu/ops/rmsnorm.py:23",
        "launches": serve["rmsnorm_launches"],
        "max_abs_err": k["max_abs_err"],
        "ms": decode["kernel_us"] / 1e3,
        "plain_ms": decode["plain_us"] / 1e3,
        "bound_ms": decode["bound_us"] / 1e3,
        "bound_by": "bytes",
        "library_ms": decode["library_us"] / 1e3 if decode["library_us"] is not None else None,
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
