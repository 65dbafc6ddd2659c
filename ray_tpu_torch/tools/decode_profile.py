"""Where a decode step's time goes, on one CUDA card.

    python -m ray_tpu_torch.tools.decode_profile

Builds llama3.2-3b (full depth, seeded random weights, fused RMSNorm) with
a 16-slot x 1024-position cache, fills it to ~100 positions, then times
``decode_step`` eagerly, the same step replayed as one CUDA graph (the
engine's ``DecodeGraph``), and one 256-token prefill chunk:

- host_ms: the Python call alone (kernels enqueued, no wait);
- span_ms: CUDA events around the same call (device-side span, host gaps
  included);
- from torch.profiler over a few steps: kernels per step, summed kernel
  time per step, the device's idle share of the span, the RMSNorm
  kernel's launches and time per step, and the top kernels.

Run as a file (``PYTHONPATH=<checkout> python <checkout>/ray_tpu_torch/
tools/decode_profile.py``) it measures that checkout, so two checkouts
alternate in one call on one card.

Prints one JSON line per measurement, each with the card's nvidia-smi name
and power limit. ``chip_smoke.py`` shares this module's card query,
bandwidth constant and timers.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch

from ray_tpu_torch.llm.engine import DecodeGraph
from ray_tpu_torch.models.llama import LlamaConfig, decode_step, init_kv_cache, init_params, prefill

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet (at its 700 W limit)


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def timed(fn, reps: int, warmup: int = 1):
    """(host ms per call without waiting, device span ms per call) of
    ``fn`` launched back to back from Python: the span is what the eager
    serving path pays, host overhead included (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    host = 0.0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        host += time.perf_counter() - t0
    end.record()
    end.synchronize()
    return host * 1e3 / reps, start.elapsed_time(end) / reps


def graph_us(fn, per_graph: int = 50, replays: int = 20) -> float:
    """Device time per call: ``per_graph`` calls captured in one CUDA graph,
    replayed, timed with CUDA events (no host overhead in the number)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / (per_graph * replays)


def _profile(fn, reps: int) -> dict:
    """Kernel count and summed kernel time per call, and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict[str, list] = {}
    for e in kernels:
        acc = by_name.setdefault(e.name, [0, 0.0])
        acc[0] += 1
        acc[1] += e.time_range.elapsed_us()
    busy_us = sum(v[1] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    norm = [v for n, v in by_name.items() if "rmsnorm" in n]
    norm_calls, norm_us = sum(v[0] for v in norm), sum(v[1] for v in norm)
    return {
        "rmsnorm_launches_per_call": norm_calls / reps,
        "rmsnorm_us_per_launch": norm_us / norm_calls if norm_calls else None,
        "device_events_per_call": len(kernels) / reps,
        "device_busy_ms_per_call": busy_us / 1e3 / reps,
        "profiled_wall_ms_per_call": wall * 1e3 / reps,
        "idle_share": 1.0 - busy_us / 1e6 / wall if kernels else None,
        "top": [{"name": n[:80], "calls_per_call": c / reps, "ms_per_call": t / 1e3 / reps}
                for n, (c, t) in top],
    }


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("decode_profile: needs a CUDA card")
    name = card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LlamaConfig.llama32_3b(max_seq_len=1024, fused_rmsnorm=True)
    params = init_params(cfg, seed=0, device="cuda")
    B, S = 16, 1024
    cache = init_kv_cache(cfg, B, S, "cuda")
    gen = torch.Generator().manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (B, 96), generator=gen, dtype=torch.int32).cuda()
    toks = torch.zeros(B, dtype=torch.int32, device="cuda")
    weight_bytes = sum(p.numel() * p.element_size() for p in params.values())
    kv_bytes = 2 * cache["k"].numel() * cache["k"].element_size()
    with torch.inference_mode():
        prefill(params, cache, prompt, cfg)

        def step():
            decode_step(params, cache, toks, cfg)
            cache["length"] -= 1  # stay at the same positions from call to call

        bound_ms = (weight_bytes + kv_bytes) / HBM_BYTES_PER_S * 1e3
        host_ms, span_ms = timed(step, 20)
        prof = _profile(step, 5)
        print(json.dumps({
            "measure": "decode_step", "card": name, "batch": B, "stripe": S,
            "host_ms": host_ms, "span_ms": span_ms, "byte_bound_ms": bound_ms, **prof,
        }), flush=True)

        # the same step as one graph replay; the decode attention reads all
        # S slots whatever the length, so positions may advance here
        length = cache["length"].clone()
        graph = DecodeGraph(params, cache, toks, cfg)
        host_ms, span_ms = timed(graph.replay, 100, warmup=3)
        prof = _profile(graph.replay, 10)
        cache["length"].copy_(length)
        print(json.dumps({
            "measure": "decode_step_graph", "card": name, "batch": B, "stripe": S,
            "host_ms": host_ms, "span_ms": span_ms, "byte_bound_ms": bound_ms, **prof,
        }), flush=True)
        del graph

        one = init_kv_cache(cfg, 1, S, "cuda")
        chunk = torch.randint(0, cfg.vocab_size, (1, 256), generator=gen, dtype=torch.int32).cuda()

        def chunk_step():
            prefill(params, one, chunk, cfg, with_logits=False)

        host_ms, span_ms = timed(chunk_step, 10)
        prof = _profile(chunk_step, 3)
        flops = 2 * 256 * (cfg.num_params() - cfg.vocab_size * cfg.d_model)
        print(json.dumps({
            "measure": "prefill_chunk_256", "card": name, "host_ms": host_ms,
            "span_ms": span_ms, "matmul_flop_bound_ms": flops / 989e12 * 1e3, **prof,
        }), flush=True)


if __name__ == "__main__":
    main()
