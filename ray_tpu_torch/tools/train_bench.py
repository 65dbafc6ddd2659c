"""Train-step throughput, and where a step's time goes, on one CUDA card.

    python -m ray_tpu_torch.tools.train_bench

Runs the JAX package's flagship train configuration (``bench.py:31-47``,
value for value: vocab 32000, d_model 2048, 16 layers, 16 heads / 16 kv
heads, d_ff 8192, bf16, remat "full", attention "splash", plain
cross-entropy; batch 4 x 2048) through ``make_train_step`` with seeded
random weights and tokens, and prints one JSON line per measurement, each
with the card's nvidia-smi name and power limit:

- ``train``: step ms (host clock over the timed steps, which end by
  reading the losses), tokens/s, MFU against the H100's 989 TFLOP/s, peak
  memory, each step's loss, and the attention kernels' launch counts over
  the timed steps;
- ``train_profile``: one more step under ``torch.profiler``: kernel time by
  category (matmul, attention kernels, loss, optimizer, other
  elementwise/reductions), the top kernels, the aten ops with the most
  device time (what the elementwise work is), and the device's idle share of
  the profiled step (profiling adds host time, so this overstates the idle
  share of an unprofiled step).

``chip_smoke.py`` runs the same functions as its train phase.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from ray_tpu_torch.models.llama import LlamaConfig
from ray_tpu_torch.models.training import flops_per_token, make_train_step, mfu
from ray_tpu_torch.ops.flash_attention import flash_attention, reset_launches

BATCH, SEQ = 4, 2048


def bench_config(**kw) -> LlamaConfig:
    d = dict(
        vocab_size=32000, d_model=2048, n_layers=16, n_heads=16, n_kv_heads=16, d_ff=8192,
        max_seq_len=2048, dtype=torch.bfloat16, remat=True, remat_policy="full",
        attention="splash", fused_ce=False, fused_rmsnorm=False,
    )
    d.update(kw)
    return LlamaConfig(**d)


def make_batch(cfg: LlamaConfig, batch: int, seq: int, seed: int = 0, device="cuda") -> dict:
    """{'tokens': [batch, seq + 1]} int32: seq positions, shifted in loss_fn."""
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, seq + 1), dtype=np.int32)
    return {"tokens": torch.from_numpy(toks).to(device)}


def run(cfg: LlamaConfig, batch: int = BATCH, seq: int = SEQ, warmup: int = 2, steps: int = 6,
        seed: int = 0, optimizer=None) -> dict:
    """Warm-up steps, then ``steps`` timed steps; returns the measurements
    plus the live ``state``, ``step_fn`` and ``batch`` (for profiling).
    ``optimizer`` defaults to ``make_train_step``'s."""
    init_fn, step_fn = make_train_step(cfg, optimizer)
    state = init_fn(seed)
    data = make_batch(cfg, batch, seq, seed)
    for _ in range(warmup):
        state, metrics = step_fn(state, data)
        metrics["loss"].item()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    losses = []
    for _ in range(steps):
        state, metrics = step_fn(state, data)
        losses.append(metrics["loss"])
    losses = [float(x) for x in losses]  # the first read waits for the last step
    dt = time.perf_counter() - t0
    f = flash_attention
    tps = batch * seq * steps / dt
    return {
        "params": cfg.num_params(),
        "tokens_per_step": batch * seq,
        "flops_per_token": flops_per_token(cfg),
        "warmup_steps": warmup,
        "steps": steps,
        "step_ms": dt * 1e3 / steps,
        "tokens_per_s": tps,
        "mfu": mfu(cfg, tps, 1),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "losses": losses,
        "grad_norm_last": float(metrics["grad_norm"]),
        "launches": {"fwd": f.launches_fwd, "bwd_dq": f.launches_bwd_dq,
                     "bwd_dkdv": f.launches_bwd_dkdv},
        "state": state, "step_fn": step_fn, "batch": data,
    }


def _category(name: str) -> str:
    n = name.lower()
    if "flash_" in n:
        return "attention"
    if any(t in n for t in ("gemm", "nvjet", "xmma", "cutlass", "splitk")):
        return "matmul"
    if "softmax" in n or "gather" in n or "scatter" in n or "nll" in n:
        return "loss"
    if "multi_tensor" in n or "foreach" in n:
        return "optimizer"
    return "elementwise_other"


def profile_step(step_fn, state, data) -> dict:
    """One step under torch.profiler: kernel ms by category, the device's
    idle share of the step's span (CUDA events), and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        state, metrics = step_fn(state, data)
        end.record()
        metrics["loss"].item()
    span_ms = start.elapsed_time(end)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_cat: dict[str, list] = {}
    by_name: dict[str, list] = {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        for table, key in ((by_cat, _category(e.name)), (by_name, e.name)):
            acc = table.setdefault(key, [0, 0.0])
            acc[0] += 1
            acc[1] += us
    busy_ms = sum(v[1] for v in by_cat.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    # device time by the aten op that launched it (names the elementwise work)
    ops = [(e.key, e.count, e.self_device_time_total) for e in prof.key_averages()
           if e.key.startswith("aten::") and e.self_device_time_total > 0]
    top_ops = sorted(ops, key=lambda o: -o[2])[:15]
    return {
        "span_ms": span_ms,
        "kernel_ms": busy_ms,
        "kernels": len(kernels),
        "idle_share": 1.0 - busy_ms / span_ms if span_ms > 0 else None,
        "by_category_ms": {k: v[1] / 1e3 for k, v in sorted(by_cat.items())},
        "by_category_kernels": {k: v[0] for k, v in sorted(by_cat.items())},
        "top": [{"name": n[:90], "calls": c, "ms": t / 1e3} for n, (c, t) in top],
        "top_aten_ops": [{"op": k, "calls": c, "self_device_ms": t / 1e3} for k, c, t in top_ops],
    }


def main() -> None:
    from ray_tpu_torch.tools.decode_profile import card

    if not torch.cuda.is_available():
        raise SystemExit("train_bench: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    name = card()
    out = run(bench_config())
    live = {k: out.pop(k) for k in ("state", "step_fn", "batch")}
    print(json.dumps({"measure": "train", "card": name, **out}), flush=True)
    prof = profile_step(live["step_fn"], live["state"], live["batch"])
    print(json.dumps({"measure": "train_profile", "card": name, **prof}), flush=True)


if __name__ == "__main__":
    main()
