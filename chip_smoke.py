#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (ray_tpu_torch): its serving path
(dense, MoE and multi-LoRA), its training path (dense and MoE, remat "full"
and "dots"), its int8 weight path, the entry() twin, and the Train layer's
train -> checkpoint -> serve path.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, one JSON line each; any failing phase exits non-zero:
  1. device   — needs CUDA; the card's name and power limit; TF32 off.
  2. build    — nvcc builds every kernel from ray_tpu_torch/ops/csrc/, one
                process per source, in parallel.
  3. kernels  — each kernel against its plain PyTorch version on the card:
                RMSNorm at the serving path's shapes, and at the decode
                shape [16, 3072] with the residual add fused in (s and y
                bit-equal to the eager add then the unfused kernel; its
                time beside the plain twin's, the eager add + kernel's and
                its byte bound); the three
                flash-attention kernels (forward: TMA, wgmma, warp-
                specialised; backward dQ, backward dK/dV) at the train
                bench shape, the 3B GQA head shape, a ragged T and T = 1,
                each with a broken control (K one position off, V one
                element off) that must fail the limits; times, plain and
                library times (SDPA, with enable_gqa at the GQA shape;
                SDPA's backward on K/V repeated to H heads there), bounds,
                and each kernel's TFLOP/s and share of its bound.
  4. quant    — the int8 path of ray_tpu_torch.ops: llama3.2-3b (full width
                and depth, seeded bf16 weights) quantized per output row
                with quantize_int8 and dequantized to bf16 with
                dequantize_int8, all 197 weight matrices; launch counts
                reset before and read after (197 each); kernel and plain
                version bit-equal on every matrix; x @ deq(q).T within 1e-2
                relative of x @ w, and a broken control (q one column off)
                beyond it; per shape, kernel, plain and library times, the
                byte bound, and quantize_int8's time on the path's own w.T
                view (the boundary copy included).
  5. serve    — ray_tpu_torch.llm.LLMServer serves llama3.2-3b (full depth,
                seeded random weights) with the fused RMSNorm, greedy and
                seeded sampled requests; kernel launch counts are reset
                just before and read just after; every decode step is a
                CUDA-graph replay (decode_graph_replays == decode_steps).
  5b. decode_graph — the engine's DecodeGraph at full 3B width and depth
                (well-conditioned weights, 16 rows at 96 positions): 8
                graphed steps against 8 eager decode_steps on cloned caches
                (greedy tokens equal; the logits' max difference reported),
                a broken control (replays without the next tokens copied
                in: the tokens must differ), then the graphed step's device
                ms, kernels and idle share beside the eager step's and the
                step's byte bound.
  6. numerics — a 2-layer model at full 3B width on the card through the
                kernel (fp32 and bf16), against the same weights in fp32
                through the plain path on the CPU, and a broken control
                that the bf16 limit must refuse.
  7. train    — the JAX package's flagship train configuration (bench.py:
                1.2B params, 16 layers, batch 4 x 2048, remat, splash
                attention) through make_train_step: 2 warm-up and 6 timed
                steps, finite losses, attention launch counts equal to
                2L x steps (forward, re-run by remat) and L x steps (each
                backward kernel), then one profiled step.
  8. train_numerics — 2 layers at the bench width with well-conditioned
                weights: loss and grads in bf16 on the card through the
                kernels against fp32 on the CPU through dense attention, a
                broken control (the kernel fed K one position off) that
                must exceed the grad limit, and the fused cross-entropy's
                loss against the plain one.
  9. moe_serve — llama3.2-3b with 8 experts of top-2 (full width and depth,
                18 B params, seeded bf16) through LLMServer: 16 concurrent
                greedy requests x 32 tokens, every decode step a graph
                replay, RMSNorm launches counted; then 8 graphed MoE decode
                steps against 8 eager ones (tokens equal, a control that
                must differ).
 10. moe_numerics — 2 MoE layers at 3B width, bf16 and fp32 on the card
                against fp32 on the CPU (the numerics limits, the routes
                held equal for bf16), a control with one expert's w_down
                shifted.
 11. moe_train — bench.py's train widths with 8 experts top-2, capacity
                1.25, at the depth that fits: 2 warm-up and 3 timed steps,
                attention launches 2L/L/L, and a loss that falls over 5
                steps from well-conditioned weights.
 12. lora_serve — llama3.2-3b with two adapters loaded by load_lora: a
                mixed batch of 16 equal to each request's sequential run,
                base requests equal to the serve phase's tokens.
 13. train_dots — the train phase's configuration under remat "dots", in
                turns with "full" (full, dots, dots, full).
 14. graft_entry — ray_tpu_torch.graft_entry.entry() in bf16 and fp32 on
                the card against fp64 on the CPU, with a broken control.
 15. train_serve — train -> checkpoint -> serve: TorchTrainer runs the
                example train loop on one rank (a spawned process, NCCL) at
                the train phase's configuration, fails on purpose after
                step 3, resumes from its step-2 checkpoint (the whole train
                state) to the same step-3 loss, and reports the params;
                LLMServer serves that checkpoint (weights' checksums equal,
                prefill logits within the bf16 limit, a swapped-leaf copy
                refused, 16 x 32 greedy tokens, graph replays).
Then the kernels summary line, the nvidia-smi line, and, last,
{"ok": true, "device": {...}}.

Imports nothing of JAX and nothing of the ray_tpu package.
"""

from __future__ import annotations

import dataclasses
import json
import math
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
    fused = _fused_row(torch, gen)
    attention = _attention_rows(torch)
    emit({"phase": "kernels", "card": card, "rmsnorm": rows_out, "rmsnorm_fused": fused,
          "attention": attention["rows"],
          "attention_limits": attention["limits"],
          "timing": "kernel_us/plain_us/library_us: device time per call from a "
                    "replayed CUDA graph; *_call_us: eager calls back to back; "
                    "sdpa_fwd_bwd_us: eager calls, CUDA events; sdpa_bwd_us: the aten "
                    "flash backward alone from a replayed CUDA graph"})
    return {"max_abs_err": max_err, "rows": rows_out, "fused": fused, "attention": attention}


def _fused_row(torch, gen) -> dict:
    """add_rmsnorm at the decode shape [16, 3072] bf16: s = x + r and y =
    rmsnorm(s) in one launch, bit-equal (tolerance 0) to the eager add then
    the unfused kernel, and y within the bf16 limits of the plain twin."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops import add_rmsnorm, rmsnorm
    from ray_tpu_torch.ops.rmsnorm import add_rmsnorm_plain
    from ray_tpu_torch.tools.decode_profile import HBM_BYTES_PER_S, graph_us, timed

    shape = (16, 3072)
    x, r = (torch.randn(shape, generator=gen, device="cuda").bfloat16() for _ in range(2))
    w = (1.0 + 0.1 * torch.randn(shape[-1], generator=gen, device="cuda")).bfloat16()
    before = rmsnorm.launches
    s, y = add_rmsnorm(x, r, w, 1e-5)
    torch.cuda.synchronize()
    if rmsnorm.launches != before + 1:
        raise AssertionError("add_rmsnorm did not launch the kernel once")
    s_ref = x + r
    y_ref = rmsnorm(s_ref, w, 1e-5)
    s_p, y_p = add_rmsnorm_plain(x, r, w, 1e-5)
    bit_equal = (torch.equal(s.view(torch.int16), s_ref.view(torch.int16))
                 and torch.equal(y.view(torch.int16), y_ref.view(torch.int16)))
    if not bit_equal:
        raise AssertionError("add_rmsnorm differs from the eager add then the kernel")
    torch.testing.assert_close(y.float(), y_p.float(), rtol=2**-7, atol=1e-6)
    if not torch.equal(s, s_p):
        raise AssertionError("add_rmsnorm's s differs from the plain twin's")
    # x and r read, s and y written, w read once
    nbytes = 4 * x.numel() * x.element_size() + w.numel() * w.element_size()
    lib = (lambda: F.rms_norm(x + r, (shape[-1],), w, 1e-5)) if hasattr(F, "rms_norm") else None
    return {
        "shape": list(shape), "dtype": "bfloat16", "bit_equal_to_add_then_kernel": bit_equal,
        "max_abs_err": (y.float() - y_p.float()).abs().max().item(), "rtol": 2**-7, "atol": 1e-6,
        "bytes": nbytes, "bound_us": nbytes / HBM_BYTES_PER_S * 1e6,
        "kernel_us": graph_us(lambda: add_rmsnorm(x, r, w, 1e-5)),
        "plain_us": graph_us(lambda: add_rmsnorm_plain(x, r, w, 1e-5)),
        "add_then_kernel_us": graph_us(lambda: rmsnorm(x + r, w, 1e-5)),
        "add_then_library_us": graph_us(lib) if lib else None,
        "kernel_call_us": timed(lambda: add_rmsnorm(x, r, w, 1e-5), 200, warmup=10)[1] * 1e3,
        "library": "none computes add + norm in one call; add_then_library_us is torch's add "
                   "then F.rms_norm",
    }


# (B, T, H, KV, D): the train bench shape, llama3.2-3b's GQA head shape at
# the bench's batch and length, a T that is a multiple of none of the 128-,
# 64- and 32-row blocks, and T = 1
ATTN_CASES = [
    ("bench", (4, 2048, 16, 16, 128), True),
    ("gqa3b", (4, 2048, 24, 8, 128), True),
    ("ragged", (2, 200, 4, 2, 128), False),
    ("t1", (1, 1, 2, 1, 128), False),
]


def _attention_rows(torch) -> dict:
    """The flash-attention kernels against their plain versions on the same
    bf16 inputs (the backward from the kernel's own o and lse), with the
    limits of ops/flash_attention.py fixed before the first run; a broken
    control per row must fail them."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops.flash_attention import (
        MAX_ABS_LIMIT, REL_RMS_LIMIT, agreement, flash_attention, flash_attention_bwd_dkdv_kernel,
        flash_attention_bwd_dq_kernel, flash_attention_bwd_plain, flash_attention_fwd_kernel,
        flash_attention_fwd_plain,
    )
    from ray_tpu_torch.models.training import H100_BF16_DENSE_FLOPS
    from ray_tpu_torch.tools.decode_profile import HBM_BYTES_PER_S, graph_us, timed

    f = flash_attention

    def kernels(q, k, v, do):
        o, lse = flash_attention_fwd_kernel(q, k, v)
        dq, delta = flash_attention_bwd_dq_kernel(q, k, v, o, lse, do)
        dk, dv = flash_attention_bwd_dkdv_kernel(q, k, v, lse, delta, do)
        return o, lse, dq, dk, dv, delta

    def bound(flops, nbytes):
        t_ops, t_bytes = flops / H100_BF16_DENSE_FLOPS, nbytes / HBM_BYTES_PER_S
        return {"bound_us": max(t_ops, t_bytes) * 1e6,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "flops": flops, "bytes": nbytes}

    gen = torch.Generator(device="cuda").manual_seed(3)
    rows, max_err = [], 0.0
    for tag, (B, T, H, KV, D), measured in ATTN_CASES:
        q, k, v, do = (torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)
                       for s in ((B, T, H, D), (B, T, KV, D), (B, T, KV, D), (B, T, H, D)))
        before = (f.launches_fwd, f.launches_bwd_dq, f.launches_bwd_dkdv)
        o, lse, dq, dk, dv, delta = kernels(q, k, v, do)
        torch.cuda.synchronize()
        if (f.launches_fwd, f.launches_bwd_dq, f.launches_bwd_dkdv) != tuple(b + 1 for b in before):
            raise AssertionError("the flash-attention wrappers did not launch their kernels")
        o_p, lse_p = flash_attention_fwd_plain(q, k, v)
        refs = dict(zip(("o", "dq", "dk", "dv"),
                        (o_p, *flash_attention_bwd_plain(q, k, v, o, lse, do))))
        checks = {n: agreement(x, refs[n]) for n, x in zip(("o", "dq", "dk", "dv"), (o, dq, dk, dv))}
        lse_err = (lse - lse_p).abs().max().item()
        # broken control: K one position off along T, V one element off along D
        ko, vo = torch.roll(k, 1, dims=1), torch.roll(v, 1, dims=3)
        co, _, cdq, cdk, cdv, _ = kernels(q, ko, vo, do)
        control = {n: agreement(x, refs[n]) for n, x in zip(("o", "dq", "dk", "dv"), (co, cdq, cdk, cdv))}
        del ko, vo, co, cdq, cdk, cdv
        row = {"case": tag, "shape_bthkd": [B, T, H, KV, D], "lse_max_abs_err": lse_err,
               **{f"{n}_{m}": c[m] for n, c in checks.items() for m in ("max_abs_err", "rel_rms_err")},
               "control_rel_rms_err": {n: c["rel_rms_err"] for n, c in control.items()}}
        bad = [n for n, c in checks.items() if not c["ok"]]
        if bad or lse_err > 1e-4:
            raise AssertionError(f"attention {tag}: {bad or 'lse'} outside the limits: {row}")
        if all(c["ok"] for c in control.values()):
            raise AssertionError(f"attention {tag}: the broken control passed the limits: {row}")
        max_err = max(max_err, *(c["max_abs_err"] for c in checks.values()))
        if measured:
            npairs = T * (T + 1) // 2  # causal (query, key) pairs
            qb, kvb, rowb = B * T * H * D * 2, B * T * KV * D * 2, B * H * T * 4
            hd = B * H * D * npairs
            row["fwd"] = {"kernel_us": graph_us(lambda: flash_attention_fwd_kernel(q, k, v), 20, 10),
                          "plain_us": graph_us(lambda: flash_attention_fwd_plain(q, k, v), 3, 3),
                          **bound(4 * hd, 2 * qb + 2 * kvb + rowb)}
            row["bwd_dq"] = {
                "kernel_us": graph_us(lambda: flash_attention_bwd_dq_kernel(q, k, v, o, lse, do), 20, 10),
                **bound(6 * hd, 4 * qb + 2 * kvb + 2 * rowb)}
            row["bwd_dkdv"] = {
                "kernel_us": graph_us(
                    lambda: flash_attention_bwd_dkdv_kernel(q, k, v, lse, delta, do), 20, 10),
                **bound(8 * hd, 2 * qb + 4 * kvb + 2 * rowb)}
            for key in ("fwd", "bwd_dq", "bwd_dkdv"):  # useful FLOPs a second; share of the bound
                r = row[key]
                r["tflops"] = r["flops"] / r["kernel_us"] / 1e6
                r["bound_share"] = r["bound_us"] / r["kernel_us"]
            # the plain backward computes dq, dk and dv together
            plain_bwd = graph_us(lambda: flash_attention_bwd_plain(q, k, v, o, lse, do), 2, 3)
            row["bwd_dq"]["plain_us"] = row["bwd_dkdv"]["plain_us"] = plain_bwd
            row["bwd_bound_us"] = bound(10 * hd, 4 * qb + 4 * kvb + 2 * rowb)["bound_us"]
            # the library yardstick, timed here only: SDPA ([B, H, T, D] views)
            qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
            gqa = {"enable_gqa": True} if H != KV else {}
            row["sdpa_fwd_us"] = graph_us(
                lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, **gqa), 20, 10)
            leaves = [t.detach().requires_grad_(True) for t in (qt, kt, vt)]

            def sdpa_fwd_bwd():
                out = F.scaled_dot_product_attention(*leaves, is_causal=True, **gqa)
                torch.autograd.grad(out, leaves, dot)

            row["sdpa_fwd_bwd_us"] = timed(sdpa_fwd_bwd, 10, warmup=2)[1] * 1e3
            del leaves
            # the library's backward alone: one aten call gives dq, dk and dv,
            # the function of the dQ and dK/dV kernels together. Its flash
            # backward takes equal head counts only, so at GQA it reads K and
            # V repeated to H heads, as the JAX reference feeds its Pallas
            # kernels (ray_tpu/models/llama.py:315-322); the repeat is made
            # once, outside the timed graph (and its dk, dv are per q head)
            aten = torch.ops.aten
            if H == KV:
                kr, vr = kt, vt
            else:
                kr, vr = (t.repeat_interleave(H // KV, dim=1) for t in (kt, vt))
            (so, slse, cq, ck, mq, mk, seed, offset,
             _) = aten._scaled_dot_product_flash_attention(qt, kr, vr, 0.0, True)
            row["sdpa_bwd_us"] = graph_us(
                lambda: aten._scaled_dot_product_flash_attention_backward(
                    dot, qt, kr, vr, so, slse, cq, ck, mq, mk, 0.0, True, seed, offset),
                20, 10)
            row["sdpa_bwd_kv"] = ("as given" if H == KV else
                                  f"K, V repeated {H // KV}x to H heads outside the timed graph")
            row["bwd_pair_us"] = row["bwd_dq"]["kernel_us"] + row["bwd_dkdv"]["kernel_us"]
            del so, slse, kr, vr
        rows.append(row)
        del q, k, v, do, o, lse, dq, dk, dv, delta, o_p, lse_p, refs
        torch.cuda.empty_cache()
    limits = {"rel_rms_err": REL_RMS_LIMIT, "max_abs_err_of_max_ref": MAX_ABS_LIMIT,
              "lse_max_abs_err": 1e-4}
    return {"rows": rows, "limits": limits, "max_abs_err": max_err}


def _quant_matrices(params: dict, cfg):
    """Every weight matrix of the model by output row, as the JAX package's
    test quantizes ``w.T`` (tests/test_ops.py:89): per layer wq, wk, wv,
    wo, w_gate, w_up and w_down as [out, in] views, then the tied embedding
    once, whose rows are the unembedding's output rows."""
    e = cfg.d_model
    for layer in range(cfg.n_layers):
        for name in ("wq", "wk", "wv"):
            yield name, params[name][layer].reshape(e, -1).T
        yield "wo", params["wo"][layer].reshape(-1, e).T
        for name in ("w_gate", "w_up", "w_down"):
            yield name, params[name][layer].T
    yield "embed", params["embed"]


def phase_quant(torch, card: str) -> dict:
    """llama3.2-3b's weights through quantize_int8 and dequantize_int8 on
    the card. Limits: the kernels equal their plain versions bit for bit
    (q, scales, bf16 output); x @ deq(q).T, in fp32 on a seeded bf16 batch
    [16, in], within the JAX package's 1e-2 relative error of x @ w
    (tests/test_ops.py:94), and the broken control (q rolled one column,
    dequantized by the plain version) above it."""
    from ray_tpu_torch.models.llama import LlamaConfig, init_params
    from ray_tpu_torch.ops import dequantize_int8, quantize_int8
    from ray_tpu_torch.ops.quant import dequantize_int8_plain, quantize_int8_plain, reset_launches
    from ray_tpu_torch.tools.decode_profile import HBM_BYTES_PER_S, graph_us

    limit = 1e-2
    cfg = LlamaConfig.llama32_3b()
    if (cfg.d_model, cfg.n_layers, cfg.n_kv_heads * cfg.head_dim, cfg.d_ff, cfg.vocab_size,
            cfg.tie_embeddings, cfg.dtype) != (3072, L_3B, 1024, 8192, 128256, True, torch.bfloat16):
        raise AssertionError(f"not the 3B shape: {cfg}")
    params = init_params(cfg, seed=0, device="cuda")
    mats = list(_quant_matrices(params, cfg))
    gen = torch.Generator(device="cuda").manual_seed(4)
    batch = {}  # a bf16 batch [16, in] per input width

    def rel(a, b):
        return (torch.linalg.norm(a - b) / torch.linalg.norm(b)).item()

    reset_launches()  # counts from here on are the path's
    q_err = s_err = out_err = 0.0
    unequal, kinds, shapes = [], {}, {}
    for kind, w in mats:
        q, s = quantize_int8(w)
        out = dequantize_int8(q, s)
        q_p, s_p = quantize_int8_plain(w)
        out_p = dequantize_int8_plain(q, s)
        q_err = max(q_err, (q.int() - q_p.int()).abs().max().item())
        s_err = max(s_err, (s - s_p).abs().max().item())
        out_err = max(out_err, (out.float() - out_p.float()).abs().max().item())
        if not (torch.equal(q, q_p) and torch.equal(s, s_p)
                and torch.equal(out.view(torch.int16), out_p.view(torch.int16))):
            unequal.append(kind)
        x = batch.setdefault(w.shape[1], torch.randn(16, w.shape[1], generator=gen,
                                                     device="cuda").bfloat16()).float()
        ref = x @ w.float().T
        err = rel(x @ out.float().T, ref)
        control = rel(x @ dequantize_int8_plain(torch.roll(q, 1, dims=1), s).float().T, ref)
        k = kinds.setdefault(kind, {"shape": list(w.shape), "matrices": 0, "max_rel_err": 0.0,
                                    "min_control_rel_err": math.inf})
        k["matrices"] += 1
        k["max_rel_err"] = max(k["max_rel_err"], err)
        k["min_control_rel_err"] = min(k["min_control_rel_err"], control)
        shapes.setdefault(tuple(w.shape), w)
    launches = {"quantize_int8": quantize_int8.launches, "dequantize_int8": dequantize_int8.launches}

    # device time per call at each shape, from a replayed CUDA graph: the
    # kernels on a contiguous copy of the first matrix of that shape, and
    # quantize_int8 on the path's own view (w.T: the copy at the boundary,
    # then the kernel)
    rows = []
    for (r, c), view in shapes.items():
        w = view.contiguous()
        q, s = quantize_int8(w)
        lib_out = torch.empty(r, c, dtype=torch.bfloat16, device="cuda")
        big = r * c > 1e8  # the embedding: fewer calls a graph
        n, reps = (5, 5) if big else (20, 10)
        q_bytes = r * c * (w.element_size() + 1) + 4 * r
        d_bytes = r * c * (1 + 2) + 4 * r
        rows.append({
            "shape": [r, c], "dtype": "bfloat16", "matrices": sum(
                k["matrices"] for k in kinds.values() if k["shape"] == [r, c]),
            "quantize": {"kernel_us": graph_us(lambda: quantize_int8(w), n, reps),
                         "path_us": graph_us(lambda: quantize_int8(view), n, reps),
                         "path_copies": not view.is_contiguous(),
                         "plain_us": graph_us(lambda: quantize_int8_plain(w), max(n // 4, 2), reps),
                         "bytes": q_bytes, "bound_us": q_bytes / HBM_BYTES_PER_S * 1e6},
            "dequantize": {"kernel_us": graph_us(lambda: dequantize_int8(q, s), n, reps),
                           "plain_us": graph_us(lambda: dequantize_int8_plain(q, s), max(n // 4, 2), reps),
                           "library_us": graph_us(lambda: torch.mul(q, s[:, None], out=lib_out), n, reps),
                           "library_bit_equal": torch.equal(
                               lib_out.view(torch.int16), dequantize_int8(q, s).view(torch.int16)),
                           "bytes": d_bytes, "bound_us": d_bytes / HBM_BYTES_PER_S * 1e6},
        })
    # the whole model once through the path: per shape, matrices x (one
    # quantize + one dequantize); "path" counts the boundary copies of w.T
    model_us = {key: sum(t["matrices"] * (t["quantize"][qk] + t["dequantize"][dk]) for t in rows)
                for key, qk, dk in (("kernels", "kernel_us", "kernel_us"),
                                    ("path", "path_us", "kernel_us"),
                                    ("bound", "bound_us", "bound_us"))}
    out = {
        "phase": "quant", "card": card, "model": "llama3.2-3b", "matrices": len(mats),
        "launches": launches, "launches_expected": len(mats), "model_us": model_us,
        "kernel_vs_plain": {"unequal": unequal, "q_max_abs_err": q_err, "scales_max_abs_err": s_err,
                            "out_max_abs_err": out_err},
        "matmul_rel_err_limit": limit, "by_kind": kinds, "timing": rows,
        "library": "dequantize: torch.mul(q, scales[:, None], out=<bf16>); quantize: none "
                   "(no single PyTorch call computes it)",
    }
    emit(out)
    del params, mats, batch, shapes
    torch.cuda.empty_cache()
    n = out["matrices"]
    if n != 7 * L_3B + 1:
        raise AssertionError(f"{n} matrices, not 7L + 1")
    if launches != {"quantize_int8": n, "dequantize_int8": n}:
        raise AssertionError(f"quant launches {launches} != {n} each")
    if unequal:
        raise AssertionError(f"quant kernels differ from their plain versions on {unequal}")
    worst = max(k["max_rel_err"] for k in kinds.values())
    if worst > limit:
        raise AssertionError(f"int8 weights: matmul relative error {worst} > {limit}")
    if min(k["min_control_rel_err"] for k in kinds.values()) <= limit:
        raise AssertionError("quant: the broken control passed the matmul limit")
    return out


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
                 ("decode_programs", "decode_steps", "decode_graph_replays", "prefill_mid_chunks",
                  "prefill_final_chunks", "decode_device_ms", "decode_programs_timed")}
        if delta["decode_graph_replays"] != delta["decode_steps"]:
            raise AssertionError(f"decode steps that were no graph replay: {delta}")
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
            "decode_step_ms_mean": (delta["decode_device_ms"] / delta["decode_programs_timed"]
                                    / cfg.engine.decode_steps),
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
        # the 16 greedy requests' tokens, for lora_serve's base requests
        result["tokens_by_prompt"] = {tuple(o.prompt_token_ids): o.token_ids for o in outs}
        return result
    finally:
        eng.shutdown()


def _graph_vs_eager(torch, params, cfg, B: int, S: int, steps: int, seed: int) -> dict:
    """``steps`` replays of a DecodeGraph over a cache of B rows prefilled
    with 96 seeded tokens, each replay's greedy tokens copied into the
    graph's input, against ``steps`` eager decode_steps on a clone of the
    cache; then a broken control, the replays without the copy, on another
    clone. RMSNorm launches are counted over the copied replays. Returns
    the graph, its cache and input, and the comparison."""
    from ray_tpu_torch.llm.engine import DecodeGraph
    from ray_tpu_torch.models.llama import decode_step, init_kv_cache, prefill
    from ray_tpu_torch.ops import rmsnorm

    prompt = torch.randint(0, cfg.vocab_size, (B, 96), generator=torch.Generator().manual_seed(seed),
                           dtype=torch.int32).cuda()
    cache = init_kv_cache(cfg, B, S, "cuda")
    logits, _ = prefill(params, cache, prompt, cfg)
    first = logits.argmax(-1).to(torch.int32)
    eager_cache = {k: v.clone() for k, v in cache.items()}
    control_cache = {k: v.clone() for k, v in cache.items()}
    tokens = first.clone()
    graph = DecodeGraph(params, cache, tokens, cfg)

    tok, eager = first, []
    for _ in range(steps):
        lg, _ = decode_step(params, eager_cache, tok, cfg)
        tok = lg.argmax(-1).to(torch.int32)
        eager.append((lg.clone(), tok))

    def replays(copy: bool) -> list:
        tokens.copy_(first)
        out = []
        for _ in range(steps):
            lg = graph.replay()
            nxt = lg.argmax(-1).to(torch.int32)
            if copy:
                tokens.copy_(nxt)
            out.append((lg.clone(), nxt))
        return out

    rmsnorm.launches = 0
    graphed = replays(True)
    launches = rmsnorm.launches
    for k in cache:
        cache[k].copy_(control_cache[k])
    control = replays(False)
    torch.cuda.synchronize()
    return {
        "graph": graph, "cache": cache, "tokens": tokens, "rmsnorm_launches": launches,
        "tokens_equal": all(torch.equal(g[1], e[1]) for g, e in zip(graphed, eager)),
        "control_tokens_equal": all(torch.equal(c[1], e[1]) for c, e in zip(control, eager)),
        "logits_max_abs_diff": max((g[0] - e[0]).abs().max().item() for g, e in zip(graphed, eager)),
    }


def phase_decode_graph(torch, card: str) -> dict:
    """The decode step as the engine runs it on the card, one CUDA graph
    (DecodeGraph), against eager decode_step: llama3.2-3b at full width and
    depth with well-conditioned weights, 16 rows prefilled with 96 tokens in
    a 1024-slot cache, cloned for the eager run and the control. Limits:
    8 graphed steps, each step's greedy tokens copied into the graph's
    input, give the eager steps' tokens exactly (the logits' max difference
    is reported); RMSNorm counts 2L+1 launches a replay; a broken control,
    8 replays without the copy, gives other tokens. Then the graphed step's
    device time, kernels and idle share (profiler) beside the eager step's
    and the step's weight + KV byte bound."""
    from ray_tpu_torch.models.llama import LlamaConfig, decode_step
    from ray_tpu_torch.tools.decode_profile import HBM_BYTES_PER_S, _profile, timed

    cfg = LlamaConfig.llama32_3b(max_seq_len=1024, fused_rmsnorm=True)
    params = _conditioned_params(torch, cfg, seed=5)
    B, S, steps = 16, 1024, 8
    with torch.inference_mode():
        g = _graph_vs_eager(torch, params, cfg, B, S, steps, seed=5)
        graph, cache, tokens = g["graph"], g["cache"], g["tokens"]
        equal, control_equal, max_diff, launches = (
            g["tokens_equal"], g["control_tokens_equal"], g["logits_max_abs_diff"], g["rmsnorm_launches"])

        weight_bytes = sum(p.numel() * p.element_size() for p in params.values())
        kv_bytes = 2 * cache["k"].numel() * cache["k"].element_size()
        graph_host_ms, graph_span_ms = timed(graph.replay, 20, warmup=3)
        graph_prof = _profile(graph.replay, 10)
        eager_host_ms, eager_span_ms = timed(lambda: decode_step(params, cache, tokens, cfg), 10)
        eager_prof = _profile(lambda: decode_step(params, cache, tokens, cfg), 3)
    out = {
        "phase": "decode_graph", "card": card, "model": "llama3.2-3b", "batch": B, "stripe": S,
        "steps": steps, "tokens_equal": equal, "logits_max_abs_diff": max_diff,
        "control_tokens_equal": control_equal, "rmsnorm_launches": launches,
        "rmsnorm_launches_expected": (2 * cfg.n_layers + 1) * steps,
        "step_bound_ms": (weight_bytes + kv_bytes) / HBM_BYTES_PER_S * 1e3,
        "graph": {"host_ms": graph_host_ms, "span_ms": graph_span_ms, **graph_prof},
        "eager": {"host_ms": eager_host_ms, "span_ms": eager_span_ms, **eager_prof},
        "timing": "span_ms: CUDA events over back-to-back steps; idle_share and kernel "
                  "times from torch.profiler",
    }
    emit(out)
    del graph, params, cache, g
    torch.cuda.empty_cache()
    if not equal:
        raise AssertionError(f"graphed decode tokens differ from eager (max logit diff {max_diff})")
    if launches != out["rmsnorm_launches_expected"]:
        raise AssertionError(f"rmsnorm launches {launches} over {steps} replays")
    if control_equal:
        raise AssertionError("decode_graph: the broken control gave the eager tokens")
    # the profiler's own count of RMSNorm kernels a step, graphed and eager
    for mode in ("graph", "eager"):
        seen = out[mode]["rmsnorm_launches_per_call"]
        if seen != 2 * cfg.n_layers + 1:
            raise AssertionError(f"decode_graph: the {mode} step's trace holds {seen} RMSNorm kernels")
    return out


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
    width = {"embed": cfg.d_model, "unembed": cfg.d_model, "wq": cfg.d_model, "wk": cfg.d_model, "wv": cfg.d_model,
             "wo": cfg.n_heads * cfg.head_dim, "w_gate": cfg.d_model, "w_up": cfg.d_model,
             "w_down": cfg.d_ff, "moe_w_gate": cfg.d_model, "moe_w_up": cfg.d_model,
             "moe_w_down": cfg.d_ff,
             # router logits of std 3: bf16 rounding rarely reorders a
             # token's experts
             "moe_router": cfg.d_model / 9}
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


def phase_train(torch, card: str) -> dict:
    """The JAX package's flagship train configuration (bench.py:31-47),
    value for value, through make_train_step on the card."""
    from ray_tpu_torch.tools.train_bench import bench_config, profile_step, run

    cfg = bench_config()
    if (cfg.vocab_size, cfg.d_model, cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff,
            cfg.max_seq_len, cfg.attention, cfg.remat, cfg.fused_ce) != (
            32000, 2048, 16, 16, 16, 8192, 2048, "splash", True, False):
        raise AssertionError(f"not the bench config: {cfg}")
    out = run(cfg, batch=4, seq=2048, warmup=2, steps=6)
    live = {k: out.pop(k) for k in ("state", "step_fn", "batch")}
    L, steps = cfg.n_layers, out["steps"]
    expected = {"fwd": 2 * L * steps, "bwd_dq": L * steps, "bwd_dkdv": L * steps}
    out["launches_expected"] = expected
    if out["launches"] != expected:
        raise AssertionError(f"attention launches {out['launches']} != {expected}")
    if not all(math.isfinite(x) for x in out["losses"]):
        raise AssertionError(f"non-finite train loss: {out['losses']}")
    out["profile"] = profile_step(live["step_fn"], live["state"], live["batch"])
    emit({"phase": "train", "card": card, "model": "bench.py train config", **out})
    del live
    torch.cuda.empty_cache()
    return out


def phase_train_numerics(torch, card: str) -> dict:
    """2 layers at the bench width (d_model 2048, 16 heads of 128, d_ff
    8192, vocab 32000), batch 2 x 256, weights drawn well-conditioned on
    the card: the loss and the grads of wq, wk, wv, wo and embed in bf16
    on the card through the kernels, against the same weights in fp32 on
    the CPU through dense_attention. Limits, fixed before the first run
    from the same arithmetic in bf16 on the CPU (dense attention, widths
    512-2048: grads 1.9-2.2e-2 relative RMS, loss 3e-5-9e-5 relative):
    - each grad's RMS error relative to its RMS: 6e-2;
    - the loss, relative: 1e-3;
    - a broken control, the kernel fed K one position off (a kernel that
      reads K one row off), must read above the grad limit (rehearsed:
      1.2-1.4);
    - the fused cross-entropy's loss against the plain one, both bf16 on
      the card on the same params and batch: 1e-4 relative."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.llama import loss_fn
    from ray_tpu_torch.ops.flash_attention import flash_attention, reset_launches
    from ray_tpu_torch.tools.train_bench import bench_config, make_batch

    grad_limit, loss_limit, fused_limit = 6e-2, 1e-3, 1e-4
    cfg = bench_config(n_layers=2)
    ref_cfg = dataclasses.replace(cfg, dtype=torch.float32, attention="full", remat=False)
    params = _conditioned_params(torch, cfg, seed=2)
    batch = make_batch(cfg, 2, 256, seed=2, device="cpu")
    names = ("wq", "wk", "wv", "wo", "embed")

    def loss_and_grads(c, device, dtype):
        p = {k: v.detach().to(device=device, dtype=dtype).requires_grad_(True)
             for k, v in params.items()}
        loss = loss_fn(p, {k: t.to(device) for k, t in batch.items()}, c)
        grads = torch.autograd.grad(loss, [p[n] for n in names])
        if not torch.isfinite(loss):
            raise AssertionError(f"train_numerics: non-finite loss on {device} in {dtype}")
        return loss.item(), {n: g.float().cpu() for n, g in zip(names, grads)}

    def rel_rms(a, b):
        return ((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt()).item()

    ref_loss, ref = loss_and_grads(ref_cfg, "cpu", torch.float32)
    reset_launches()
    card_loss, got = loss_and_grads(cfg, "cuda", torch.bfloat16)
    f = flash_attention
    launches = (f.launches_fwd, f.launches_bwd_dq, f.launches_bwd_dkdv)
    if launches != (2 * cfg.n_layers, cfg.n_layers, cfg.n_layers):
        raise AssertionError(f"train_numerics: attention launches {launches}")
    orig = llama._attention
    llama._attention = lambda q, k, v, c: orig(q, torch.roll(k, 1, dims=1), v, c)
    try:
        ctl_loss, ctl = loss_and_grads(cfg, "cuda", torch.bfloat16)
    finally:
        llama._attention = orig
    with torch.no_grad():
        p16 = {k: v.detach() for k, v in params.items()}
        on_card = {k: t.cuda() for k, t in batch.items()}
        plain_loss = loss_fn(p16, on_card, cfg).item()
        fused_loss = loss_fn(p16, on_card, dataclasses.replace(cfg, fused_ce=True)).item()
    out = {
        "phase": "train_numerics", "card": card, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "tokens": list(batch["tokens"].shape),
        "ref_loss": ref_loss, "bf16_loss": card_loss,
        "loss_rel_err": abs(card_loss - ref_loss) / abs(ref_loss), "loss_limit": loss_limit,
        "grad_rel_rms_err": {n: rel_rms(got[n], ref[n]) for n in names}, "grad_limit": grad_limit,
        "control_loss_rel_err": abs(ctl_loss - ref_loss) / abs(ref_loss),
        "control_grad_rel_rms_err": {n: rel_rms(ctl[n], ref[n]) for n in names},
        "plain_ce_loss": plain_loss, "fused_ce_loss": fused_loss,
        "fused_vs_plain_rel_err": abs(fused_loss - plain_loss) / abs(plain_loss),
        "fused_limit": fused_limit, "attention_launches": list(launches),
    }
    emit(out)
    worst = max(out["grad_rel_rms_err"].values())
    if worst > grad_limit or out["loss_rel_err"] > loss_limit:
        raise AssertionError(f"train_numerics: bf16 on the card outside the limits ({worst})")
    if max(out["control_grad_rel_rms_err"].values()) <= grad_limit:
        raise AssertionError("train_numerics: the broken control passed the grad limit")
    if out["fused_vs_plain_rel_err"] > fused_limit:
        raise AssertionError("train_numerics: fused and plain cross-entropy disagree")
    return out


def gc_collect(torch) -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()


MOE = {"moe_experts": 8, "moe_top_k": 2}
SERVE_BUCKETS = (32, 64, 128, 256, 512, 1024)


def _serve_config(model_kwargs: dict, **engine_kw):
    """The serve phase's engine shape: llama3.2-3b, 16 slots x 1024, chunk
    256, 8 decode steps a program."""
    from ray_tpu_torch.llm import EngineConfig, LLMConfig, ModelConfig

    return LLMConfig(
        model=ModelConfig(model_id="llama3.2-3b", tokenizer="byte", seed=0,
                          model_kwargs={"fused_rmsnorm": True, **model_kwargs}),
        engine=EngineConfig(max_num_seqs=16, max_seq_len=1024, prefill_buckets=SERVE_BUCKETS,
                            prefill_chunk=256, decode_steps=8, decode_runahead=1, **engine_kw),
    )


def _serve_prompts() -> list:
    """The serve phase's 16 distinct ~100-byte prompts."""
    prompts = [f"Request {i:02d}: " + "write a short note about serving a model on one card. " * 2
               for i in range(16)]
    return [p[:100] for p in prompts]


def _concurrent(server, bodies: list) -> tuple:
    """``bodies`` through server.completions, one thread each, all at once.
    Returns (the engine's RequestOutput of each body, in order, wall s)."""
    eng = server.engine
    generate = eng.generate
    outs = {}

    def observed(prompt, **kwargs):
        out = generate(prompt, **kwargs)
        outs[(prompt, kwargs.get("lora"))] = out
        return out

    replies = [None] * len(bodies)

    def one(i):
        replies[i] = server.completions(bodies[i])

    eng.generate = observed
    try:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=one, args=(i,)) for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
    finally:
        del eng.generate  # back to the class's method
    for i, (b, r) in enumerate(zip(bodies, replies)):
        if r is None or "error" in r or r["usage"]["completion_tokens"] != b["max_tokens"]:
            raise AssertionError(f"request {i} did not return {b['max_tokens']} tokens: {r}")
    return [outs[(b["prompt"], b.get("_lora"))] for b in bodies], wall


def _step_delta(stats0: dict, stats: dict) -> dict:
    return {k: stats[k] - stats0[k] for k in
            ("decode_programs", "decode_steps", "decode_graph_replays", "prefill_mid_chunks",
             "prefill_final_chunks", "decode_device_ms", "decode_programs_timed")}


def phase_moe_serve(torch, card: str) -> dict:
    """llama3.2-3b with 8 experts of top-2 (the MoE variant the LLM config
    names), full width and depth, seeded bf16 weights, served through
    LLMServer with the fused RMSNorm. 16 concurrent greedy requests x 32
    tokens: every decode step a graph replay, RMSNorm launches as the
    serve phase counts them. Then 8 graphed MoE decode steps against 8
    eager ones on cloned caches (tokens equal; a control replayed without
    the next tokens copied in gives other tokens). The decode step's byte
    bound reads every expert: the batched branch streams the whole bank."""
    import numpy as np

    from ray_tpu_torch.llm import LLMServer
    from ray_tpu_torch.ops import rmsnorm
    from ray_tpu_torch.tools.decode_profile import HBM_BYTES_PER_S, _profile

    cfg = _serve_config(MOE)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server = LLMServer(cfg)
    init_s = time.perf_counter() - t0
    eng = server.engine
    try:
        mcfg = eng.model_cfg
        if (mcfg.d_model, mcfg.n_layers, mcfg.n_heads, mcfg.n_kv_heads, mcfg.d_ff, mcfg.vocab_size,
                mcfg.tie_embeddings, mcfg.moe_experts, mcfg.moe_top_k) != (
                3072, L_3B, 24, 8, 8192, 128256, True, 8, 2):
            raise AssertionError(f"not the 3B MoE shape: {mcfg}")
        server.completions({"prompt": "warm up " * 12, "max_tokens": 16, "ignore_eos": True})
        stats0 = eng.get_stats()
        rmsnorm.launches = 0  # counts from here on are the main path's
        bodies = [{"prompt": p, "max_tokens": 32, "temperature": 0.0, "ignore_eos": True}
                  for p in _serve_prompts()]
        outs, wall = _concurrent(server, bodies)
        launches = rmsnorm.launches
        delta = _step_delta(stats0, eng.get_stats())
    finally:
        eng.shutdown()
    if delta["decode_graph_replays"] != delta["decode_steps"]:
        raise AssertionError(f"moe_serve: decode steps that were no graph replay: {delta}")
    n_norms = 2 * L_3B + 1
    expected = (n_norms * (delta["decode_steps"] + delta["prefill_final_chunks"])
                + (n_norms - 1) * delta["prefill_mid_chunks"])
    if launches != expected:
        raise AssertionError(f"moe_serve: rmsnorm launches {launches} != expected {expected} ({delta})")
    ttft = np.asarray([o.metrics["ttft_s"] for o in outs]) * 1e3
    params = eng.params
    weight_bytes = sum(p.numel() * p.element_size() for p in params.values())
    kv_bytes = sum(2 * pool.cache["k"].numel() * pool.cache["k"].element_size() for pool in eng._pools)
    step_bound_ms = (weight_bytes + kv_bytes) / HBM_BYTES_PER_S * 1e3
    program_ms = delta["decode_device_ms"] / delta["decode_programs_timed"]
    del server, eng, outs
    gc_collect(torch)
    with torch.inference_mode():
        g = _graph_vs_eager(torch, params, mcfg, 16, 1024, 8, seed=7)
        prof = _profile(g["graph"].replay, 5)
    out = {
        "phase": "moe_serve", "card": card, "model": "llama3.2-3b + 8 experts top-2",
        "params": sum(p.numel() for p in params.values()), "engine_init_s": init_s,
        "wall_s_16x32": wall, "out_tok_per_s": 16 * 32 / wall,
        "ttft_ms_p50": float(np.percentile(ttft, 50)), "ttft_ms_p99": float(np.percentile(ttft, 99)),
        "decode_program_ms_mean": program_ms, "decode_step_ms_mean": program_ms / 8,
        "decode_step_bytes": weight_bytes + kv_bytes, "decode_step_bound_ms": step_bound_ms,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "rmsnorm_launches": launches, "rmsnorm_launches_expected": expected, **delta,
        "graphed_vs_eager": {k: g[k] for k in ("tokens_equal", "control_tokens_equal",
                                               "logits_max_abs_diff", "rmsnorm_launches")},
        "graphed_step_profile": prof,
    }
    emit(out)
    del g, params
    gc_collect(torch)
    if not out["graphed_vs_eager"]["tokens_equal"]:
        raise AssertionError("moe_serve: graphed MoE decode tokens differ from eager")
    if out["graphed_vs_eager"]["control_tokens_equal"]:
        raise AssertionError("moe_serve: the broken control gave the eager tokens")
    return out


def phase_moe_numerics(torch, card: str) -> dict:
    """phase_numerics for the MoE variant: 2 layers at full 3B width with 8
    experts of top-2, prefill of 2 x 64 tokens (G = 128: the prefill's
    expert-by-expert branch), last-token logits on the card (fp32 and bf16,
    through the RMSNorm kernel) against the same weights in fp32 on the
    CPU through the plain path, on the RMS logit error relative to the RMS
    logit. Router logits have a std of 3 (_conditioned_params). Limits:
    - fp32: 1e-4, every token on the reference's experts;
    - bf16: 5e-2 against the reference run on the card's expert choices
      (at its own gates), and those choices equal to the reference's for
      at least 95% of (layer, token) expert sets. bf16 rounding reorders
      a token's experts near a tie, and such a token then carries another
      expert's output: on the CPU at widths 768 and 1536 this doubles the
      bf16 error (4.1-4.4e-2, against 2.1-2.5e-2 on equal choices; 2-3.5%
      of sets changed), and on an H100 the card's own choices read 6.8e-2.
      That error is reported beside the gated one;
    - a broken control: one expert's w_down shifted by one element along
      d_model in every layer, on the card copy only (the expert that the
      reference routes row 0's last token to first in layer 0), must
      exceed the bf16 limit against the reference on its own choices."""
    from ray_tpu_torch.models.llama import LlamaConfig, init_kv_cache, prefill
    from ray_tpu_torch.parallel import moe

    bf16 = LlamaConfig.llama32_3b(n_layers=2, max_seq_len=128, fused_rmsnorm=True, **MOE)
    fp32 = dataclasses.replace(bf16, dtype=torch.float32)
    params = _conditioned_params(torch, bf16, seed=6)
    tokens = torch.randint(0, bf16.vocab_size, (2, 64), generator=torch.Generator().manual_seed(6),
                           dtype=torch.int32)
    topk = moe.topk_gates

    def logits(cfg, device, dtype, p=params, force=None):
        """Last-token logits and each layer's expert choices [layers, G, k].
        ``force`` gives the choices instead, at this run's own gates."""
        routes = []

        def recording(bank, x, k):
            probs, vals, idx = topk(bank, x, k)
            if force is not None:
                idx = force[len(routes)].to(x.device)
                vals = probs.gather(-1, idx)
                vals = vals / vals.sum(-1, keepdim=True).clamp_min(1e-9)
            routes.append(idx.cpu())
            return probs, vals, idx

        p = {k: v.to(device=device, dtype=dtype) for k, v in p.items()}
        moe.topk_gates = recording
        try:
            with torch.inference_mode():
                out, _ = prefill(p, init_kv_cache(cfg, 2, 64, device), tokens.to(device), cfg)
        finally:
            moe.topk_gates = topk
        if not torch.isfinite(out).all() or out.shape != (2, cfg.vocab_size):
            raise AssertionError(f"moe logits on {device} in {dtype}: wrong shape or not finite")
        return out.float().cpu(), torch.stack(routes)

    def rel_rms(a, b):
        return ((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt()).item()

    def set_agreement(a, b):
        """Share of (layer, token) whose chosen expert sets are equal."""
        return (a.sort(-1).values == b.sort(-1).values).all(-1).float().mean().item()

    plain = dataclasses.replace(fp32, fused_rmsnorm=False)
    ref, ref_routes = logits(plain, "cpu", torch.float32)
    expert = int(ref_routes[0, 63, 0])  # layer 0, row 0's last token, first choice
    shifted = dict(params)
    shifted["moe_w_down"] = params["moe_w_down"].clone()
    shifted["moe_w_down"][:, expert] = torch.roll(params["moe_w_down"][:, expert], 1, dims=-1)
    card32, routes32 = logits(fp32, "cuda", torch.float32)
    card16, routes16 = logits(bf16, "cuda", torch.bfloat16)
    control, control_routes = logits(bf16, "cuda", torch.bfloat16, shifted)
    del shifted
    # the reference with the card's expert choices: bf16 reorders a token's
    # experts near a tie, and a changed choice moves that token by a whole
    # expert's output, which is routing, not arithmetic
    ref16, _ = logits(plain, "cpu", torch.float32, force=routes16)
    ref_control, _ = logits(plain, "cpu", torch.float32, force=control_routes)
    out = {
        "phase": "moe_numerics", "card": card, "layers": 2, "d_model": bf16.d_model, "experts": 8,
        "top_k": 2, "tokens": list(tokens.shape), "ref_rms": ref.pow(2).mean().sqrt().item(),
        "fp32_rel_rms_err": rel_rms(card32, ref), "fp32_limit": 1e-4,
        "fp32_route_set_agreement": set_agreement(routes32, ref_routes),
        "bf16_rel_rms_err_same_routes": rel_rms(card16, ref16), "bf16_limit": 5e-2,
        "bf16_route_set_agreement": set_agreement(routes16, ref_routes), "route_set_limit": 0.95,
        "bf16_rel_rms_err_own_routes": rel_rms(card16, ref),
        "bf16_route_position_agreement": (routes16 == ref_routes).float().mean().item(),
        "bf16_max_abs_err_same_routes": (card16 - ref16).abs().max().item(),
        "bf16_top1_agreement": (card16.argmax(-1) == ref.argmax(-1)).float().mean().item(),
        "control_expert": expert, "control_rel_rms_err_same_routes": rel_rms(control, ref_control),
    }
    emit(out)
    del params
    gc_collect(torch)
    if out["fp32_rel_rms_err"] > out["fp32_limit"] or out["fp32_route_set_agreement"] < 1.0:
        raise AssertionError(f"moe fp32 on the card: {out['fp32_rel_rms_err']} > {out['fp32_limit']}")
    if out["bf16_rel_rms_err_same_routes"] > out["bf16_limit"]:
        raise AssertionError(f"moe bf16 on the card: {out['bf16_rel_rms_err_same_routes']} > 5e-2")
    if out["bf16_route_set_agreement"] < out["route_set_limit"]:
        raise AssertionError(f"moe bf16 routes: {out['bf16_route_set_agreement']} agree < 0.95")
    if out["control_rel_rms_err_same_routes"] <= out["bf16_limit"]:
        raise AssertionError("moe_numerics: the broken control passed the bf16 limit")
    return out


def phase_moe_train(torch, card: str) -> dict:
    """bench.py's train widths with 8 experts, top-2, capacity 1.25 (batch
    4 x 2048, bf16, remat "full", splash) through make_train_step, at the
    depth that fits (tools/moe_train_bench.py:moe_layers), the optimizer at
    its peak rate from step 2 (moe_optimizer): 2 warm-up and 3 timed steps
    from init_params' weights, finite losses, attention launches 2L/L/L a
    step. Then the learning check: 5 steps on one fixed batch from
    well-conditioned weights (_conditioned_params), the last loss below
    the first. From init_params' weights at this width the gradient norm
    reads ~2e7 and the loss moves by +-0.02 from step to step whatever the
    rate (on an H100: 11.01-11.05 over 7 steps), so those steps show no
    learning either way."""
    from ray_tpu_torch.models.training import TrainState, make_train_step
    from ray_tpu_torch.tools.moe_train_bench import (
        measured, moe_layers, moe_optimizer, moe_train_config, reckoned_peak_bytes,
    )
    from ray_tpu_torch.tools.train_bench import make_batch, profile_step, run

    L, why = moe_layers()
    cfg = moe_train_config(L)
    out = run(cfg, batch=4, seq=2048, warmup=2, steps=3, optimizer=moe_optimizer())
    live = {k: out.pop(k) for k in ("state", "step_fn", "batch")}
    profile = profile_step(live["step_fn"], live["state"], live["batch"])
    del live
    gc_collect(torch)
    steps = out["steps"]
    expected = {"fwd": 2 * L * steps, "bwd_dq": L * steps, "bwd_dkdv": L * steps}
    params = _conditioned_params(torch, cfg, seed=8)
    opt = moe_optimizer()
    _, step_fn = make_train_step(cfg, opt)
    state, batch, learn = TrainState(params, opt.init(params), 0), make_batch(cfg, 4, 2048, seed=8), []
    for _ in range(5):
        state, metrics = step_fn(state, batch)
        learn.append(metrics["loss"])
    learn = [float(x) for x in learn]
    del params, state, metrics, batch
    gc_collect(torch)
    out = {
        "phase": "moe_train", "card": card, "model": "bench.py train widths + 8 experts top-2",
        "layers": L, "depth_rule": why, "reckoned_peak_gb": reckoned_peak_bytes(cfg) / 1e9,
        "optimizer": "default_optimizer with 1 warm-up step (peak rate 3e-4 from step 2)",
        **measured(cfg, out), "learning_losses": learn, "launches_expected": expected,
        "profile": profile,
        "mfu_note": "mfu counts each token through its top-k experts (6 x active params + "
                    "attention); mfu_capacity_slots counts the capacity buffers' slots "
                    "(capacity factor x top-k)",
    }
    emit(out)
    if out["launches"] != expected:
        raise AssertionError(f"moe_train: attention launches {out['launches']} != {expected}")
    if not all(math.isfinite(x) for x in out["losses"] + learn):
        raise AssertionError(f"moe_train: non-finite loss: {out['losses']}, {learn}")
    if not learn[-1] < learn[0]:
        raise AssertionError(f"moe_train: the loss did not fall over {len(learn)} steps: {learn}")
    return out


def phase_train_dots(torch, card: str, full: dict) -> dict:
    """The train phase's configuration with remat_policy="dots", in turns
    with "full" in this phase (full, dots, dots, full: 2 warm-up and 3 timed
    steps each), so both read the card in the same state; the train
    phase's own "full" reading stands beside them. Attention launches
    stay 2L/L/L a step under "dots" (the attention kernel is no matmul op,
    so the policy recomputes it)."""
    from ray_tpu_torch.tools.train_bench import bench_config, run

    runs = []
    for policy in ("full", "dots", "dots", "full"):
        cfg = bench_config(remat_policy=policy)
        out = run(cfg, batch=4, seq=2048, warmup=2, steps=3)
        for k in ("state", "step_fn", "batch"):
            del out[k]
        gc_collect(torch)
        runs.append({"policy": policy, **out})
    L, steps = cfg.n_layers, runs[0]["steps"]
    expected = {"fwd": 2 * L * steps, "bwd_dq": L * steps, "bwd_dkdv": L * steps}
    ms = {p: [r["step_ms"] for r in runs if r["policy"] == p] for p in ("full", "dots")}
    peak = {p: max(r["peak_mem_gib"] for r in runs if r["policy"] == p) for p in ("full", "dots")}
    out = {"phase": "train_dots", "card": card, "model": "bench.py train config, remat dots vs full",
           "step_ms": ms, "peak_mem_gib": peak, "launches_expected": expected,
           "runs": [{k: r[k] for k in ("policy", "step_ms", "mfu", "peak_mem_gib", "losses", "launches")}
                    for r in runs],
           "train_phase_full_step_ms": full["step_ms"], "train_phase_full_peak_mem_gib": full["peak_mem_gib"]}
    emit(out)
    for r in runs:
        if r["launches"] != expected:
            raise AssertionError(f"train_dots: {r['policy']} attention launches {r['launches']} != {expected}")
        if not all(math.isfinite(x) for x in r["losses"]):
            raise AssertionError(f"train_dots: non-finite loss: {r['losses']}")
    return {"launches": next(r for r in runs if r["policy"] == "dots")["launches"], **out}


def phase_lora_serve(torch, card: str, serve: dict) -> dict:
    """llama3.2-3b at full depth with max_loras=2, lora_rank=8, served
    through LLMServer (prefix caching off, so every prefill is cold). Two
    seeded adapters loaded with load_lora. 16 requests of 32 tokens on the
    serve phase's prompts, on adapters (none, "a", "b") in turn, run one
    by one and then all at once: each request's tokens equal in both runs;
    the base requests' tokens equal the serve phase's (no-LoRA engine, same
    weights) first 32; adapted tokens differ from the base somewhere; every
    decode step a graph replay while slots change adapters."""
    from ray_tpu_torch.llm import LLMServer, SamplingParams
    from ray_tpu_torch.ops import rmsnorm
    from ray_tpu_torch.tools.decode_profile import _profile

    cfg = _serve_config({}, max_loras=2, lora_rank=8, enable_prefix_caching=False)
    server = LLMServer(cfg)
    eng = server.engine
    try:
        gen = torch.Generator(device="cuda").manual_seed(9)
        mcfg = eng.model_cfg
        for name in ("a", "b"):
            # A: N(0, 1) / sqrt(d_model); B: N(0, 1) x 4 / sqrt(rank): deltas
            # of O(4) on q and v, whose entries are O(10) under this init
            weights = {k: torch.randn(v.shape[:1] + v.shape[2:], generator=gen, device="cuda")
                       * (mcfg.d_model**-0.5 if k.endswith("_a") else 4 * cfg.engine.lora_rank**-0.5)
                       for k, v in eng.loras.items()}
            server.load_lora(name, weights)
        if server.list_loras() != ["a", "b"]:
            raise AssertionError(f"lora_serve: loaded {server.list_loras()}")
        server.completions({"prompt": "warm up " * 12, "max_tokens": 16, "ignore_eos": True,
                            "_lora": "a"})
        adapters = [(None, "a", "b")[i % 3] for i in range(16)]
        bodies = [{"prompt": p, "max_tokens": 32, "temperature": 0.0, "ignore_eos": True,
                   **({"_lora": a} if a else {})} for p, a in zip(_serve_prompts(), adapters)]
        sp = SamplingParams(max_tokens=32, temperature=0.0, ignore_eos=True)
        sequential = [eng.generate(b["prompt"], sampling_params=sp, lora=b.get("_lora")).token_ids
                      for b in bodies]
        stats0 = eng.get_stats()
        rmsnorm.launches = 0  # counts from here on are the path's
        outs, wall = _concurrent(server, bodies)
        launches = rmsnorm.launches
        delta = _step_delta(stats0, eng.get_stats())
    finally:
        eng.shutdown()
    n_norms = 2 * L_3B + 1
    expected = (n_norms * (delta["decode_steps"] + delta["prefill_final_chunks"])
                + (n_norms - 1) * delta["prefill_mid_chunks"])
    with torch.inference_mode():  # the pool's decode graph, adapters and all
        prof = _profile(eng._pools[0].graph.replay, 5)
    mixed = [o.token_ids for o in outs]
    base = {tuple(o.prompt_token_ids): o.token_ids for o, a in zip(outs, adapters) if a is None}
    base_equal = all(serve["tokens_by_prompt"][k][:32] == t for k, t in base.items())
    adapted_differ = sum(
        o.token_ids != serve["tokens_by_prompt"][tuple(o.prompt_token_ids)][:32]
        for o, a in zip(outs, adapters) if a)
    out = {
        "phase": "lora_serve", "card": card, "model": "llama3.2-3b", "max_loras": 2, "lora_rank": 8,
        "requests": 16, "adapters": adapters, "wall_s_16x32": wall, "out_tok_per_s": 16 * 32 / wall,
        "serve_out_tok_per_s_16x64": serve["out_tok_per_s"],
        "mixed_equal_sequential": mixed == sequential, "base_requests": len(base),
        "base_equal_no_lora_engine": base_equal, "adapted_requests_differing_from_base": adapted_differ,
        "decode_program_ms_mean": delta["decode_device_ms"] / delta["decode_programs_timed"],
        "rmsnorm_launches": launches, "rmsnorm_launches_expected": expected, **delta,
        "graphed_step_profile": prof,
    }
    emit(out)
    del server, eng, outs
    gc_collect(torch)
    if delta["decode_graph_replays"] != delta["decode_steps"]:
        raise AssertionError(f"lora_serve: decode steps that were no graph replay: {delta}")
    if launches != expected:
        raise AssertionError(f"lora_serve: rmsnorm launches {launches} != expected {expected}")
    if not out["mixed_equal_sequential"]:
        raise AssertionError("lora_serve: the mixed batch's tokens differ from the sequential runs'")
    if not base_equal or len(base) != 6:
        raise AssertionError("lora_serve: base requests differ from the no-LoRA engine's tokens")
    if adapted_differ == 0:
        raise AssertionError("lora_serve: no adapter changed any request's tokens")
    return out


def phase_graft_entry(torch, card: str) -> dict:
    """ray_tpu_torch.graft_entry.entry() on the card: its bf16 forward, and
    the same weights in fp32, against an fp64 reference on the CPU. The
    entry's weights are ill-conditioned (init_params draws wq/wk with
    fan_in = the head count: attention scores of std ~64, a nearly one-hot
    softmax), so bf16 alone is far from the reference: on the CPU the
    port's bf16 reads 0.53 and the JAX entry's 0.56 relative RMS, fp32
    8.2e-4. Limits, fixed from those CPU readings before the first card
    run: fp32 1e-2, bf16 0.75; a broken control (layer 0's wo rolled by
    one along d_model: 1.42 on the CPU) must exceed both."""
    from ray_tpu_torch.graft_entry import entry, entry_config
    from ray_tpu_torch.models.llama import forward

    fn, (params, tokens) = entry()
    cfg = entry_config()

    def run(p, device, dtype):
        c = dataclasses.replace(cfg, dtype=dtype)
        with torch.inference_mode():
            out = forward({k: v.to(device=device, dtype=dtype) for k, v in p.items()}, tokens.to(device), c)
        if not torch.isfinite(out).all() or out.shape != (2, 128, cfg.vocab_size):
            raise AssertionError(f"graft_entry on {device} in {dtype}: wrong shape or not finite")
        return out.double().cpu()

    def rel_rms(a, b):
        return ((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt()).item()

    with torch.inference_mode():
        card16 = fn(params, tokens).double().cpu()
    ref = run(params, "cpu", torch.float64)
    broken = dict(params)
    broken["wo"] = params["wo"].clone()
    broken["wo"][0] = torch.roll(params["wo"][0], 1, dims=-1)
    out = {
        "phase": "graft_entry", "card": card, "config": "4 layers, d 512, 8/4 heads, d_ff 1408, "
        "vocab 4096, bf16, 2 x 128 tokens", "logits": list(card16.shape),
        "bf16_rel_rms_err": rel_rms(card16, ref), "bf16_limit": 0.75,
        "cpu_bf16_rel_rms_err": rel_rms(run(params, "cpu", torch.bfloat16), ref),
        "fp32_rel_rms_err": rel_rms(run(params, "cuda", torch.float32), ref), "fp32_limit": 1e-2,
        "bf16_top1_agreement": (card16.argmax(-1) == ref.argmax(-1)).double().mean().item(),
        "control_fp32_rel_rms_err": rel_rms(run(broken, "cuda", torch.float32), ref),
        "control_bf16_rel_rms_err": rel_rms(run(broken, "cuda", torch.bfloat16), ref),
    }
    emit(out)
    if out["fp32_rel_rms_err"] > out["fp32_limit"] or out["bf16_rel_rms_err"] > out["bf16_limit"]:
        raise AssertionError(f"graft_entry: outside the limits: {out}")
    if out["control_fp32_rel_rms_err"] <= out["fp32_limit"] or out["control_bf16_rel_rms_err"] <= out["bf16_limit"]:
        raise AssertionError("graft_entry: the broken control passed a limit")
    return out


TRAIN_SERVE_WIDTHS = dict(vocab_size=32000, d_model=2048, n_layers=16, n_heads=16, n_kv_heads=16,
                          d_ff=8192)


def _swapped_copy(src: str, dst: str, a: str, b: str) -> None:
    """A copy of the checkpoint at ``src`` whose leaves ``a`` and ``b``
    trade names: the same data file (hard-linked), the manifest's keys
    swapped."""
    import os
    import shutil

    from ray_tpu_torch.train.checkpoint import _PYTREE_DATA, _PYTREE_MANIFEST, read_manifest

    os.makedirs(dst)
    try:
        os.link(os.path.join(src, _PYTREE_DATA), os.path.join(dst, _PYTREE_DATA))
    except OSError:
        shutil.copyfile(os.path.join(src, _PYTREE_DATA), os.path.join(dst, _PYTREE_DATA))
    manifest = read_manifest(src)
    manifest["keys"] = [{a: b, b: a}.get(k, k) for k in manifest["keys"]]
    with open(os.path.join(dst, _PYTREE_MANIFEST), "w") as f:
        json.dump(manifest, f)


def phase_train_serve(torch, card: str, train: dict) -> dict:
    """Train -> checkpoint -> serve at the bench width, through the entry
    points a user calls.

    TorchTrainer runs ray_tpu_torch.examples.train_llama_dp.train_loop on
    one rank (a spawned process, one card, an NCCL process group; the batch
    seed goes through broadcast_from_rank_zero) on bench.py's train config
    (1.20 B params, batch 4 x 2048, remat, the attention kernels). Attempt
    0 runs 2 steps, reports the whole train state (params, AdamW moments,
    step) as a checkpoint, runs step 3 and raises on purpose. Attempt 1
    (FailureConfig(max_failures=1)) resumes from the step-2 checkpoint,
    re-runs step 3 (its loss must equal attempt 0's), runs step 4 and
    reports the params as the final checkpoint, with their bit checksums
    and the prefill logits of a probe prompt. Every step launches the
    attention kernels 2L / L / L times; no rank outlives fit().

    LLMServer then serves the final checkpoint (ModelConfig.checkpoint_path,
    the bench widths, fused RMSNorm, 16 slots): the restored weights'
    checksums equal the rank's; the probe's prefill logits lie within the
    numerics phase's bf16 limit (5e-2 relative RMS) of the rank's; 16
    concurrent greedy requests x 32 tokens complete, every decode step a
    graph replay, RMSNorm launches as counted. Broken control: a copy of
    the checkpoint with the wq and wk leaves swapped (equal shapes at
    16/16 heads) restores and must fail the logits limit; that restore's
    peak device memory is one copy of the params."""
    import multiprocessing
    import shutil
    import tempfile

    import numpy as np

    from ray_tpu_torch.examples import train_llama_dp as ex
    from ray_tpu_torch.llm import EngineConfig, LLMConfig, LLMServer, ModelConfig
    from ray_tpu_torch.llm.tokenizer import ByteTokenizer
    from ray_tpu_torch.models.llama import param_template
    from ray_tpu_torch.ops import rmsnorm
    from ray_tpu_torch.train import (CheckpointConfig, FailureConfig, RunConfig, ScalingConfig,
                                     TorchTrainer, restore_state_dict)

    limit = 5e-2  # the numerics phase's bf16 limit
    L = TRAIN_SERVE_WIDTHS["n_layers"]
    serve_kwargs = {**TRAIN_SERVE_WIDTHS, "fused_rmsnorm": True}
    probe = {"tokens": ByteTokenizer().encode("The port trains, checkpoints and serves one model."),
             "model_kwargs": serve_kwargs, "max_seq_len": 256}
    config = {"model": "bench", "steps": 4, "batch": 4, "seq_len": 2048, "seed": 0,
              "state_checkpoint_at": 2, "fail_once_after": 3, "probe": probe}
    gc_collect(torch)  # the parent holds no model while the rank runs
    storage = tempfile.mkdtemp(prefix="train-serve-")
    try:
        trainer = TorchTrainer(
            ex.train_loop, train_loop_config=config,
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            run_config=RunConfig(name="train_serve", storage_path=storage,
                                 failure_config=FailureConfig(max_failures=1),
                                 checkpoint_config=CheckpointConfig(num_to_keep=1)),
        )
        t0 = time.perf_counter()
        result = trainer.fit()
        fit_s = time.perf_counter() - t0
        left = [p.name for p in multiprocessing.active_children() if "-rank-" in p.name]
        if result.error is not None or left:
            raise AssertionError(f"train_serve: fit failed ({result.error}) or left {left}")
        h = result.metrics_history
        if [m["step"] for m in h] != [1, 2, 3, 3, 4]:
            raise AssertionError(f"train_serve: steps reported {[m['step'] for m in h]}")
        a0, a1 = h[2], h[3]  # step 3 in attempts 0 and 1
        if a1.get("resumed_from_step") != 2 or not a1["resumed_from"].endswith(
                "attempt_000/checkpoint_000001"):
            raise AssertionError(f"train_serve: attempt 1 did not resume from step 2: {a1}")
        expected = {"flash_attention_fwd": 2 * L, "flash_attention_bwd_dq": L,
                    "flash_attention_bwd_dkdv": L}
        bad = [m["launches"] for m in h
               if any(m["launches"][k] != n for k, n in expected.items())]
        if bad or not all(math.isfinite(m["loss"]) for m in h):
            raise AssertionError(f"train_serve: attention launches {bad} or a loss not finite")
        if {m["backend"] for m in h} != {"nccl"}:
            raise AssertionError(f"train_serve: the rank's process group is not NCCL: {h[0]}")
        loss_diff = abs(a1["loss"] - a0["loss"])
        if loss_diff > 1e-6 * abs(a0["loss"]):
            raise AssertionError(f"train_serve: resumed step-3 loss {a1['loss']} != {a0['loss']}")
        final = h[-1]
        ckpt = result.checkpoint.path

        # serving the checkpoint
        rank_logits = final["probe_logits"]
        cfg = LLMConfig(
            model=ModelConfig(model_id="tiny", tokenizer="byte", seed=0, model_kwargs=serve_kwargs,
                              checkpoint_path=ckpt),
            engine=EngineConfig(max_num_seqs=16, max_seq_len=256, prefill_buckets=(32, 64, 128, 256),
                                prefill_chunk=256, decode_steps=8, decode_runahead=1),
        )
        t0 = time.perf_counter()
        server = LLMServer(cfg)
        engine_init_s = time.perf_counter() - t0
        eng = server.engine
        try:
            if eng.model_cfg != ex.serve_config(probe):
                raise AssertionError(f"train_serve: served config {eng.model_cfg}")
            served_checksums = ex.bit_checksums(eng.params)
            served_logits = ex.probe_logits(eng.params, eng.model_cfg, probe["tokens"])
            server.completions({"prompt": "warm up " * 12, "max_tokens": 16, "ignore_eos": True})
            stats0 = eng.get_stats()
            rmsnorm.launches = 0  # counts from here on are the path's
            bodies = [{"prompt": p, "max_tokens": 32, "temperature": 0.0, "ignore_eos": True}
                      for p in _serve_prompts()]
            outs, wall = _concurrent(server, bodies)
            launches = rmsnorm.launches
            delta = _step_delta(stats0, eng.get_stats())
        finally:
            eng.shutdown()
        del server, eng
        gc_collect(torch)
        n_norms = 2 * L + 1
        norms_expected = (n_norms * (delta["decode_steps"] + delta["prefill_final_chunks"])
                          + (n_norms - 1) * delta["prefill_mid_chunks"])

        # the broken control: wq and wk swapped, restored onto the card
        ctl_dir = ckpt + "_swapped"
        _swapped_copy(ckpt, ctl_dir, "wq", "wk")
        mcfg = ex.serve_config(probe)
        # bytes the restore asked the allocator for (its blocks may round up
        # by as much as 1 MiB each: a large block is not split for less)
        torch.cuda.synchronize()
        base = torch.cuda.memory_stats()["requested_bytes.all.current"]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        swapped = restore_state_dict(ctl_dir, like=param_template(mcfg), device="cuda")
        torch.cuda.synchronize()
        ctl_read_s = time.perf_counter() - t0
        restore_peak = torch.cuda.memory_stats()["requested_bytes.all.peak"] - base
        param_bytes = sum(t.numel() * t.element_size() for t in swapped.values())
        ctl_logits = ex.probe_logits(swapped, mcfg, probe["tokens"])
        del swapped
        gc_collect(torch)
    finally:
        shutil.rmtree(storage, ignore_errors=True)

    def rel_rms(a, b):
        return float(np.sqrt(np.mean((a - b) ** 2) / np.mean(b ** 2)))

    steps_ms = [m["step_ms"] for m in h]
    gb = 1e9
    ttft = np.asarray([o.metrics["ttft_s"] for o in outs]) * 1e3
    out = {
        "phase": "train_serve", "card": card, "model": "bench.py train config",
        "params": ex.model_config(config).num_params(), "fit_s": fit_s,
        "rank_startup_s": trainer._controller.rank_startup_s,
        "losses": [m["loss"] for m in h], "steps": [m["step"] for m in h],
        "step_ms": steps_ms,
        # steps 2 and 4: neither the first step of a process nor a resumed one
        "steady_step_ms": [h[1]["step_ms"], h[4]["step_ms"]],
        "train_phase_step_ms": train["step_ms"],
        "resumed_from": a1["resumed_from"], "step3_loss_attempt0": a0["loss"],
        "step3_loss_attempt1": a1["loss"], "step3_loss_diff": loss_diff,
        "step3_bit_equal": a1["loss"] == a0["loss"],
        "launches": {k: sum(m["launches"][k] for m in h) for k in expected},
        "launches_per_step": expected,
        "state_checkpoint_gb": h[1]["checkpoint_bytes"] / gb,
        "state_checkpoint_write_s": h[1]["checkpoint_write_s"],
        "state_checkpoint_write_gb_per_s": h[1]["checkpoint_bytes"] / gb / h[1]["checkpoint_write_s"],
        "state_checkpoint_read_s": a1["checkpoint_read_s"],
        "state_checkpoint_read_gb_per_s": a1["checkpoint_bytes"] / gb / a1["checkpoint_read_s"],
        "params_checkpoint_gb": final["checkpoint_bytes"] / gb,
        "params_checkpoint_write_s": final["checkpoint_write_s"],
        "params_checkpoint_write_gb_per_s": final["checkpoint_bytes"] / gb / final["checkpoint_write_s"],
        "params_checkpoint_read_to_card_s": ctl_read_s,
        "params_checkpoint_read_gb_per_s": param_bytes / gb / ctl_read_s,
        "engine_init_s": engine_init_s,
        "checksums_equal": served_checksums == final["checksums"],
        "logits_rel_rms_err": rel_rms(served_logits, rank_logits),
        "logits_max_abs_err": float(np.abs(served_logits - rank_logits).max()),
        "logits_bit_equal": bool(np.array_equal(served_logits, rank_logits)),
        "logits_limit": limit,
        "control_logits_rel_rms_err": rel_rms(ctl_logits, rank_logits),
        "restore_peak_bytes": restore_peak, "param_bytes": param_bytes,
        "requests": len(bodies), "wall_s_16x32": wall, "out_tok_per_s": 16 * 32 / wall,
        "ttft_ms_p50": float(np.percentile(ttft, 50)), "ttft_ms_p99": float(np.percentile(ttft, 99)),
        "decode_program_ms_mean": delta["decode_device_ms"] / delta["decode_programs_timed"],
        "rmsnorm_launches": launches, "rmsnorm_launches_expected": norms_expected, **delta,
    }
    emit(out)
    if not out["checksums_equal"]:
        raise AssertionError("train_serve: the served weights' checksums differ from the rank's")
    if out["logits_rel_rms_err"] > limit:
        raise AssertionError(f"train_serve: served logits {out['logits_rel_rms_err']} > {limit}")
    if out["control_logits_rel_rms_err"] <= limit:
        raise AssertionError("train_serve: the swapped-leaf control passed the logits limit")
    if delta["decode_graph_replays"] != delta["decode_steps"]:
        raise AssertionError(f"train_serve: decode steps that were no graph replay: {delta}")
    if launches != norms_expected:
        raise AssertionError(f"train_serve: rmsnorm launches {launches} != {norms_expected}")
    # one copy of the params on the card, no more
    if restore_peak != param_bytes:
        raise AssertionError(f"train_serve: restore peak {restore_peak} B for {param_bytes} B")
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

    timings = {}

    def timed_phase(name, fn):
        t = time.perf_counter()
        result = fn(torch, card)
        timings[name] = time.perf_counter() - t
        return result

    k = timed_phase("kernels", phase_kernels)
    quant = timed_phase("quant", phase_quant)
    torch.cuda.empty_cache()
    serve = timed_phase("serve", phase_serve)
    torch.cuda.empty_cache()
    timed_phase("decode_graph", phase_decode_graph)
    timed_phase("numerics", phase_numerics)
    train = timed_phase("train", phase_train)
    timed_phase("train_numerics", phase_train_numerics)
    gc_collect(torch)
    moe_serve = timed_phase("moe_serve", phase_moe_serve)
    timed_phase("moe_numerics", phase_moe_numerics)
    moe_train = timed_phase("moe_train", phase_moe_train)
    lora_serve = timed_phase("lora_serve", lambda torch, card: phase_lora_serve(torch, card, serve))
    dots = timed_phase("train_dots", lambda torch, card: phase_train_dots(torch, card, train))
    timed_phase("graft_entry", phase_graft_entry)
    train_serve = timed_phase("train_serve", lambda torch, card: phase_train_serve(torch, card, train))
    emit({"phase": "timings", "seconds": timings, "build_seconds": build_s})

    decode = next(r for r in k["rows"] if r["case"] == "decode")
    fused = k["fused"]
    bench = next(r for r in k["attention"]["rows"] if r["case"] == "bench")
    gqa3b = next(r for r in k["attention"]["rows"] if r["case"] == "gqa3b")
    attention_kernels = [
        ("flash_attention_fwd", "fwd", "ray_tpu/models/llama.py:334", bench["sdpa_fwd_us"]),
        ("flash_attention_bwd_dq", "bwd_dq", "ray_tpu/models/llama.py:334", bench["sdpa_bwd_us"]),
        ("flash_attention_bwd_dkdv", "bwd_dkdv", "ray_tpu/models/llama.py:334", bench["sdpa_bwd_us"]),
    ]
    # the backward pair computes one function, dq, dk and dv: its bound (10
    # flops per causal pair and head dim, S and dP once) and its library
    # time (one aten backward call) stand on both rows beside the per-kernel
    # bounds, which count the S and dP that each kernel recomputes
    bwd_pair = {"bwd_function_bound_ms": bench["bwd_bound_us"] / 1e3,
                "bwd_pair_ms": bench["bwd_pair_us"] / 1e3,
                "gqa3b_bwd_pair_ms": gqa3b["bwd_pair_us"] / 1e3,
                "gqa3b_bwd_function_bound_ms": gqa3b["bwd_bound_us"] / 1e3,
                "library_note": "aten._scaled_dot_product_flash_attention_backward: dq, dk, dv "
                                "together, the function of both backward kernels; at gqa3b on "
                                "K, V repeated to H heads outside the timed graph"}
    # the quant rows at w_gate/w_up's shape [8192, 3072] (56 of the 197
    # matrices); the quant phase line has every shape
    mlp_up = next(r for r in quant["timing"] if r["shape"] == [8192, 3072])
    kvp = quant["kernel_vs_plain"]
    quant_kernels = [
        ("quantize_int8", "quantize", "ray_tpu/ops/quant.py:20",
         max(kvp["q_max_abs_err"], kvp["scales_max_abs_err"])),
        ("dequantize_int8", "dequantize", "ray_tpu/ops/quant.py:29", kvp["out_max_abs_err"]),
    ]
    emit({"kernels": [{
        "name": "rmsnorm",
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/rmsnorm.cu",
        "replaces": "ray_tpu/ops/rmsnorm.py:23",
        "launches": serve["rmsnorm_launches"],
        # each serving path, its counter set to 0 just before it
        "launches_by_path": {"serve": serve["rmsnorm_launches"],
                             "moe_serve": moe_serve["rmsnorm_launches"],
                             "lora_serve": lora_serve["rmsnorm_launches"],
                             "train_serve": train_serve["rmsnorm_launches"]},
        "max_abs_err": k["max_abs_err"],
        "ms": decode["kernel_us"] / 1e3,
        "plain_ms": decode["plain_us"] / 1e3,
        "bound_ms": decode["bound_us"] / 1e3,
        "bound_by": "bytes",
        "library_ms": decode["library_us"] / 1e3 if decode["library_us"] is not None else None,
        # the residual add fused in (add_rmsnorm) at the same shape
        "fused_ms": fused["kernel_us"] / 1e3,
        "fused_bound_ms": fused["bound_us"] / 1e3,
        "fused_plain_ms": fused["plain_us"] / 1e3,
        "fused_add_then_kernel_ms": fused["add_then_kernel_us"] / 1e3,
        "fused_bit_equal": fused["bit_equal_to_add_then_kernel"],
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/flash_attention" + ("_fwd.cu" if key == "fwd" else ".cu"),
        "replaces": replaces,
        "launches": train["launches"][key],
        # each training path's timed steps, the counters set to 0 before them
        "launches_by_path": {"train": train["launches"][key], "moe_train": moe_train["launches"][key],
                             "train_dots": dots["launches"][key],
                             # the trainer's rank process, its own counters
                             "train_serve": train_serve["launches"][name]},
        "max_abs_err": k["attention"]["max_abs_err"],
        "ms": bench[key]["kernel_us"] / 1e3,
        "plain_ms": bench[key]["plain_us"] / 1e3,
        "bound_ms": bench[key]["bound_us"] / 1e3,
        "bound_by": bench[key]["bound_by"],
        "library_ms": lib_us / 1e3 if lib_us is not None else None,
        **(bwd_pair if key.startswith("bwd") else {}),
        "tflops": bench[key]["tflops"],
        "bound_share": bench[key]["bound_share"],
        "gqa3b_ms": gqa3b[key]["kernel_us"] / 1e3,
        "gqa3b_bound_ms": gqa3b[key]["bound_us"] / 1e3,
        "gqa3b_library_ms": gqa3b["sdpa_fwd_us" if key == "fwd" else "sdpa_bwd_us"] / 1e3,
        "gqa3b_tflops": gqa3b[key]["tflops"],
        "gqa3b_bound_share": gqa3b[key]["bound_share"],
    } for name, key, replaces, lib_us in attention_kernels] + [{
        "name": name,
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/quant.cu",
        "replaces": replaces,
        "launches": quant["launches"][name],
        "max_abs_err": err,
        "ms": mlp_up[key]["kernel_us"] / 1e3,
        "plain_ms": mlp_up[key]["plain_us"] / 1e3,
        "bound_ms": mlp_up[key]["bound_us"] / 1e3,
        "bound_by": "bytes",
        "library_ms": mlp_up[key]["library_us"] / 1e3 if "library_us" in mlp_up[key] else None,
        "shape": mlp_up["shape"],
        **({"path_ms": mlp_up[key]["path_us"] / 1e3} if "path_us" in mlp_up[key] else {}),
        **({"library_bit_equal": mlp_up[key]["library_bit_equal"]} if "library_us" in mlp_up[key]
           else {"library_note": "no single PyTorch call computes per-row absmax int8 quantization"}),
    } for name, key, replaces, err in quant_kernels]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
