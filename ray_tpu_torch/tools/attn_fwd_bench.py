"""The flash-attention kernels against SDPA, on one CUDA card: the forward
beside SDPA's forward, and the backward pair (dQ, then dK/dV) beside
SDPA's backward.

    python -m ray_tpu_torch.tools.attn_fwd_bench [--shape name=B,T,H,KV,D[,full] ...]

Holds the package's forward against ``flash_attention_fwd_plain`` and its
backward pair, fed the forward's own o and lse, against
``flash_attention_bwd_plain``, within the package's limits (LSE within
1e-4), at the train bench shape and llama3.2-3b's GQA head shape (causal,
bf16) or the ``--shape``s given. The yardsticks, timed here only: SDPA's
forward, and its flash backward alone
(``aten._scaled_dot_product_flash_attention_backward``, dq, dk and dv in
one call), which takes equal head counts only, so at GQA it reads K and V
repeated to H heads outside the timed graph. Device time per call from a
replayed CUDA graph, in 5 turns (package, SDPA, package backward pair,
each backward kernel alone, SDPA backward, then the reverse, ...). One
JSON line per shape, with the card's nvidia-smi name and power limit;
exits 1 if a check fails.

Run as a file with another checkout first on ``PYTHONPATH``
(``PYTHONPATH=<checkout> python ray_tpu_torch/tools/attn_fwd_bench.py``),
it times that checkout's kernels: run two checkouts in turn (A, B, B, A)
to compare them on one card.
"""

from __future__ import annotations

import argparse
import importlib
import json
import statistics
import sys

import torch
import torch.nn.functional as F

SHAPES = {"bench": (4, 2048, 16, 16, 128), "gqa3b": (4, 2048, 24, 8, 128)}  # B, T, H, KV, D
TURNS = 5


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", action="append", default=[],
                    help="name=B,T,H,KV,D[,full]: shapes to time instead of bench and gqa3b")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("attn_fwd_bench: needs a CUDA card")
    from ray_tpu_torch.models.training import H100_BF16_DENSE_FLOPS
    from ray_tpu_torch.tools.decode_profile import card, graph_us

    # the module (ray_tpu_torch.ops re-exports a function of the same name)
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    name, ok = card(), True
    gen = torch.Generator(device="cuda").manual_seed(3)
    shapes = {tag: (*dims, True) for tag, dims in SHAPES.items()}
    if args.shape:
        shapes = {}
        for spec in args.shape:
            tag, dims = spec.split("=")
            dims = dims.split(",")
            shapes[tag] = (*map(int, dims[:5]), dims[5:] != ["full"])
    for tag, (B, T, H, KV, D, causal) in shapes.items():
        q, k, v, do = (torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)
                       for s in ((B, T, H, D), (B, T, KV, D), (B, T, KV, D), (B, T, H, D)))
        hd = B * H * D * (T * (T + 1) // 2 if causal else T * T)  # (query, key) pairs x D
        # useful FLOPs: the forward 4, the backward function 10 (S and dP
        # once), dQ 6 and dK/dV 8 (each recomputes S and dP)
        flops = {"package": 4 * hd, "sdpa": 4 * hd, "package_bwd": 10 * hd,
                 "package_bwd_dq": 6 * hd, "package_bwd_dkdv": 8 * hd, "sdpa_bwd": 10 * hd}
        o_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, causal=causal)

        def check(o, lse):
            a = fa.agreement(o, o_p)
            a["lse_max_abs_err"] = (lse - lse_p).abs().max().item()
            a["ok"] = a["ok"] and a["lse_max_abs_err"] <= 1e-4
            return a

        o, lse = fa.flash_attention_fwd_kernel(q, k, v, causal=causal)
        checks = {"package": check(o, lse)}
        refs = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
        got = fa.flash_attention_bwd_kernel(q, k, v, o, lse, do, causal=causal)
        checks.update({f"package_bwd_{n}": fa.agreement(x, ref)
                       for n, x, ref in zip(("dq", "dk", "dv"), got, refs)})
        del refs, got
        _, delta = fa.flash_attention_bwd_dq_kernel(q, k, v, o, lse, do, causal=causal)
        qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
        gqa = {"enable_gqa": True} if H != KV else {}
        kr, vr = (kt, vt) if H == KV else (t.repeat_interleave(H // KV, dim=1) for t in (kt, vt))
        aten = torch.ops.aten
        so, slse, cq, ck, mq, mk, seed, offset, _ = aten._scaled_dot_product_flash_attention(
            qt, kr, vr, 0.0, causal)
        fns = {"package": lambda: fa.flash_attention_fwd_kernel(q, k, v, causal=causal),
               "sdpa": lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, **gqa),
               "package_bwd": lambda: fa.flash_attention_bwd_kernel(q, k, v, o, lse, do, causal=causal),
               "package_bwd_dq": lambda: fa.flash_attention_bwd_dq_kernel(q, k, v, o, lse, do,
                                                                          causal=causal),
               "package_bwd_dkdv": lambda: fa.flash_attention_bwd_dkdv_kernel(q, k, v, lse, delta, do,
                                                                              causal=causal),
               "sdpa_bwd": lambda: aten._scaled_dot_product_flash_attention_backward(
                   dot, qt, kr, vr, so, slse, cq, ck, mq, mk, 0.0, causal, seed, offset)}
        times = {key: [] for key in fns}
        for turn in range(TURNS):  # in order; then in reverse; ...
            for key in list(fns) if turn % 2 == 0 else list(fns)[::-1]:
                times[key].append(graph_us(fns[key], 20, 30))
        ok = ok and all(c["ok"] for c in checks.values())
        print(json.dumps({
            "shape": tag, "bthkd": [B, T, H, KV, D], "causal": causal, "card": name,
            "flops": flops,
            "bound_us": {key: f / H100_BF16_DENSE_FLOPS * 1e6 for key, f in flops.items()},
            "us": times, "median_us": {key: statistics.median(ts) for key, ts in times.items()},
            "tflops": {key: [flops[key] / t / 1e6 for t in ts] for key, ts in times.items()},
            "checks": checks,
            "sdpa_bwd_kv": "as given" if H == KV else
                           f"K, V repeated {H // KV}x to H heads outside the timed graph",
            "timing": f"device time per call, replayed CUDA graph of 20 calls, 30 replays; "
                      f"{TURNS} turns, every other one in reverse order",
        }), flush=True)
        del q, k, v, do, qt, kt, vt, dot, kr, vr, o, lse, delta, so, slse, o_p, lse_p
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
