"""The flash-attention forward kernel against SDPA's forward, on one CUDA card.

    python -m ray_tpu_torch.tools.attn_fwd_bench [--shape name=B,T,H,KV,D[,full] ...]

Holds the package's forward kernel against ``flash_attention_fwd_plain``
within the package's limits (LSE within 1e-4) and times it beside SDPA's
forward (the yardstick, timed here only), at the train bench shape and
llama3.2-3b's GQA head shape (causal, bf16) or the ``--shape``s given.
Device time per call from a replayed CUDA graph, in 5 turns (package,
SDPA, then the reverse, ...). One JSON line per shape, with the card's
nvidia-smi name and power limit; exits 1 if a check fails.

Run as a file with another checkout first on ``PYTHONPATH``
(``PYTHONPATH=<checkout> python ray_tpu_torch/tools/attn_fwd_bench.py``),
it times that checkout's forward: run two checkouts in turn (A, B, B, A)
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
        q, k, v = (torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)
                   for s in ((B, T, H, D), (B, T, KV, D), (B, T, KV, D)))
        flops = 4 * B * H * D * (T * (T + 1) // 2 if causal else T * T)
        o_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, causal=causal)

        def check(o, lse):
            a = fa.agreement(o, o_p)
            a["lse_max_abs_err"] = (lse - lse_p).abs().max().item()
            a["ok"] = a["ok"] and a["lse_max_abs_err"] <= 1e-4
            return a

        checks = {"package": check(*fa.flash_attention_fwd_kernel(q, k, v, causal=causal))}
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        gqa = {"enable_gqa": True} if H != KV else {}
        fns = {"package": lambda: fa.flash_attention_fwd_kernel(q, k, v, causal=causal),
               "sdpa": lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, **gqa)}
        times = {key: [] for key in fns}
        for turn in range(TURNS):  # package, sdpa; then in reverse; ...
            for key in list(fns) if turn % 2 == 0 else list(fns)[::-1]:
                times[key].append(graph_us(fns[key], 20, 30))
        ok = ok and all(c["ok"] for c in checks.values())
        print(json.dumps({
            "shape": tag, "bthkd": [B, T, H, KV, D], "causal": causal, "card": name,
            "flops": flops, "bound_us": flops / H100_BF16_DENSE_FLOPS * 1e6,
            "us": times, "median_us": {key: statistics.median(ts) for key, ts in times.items()},
            "tflops": {key: [flops / t / 1e6 for t in ts] for key, ts in times.items()},
            "checks": checks,
            "timing": f"device time per call, replayed CUDA graph of 20 calls, 30 replays; "
                      f"{TURNS} turns, every other one in reverse order",
        }), flush=True)
        del q, k, v, qt, kt, vt, o_p, lse_p
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
