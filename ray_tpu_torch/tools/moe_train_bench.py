"""MoE train-step throughput on one CUDA card, and the dispatch
formulation's cost.

    python -m ray_tpu_torch.tools.moe_train_bench

The configuration is ``bench.py``'s train widths (vocab 32000, d_model
2048, 16 heads of 128, d_ff 8192 per expert, bf16, remat "full",
attention "splash", batch 4 x 2048) with 8 experts, top-2 routing and
capacity factor 1.25, at the depth that fits (``moe_layers``). It times
the step with the package's gather dispatch (``parallel/moe.py:moe_dense``)
and with the JAX package's one-hot einsum dispatch (``moe_dense_onehot``
below, swapped in for the run), in turns (gather, one-hot, one-hot,
gather) on one card, and prints one JSON line per run with the card's
nvidia-smi name and power limit. ``chip_smoke.py``'s moe_train phase uses
the configuration, the depth rule and the FLOP counts from here.
"""

from __future__ import annotations

import gc
import json

import torch

from ray_tpu_torch.models.llama import LlamaConfig
from ray_tpu_torch.models.training import H100_BF16_DENSE_FLOPS, default_optimizer
from ray_tpu_torch.parallel import moe
from ray_tpu_torch.tools.train_bench import bench_config, run

MOE = dict(moe_experts=8, moe_top_k=2, moe_capacity_factor=1.25)
PEAK_BUDGET_BYTES = 72e9  # of the H100's 80 GB, room kept for the allocator and CUDA


def moe_train_config(n_layers: int = 16) -> LlamaConfig:
    return bench_config(n_layers=n_layers, **MOE)


def moe_optimizer():
    """``default_optimizer`` at its peak rate from the second step (one
    warm-up step, not 100): the weights are bf16, and the first steps of a
    100-step warm-up move most of them by less than half a bf16 ulp, so a
    few steps could not show the loss falling."""
    return default_optimizer(warmup_steps=1)


def reckoned_peak_bytes(cfg: LlamaConfig) -> float:
    """The step's resident bytes before activations: params, grads, the two
    AdamW moments and the optimizer's dict of updates, each the params' size
    in bf16, plus two transients the size of the largest leaf (the expert
    bank of one projection) while an update is formed."""
    elt = torch.finfo(cfg.dtype).bits // 8
    largest = cfg.n_layers * cfg.moe_experts * cfg.d_model * cfg.d_ff
    return 5 * cfg.num_params() * elt + 2 * largest * elt


def moe_layers() -> tuple[int, str]:
    """16 layers if their reckoned peak stays under the budget, else 8."""
    full = reckoned_peak_bytes(moe_train_config(16))
    if full < PEAK_BUDGET_BYTES:
        return 16, f"16 layers: reckoned peak {full / 1e9:.1f} GB < {PEAK_BUDGET_BYTES / 1e9:.0f} GB"
    return 8, (f"8 layers: at 16 the params, grads, two moments and the optimizer's updates "
               f"(5 x {moe_train_config(16).num_params() * 2 / 1e9:.2f} GB) and the largest leaf's "
               f"transients reckon {full / 1e9:.1f} GB, over the {PEAK_BUDGET_BYTES / 1e9:.0f} GB budget")


def flops_per_token(cfg: LlamaConfig, capacity_slots: bool = False) -> float:
    """Train FLOPs a token, 6 x the params it passes through + the attention
    term of ``training.flops_per_token``. Each token passes its top-k
    experts (``capacity_slots=False``), or the capacity buffers' share of
    computed slots, capacity_factor x top-k (True)."""
    e, f, E, k, L = cfg.d_model, cfg.d_ff, cfg.moe_experts, cfg.moe_top_k, cfg.n_layers
    per_expert = 3 * e * f
    used = k * cfg.moe_capacity_factor if capacity_slots else k
    active = cfg.num_params() - L * E * per_expert + L * used * per_expert
    return 6.0 * active + 12 * L * cfg.d_model * cfg.max_seq_len


def moe_dense_onehot(params, x, *, num_experts: int, top_k: int = 2, capacity_factor: float = 1.25):
    """``moe_dense`` as the JAX package writes it: the dispatch and combine
    einsums over ``_route``'s one-hot [G, E, C] tensors."""
    C = max(1, int(capacity_factor * x.shape[0] * top_k / num_experts))
    disp, comb, aux = moe._route(params, x, num_experts, top_k, C)
    out = moe._expert_ffn(params, torch.einsum("gd,gec->ecd", x, disp))
    return torch.einsum("ecd,gec->gd", out, comb), aux


def measured(cfg: LlamaConfig, out: dict) -> dict:
    """``train_bench.run``'s measurements with the MoE FLOP counts: its
    ``flops_per_token`` and ``mfu`` count every expert's params."""
    out = {k: v for k, v in out.items() if k not in ("flops_per_token", "mfu")}
    topk, slots = flops_per_token(cfg), flops_per_token(cfg, capacity_slots=True)
    return {**out, "flops_per_token_topk": topk, "flops_per_token_capacity_slots": slots,
            "mfu": out["tokens_per_s"] * topk / H100_BF16_DENSE_FLOPS,
            "mfu_capacity_slots": out["tokens_per_s"] * slots / H100_BF16_DENSE_FLOPS}


def timed_run(cfg: LlamaConfig, dispatch: str, warmup: int = 1, steps: int = 3) -> dict:
    """One run of ``train_bench.run`` with the named dispatch."""
    gather = moe.moe_dense
    if dispatch == "onehot":
        moe.moe_dense = moe_dense_onehot
    try:
        out = run(cfg, warmup=warmup, steps=steps, optimizer=moe_optimizer())
    finally:
        moe.moe_dense = gather
    for k in ("state", "step_fn", "batch"):
        del out[k]
    gc.collect()
    torch.cuda.empty_cache()
    return {"dispatch": dispatch, **measured(cfg, out)}


def main() -> None:
    from ray_tpu_torch.tools.decode_profile import card

    if not torch.cuda.is_available():
        raise SystemExit("moe_train_bench: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    name = card()
    layers, why = moe_layers()
    cfg = moe_train_config(layers)
    for dispatch in ("gather", "onehot", "onehot", "gather"):
        out = timed_run(cfg, dispatch)
        print(json.dumps({"measure": "moe_train", "card": name, "layers": layers, "depth_rule": why,
                          **out}), flush=True)


if __name__ == "__main__":
    main()
