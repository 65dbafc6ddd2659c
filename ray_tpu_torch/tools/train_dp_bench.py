"""Data-parallel training across ranks: one rank against N, through TorchTrainer.

    python -m ray_tpu_torch.tools.train_dp_bench --ranks 1 4        # one card a rank
    python -m ray_tpu_torch.tools.train_dp_bench --ranks 1 4 --cpu  # CPU ranks, tiny model

Runs ``examples/train_llama_dp.py:train_loop`` at ``bench.py``'s train
config (1.20 B params, bf16, remat, the attention kernels; batch 4 x 2048
per rank, so N ranks take N times the tokens a step) for ``--steps``
steps at each rank count in turn, and prints one JSON line per count with
the card's nvidia-smi name and power limit: rank 0's step ms (each step
ends in a loss read, so it includes the gradient all-reduce), the median
of the steps after the first, tokens/s over all ranks, the scaling
efficiency against the first count (tokens/s per rank over the first
count's), whether every rank ends with the same params (an all-gather of
bit checksums), the losses, and rank start-up seconds. ``--cpu`` runs
gloo ranks at ``LlamaConfig.tiny`` for a rehearsal; its times are the
CPU's, not a device's.
"""

from __future__ import annotations

import argparse
import json
import statistics
import tempfile
import time

from ray_tpu_torch.examples.train_llama_dp import model_config, train_loop
from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer


def run(ranks: int, steps: int, cpu: bool, storage: str) -> dict:
    config = ({"model": "tiny", "steps": steps, "batch": 2, "seq_len": 32} if cpu else
              {"model": "bench", "steps": steps, "batch": 4, "seq_len": 2048})
    trainer = TorchTrainer(
        train_loop, train_loop_config=config,
        scaling_config=ScalingConfig(num_workers=ranks, use_gpu=not cpu),
        run_config=RunConfig(name=f"dp{ranks}", storage_path=storage),
    )
    t0 = time.perf_counter()
    result = trainer.fit()
    fit_s = time.perf_counter() - t0
    if result.error is not None:
        raise RuntimeError(f"{ranks} ranks: {result.error}")
    h = result.metrics_history
    steady = statistics.median(m["step_ms"] for m in h[1:])
    tokens = ranks * config["batch"] * config["seq_len"]
    return {
        "ranks": ranks, "device": "cpu" if cpu else "cuda", "backend": h[0]["backend"],
        "params": model_config(config).num_params(), "tokens_per_step": tokens,
        "step_ms": [m["step_ms"] for m in h], "steady_step_ms": steady,
        "tokens_per_s": tokens / (steady / 1e3), "losses": [m["loss"] for m in h],
        "params_equal_across_ranks": h[-1]["params_equal_across_ranks"],
        "rank_startup_s": trainer._controller.rank_startup_s, "fit_s": fit_s,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, nargs="+", default=[1, 4])
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--cpu", action="store_true", help="gloo ranks at the tiny config")
    args = ap.parse_args(argv)
    card = "cpu"
    if not args.cpu:
        from ray_tpu_torch.tools.decode_profile import card as nvidia_smi

        card = nvidia_smi()
    first = None
    with tempfile.TemporaryDirectory(prefix="train-dp-") as storage:
        for n in args.ranks:
            out = run(n, args.steps, args.cpu, storage)
            first = first or out
            out["scaling_efficiency"] = (out["tokens_per_s"] / n) / (first["tokens_per_s"] / first["ranks"])
            if not out["params_equal_across_ranks"]:
                raise RuntimeError(f"{n} ranks ended with different params")
            print(json.dumps({"phase": "train_dp", "card": card, **out}), flush=True)


if __name__ == "__main__":
    main()
