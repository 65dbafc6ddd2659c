"""Train-step time of the JAX package's multi-chip sweep on 1 to N cards.

    python -m ray_tpu_torch.tools.parallel_bench --ranks 1 4
    python -m ray_tpu_torch.tools.parallel_bench --ranks 1 4 --cpu --widths tiny  # gloo

For each rank count, ``graft_entry.dryrun_multichip`` runs every mesh of
the sweep (``graft_entry.mesh_sweep``: JAX's ``_mesh_sweep`` at 8k ranks,
halved to fit 1, 2 or 4, then the tool's own ``EP_SP_MESH``, fitted the
same way) on one NCCL rank a
card, at the bench widths
(``bench.py:31-47``: 16 layers, the pp and MoE meshes 4 layers and 4
experts; ``graft_entry.conditioned_params``, seed 0) with 4 x 2048
tokens a data shard: one step, then ``--steps``
timed steps (host clock, each ending by reading the loss; the median is
kept). With more than one rank, rank 0 also runs the unsharded step on the
global batch, and each mesh's loss and grad norm stand beside it.

Prints one JSON line per (rank count, mesh): step ms, tokens/s, the flash
launches of the first step, and, past the first rank count, the scaling
against the first: efficiency = (tokens/s at n) / (n / n_first x tokens/s
of the same mesh at n_first). The last line is the card's nvidia-smi name
and power limit.
"""

from __future__ import annotations

import argparse
import json

# the tool's own mesh after the sweep's, at 8 ranks (fitted to n as the
# sweep's are): MoE over ep and sp together, routed in JAX's flat token chunks
EP_SP_MESH = ("dp2-sp2-ep2-moe", {"dp": 2, "sp": 2, "ep": 2},
              {"attention": "ring", "moe_experts": 4, "moe_top_k": 2})


def main(argv=None) -> None:
    from ray_tpu_torch.graft_entry import dryrun_multichip, fit_mesh

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, nargs="+", default=[1, 4])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--widths", default="bench", choices=("bench", "tiny"))
    ap.add_argument("--cpu", action="store_true", help="gloo ranks on the CPU")
    ap.add_argument("--meshes", nargs="*", help="labels of the sweep to run (default: all)")
    args = ap.parse_args(argv)
    first: dict = {}
    label, sizes, kw = EP_SP_MESH
    for n in args.ranks:
        extra = [(label, fit_mesh(label, sizes, n).sizes(), kw)]
        recs = dryrun_multichip(n, "cpu" if args.cpu else None, widths=args.widths,
                                init="conditioned", timed_steps=args.steps, reference=n > 1,
                                meshes=args.meshes, extra_meshes=extra, timeout_s=1800)
        for r in recs:
            row = {"ranks": n, "label": r["label"],
                   "mesh": {a: s for a, s in r["mesh"].items() if s > 1},
                   "step_ms": r["step_ms"], "step_ms_all": r["step_ms_all"],
                   "first_step_ms": r["first_step_ms"], "tokens": r["tokens"],
                   "tokens_per_s": r["tokens"] / r["step_ms"] * 1e3, "loss": r["loss"],
                   "grad_norm": r["grad_norm"], "launches": r["launches"],
                   "unsharded_function": r["unsharded_function"]}
            if "ref_loss" in r:
                row["ref_loss"], row["ref_grad_norm"] = r["ref_loss"], r["ref_grad_norm"]
                row["loss_rel_err"] = abs(r["loss"] - r["ref_loss"]) / abs(r["ref_loss"])
                row["grad_norm_rel_err"] = (abs(r["grad_norm"] - r["ref_grad_norm"])
                                            / r["ref_grad_norm"])
            base = first.get(r["label"])
            if base is None:
                first[r["label"]] = row
            else:
                row["efficiency"] = row["tokens_per_s"] / (
                    n / base["ranks"] * base["tokens_per_s"])
                row["step_ms_at_first"] = base["step_ms"]
            print(json.dumps(row), flush=True)
    if not args.cpu:
        from ray_tpu_torch.tools.decode_profile import card

        print(card(), flush=True)


if __name__ == "__main__":
    main()
