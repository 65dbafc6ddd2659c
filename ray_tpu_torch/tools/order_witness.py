"""Whether a change of summation order alone parts greedy completions, on one card.

    python -m ray_tpu_torch.tools.order_witness
    python -m ray_tpu_torch.tools.order_witness --model tiny --cpu  # rehearsal

One process, no mesh, no collective: llama3.2-3b at full width and depth in
fp32 (``gang_bench``'s serving config at tp 1) prefills ``gang_bench``'s 16
prompts and decodes each greedily for 64 tokens, with ``prefill`` and
``decode_step`` called eagerly. It does so three times on each set of
weights: as the model stands, once more the same way (the run's own
repeatability), and with every ``wo`` and ``w_down`` product summed as a
tensor-parallel gang of ``--parts`` ranks sums it: each rank's rows give a
partial product and the partials are added in rank order (a
``TorchFunctionMode`` splits those two matmuls; nothing else changes).
The weights are the seeded ``init_params`` (wq/wk drawn with fan_in = the
head count) and ``graft_entry.conditioned_params``.

Prints one JSON line per (weights, run) against the first run: the prefill
logits' relative difference (Frobenius norm of the difference over the
first run's), the share of equal argmaxes of those logits, and the
completions' agreement (whole, first token, mean common prefix of 64).
The last line is the card's nvidia-smi name and power limit.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess

import torch
from torch.overrides import TorchFunctionMode

from ray_tpu_torch.tools.gang_bench import _common_prefix, _config, _prompts

NEW_TOKENS = 64


class _SplitSum(TorchFunctionMode):
    """``x @ w`` for the listed weights (matched by storage address) as the
    sum, in rank order, of ``parts`` partial products over row blocks of w:
    the order of a tensor-parallel all-reduce over those rows."""

    def __init__(self, weights, parts: int):
        super().__init__()
        self.ptrs = {w.data_ptr() for w in weights}
        self.parts = parts

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if (func in (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__)
                and len(args) == 2 and args[1].dim() == 2
                and args[1].data_ptr() in self.ptrs):
            x, w = args
            n = w.shape[0] // self.parts
            y = x[..., :n] @ w[:n]
            for p in range(1, self.parts):
                y = y + x[..., p * n:(p + 1) * n] @ w[p * n:(p + 1) * n]
            return y
        return func(*args, **kwargs)


@torch.no_grad()
def _greedy(params, cfg, tokens, split: int):
    """(prefill logits [B, V], the B greedy completions of NEW_TOKENS)."""
    from contextlib import nullcontext

    from ray_tpu_torch.models.llama import decode_step, init_kv_cache, prefill

    B, T = tokens.shape
    cache = init_kv_cache(cfg, B, max_len=T + NEW_TOKENS, device=tokens.device)
    weights = [params["wo"][l] for l in range(cfg.n_layers)]
    weights += [params["w_down"][l] for l in range(cfg.n_layers)]
    with (_SplitSum(weights, split) if split > 1 else nullcontext()):
        logits, cache = prefill(params, cache, tokens, cfg)
        first = logits.clone()
        out = [logits.argmax(-1)]
        for _ in range(NEW_TOKENS - 1):
            logits, cache = decode_step(params, cache, out[-1], cfg)
            out.append(logits.argmax(-1))
    return first, torch.stack(out, 1).tolist()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="3b", choices=("3b", "tiny"))
    ap.add_argument("--parts", type=int, nargs="+", default=[2, 4],
                    help="the tensor-parallel degrees whose summation order is replayed")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (the rehearsal)")
    args = ap.parse_args(argv)

    from ray_tpu_torch.graft_entry import conditioned_params
    from ray_tpu_torch.llm.config import resolve_llama_config
    from ray_tpu_torch.llm.tokenizer import get_tokenizer
    from ray_tpu_torch.models.llama import init_params

    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (pass --cpu for the rehearsal)")
    device = "cpu" if args.cpu else "cuda"
    # the matmuls stay fp32: the split changes the order of the sums only
    torch.backends.cuda.matmul.allow_tf32 = False
    lc = _config(args.model, 1, 1, "float32")
    tok = get_tokenizer(lc.model.tokenizer)
    cfg = resolve_llama_config(lc.model, lc.engine, min_vocab=tok.vocab_size)
    tokens = torch.tensor([tok.encode(p) for p in _prompts()], device=device)
    for weights in ("seeded", "conditioned"):
        params = (init_params(cfg, seed=0, device=device) if weights == "seeded"
                  else conditioned_params(cfg, seed=0, device=device))
        ref_logits, ref = _greedy(params, cfg, tokens, 1)
        for run, split in [("repeat", 1)] + [(f"split{p}", p) for p in args.parts]:
            logits, comp = _greedy(params, cfg, tokens, split)
            print(json.dumps({
                "model": args.model, "dtype": "float32", "weights": weights, "run": run,
                "logits_rel": float((logits - ref_logits).norm() / ref_logits.norm()),
                "argmax_equal": int((logits.argmax(-1) == ref_logits.argmax(-1)).sum()),
                "completions_equal": sum(a == b for a, b in zip(comp, ref)),
                "first_equal": sum(a[0] == b[0] for a, b in zip(comp, ref)),
                "mean_common_prefix": sum(_common_prefix(a, b) for a, b in zip(comp, ref))
                / len(ref),
                "of": len(ref),
            }), flush=True)
        del params
        if device == "cuda":
            torch.cuda.empty_cache()
    smi = shutil.which("nvidia-smi")
    if smi:
        print(subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
