"""Gang serving's tok/s, TTFT and decode step on 1 to N cards.

    python -m ray_tpu_torch.tools.gang_bench --tp 1 2 4 --sp-tp 2,2
    python -m ray_tpu_torch.tools.gang_bench --tp 1 2 4 --dtype float32 --no-engine
    python -m ray_tpu_torch.tools.gang_bench --tp 1 2 4 --adapters  # multi-LoRA
    python -m ray_tpu_torch.tools.gang_bench --tp 1 2 --cpu --model tiny  # gloo rehearsal

For each tensor-parallel degree (and each sp,tp pair of ``--sp-tp``) a
``GangLLMServer`` of tp x sp ranks, one a card (NCCL), serves llama3.2-3b
at full width and depth (seeded weights, bf16 or ``--dtype float32``,
fused RMSNorm; ``--model tiny`` in fp32 for the rehearsal) with 16 slots x 1024, chunk 256,
decode_steps 4 and run-ahead 2 (the smoke's gang_serve phase): a warm-up, the ranks'
counters set to 0, then 16 distinct ~100-byte greedy prompts of 64 tokens
submitted at once. The single-process ``TorchEngine`` on the same config
runs first on one card (``--no-engine`` skips it). ``--adapters`` serves
with max_loras=2, lora_rank=8: two seeded adapters loaded into the engine
and each gang, and the 16 prompts on adapters (none, a, b) in turn.

Prints one JSON line per configuration: output tok/s (16 x 64 over the
wall time from the first submit to the last token), TTFT p50/p99 (each
request's first token time from its submit), the gang's start-up and each
rank's (spawn to ready: rendezvous, weights, decode graph), the plan round
trip (dispatch to rank 0's reply, one host clock) and rank 0's execution of
it, the decode step's device time on rank 0 (CUDA events around each
plan's decode steps, sampling and the token broadcast included) and its
graph replay's alone, and the greedy tokens' agreement with the first
configuration's (whole completions, first tokens, mean common prefix).
The last line is the card's nvidia-smi name and power limit.
"""

from __future__ import annotations

import argparse
import json
import shutil
import time


DECODE_STEPS, RUNAHEAD = 4, 2


def _config(model: str, tp: int, sp: int, dtype: str, checkpoint=None, adapters=False):
    from ray_tpu_torch.llm import EngineConfig, LLMConfig, ModelConfig

    tiny = model == "tiny"
    return LLMConfig(
        model=ModelConfig(model_id="tiny" if tiny else "llama3.2-3b", tokenizer="byte", seed=0,
                          checkpoint_path=checkpoint,
                          model_kwargs={} if tiny else {"fused_rmsnorm": True}),
        engine=EngineConfig(max_num_seqs=16, max_seq_len=1024, prefill_buckets=(256, 512, 1024),
                            prefill_chunk=256, decode_steps=DECODE_STEPS,
                            decode_runahead=RUNAHEAD, tensor_parallel_degree=tp,
                            sequence_parallel_degree=sp,
                            dtype="float32" if tiny else dtype,
                            max_loras=2 if adapters else 0, lora_rank=8),
    )


def _adapters(cfg) -> dict:
    """Two seeded adapters {name: weights} of the served model's shapes, on
    the host (chip_smoke.py's lora_serve scale: A N(0, 1) / sqrt(d_model),
    B N(0, 1) x 4 / sqrt(rank))."""
    import torch

    from ray_tpu_torch.llm.config import resolve_llama_config
    from ray_tpu_torch.llm.tokenizer import get_tokenizer
    from ray_tpu_torch.models.llama import init_lora_stack

    ec = cfg.engine
    mcfg = resolve_llama_config(cfg.model, ec,
                                min_vocab=get_tokenizer(cfg.model.tokenizer).vocab_size)
    gen = torch.Generator().manual_seed(9)
    return {name: {k: torch.randn(v.shape[:1] + v.shape[2:], generator=gen)
                   * (mcfg.d_model**-0.5 if k.endswith("_a") else 4 * ec.lora_rank**-0.5)
                   for k, v in init_lora_stack(mcfg, ec.max_loras, ec.lora_rank, "meta").items()}
            for name in ("a", "b")}


def _prompts() -> list:
    """chip_smoke.py's serve prompts: 16 distinct ~100-byte ones."""
    return [(f"Request {i:02d}: " + "write a short note about serving a model on one card. " * 2)
            [:100] for i in range(16)]


def _burst(submit, loras: list) -> tuple:
    """The 16 prompts submitted at once, prompt i on adapter ``loras[i]``:
    (requests, wall s)."""
    t0 = time.perf_counter()
    reqs = [submit(p, a) for p, a in zip(_prompts(), loras)]
    for r in reqs:
        if not r.done.wait(600) or r.error is not None:
            raise RuntimeError(f"a request failed: {r.error!r}")
    return reqs, time.perf_counter() - t0


def _conditioned_checkpoint(cfg, device: str) -> str:
    """``graft_entry.conditioned_params`` (seed 0) of the served model,
    written to a new directory under the temp dir, which is returned."""
    import tempfile

    import torch

    from ray_tpu_torch.graft_entry import conditioned_params
    from ray_tpu_torch.llm.config import resolve_llama_config
    from ray_tpu_torch.llm.tokenizer import get_tokenizer
    from ray_tpu_torch.train.checkpoint import save_state_dict

    mcfg = resolve_llama_config(cfg.model, cfg.engine,
                                min_vocab=get_tokenizer(cfg.model.tokenizer).vocab_size)
    path = tempfile.mkdtemp(prefix="gang_bench_")
    params = conditioned_params(mcfg, seed=0, device=device)
    save_state_dict(params, path)
    del params
    if device == "cuda":
        torch.cuda.empty_cache()
    return path


def _common_prefix(a: list, b: list) -> int:
    n = 0
    while n < min(len(a), len(b)) and a[n] == b[n]:
        n += 1
    return n


def _ms_stats(xs) -> dict:
    import numpy as np

    xs = np.asarray(xs, dtype=float) * 1e3
    return {"p50": float(np.percentile(xs, 50)), "p99": float(np.percentile(xs, 99))}


def main(argv=None) -> None:
    from ray_tpu_torch.llm import SamplingParams

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tp", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--sp-tp", nargs="*", default=[], help="sp,tp pairs, e.g. 2,2")
    ap.add_argument("--model", default="3b", choices=("3b", "tiny"))
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"),
                    help="the 3b model's (tiny is float32)")
    ap.add_argument("--weights", default="seeded", choices=("seeded", "conditioned"),
                    help="init_params' (its wq/wk make the model chaotic: summation order "
                         "changes the tokens) or well-conditioned ones through a checkpoint")
    ap.add_argument("--cpu", action="store_true", help="gloo ranks on the CPU")
    ap.add_argument("--no-engine", action="store_true")
    ap.add_argument("--adapters", action="store_true",
                    help="two adapters loaded, the prompts on none, a, b in turn")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None
    greedy = SamplingParams(max_tokens=64, temperature=0.0, ignore_eos=True)
    runs = [(1, tp) for tp in args.tp] + [tuple(int(v) for v in p.split(",")) for p in args.sp_tp]
    ckpt = None
    if args.weights == "conditioned":
        ckpt = _conditioned_checkpoint(_config(args.model, 1, 1, args.dtype),
                                       "cpu" if args.cpu else "cuda")
    try:
        _run(args, runs, ckpt, device, greedy)
    finally:
        if ckpt is not None:
            shutil.rmtree(ckpt, ignore_errors=True)
    if not args.cpu:
        from ray_tpu_torch.tools.decode_profile import card

        print(card(), flush=True)


def _run(args, runs, ckpt, device, greedy) -> None:
    import numpy as np

    from ray_tpu_torch.llm import TorchEngine
    from ray_tpu_torch.llm.gang import GangLLMServer

    first = None
    adapters = (_adapters(_config(args.model, 1, 1, args.dtype, adapters=True))
                if args.adapters else {})
    loras = [((None, "a", "b")[i % 3] if args.adapters else None) for i in range(16)]
    if not args.no_engine:
        eng = TorchEngine(_config(args.model, 1, 1, args.dtype, ckpt, args.adapters), device)
        try:
            if args.adapters:
                for name, w in adapters.items():
                    eng.add_lora(name, w)
            eng.generate("warm up " * 12, sampling_params=greedy)
            stats0 = eng.get_stats()
            reqs, wall = _burst(lambda p, a: eng.submit(p, sampling_params=greedy, lora=a),
                                loras)
            st = eng.get_stats()
        finally:
            eng.shutdown()
        first = [list(r.out_tokens) for r in reqs]
        # each timed program is decode_steps steps
        timed = st["decode_programs_timed"] - stats0["decode_programs_timed"]
        device_ms = st["decode_device_ms"] - stats0["decode_device_ms"]
        row = {"config": "engine", "ranks": 1, "adapters": args.adapters,
               "out_tok_per_s": 16 * 64 / wall, "wall_s": wall,
               "ttft_ms": _ms_stats([r.first_token_t - r.submitted_t for r in reqs]),
               "decode_step_device_ms": (device_ms / (timed * DECODE_STEPS)
                                         if timed else None)}
        print(json.dumps(row), flush=True)
    for sp, tp in runs:
        cfg = _config(args.model, tp, sp, args.dtype, ckpt, args.adapters)
        t0 = time.perf_counter()
        gang = GangLLMServer(cfg, num_workers=tp * sp, device=device)
        startup = time.perf_counter() - t0
        try:
            if args.adapters:
                for name, w in adapters.items():
                    gang.add_lora(name, w)
            gang.submit("warm up " * 12, greedy).done.wait(600)
            gang.rank_counts(reset=True)
            n_plans = len(gang.plan_times())
            reqs, wall = _burst(lambda p, a: gang.submit(p, greedy, a), loras)
            counts = gang.rank_counts()
            plans = np.asarray(gang.plan_times()[n_plans:])
        finally:
            gang.shutdown()
        prog = counts[0]["programs"]
        tokens = [list(r.out_tokens) for r in reqs]
        if first is None:
            first = tokens
        row = {
            "config": f"sp{sp}-tp{tp}", "ranks": tp * sp, "mesh": gang.gang_info["mesh"],
            "adapters": args.adapters,
            "out_tok_per_s": 16 * 64 / wall, "wall_s": wall,
            "ttft_ms": _ms_stats([r.first_token_t - r.submitted_t for r in reqs]),
            "gang_startup_s": startup, "rank_startup_s": gang.gang_info["rank_startup_s"],
            "plans": len(plans),
            "plan_roundtrip_ms_p50": float(np.percentile(plans[:, 0], 50)),
            "plan_exec_ms_p50": float(np.percentile(plans[:, 1], 50)),
            "decode_step_device_ms": (prog["decode_device_ms"] / prog["decode_steps"]
                                      if prog["decode_programs_timed"] else None),
            "decode_replay_device_ms": (prog["decode_replay_ms"] / prog["decode_steps"]
                                        if prog["decode_programs_timed"] else None),
            "decode_graph_replays": prog["decode_graph_replays"],
            "decode_steps": prog["decode_steps"],
            "rmsnorm_launches_rank0": counts[0]["launches"]["rmsnorm"],
            "greedy_equal_first_config": sum(a == b for a, b in zip(tokens, first)),
            "first_token_equal_first_config": sum(a[0] == b[0] for a, b in zip(tokens, first)),
            "common_prefix_mean": float(np.mean([_common_prefix(a, b)
                                                 for a, b in zip(tokens, first)])),
        }
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
