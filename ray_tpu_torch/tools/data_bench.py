"""Data on the card: batch inference on two actor processes that lease half
of the card each, and Train ingest of a port Dataset, through the entry
points a user calls.

    python -m ray_tpu_torch.tools.data_bench          # the card: the smoke's data parts
    python -m ray_tpu_torch.tools.data_bench --cpu    # rehearsal on the CPU, tiny models

``chip_smoke.py``'s data phase runs both parts; each returns one dict with
its measurements, ``ok`` and ``failed_checks``:

- ``batch_actors``: ``build_llm_processor(ProcessorConfig(...,
  batch_size=16, concurrency=2))(data.from_items(rows, parallelism=2))``:
  an ``ActorPoolStrategy(size=2)`` stage whose actors each lease half of
  the card from the host's ledger and build one engine. Limits: each row's
  text equal to the expected text for its prompt, in input order; in each
  actor, every decode step a graph replay and the RMSNorm launches since
  its engine was built (counted in its own process) equal to what its
  engine's counters give (2L+1 a step and a final prefill chunk, 2L a mid
  chunk); two half-card leases held while the stage runs, none after.
  Reported: rows/s and output tok/s (over the stage, and after both
  engines were built), each actor's start-up (spawn to its transform
  chain built), engine build and peak memory.
- ``train_ingest``: ``TorchTrainer`` with one rank running
  ``examples/train_llama_dp.py``'s loop (through ``tune_bench``'s
  ``loss_history_loop``) at the bench widths cut to ``tune_bench.DEPTH``
  layers, ``datasets={"train": ds}`` with ``ds`` a port Dataset of seeded
  token rows, which the rank reads through ``get_dataset_shard`` and
  ``iter_device_batches``. Limits: each step's loss equal (bit for bit) to
  the same steps run in this process on the same rows; the attention
  launches in the rank 2L / L / L a step; no lease after.

On the CPU (``--cpu``) the model is tiny, the actors lease nothing and the
rank is a gloo CPU rank; nothing there is a device number.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import numpy as np

from ray_tpu_torch import data
from ray_tpu_torch._private.cards import default_ledger
from ray_tpu_torch._private.process_actor import get
from ray_tpu_torch.data.execution import StreamingExecutor, _resolve
from ray_tpu_torch.tools.tune_bench import ATTENTION, DEPTH, LedgerWatch, loss_history_loop

INGEST_STEPS = 3
ACTORS = 2


def actor_report(llm_config, device) -> dict:
    """In a processor actor's process: its engine's counters, the kernel
    launches since the engine was built, the build's seconds, the peak
    device memory."""
    import torch

    from ray_tpu_torch.llm import batch
    from ray_tpu_torch.ops import launch_counts

    key = batch._engine_key(llm_config, device)
    built = batch._ENGINE_BUILT[key]
    now = launch_counts()
    eng = batch._ENGINE_CACHE[key]
    return {"pid": os.getpid(), "engines": len(batch._ENGINE_CACHE),
            "n_layers": eng.model_cfg.n_layers, "stats": eng.get_stats(),
            "engine_build_s": built["seconds"],
            "launches_since_build": {k: now[k] - built["launches"][k] for k in now},
            "peak_memory_gb": (torch.cuda.max_memory_allocated() / 1e9
                               if torch.cuda.is_available() else 0.0)}


def batch_actors(llm_config, prompts: list, sampling: dict, want: list,
                 device=None) -> dict:
    """The processor over ``prompts`` on two actors; ``want``: each
    prompt's expected text."""
    from ray_tpu_torch.llm import ProcessorConfig, build_llm_processor

    proc = build_llm_processor(ProcessorConfig(llm_config=llm_config, batch_size=16,
                                               sampling_params=sampling, concurrency=ACTORS,
                                               device=device))
    ds = data.from_items([{"prompt": p, "row": i} for i, p in enumerate(prompts)],
                         parallelism=2)
    ex, blocks = StreamingExecutor(), []
    ledger = default_ledger()
    with LedgerWatch(ledger) as watch:
        t0 = time.time()
        for item in ex.execute(proc(ds)._plan):
            blocks.append(_resolve(item))
            if sum(len(b["row"]) for b in blocks) == len(prompts):
                t_end = time.time()
                pool, = ex.actor_pools  # still alive: read each actor's process
                infos = get([a.call("info") for a in pool.actors])
                reports = get([a.call(actor_report, llm_config, device) for a in pool.actors])
                spawned = list(pool.spawned_at)
    holders_after = [str(h) for h in ledger.holders()]
    rows = [{k: b[k][i] for k in b} for b in blocks for i in range(len(b["row"]))]
    texts = [str(r["generated_text"]) for r in rows]
    actors = []
    for info, rep, t_spawn in zip(infos, reports, spawned):
        st, n_norms = rep["stats"], 2 * rep["n_layers"] + 1
        expected = (n_norms * (st["decode_steps"] + st["prefill_final_chunks"])
                    + (n_norms - 1) * st["prefill_mid_chunks"])
        actors.append({
            "pid": info["pid"], "startup_s": info["built_at"] - t_spawn,
            "engine_build_s": rep["engine_build_s"],
            "ready_at_s": info["built_at"] - t0 + rep["engine_build_s"],
            "peak_memory_gb": rep["peak_memory_gb"], "engines": rep["engines"],
            "rmsnorm_launches": rep["launches_since_build"]["rmsnorm"],
            "rmsnorm_launches_expected": expected,
            **{k: st[k] for k in ("decode_programs", "decode_steps", "decode_graph_replays",
                                  "prefill_mid_chunks", "prefill_final_chunks")}})
    wall = t_end - t0
    after_build = t_end - t0 - max(a["ready_at_s"] for a in actors)
    out_tokens = len(prompts) * sampling["max_tokens"]
    share = None if device == "cpu" else 1.0 / ACTORS
    out = {
        "part": "batch_actors", "device": device or "cuda", "rows": len(rows),
        "blocks": len(blocks), "block_rows": [len(b["row"]) for b in blocks],
        "texts_equal": sum(t == w for t, w in zip(texts, want)),
        "in_order": [int(r["row"]) for r in rows] == list(range(len(prompts))),
        "wall_s": wall, "rows_per_s": len(rows) / wall, "out_tok_per_s": out_tokens / wall,
        "after_build_s": after_build,
        "rows_per_s_after_build": len(rows) / after_build if after_build > 0 else None,
        "out_tok_per_s_after_build": out_tokens / after_build if after_build > 0 else None,
        "actors": actors, "most_actor_leases_held": watch.most(f"{ACTORS} data actors"),
        "actor_holdings": watch.held(f"{ACTORS} data actors"), "holders_after": holders_after,
        "launches": {"rmsnorm": sum(a["rmsnorm_launches"] for a in actors)},
    }
    bad = []
    if out["texts_equal"] != len(prompts) or len(texts) != len(prompts) or not out["in_order"]:
        bad.append(f"{len(prompts) - out['texts_equal']} texts differ, or rows out of order")
    if len({a["pid"] for a in actors}) != ACTORS or any(a["engines"] != 1 for a in actors):
        bad.append(f"not {ACTORS} actors of one engine each: {actors}")
    for a in actors:
        if a["decode_graph_replays"] != a["decode_steps"] and device != "cpu":
            bad.append(f"actor {a['pid']}: a decode step was no graph replay")
        if a["rmsnorm_launches"] != (0 if device == "cpu" else a["rmsnorm_launches_expected"]):
            bad.append(f"actor {a['pid']}: rmsnorm launches {a['rmsnorm_launches']} != "
                       f"{a['rmsnorm_launches_expected']}")
    if share is not None and (out["most_actor_leases_held"] != ACTORS or any(
            list(json.loads(g).values()) != [share] for g, _ in out["actor_holdings"])):
        bad.append(f"not {ACTORS} leases of {share} card held: {out['actor_holdings']}")
    if holders_after:
        bad.append(f"leases left: {holders_after}")
    out["ok"] = not bad
    out["failed_checks"] = bad
    return out


def _ingest_config(device: str) -> dict:
    config = {"steps": INGEST_STEPS, "batch": 4, "seed": 0,
              "optimizer": {"learning_rate": 1e-3, "warmup_steps": 1,
                            "total_steps": INGEST_STEPS}}
    if device == "cpu":
        return {**config, "model": "tiny", "seq_len": 16}
    return {**config, "model": "bench", "model_kwargs": {"n_layers": DEPTH}, "seq_len": 2048}


def train_ingest(device: str = "cuda") -> dict:
    """A one-rank TorchTrainer fed a port Dataset, against the same steps
    in this process."""
    import torch

    from ray_tpu_torch.examples import train_llama_dp as ex
    from ray_tpu_torch.models.training import default_optimizer, make_train_step
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    config = _ingest_config(device)
    cfg = ex.model_config(config)
    rng = np.random.default_rng(config["seed"])
    toks = rng.integers(0, cfg.vocab_size, (INGEST_STEPS * config["batch"], config["seq_len"] + 1),
                        dtype=np.int32)
    ds = data.from_items([{"tokens": t} for t in toks], parallelism=2)
    t0 = time.perf_counter()
    ds.streaming_split(1, equal=True)  # what fit() hands the rank, timed alone
    split_s = time.perf_counter() - t0
    scaling = ScalingConfig(num_workers=1, use_gpu=device != "cpu")
    ledger = default_ledger()
    with tempfile.TemporaryDirectory(prefix="ingest-") as storage:
        trainer = TorchTrainer(loss_history_loop, train_loop_config=config,
                               scaling_config=scaling, datasets={"train": ds},
                               run_config=RunConfig(name="ingest", storage_path=storage))
        t0 = time.perf_counter()
        result = trainer.fit()
        fit_s = time.perf_counter() - t0
    holders_after = [str(h) for h in ledger.holders()]
    # the same steps here, on the same rows, read through the same iterator
    optimizer = default_optimizer(**config["optimizer"])
    init_fn, step_fn = make_train_step(cfg, optimizer, device=device)
    state, driver = init_fn(config["seed"]), []
    for batch in ds.iter_device_batches(batch_size=config["batch"], device=device):
        state, m = step_fn(state, batch)
        driver.append(m["loss"].item())
    del state
    if device != "cpu":
        torch.cuda.empty_cache()
    hist = result.metrics_history
    losses = [m["loss"] for m in hist]
    L = cfg.n_layers
    per_step = [[m["launches"][k] for k in ATTENTION] for m in hist]
    out = {
        "part": "train_ingest", "device": device, "layers": L, "error": result.error,
        "rows": len(toks), "tokens_per_row": config["seq_len"] + 1, "fit_s": fit_s,
        "split_s": split_s, "rank_startup_s": trainer._controller.rank_startup_s,
        "losses": losses, "driver_losses": driver,
        "losses_equal": losses == driver,
        "max_rel_diff": (max(abs(a - b) / abs(b) for a, b in zip(losses, driver))
                         if losses and len(losses) == len(driver) else None),
        "step_ms": [m["step_ms"] for m in hist],
        "peak_memory_gb": max((m["peak_memory_gb"] for m in hist), default=None),
        "launches": {k: sum(s[i] for s in per_step) for i, k in enumerate(ATTENTION)},
        "steps": len(hist), "holders_after": holders_after,
    }
    bad = []
    if result.error:
        bad.append(f"the fit failed: {result.error}")
    if len(losses) != INGEST_STEPS or not out["losses_equal"]:
        bad.append(f"the rank's losses {losses} != the driver's {driver}")
    want = [0, 0, 0] if device == "cpu" else [2 * L, L, L]
    if any(s != want for s in per_step):
        bad.append(f"attention launches {per_step} != {want} a step")
    if holders_after:
        bad.append(f"leases left: {holders_after}")
    out["ok"] = not bad
    out["failed_checks"] = bad
    return out


def card_llm_config():
    """The smoke's batch phase's engine: llama3.2-3b at full width and
    depth, seeded bf16 weights, the fused RMSNorm, 16 slots x 1024, prefix
    caching off."""
    from ray_tpu_torch.llm import EngineConfig, LLMConfig, ModelConfig

    return LLMConfig(
        model=ModelConfig(model_id="llama3.2-3b", tokenizer="byte", seed=0,
                          model_kwargs={"fused_rmsnorm": True}),
        engine=EngineConfig(max_num_seqs=16, max_seq_len=1024,
                            prefill_buckets=(32, 64, 128, 256, 512, 1024), prefill_chunk=256,
                            decode_steps=8, decode_runahead=1, enable_prefix_caching=False))


def main(argv=None) -> int:
    import argparse

    from ray_tpu_torch.llm import EngineConfig, LLMConfig, ModelConfig
    from ray_tpu_torch.llm import ProcessorConfig, build_llm_processor
    from ray_tpu_torch.tools.decode_profile import card

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="CPU actors and rank, tiny models")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None
    smi = "cpu (rehearsal)" if args.cpu else card()
    if args.cpu:
        llm = LLMConfig(model=ModelConfig(model_id="tiny", tokenizer="byte", seed=0),
                        engine=EngineConfig(max_num_seqs=16, max_seq_len=128,
                                            prefill_buckets=(32, 64, 128), dtype="float32"))
    else:
        llm = card_llm_config()
    sampling = {"max_tokens": 32 if not args.cpu else 4, "temperature": 0.0, "ignore_eos": True}
    prompts = [f"Row {i:02d}: summarise offline batch inference on a card." for i in range(32)]
    # the expected texts: the same processor on one engine in this process
    want = [str(r["generated_text"]) for r in build_llm_processor(ProcessorConfig(
        llm_config=llm, batch_size=16, sampling_params=sampling, concurrency=0, device=device))(
        data.from_items([{"prompt": p} for p in prompts], parallelism=2)).take_all()]
    from ray_tpu_torch.llm import batch

    for eng in batch._ENGINE_CACHE.values():
        eng.shutdown()
    batch._ENGINE_CACHE.clear()
    ok = True
    for part in (batch_actors(llm, prompts, sampling, want, device=device),
                 train_ingest("cpu" if args.cpu else "cuda")):
        print(json.dumps({**part, "card": smi}, default=str), flush=True)
        ok &= part["ok"]
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
