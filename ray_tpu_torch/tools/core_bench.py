"""The core API on the card: ``init``, ``@remote`` tasks holding half-card
shares of the card ledger, ``ObjectRef``s with ``put``, ``get``, ``wait``
and ``cancel``, through the entry points a user calls.

    python -m ray_tpu_torch.tools.core_bench          # the card: the smoke's core phase
    python -m ray_tpu_torch.tools.core_bench --cpu    # rehearsal on the CPU, a tiny model

``chip_smoke.py``'s core phase runs ``core_part``, which returns one dict
with its measurements, ``ok`` and ``failed_checks``:

1. ``ray_tpu_torch.init(num_cpus=4)`` in process mode.
2. ``put`` of the prompts.
3. Two ``@remote(num_gpus=0.5)`` tasks (``generate_block``) take that ref
   and a block index. Each builds the batch phase's engine
   (``data_bench.card_llm_config()``: llama3.2-3b at full width and depth,
   seeded bf16 weights, the fused RMSNorm, 16 slots, prefix caching off)
   on the half card its worker leases, and generates its block of 16
   prompts, greedy. Each returns the texts, the RMSNorm launches counted
   in its own process since its engine was built, and its engine's
   counters.
4. A ``num_gpus=1`` task queued while the two halves are held, then
   cancelled: ``TaskCancelledError``.
5. ``wait(num_returns=1)``, then both refs; a CPU task chained on the two
   refs counts their tokens.
6. A ``max_retries=1`` CPU task ``os._exit(1)``s on its first attempt and
   returns on its second.
7. A raising task: ``TaskError`` that is also its cause.
8. A warm CPU task's round trip (median of 20) and a 4 MiB array's
   ``put`` and ``get``.
9. ``shutdown()``: no lease on the ledger, no worker process alive (the
   card workers ended with their tasks, the CPU workers at ``shutdown``),
   no segment of this driver under ``/dev/shm``.

Limits: every text equal to the expected one for its prompt, in order;
each worker's RMSNorm launches equal to what its engine's counters give
(2L+1 a decode step and a final prefill chunk, 2L a mid chunk); every
decode step a graph replay; the chained count equal to the tokens
generated. On the CPU (``--cpu``) the card is a fake one of a ledger of
its own, the model tiny and the launches 0; nothing there is a device
number.
"""

from __future__ import annotations

import json
import os
import statistics
import tempfile
import time

import numpy as np

import ray_tpu_torch as rt
from ray_tpu_torch._private import object_store, worker
from ray_tpu_torch._private.cards import default_ledger
from ray_tpu_torch._private.session import _alive
from ray_tpu_torch._private.task_worker import LEASE_NAME

BLOCK = 16
SHARE = 0.5
ROUND_TRIPS = 20
ARRAY_FLOATS = 1 << 20  # 4 MiB of float32
CANCEL_WAIT_S = 1.0
LEASES = LEASE_NAME + "s"  # what the task workers' card leases are named after


def generate_block(llm_config, prompts: list, block: int, sampling: dict, device=None) -> dict:
    """A card-share task: the batch phase's engine in this worker (built at
    its first task), over block ``block`` of ``prompts``."""
    import torch

    from ray_tpu_torch.llm import batch
    from ray_tpu_torch.llm.batch import _sampling
    from ray_tpu_torch.ops import launch_counts

    entered = time.time()
    eng = batch._get_engine(llm_config, device)
    built = batch._ENGINE_BUILT[batch._engine_key(llm_config, device)]
    rows = prompts[block * BLOCK:(block + 1) * BLOCK]
    start = time.time()
    reqs = [eng.submit(p, sampling_params=_sampling(sampling)) for p in rows]
    texts, tokens = [], []
    for r in reqs:
        eng._await_done(r)
        if r.error is not None:
            raise r.error
        texts.append(eng.tokenizer.decode(r.out_tokens))
        tokens.append(len(r.out_tokens))
    end = time.time()
    now = launch_counts()
    return {"block": block, "pid": os.getpid(), "entered_at": entered, "gen_start": start,
            "gen_end": end, "engine_build_s": built["seconds"], "texts": texts,
            "tokens": tokens, "stats": eng.get_stats(), "n_layers": eng.model_cfg.n_layers,
            "launches_since_build": {k: now[k] - built["launches"][k] for k in now},
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "task_name": rt.get_runtime_context().get_task_name(),
            "peak_memory_gb": (torch.cuda.max_memory_allocated() / 1e9
                               if torch.cuda.is_available() else 0.0)}


def count_tokens(a: dict, b: dict) -> int:
    return sum(a["tokens"]) + sum(b["tokens"])


def whole_card() -> str:
    return os.environ.get("CUDA_VISIBLE_DEVICES", "")


def die_once(marker_dir: str) -> int:
    """Kills its worker on the first attempt; returns the attempt count."""
    marker = os.path.join(marker_dir, "attempts")
    with open(marker, "a") as f:
        f.write("x")
    with open(marker) as f:
        attempts = len(f.read())
    if attempts == 1:
        os._exit(1)
    return attempts


def raises() -> None:
    raise ValueError("core phase: raised on purpose")


def echo(x):
    return x


def core_part(llm_config, prompts: list, sampling: dict, want: list, device=None) -> dict:
    """The core slice over ``prompts``; ``want``: each prompt's expected
    text."""
    cpu = device == "cpu"
    ledger = default_ledger()
    blocks = (len(prompts) + BLOCK - 1) // BLOCK
    bad = []
    t0 = time.perf_counter()
    rt.init(num_cpus=4)
    init_s = time.perf_counter() - t0
    driver_pid = os.getpid()
    pids: list = []
    try:
        prompts_ref = rt.put(prompts)
        gen = rt.remote(num_gpus=SHARE)(generate_block)
        t_submit = time.time()
        refs = [gen.remote(llm_config, prompts_ref, b, sampling, device) for b in range(blocks)]
        # a whole card while the halves are held: queued, then cancelled
        blocker = rt.remote(num_gpus=1)(whole_card).remote()
        queued, _ = rt.wait([blocker], timeout=CANCEL_WAIT_S)
        halves = [h for h in ledger.holders() if h.name.endswith(LEASES)]
        rt.cancel(blocker)
        try:
            rt.get(blocker, timeout=30)
            cancelled = "returned"
        except rt.TaskCancelledError:
            cancelled = "TaskCancelledError"
        first, rest = rt.wait(refs, num_returns=1)
        results = rt.get(refs, timeout=900)
        done_t = time.time()
        chained = rt.get(rt.remote(count_tokens).remote(refs[0], refs[1]), timeout=120)
        with tempfile.TemporaryDirectory() as d:
            retried = rt.get(rt.remote(max_retries=1)(die_once).remote(d), timeout=120)
        try:
            rt.get(rt.remote(raises).remote(), timeout=120)
            raised = None
        except rt.TaskError as e:
            raised = {"task_error": True, "is_cause_type": isinstance(e, ValueError),
                      "cause": repr(e.cause)}
        # a warm CPU task's round trip, and a 4 MiB array through put / get
        for i in range(3):
            rt.get(rt.remote(echo).remote(i))
        trips = []
        for i in range(ROUND_TRIPS):
            t = time.perf_counter()
            rt.get(rt.remote(echo).remote(i))
            trips.append((time.perf_counter() - t) * 1e3)
        arr = np.random.default_rng(0).standard_normal(ARRAY_FLOATS).astype(np.float32)
        put_ms, get_ms, equal = [], [], True
        for _ in range(5):
            t = time.perf_counter()
            ref = rt.put(arr)
            put_ms.append((time.perf_counter() - t) * 1e3)
            t = time.perf_counter()
            back = rt.get(ref)
            get_ms.append((time.perf_counter() - t) * 1e3)
            equal &= bool(np.array_equal(back, arr))
            wire_kind = worker.driver().store.read(ref.hex())[1][0]
            del ref
        # the card workers ended with their tasks; the CPU workers idle
        pids = worker.driver().pool.pids() + [r["pid"] for r in results]
    finally:
        t_down = time.perf_counter()
        rt.shutdown()
        shutdown_s = time.perf_counter() - t_down
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and (any(_alive(p) for p in pids) or any(
            h.pid in pids for h in ledger.holders())):
        time.sleep(0.02)
    alive_after = [p for p in pids if _alive(p)]
    leases_after = [str(h) for h in ledger.holders()
                    if h.pid in pids or h.pid == driver_pid or h.name.endswith(LEASES)]
    segments_after = object_store.driver_segments(driver_pid)

    texts = [t for r in sorted(results, key=lambda r: r["block"]) for t in r["texts"]]
    n_out = sum(sum(r["tokens"]) for r in results)
    per_worker = []
    for r in sorted(results, key=lambda r: r["block"]):
        st, n_norms = r["stats"], 2 * r["n_layers"] + 1
        expected = (n_norms * (st["decode_steps"] + st["prefill_final_chunks"])
                    + (n_norms - 1) * st["prefill_mid_chunks"])
        per_worker.append({
            "block": r["block"], "pid": r["pid"], "visible": r["visible"],
            "startup_s": r["entered_at"] - t_submit, "engine_build_s": r["engine_build_s"],
            "gen_s": r["gen_end"] - r["gen_start"], "peak_memory_gb": r["peak_memory_gb"],
            "generated": sum(r["tokens"]), "task_name": r["task_name"],
            "rmsnorm_launches": r["launches_since_build"]["rmsnorm"],
            "rmsnorm_launches_expected": expected,
            **{k: st[k] for k in ("decode_steps", "decode_graph_replays", "prefill_mid_chunks",
                                  "prefill_final_chunks")}})
    gen_span = max(r["gen_end"] for r in results) - min(r["gen_start"] for r in results)
    out = {
        "part": "core", "device": device or "cuda", "rows": len(prompts), "blocks": blocks,
        "init_s": init_s, "submit_to_done_s": done_t - t_submit,
        "texts_equal": sum(t == w for t, w in zip(texts, want)),
        "out_tok_per_s": n_out / gen_span, "tokens_generated": n_out, "chained_count": chained,
        "first_ready": len(first) == 1 and len(rest) == blocks - 1,
        "cancel_queued": not queued, "cancelled": cancelled,
        "halves_held": [str(h) for h in halves], "retried": retried, "raised": raised,
        "round_trip_ms_median": statistics.median(trips), "round_trip_ms_max": max(trips),
        "put_4mib_ms_median": statistics.median(put_ms),
        "get_4mib_ms_median": statistics.median(get_ms), "array_equal": equal,
        "array_wire": wire_kind, "shutdown_s": shutdown_s, "worker_pids": pids,
        "alive_after": alive_after, "leases_after": leases_after,
        "segments_after": segments_after, "workers": per_worker,
        "launches": {"rmsnorm": sum(w["rmsnorm_launches"] for w in per_worker)},
    }
    if out["texts_equal"] != len(prompts) or len(texts) != len(prompts):
        bad.append(f"{len(prompts) - out['texts_equal']} texts differ")
    if n_out != len(prompts) * sampling["max_tokens"] or chained != n_out:
        bad.append(f"chained count {chained}, tokens generated {n_out}, want "
                   f"{len(prompts) * sampling['max_tokens']}")
    if not out["cancel_queued"] or cancelled != "TaskCancelledError":
        bad.append(f"the whole-card task was not queued behind the halves, or its cancel "
                   f"gave {cancelled}")
    if len(halves) != blocks or any(h.gpu != {ledger.card_ids()[0]: SHARE} for h in halves):
        bad.append(f"the halves held: {out['halves_held']}")
    if not out["first_ready"]:
        bad.append(f"wait(num_returns=1) gave {len(first)} ready and {len(rest)} not")
    if retried != 2:
        bad.append(f"the retried task returned after {retried} attempts, not 2")
    if not raised or not raised["is_cause_type"]:
        bad.append(f"the raising task gave {raised}")
    if not equal or wire_kind != "shm":
        bad.append(f"the 4 MiB array: equal {equal}, wire {wire_kind}")
    for w in per_worker:
        if w["rmsnorm_launches"] != (0 if cpu else w["rmsnorm_launches_expected"]):
            bad.append(f"worker {w['pid']}: rmsnorm launches {w['rmsnorm_launches']} != "
                       f"{w['rmsnorm_launches_expected']}")
        if not cpu and w["decode_graph_replays"] != w["decode_steps"]:
            bad.append(f"worker {w['pid']}: a decode step was no graph replay")
        if w["task_name"] != "generate_block":
            bad.append(f"worker {w['pid']}: task name {w['task_name']}")
    if len({w["pid"] for w in per_worker}) != blocks:
        bad.append("the two halves did not run in two workers")
    if alive_after or leases_after or segments_after:
        bad.append(f"left after shutdown: processes {alive_after}, leases {leases_after}, "
                   f"segments {segments_after}")
    out["ok"] = not bad
    out["failed_checks"] = bad
    return out


def main(argv=None) -> int:
    import argparse

    from ray_tpu_torch._private.cards import CardLedger, use_ledger
    from ray_tpu_torch.tools.util_bench import expected_texts, rehearsal_config

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="a fake card of a ledger of its own, "
                                                       "a tiny model")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None
    llm, sampling, prompts, smi = rehearsal_config(args.cpu)
    want = expected_texts(llm, prompts, sampling, device)
    if args.cpu:
        with tempfile.TemporaryDirectory() as d, use_ledger(CardLedger(d, cards=["0"], cpus=8)):
            out = core_part(llm, prompts, sampling, want, device=device)
    else:
        import torch

        torch.cuda.empty_cache()  # this process holds no model while the workers run
        out = core_part(llm, prompts, sampling, want, device=device)
    print(json.dumps({**out, "card": smi}, default=str), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
