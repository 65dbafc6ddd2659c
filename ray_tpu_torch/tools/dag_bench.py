"""Compiled DAGs on the card: two llama3.2-3b engine actors in a two-stage
graph, run eagerly and compiled over shared-memory channels, read back
through the dashboard, with an ``internal_kv`` counter kept from inside
the first stage's actor.

    python -m ray_tpu_torch.tools.dag_bench          # the card: the smoke's dag phase
    python -m ray_tpu_torch.tools.dag_bench --cpu    # rehearsal on the CPU, a tiny model

``chip_smoke.py``'s dag phase runs ``dag_actors``, which returns one dict
with its measurements, ``ok`` and ``failed_checks``:

1. Two ``ProcessActor(StageActor)`` (``util_bench.EngineActor``, whose
   ``generate`` also counts its rows in ``internal_kv`` when given a key),
   each on a half-card lease from ``spawn_env.assign_cards``, each
   building the batch phase's engine (``data_bench.card_llm_config()``:
   llama3.2-3b at full width and depth, seeded bf16 weights, the fused
   RMSNorm, every decode step a graph replay); and two CPU actors
   (``lease=None``) of ``Relay``, whose ``relay`` returns its argument.
2. The graph ``x = a.bind("generate", inp, sampling, kv_key=KEY)``,
   ``MultiOutputNode([x, b.bind("generate", x, sampling)])``: stage 2
   continues from stage 1's texts. After a warm-up block through each
   engine, the prompts go in blocks of 16, both blocks submitted before
   either is read, in four runs: eager (``dag.execute``), compiled
   (``dag.experimental_compile()``) twice, eager.
3. One block straight to ``a`` with both compiled loops idle, then one
   after ``teardown``, ``IDLE_TURNS`` times in turns (compiling anew for
   each idle turn): the idle loop's cost in tok/s.
4. The CPU chain ``r2.relay(r1.relay(inp))`` in four turns of
   ``ROUND_TRIPS`` (eager, compiled, compiled, eager): each turn's median
   and 90th percentile µs per ``execute`` and ``get``, beside the host's
   load average and the driver's threads at the time.
5. While the engines and the compiled DAG are alive:
   ``start_dashboard(port=0)`` read over HTTP (``/api/actors``,
   ``/api/stacks``, ``/api/logs``, ``/metrics``), and the KV counter read
   back in the driver.

Limits: stage 1's texts equal the expected ones for their prompts in
every run; stage 2's texts in every run equal the first eager run's; in each engine
actor every decode step a graph replay and its RMSNorm launches since its
engine was built equal what its engine's counters give; ``/api/actors``
shows both engines ``ALIVE`` with their card; ``/api/stacks`` shows the
``dag-loop`` thread in each engine's process; ``/api/logs`` has one entry
for each of the four actors; ``/metrics`` is non-empty; the KV counter
equals the rows stage 1 ran; after ``teardown`` both engines answer a
normal call and none of the DAG's channel files is left under
``/dev/shm``; after the kill no lease is left. On the CPU (``--cpu``) the
model is tiny and the actors lease nothing; nothing there is a device
number.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.request

from ray_tpu_torch._private.cards import default_ledger
from ray_tpu_torch._private.process_actor import ProcessActor, get, start_all
from ray_tpu_torch._private.spawn_env import assign_cards
from ray_tpu_torch.dag import InputNode, MultiOutputNode
from ray_tpu_torch.dashboard import start_dashboard, stop_dashboard
from ray_tpu_torch.experimental import internal_kv
from ray_tpu_torch.experimental.channel import channel_files
from ray_tpu_torch.tools.util_bench import EngineActor

BLOCK = 16
KV_NAMESPACE = "dag_bench"
KV_KEY = "stage1_rows"
ROUND_TRIPS = 100
IDLE_TURNS = 3  # blocks with the loops idle, and as many without, in turns


class StageActor(EngineActor):
    """An engine actor whose ``generate`` also adds its rows to an
    ``internal_kv`` counter in the driver when given ``kv_key``."""

    def generate(self, prompts: list, sampling: dict, kv_key=None) -> list:
        texts = super().generate(prompts, sampling)
        if kv_key is not None:
            n = int(internal_kv.kv_get(kv_key, namespace=KV_NAMESPACE) or b"0")
            internal_kv.kv_put(kv_key, str(n + len(texts)).encode(), namespace=KV_NAMESPACE)
        return texts


class Relay:
    """A CPU actor whose method returns its argument: the channel's round
    trip with nothing else in it."""

    def relay(self, x):
        return x


def _http(base: str, path: str):
    with urllib.request.urlopen(base + path, timeout=60) as r:
        body = r.read().decode()
    return body if path == "/metrics" else json.loads(body)


def _run_blocks(dag, blocks: list) -> tuple[list, list, float]:
    """Both blocks submitted, then read: (stage 1 texts, stage 2 texts,
    seconds)."""
    t0 = time.perf_counter()
    refs = [dag.execute(block) for block in blocks]
    outs = [get(r, timeout=600) for r in refs]
    wall = time.perf_counter() - t0
    return ([t for o in outs for t in o[0]], [t for o in outs for t in o[1]], wall)


def _direct_block(actor, block: list, sampling: dict) -> float:
    """One block sent to ``actor`` as a normal call: its output tok/s."""
    t0 = time.perf_counter()
    get(actor.call("generate", block, sampling), timeout=600)
    return len(block) * sampling["max_tokens"] / (time.perf_counter() - t0)


def _round_trips_us(run, n: int) -> dict:
    """The median and 90th percentile of ``n`` timed ``run(i)``, in µs."""
    run(0)  # warm
    times = []
    for i in range(n):
        t0 = time.perf_counter()
        run(i)
        times.append((time.perf_counter() - t0) * 1e6)
    times.sort()
    return {"median": times[n // 2], "p90": times[n * 9 // 10]}


def dag_actors(llm_config, prompts: list, sampling: dict, want: list, device=None) -> dict:
    """The dag slice over ``prompts``; ``want``: each prompt's expected
    text."""
    ledger = default_ledger()
    cpu = device == "cpu"
    blocks = [prompts[i:i + BLOCK] for i in range(0, len(prompts), BLOCK)]
    files_before = set(channel_files())
    bad, engines, relays, compiled, port = [], [], [], None, None
    internal_kv.kv_del(KV_KEY, namespace=KV_NAMESPACE)
    try:
        leases = [None, None] if cpu else assign_cards(2, 0.5, "dag engine actors")
        t_spawn = time.time()
        engines = [ProcessActor(StageActor, (llm_config, device), lease=lease,
                                name=f"dag-engine-{i}") for i, lease in enumerate(leases)]
        relays = [ProcessActor(Relay, name=f"dag-relay-{i}") for i in range(2)]
        start_all(engines + relays)
        t_ready = time.time()
        a, b = engines
        with InputNode() as inp:
            x = a.bind("generate", inp, sampling, kv_key=KV_KEY)
            dag = MultiOutputNode([x, b.bind("generate", x, sampling)])
        # a warm-up block through each engine, then eager, compiled,
        # compiled, eager (the first run after a build pays for first uses)
        get([a.call("generate", blocks[0], sampling), b.call("generate", blocks[0], sampling)],
            timeout=600)
        eager = [_run_blocks(dag, blocks)]
        t_compile = time.perf_counter()
        compiled = dag.experimental_compile()
        compile_s = time.perf_counter() - t_compile
        runs = [_run_blocks(compiled, blocks) for _ in range(2)]
        eager.append(_run_blocks(dag, blocks))
        dag_files = sorted(set(channel_files()) - files_before)
        idle_loop = [_direct_block(a, blocks[0], sampling)]
        # the dashboard and the KV counter while the engines and loops live
        port = start_dashboard(port=0)
        base = f"http://127.0.0.1:{port}"
        listed = {r["actor_id"]: r for r in _http(base, "/api/actors")}
        stacks = _http(base, "/api/stacks")
        logs = _http(base, "/api/logs")
        metrics_text = _http(base, "/metrics")
        kv_rows = (internal_kv.kv_get(KV_KEY, namespace=KV_NAMESPACE) or b"").decode()
        compiled.teardown()
        no_loop = [_direct_block(a, blocks[0], sampling)]
        for _ in range(IDLE_TURNS - 1):  # the loops idle, then gone, in turns
            again = dag.experimental_compile()
            try:
                idle_loop.append(_direct_block(a, blocks[0], sampling))
            finally:
                again.teardown()
            no_loop.append(_direct_block(a, blocks[0], sampling))
        reports = get([e.call("report") for e in engines])  # a normal call after teardown
        files_left = sorted(set(dag_files) & set(channel_files()))
        # the channel's round trip against the eager call's, on the CPU chain
        r1, r2 = relays
        with InputNode() as inp:
            chain = r2.bind("relay", r1.bind("relay", inp))
        load = os.getloadavg()
        threads = sorted(t.name for t in threading.enumerate())
        turns = [_round_trips_us(lambda i: get(chain.execute(i)), ROUND_TRIPS)]
        cchain = chain.experimental_compile()
        try:
            chain_ok = [get(cchain.execute(i)) for i in range(3)] == [0, 1, 2]
            turns += [_round_trips_us(lambda i: get(cchain.execute(i)), ROUND_TRIPS)
                      for _ in range(2)]
            turns.append(_round_trips_us(lambda i: get(chain.execute(i)), ROUND_TRIPS))
        finally:
            cchain.teardown()
    finally:
        if compiled is not None:
            compiled.teardown()
        if port is not None:
            stop_dashboard()
        for actor in engines + relays:
            actor.kill()
    holders_after = [str(h) for h in ledger.holders()]

    per_actor = []
    for actor, rep in zip(engines, reports):
        st, n_norms = rep["stats"], 2 * rep["n_layers"] + 1
        expected = (n_norms * (st["decode_steps"] + st["prefill_final_chunks"])
                    + (n_norms - 1) * st["prefill_mid_chunks"])
        row = listed.get(actor.actor_id, {})
        per_actor.append({
            "pid": rep["pid"], "startup_s": rep["entered_at"] - t_spawn,
            "engine_build_s": rep["engine_build_s"], "peak_memory_gb": rep["peak_memory_gb"],
            "visible": rep["visible"], "listed_state": row.get("state"),
            "listed_cards": row.get("cards"), "generated": rep["generated"],
            "rmsnorm_launches": rep["launches_since_build"]["rmsnorm"],
            "rmsnorm_launches_expected": expected,
            "loop_in_stacks": "thread dag-loop" in stacks.get(actor.actor_id, ""),
            **{k: st[k] for k in ("decode_steps", "decode_graph_replays",
                                  "prefill_mid_chunks", "prefill_final_chunks")}})
    log_ids = [r["worker_id"] for r in logs]
    mine = [x.actor_id for x in engines + relays]
    n_tok = 2 * len(prompts) * sampling["max_tokens"]
    stage2 = eager[0][1]

    def equal(run_list, i, ref):
        return [sum(t == w for t, w in zip(r[i], ref)) for r in run_list]

    out = {
        "part": "dag_actors", "device": device or "cuda", "rows": len(prompts),
        "blocks": len(blocks), "runs": "eager, compiled, compiled, eager",
        "stage1_equal_eager": equal(eager, 0, want), "stage1_equal_compiled": equal(runs, 0, want),
        "stage2_equal_first_eager": equal(eager[1:] + runs, 1, stage2),
        "stage2_rows": [len(r[1]) for r in eager + runs],
        "eager_s": [r[2] for r in eager], "compiled_s": [r[2] for r in runs],
        "compile_s": compile_s,
        "eager_out_tok_per_s": [n_tok / r[2] for r in eager],
        "compiled_out_tok_per_s": [n_tok / r[2] for r in runs],
        "idle_loop_tok_per_s": idle_loop, "no_loop_tok_per_s": no_loop,
        "idle_loop_cost": 1.0 - (sum(idle_loop) / sum(no_loop)),
        "chain_eager_us": [turns[0], turns[3]], "chain_compiled_us": turns[1:3],
        "chain_ok": chain_ok, "host_loadavg": load, "driver_threads": threads,
        "actors_ready_s": t_ready - t_spawn, "dag_channel_files": len(dag_files),
        "channel_files_left": files_left, "kv_rows": kv_rows,
        "kv_rows_expected": len(eager + runs) * len(prompts), "dashboard_port": port,
        "log_entries": {i: log_ids.count(i) for i in mine},
        "metrics_bytes": len(metrics_text),
        "holders_after": holders_after, "actors": per_actor,
        "launches": {"rmsnorm": sum(a["rmsnorm_launches"] for a in per_actor)},
    }
    card = None if cpu else ledger.card_ids()[0]
    n = len(prompts)
    if set(out["stage1_equal_eager"] + out["stage1_equal_compiled"]) != {n}:
        bad.append(f"stage 1 texts differ from the expected: eager {out['stage1_equal_eager']}, "
                   f"compiled {out['stage1_equal_compiled']} of {n} equal")
    if set(out["stage2_equal_first_eager"] + out["stage2_rows"]) != {n}:
        bad.append(f"stage 2 (eager, compiled, compiled) differs from the first eager run: "
                   f"{out['stage2_equal_first_eager']} of {n} equal")
    if not dag_files:
        bad.append("the compiled DAG made no channel file under /dev/shm")
    for a in per_actor:
        if a["listed_state"] != "ALIVE" or (not cpu and a["listed_cards"] != [card]):
            bad.append(f"actor {a['pid']}: /api/actors shows {a['listed_state']} on "
                       f"{a['listed_cards']}")
        if not a["loop_in_stacks"]:
            bad.append(f"actor {a['pid']}: no dag-loop thread in /api/stacks")
        if not cpu and a["decode_graph_replays"] != a["decode_steps"]:
            bad.append(f"actor {a['pid']}: a decode step was no graph replay")
        if a["rmsnorm_launches"] != (0 if cpu else a["rmsnorm_launches_expected"]):
            bad.append(f"actor {a['pid']}: rmsnorm launches {a['rmsnorm_launches']} != "
                       f"{a['rmsnorm_launches_expected']}")
    if any(n != 1 for n in out["log_entries"].values()):
        bad.append(f"/api/logs entries per actor: {out['log_entries']}")
    if not metrics_text.strip():
        bad.append("/metrics is empty")
    if kv_rows != str(out["kv_rows_expected"]):
        bad.append(f"internal_kv counter {kv_rows!r} != {out['kv_rows_expected']}")
    if files_left:
        bad.append(f"channel files left after teardown: {files_left}")
    if not chain_ok:
        bad.append("the compiled CPU chain gave wrong values")
    if holders_after:
        bad.append(f"leases left: {holders_after}")
    out["ok"] = not bad
    out["failed_checks"] = bad
    return out


def main(argv=None) -> int:
    import argparse

    from ray_tpu_torch.tools.util_bench import expected_texts, rehearsal_config

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="CPU actors, a tiny model")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None
    llm, sampling, prompts, smi = rehearsal_config(args.cpu)
    want = expected_texts(llm, prompts, sampling, device)
    if not args.cpu:
        import torch

        torch.cuda.empty_cache()  # this process holds no model while the actors run
    out = dag_actors(llm, prompts, sampling, want, device=device)
    print(json.dumps({**out, "card": smi}, default=str), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
