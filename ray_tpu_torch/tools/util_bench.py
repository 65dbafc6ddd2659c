"""``ray_tpu_torch.util`` on the card: two llama3.2-3b engine actors placed in
a placement group's bundles, driven through ``ActorPool`` and a ``Queue``,
read back through metrics, tracing, pubsub and the state API, through the
entry points a user calls.

    python -m ray_tpu_torch.tools.util_bench          # the card: the smoke's util phase
    python -m ray_tpu_torch.tools.util_bench --cpu    # rehearsal on the CPU, a tiny model

``chip_smoke.py``'s util phase runs ``util_actors``, which returns one dict
with its measurements, ``ok`` and ``failed_checks``:

1. ``placement_group([{"GPU": 0.5}] * 2, strategy="STRICT_PACK")`` on the
   host's card ledger: ``ready()`` true, and the ledger holding the two
   half-card bundles.
2. Two ``ProcessActor(EngineActor)``, each placed in its bundle by
   ``PlacementGroupSchedulingStrategy(pg, i)``, each building the batch
   phase's engine (``data_bench.card_llm_config()``: llama3.2-3b at full
   width and depth, seeded bf16 weights, the fused RMSNorm, every decode
   step a graph replay) on the card its bundle leases.
3. ``ActorPool.map`` of the prompts in blocks of 16 (each block one
   continuously batched run, so the decode GEMMs have the batch phase's
   M): every text equal to the expected one, in input order.
4. A ``Queue(maxsize=8)`` on a CPU actor, passed as an argument to one
   engine actor, which pulls the first block of 16 prompts from it while
   the driver puts them: those texts equal too.
5. In each engine actor, a ``metrics.Counter`` of output tokens, merged by
   the driver's ``state.cluster_metrics()``: equal to the tokens
   generated. A ``tracing.span`` around each block, parented by the
   driver's span around the map or the queue's pull across the process
   boundary: each in ``state.timeline()`` with that parent.
6. ``state.list_actors()``: the 3 actors ``ALIVE`` with their pids, the
   engines with their bundle's card; ``state.list_placement_groups()``:
   the bundles on the card; the ``"actors"`` channel: ``ALIVE`` for each.
7. One engine actor killed: ``DEAD`` on the channel, its bundle still
   reserved. ``remove_placement_group``: the other ends, and no lease is
   left once the queue is shut down.

Each actor's RMSNorm launches since its engine was built (counted in its
own process) equal what its engine's counters give (2L+1 a decode step and
a final prefill chunk, 2L a mid chunk). Reported: each actor's start-up
and engine build, peak memory, output tok/s over the map, the group's time
to ready and the actors' to their bundles, and the time to free after
removal. On the CPU (``--cpu``) the bundles are CPU slots, the model tiny
and the launches 0; nothing there is a device number.
"""

from __future__ import annotations

import json
import os
import time

from ray_tpu_torch._private.cards import default_ledger
from ray_tpu_torch._private.process_actor import ProcessActor, get, start_all
from ray_tpu_torch.util import placement_group, remove_placement_group, state, tracing
from ray_tpu_torch.util.actor_pool import ActorPool
from ray_tpu_torch.util.pubsub import Subscriber
from ray_tpu_torch.util.queue import Queue
from ray_tpu_torch.util.scheduling_strategies import PlacementGroupSchedulingStrategy

ENGINES = 2
BLOCK = 16
QUEUE_MAX = 8
GROUP = "util-engines"
TOKENS = "util_output_tokens"
EVENT_WAIT_S = 30.0


class EngineActor:
    """One engine in a placed actor's process: the batch phase's engine,
    built on the card its bundle leases (``device=None``) or the CPU."""

    def __init__(self, llm_config, device=None):
        from ray_tpu_torch.llm import batch
        from ray_tpu_torch.util import metrics

        self.entered_at = time.time()
        self.config, self.device = llm_config, device
        self.engine = batch._get_engine(llm_config, device)
        self.built_at = time.time()
        self.tokens = metrics.Counter(TOKENS, "output tokens generated", tag_keys=("actor",))
        self.generated = 0

    def generate(self, prompts: list, sampling: dict) -> list:
        """One block: every prompt submitted at once, each waited for."""
        from ray_tpu_torch.llm.batch import _sampling

        with tracing.span("util.block", rows=len(prompts), pid=os.getpid()):
            reqs = [self.engine.submit(p, sampling_params=_sampling(sampling)) for p in prompts]
            texts = []
            for r in reqs:
                self.engine._await_done(r)
                if r.error is not None:
                    raise r.error
                texts.append(self.engine.tokenizer.decode(r.out_tokens))
                self.generated += len(r.out_tokens)
                self.tokens.inc(len(r.out_tokens), tags={"actor": str(os.getpid())})
        return texts

    def pull(self, queue, n: int, sampling: dict) -> list:
        """Take ``n`` (row, prompt) items from ``queue``, then run them as
        one block; returns (row, text) pairs."""
        items = [queue.get(timeout=120) for _ in range(n)]
        texts = self.generate([p for _, p in items], sampling)
        return [(row, t) for (row, _), t in zip(items, texts)]

    def report(self) -> dict:
        import torch

        from ray_tpu_torch.llm import batch
        from ray_tpu_torch.ops import launch_counts
        from ray_tpu_torch.util import get_current_placement_group

        key = batch._engine_key(self.config, self.device)
        built, now = batch._ENGINE_BUILT[key], launch_counts()
        pg = get_current_placement_group()
        return {"pid": os.getpid(), "entered_at": self.entered_at, "built_at": self.built_at,
                "engine_build_s": built["seconds"], "n_layers": self.engine.model_cfg.n_layers,
                "stats": self.engine.get_stats(), "generated": self.generated,
                "launches_since_build": {k: now[k] - built["launches"][k] for k in now},
                "placement_group_id": pg.id if pg is not None else None,
                "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "peak_memory_gb": (torch.cuda.max_memory_allocated() / 1e9
                                   if torch.cuda.is_available() else 0.0)}


def _events(sub: Subscriber, want: set, state_: str) -> set:
    """The ids of ``want`` seen in ``state_`` on ``sub`` within
    ``EVENT_WAIT_S``."""
    seen, deadline = set(), time.monotonic() + EVENT_WAIT_S
    while seen != want and time.monotonic() < deadline:
        seen |= {e["actor_id"] for e in sub.poll(timeout=1.0)
                 if e["state"] == state_ and e["actor_id"] in want}
    return seen


def util_actors(llm_config, prompts: list, sampling: dict, want: list, device=None) -> dict:
    """The util slice over ``prompts``; ``want``: each prompt's expected
    text."""
    ledger = default_ledger()
    cpu = device == "cpu"
    bundle = {"CPU": 1} if cpu else {"GPU": 1.0 / ENGINES}
    group_name = f"placement group {GROUP}"
    sub = Subscriber("actors", start_from_beginning=False)
    bad, actors, q = [], [], None
    t0 = time.perf_counter()
    pg = placement_group([bundle] * ENGINES, strategy="STRICT_PACK", name=GROUP)
    ready = pg.ready(timeout=60)
    group_ready_s = time.perf_counter() - t0
    reserved = [h for h in ledger.holders() if h.name == group_name]
    try:
        t_spawn = time.time()
        actors = [ProcessActor(EngineActor, (llm_config, device), name=f"util-engine-{i}",
                               scheduling_strategy=PlacementGroupSchedulingStrategy(pg, i))
                  for i in range(ENGINES)]
        q = Queue(maxsize=QUEUE_MAX)
        start_all(actors + [q.actor])
        t_ready = time.time()
        blocks = [prompts[i:i + BLOCK] for i in range(0, len(prompts), BLOCK)]
        pool = ActorPool(actors)
        t1 = time.perf_counter()
        with tracing.span("util.pool_map", blocks=len(blocks)):
            map_span = tracing.current_context()[1]
            texts = [t for block in pool.map(lambda a, b: a.call("generate", b, sampling),
                                             blocks) for t in block]
        map_s = time.perf_counter() - t1
        with tracing.span("util.queue_pull", rows=len(blocks[0])):
            queue_span = tracing.current_context()[1]
            pulled = actors[0].call("pull", q, len(blocks[0]), sampling)
            for row, p in enumerate(blocks[0]):
                q.put((row, p), timeout=120)
            queue_texts = [t for _, t in sorted(get(pulled, timeout=600))]
        reports = get([a.call("report") for a in actors])
        merged = {r["name"]: r for r in state.cluster_metrics()}.get(TOKENS, {})
        merged_tokens = sum(merged.get("values", {}).values())
        trace = state.timeline()
        listed = {a["actor_id"]: a for a in state.list_actors()}
        groups = {g["placement_group_id"]: g for g in state.list_placement_groups()}
        mine = {a.actor_id for a in actors} | {q.actor.actor_id}
        alive_seen = _events(sub, mine, "ALIVE")
        # one engine actor killed: its bundle stays reserved
        killed = actors[1]
        killed.kill()
        dead_seen = _events(sub, {killed.actor_id}, "DEAD")
        reserved_after_kill = [h for h in ledger.holders() if h.name == group_name]
        t2 = time.perf_counter()
        remove_placement_group(pg)
        while any(h.name == group_name for h in ledger.holders()) and \
                time.perf_counter() - t2 < 30:
            time.sleep(0.01)
        free_s = time.perf_counter() - t2
        survivor_alive = actors[0].is_alive()
    finally:
        remove_placement_group(pg)
        if q is not None:
            q.shutdown()
        for a in actors:
            a.kill()
    holders_after = [str(h) for h in ledger.holders()]

    block_spans = [e for e in trace if e["name"] == "util.block"]
    parents = sorted(e["args"]["parent_id"] for e in block_spans)
    want_parents = sorted([map_span] * len(blocks) + [queue_span])
    n_out = sum(r["generated"] for r in reports)
    per_actor = []
    for a, rep in zip(actors, reports):
        st, n_norms = rep["stats"], 2 * rep["n_layers"] + 1
        expected = (n_norms * (st["decode_steps"] + st["prefill_final_chunks"])
                    + (n_norms - 1) * st["prefill_mid_chunks"])
        row = listed.get(a.actor_id, {})
        per_actor.append({
            "pid": rep["pid"], "startup_s": rep["entered_at"] - t_spawn,
            "engine_build_s": rep["engine_build_s"], "peak_memory_gb": rep["peak_memory_gb"],
            "visible": rep["visible"], "listed_state": row.get("state"),
            "listed_pid": row.get("pid"), "listed_cards": row.get("cards"),
            "bundle_index": row.get("bundle_index"), "in_group": rep["placement_group_id"],
            "generated": rep["generated"], "rmsnorm_launches": rep["launches_since_build"]["rmsnorm"],
            "rmsnorm_launches_expected": expected,
            **{k: st[k] for k in ("decode_programs", "decode_steps", "decode_graph_replays",
                                  "prefill_mid_chunks", "prefill_final_chunks")}})
    table = groups.get(pg.id, {})
    out = {
        "part": "util_actors", "device": device or "cuda", "rows": len(prompts),
        "blocks": len(blocks), "block_rows": [len(b) for b in blocks],
        "texts_equal": sum(t == w for t, w in zip(texts, want)),
        "queue_texts_equal": sum(t == w for t, w in zip(queue_texts, want)),
        "queue_rows": len(queue_texts), "map_s": map_s,
        "out_tok_per_s": len(prompts) * sampling["max_tokens"] / map_s,
        "group_ready": ready, "group_ready_s": group_ready_s,
        "actors_placed_s": max(a["startup_s"] for a in per_actor),
        "actors_ready_s": t_ready - t_spawn, "free_after_remove_s": free_s,
        "reserved": [str(h) for h in reserved],
        "reserved_after_kill": [str(h) for h in reserved_after_kill],
        "bundle_cards": table.get("bundle_cards"), "group_state": table.get("state"),
        "merged_tokens": merged_tokens, "tokens_generated": n_out,
        "block_spans": len(block_spans), "block_span_parents_ok": parents == want_parents,
        "alive_seen": len(alive_seen), "dead_seen": len(dead_seen),
        "queue_actor_state": listed.get(q.actor.actor_id, {}).get("state"),
        "other_actors_alive": sum(a["state"] == "ALIVE" for k, a in listed.items()
                                  if k not in mine),
        "survivor_alive_after_remove": survivor_alive, "holders_after": holders_after,
        "actors": per_actor,
        "launches": {"rmsnorm": sum(a["rmsnorm_launches"] for a in per_actor)},
    }
    card = None if cpu else ledger.card_ids()[0]
    if not ready or len(reserved) != ENGINES or any(
            (h.gpu, h.cpu) != (({} if cpu else {card: 1.0 / ENGINES}), 1.0 if cpu else 0.0)
            for h in reserved):
        bad.append(f"the group is not ready with {ENGINES} bundles of {bundle}: {reserved}")
    if out["texts_equal"] != len(prompts) or len(texts) != len(prompts):
        bad.append(f"{len(prompts) - out['texts_equal']} pool texts differ")
    if out["queue_texts_equal"] != len(blocks[0]) or len(queue_texts) != len(blocks[0]):
        bad.append(f"{len(blocks[0]) - out['queue_texts_equal']} queue texts differ")
    if merged_tokens != n_out or n_out != (len(prompts) + len(blocks[0])) * sampling["max_tokens"]:
        bad.append(f"merged token counter {merged_tokens} != tokens generated {n_out}")
    if not out["block_span_parents_ok"]:
        bad.append(f"block spans' parents {parents} != {want_parents}")
    if out["alive_seen"] != len(mine) or out["dead_seen"] != 1:
        bad.append(f"ALIVE seen for {out['alive_seen']} of {len(mine)}, DEAD for "
                   f"{out['dead_seen']} of 1")
    if out["queue_actor_state"] != "ALIVE":
        bad.append(f"the queue's actor is {out['queue_actor_state']} in list_actors")
    for a in per_actor:
        if (a["listed_state"], a["listed_pid"]) != ("ALIVE", a["pid"]) or a["in_group"] != pg.id:
            bad.append(f"actor {a['pid']}: listed {a['listed_state']} pid {a['listed_pid']}, "
                       f"group {a['in_group']}")
        if not cpu:
            if a["listed_cards"] != [card]:
                bad.append(f"actor {a['pid']}: cards {a['listed_cards']} != [{card}]")
            if a["decode_graph_replays"] != a["decode_steps"]:
                bad.append(f"actor {a['pid']}: a decode step was no graph replay")
        if a["rmsnorm_launches"] != (0 if cpu else a["rmsnorm_launches_expected"]):
            bad.append(f"actor {a['pid']}: rmsnorm launches {a['rmsnorm_launches']} != "
                       f"{a['rmsnorm_launches_expected']}")
    if not cpu and out["bundle_cards"] != [{card: 1.0 / ENGINES}] * ENGINES:
        bad.append(f"bundles {out['bundle_cards']} not on card {card}")
    if len(reserved_after_kill) != ENGINES:
        bad.append(f"a killed actor's bundle was freed: {out['reserved_after_kill']}")
    if survivor_alive:
        bad.append("the group's other actor outlived remove_placement_group")
    if holders_after:
        bad.append(f"leases left: {holders_after}")
    out["ok"] = not bad
    out["failed_checks"] = bad
    return out


def expected_texts(llm_config, prompts: list, sampling: dict, device=None) -> list:
    """Each prompt's text from one engine in this process, run in the same
    blocks of ``BLOCK`` (the engine is shut down after)."""
    from ray_tpu_torch.llm import SamplingParams
    from ray_tpu_torch.llm import batch

    eng = batch._get_engine(llm_config, device)
    try:
        want = []
        for i in range(0, len(prompts), BLOCK):
            reqs = [eng.submit(p, sampling_params=SamplingParams(**sampling))
                    for p in prompts[i:i + BLOCK]]
            for r in reqs:
                eng._await_done(r)
                want.append(eng.tokenizer.decode(r.out_tokens))
    finally:
        eng.shutdown()
        batch._ENGINE_CACHE.clear()
    return want


def rehearsal_config(cpu: bool) -> tuple:
    """(LLM config, sampling, 32 prompts, the card's nvidia-smi line) of a
    tool run alone: the batch phase's engine on the card, or a tiny model
    with 4 tokens a prompt on the CPU."""
    from ray_tpu_torch.llm import EngineConfig, LLMConfig, ModelConfig
    from ray_tpu_torch.tools.data_bench import card_llm_config
    from ray_tpu_torch.tools.decode_profile import card

    if cpu:
        llm = LLMConfig(model=ModelConfig(model_id="tiny", tokenizer="byte", seed=0),
                        engine=EngineConfig(max_num_seqs=16, max_seq_len=128,
                                            prefill_buckets=(32, 64, 128), dtype="float32"))
    else:
        llm = card_llm_config()
    sampling = {"max_tokens": 32 if not cpu else 4, "temperature": 0.0, "ignore_eos": True}
    prompts = [f"Row {i:02d}: summarise offline batch inference on a card." for i in range(32)]
    return llm, sampling, prompts, "cpu (rehearsal)" if cpu else card()


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="CPU bundles, a tiny model")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None
    llm, sampling, prompts, smi = rehearsal_config(args.cpu)
    want = expected_texts(llm, prompts, sampling, device)
    if not args.cpu:
        import torch

        torch.cuda.empty_cache()  # this process holds no model while the actors run
    out = util_actors(llm, prompts, sampling, want, device=device)
    print(json.dumps({**out, "card": smi}, default=str), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
