"""Tune on the card: trials leasing shares of one card, a trainer and an
algorithm as trainables, all through ``Tuner.fit``.

    python -m ray_tpu_torch.tools.tune_bench          # the card: the smoke's tune parts
    python -m ray_tpu_torch.tools.tune_bench --cpu    # rehearsal on CPU trials, tiny model

The Llama parts drive ``examples/train_llama_dp.py:train_loop`` (through
``loss_history_loop``, which adds to each report the losses, step times and
attention launches so far, the step's wall-clock end and the process's peak
device memory) at the bench widths (``bench.py:31-47``: d_model 2048, 16/16 heads
of 128, d_ff 8192, vocab 32000, bf16, remat "full", splash attention; depth
cut to ``DEPTH`` layers), batch 4 x 2048, and print one JSON line each with the card's
nvidia-smi name and power limit. ``chip_smoke.py``'s tune phase runs them:

- ``asha_shared``: four trials over a 4-point ``optimizer.learning_rate``
  grid, each ``with_resources({"GPU": 0.25})``, under ASHA (``max_t`` 6
  steps, grace 2, reduction factor 2, metric loss, mode min): all four hold
  their leases on the one card at once (a thread samples the ledger); each
  trial's peak memory; the controller's sequence of results replayed
  through a fresh ASHA gives the same decisions; the card's total tokens/s
  over step 2, which the four trials start together (each waits after its
  first step, the warm-up, until all four are there); the attention
  launches 2L / L / L a step, counted in the trial processes.
- ``trainer_trainable``: ``TorchTrainer(loss_history_loop,
  ScalingConfig(num_workers=1, use_gpu=True))`` in a ``Tuner`` over a
  2-point grid, ``max_concurrent_trials=1``: the trial process leases a CPU
  slot and its nested rank the card; each trial's losses equal a direct
  ``fit()`` at the same learning rate (relative difference at most 1e-6);
  the nested rank's steps after the first give the tokens/s of one trial
  alone on the card.
- ``ppo_trainable``: ``PPO.as_trainable`` (``examples/tune_ppo.py``'s
  settings) at ``{"GPU": 0.5}`` a trial, 2 learning rates, 2 iterations:
  both trials hold half the card at once, the learner on it.

No lease is left after each part. On the CPU (``--cpu``) trials lease CPU
slots of a ledger of their own and the model is tiny; nothing there is a
device number.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import tempfile
import threading
import time

from ray_tpu_torch import tune
from ray_tpu_torch._private.cards import CardLedger, default_ledger, use_ledger
from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

ATTENTION = ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkdv")
LOSS_RTOL = 1e-6  # a trial's losses against a direct fit at the same learning rate
LRS = [3e-4, 1e-3, 3e-3, 1e-2]
TRAINER_LRS = [1e-3, 3e-3]
PPO_LRS = [3e-4, 1e-3]
DEPTH = 4  # layers at the bench widths: chip_smoke.py's ELASTIC_DEPTH
ASHA_MAX_T = 6  # steps of an ASHA trial that no rung stops
TRAINER_STEPS = 3  # steps of each trainer_trainable trial and direct fit
PPO_ITERS = 2  # iterations of each ppo_trainable trial
ALIGN_S = 180.0  # how long align waits for its peers


def loss_history_loop(config: dict) -> None:
    """``examples/train_llama_dp.py:train_loop``, each report also carrying
    ``losses``, ``steps_ms`` and ``launches_total`` (the attention
    launches) so far, ``t_end`` (time.time() at the report) and
    ``peak_memory_gb``. With
    ``config["align"]`` ({"dir", "n"}) the process waits after its first
    report until ``n`` processes have reached theirs."""
    import torch

    import ray_tpu_torch.train as train
    from ray_tpu_torch.examples import train_llama_dp as ex

    report = train.report
    losses, step_ms, totals = [], [], dict.fromkeys(ATTENTION, 0)

    def with_history(metrics, checkpoint=None):
        losses.append(metrics["loss"])
        step_ms.append(metrics["step_ms"])
        for k in ATTENTION:
            totals[k] += metrics["launches"][k]
        extra = {"losses": list(losses), "steps_ms": list(step_ms),
                 "launches_total": dict(totals), "t_end": time.time(),
                 "peak_memory_gb": (torch.cuda.max_memory_allocated() / 1e9
                                    if torch.cuda.is_available() else 0.0)}
        report({**metrics, **extra}, checkpoint=checkpoint)
        if len(losses) == 1 and "align" in config:
            align(**config["align"])

    train.report = with_history  # in this process only
    try:
        ex.train_loop(config)
    finally:
        train.report = report


def align(dir: str, n: int) -> None:
    """A barrier of ``n`` processes in the directory ``dir``: each marks its
    arrival there, then waits (up to ``ALIGN_S``) until ``n`` have."""
    open(os.path.join(dir, f"ready-{os.getpid()}"), "w").close()
    deadline = time.monotonic() + ALIGN_S
    while len(os.listdir(dir)) < n and time.monotonic() < deadline:
        time.sleep(0.005)


def _loop_config(device: str, steps: int, lr: float) -> dict:
    config = {"steps": steps, "batch": 4, "seed": 0,
              "optimizer": {"learning_rate": lr, "warmup_steps": 1, "total_steps": steps}}
    if device == "cpu":
        return {**config, "model": "tiny", "seq_len": 16}
    return {**config, "model": "bench", "model_kwargs": {"n_layers": DEPTH}, "seq_len": 2048}


@contextlib.contextmanager
def _host(device: str):
    """The ledger: the host's on the card; on the CPU one of its own with
    4 CPU slots (a trial takes one)."""
    if device != "cpu":
        yield default_ledger()
        return
    with tempfile.TemporaryDirectory(prefix="tune-ledger-") as d, \
            use_ledger(CardLedger(d, cards=[], cpus=4)) as ledger:
        yield ledger


class LedgerWatch:
    """Samples a ledger's holders every 20 ms while a fit runs."""

    def __init__(self, ledger):
        self.ledger, self.seen, self._stop = ledger, [], threading.Event()
        self._t = threading.Thread(target=self._run, name="ledger-watch", daemon=True)

    def _run(self):
        while not self._stop.is_set():
            self.seen.append(self.ledger.holders())
            time.sleep(0.02)

    def __enter__(self):
        self._t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join()

    def most(self, name: str) -> int:
        return max((sum(h.name == name for h in hs) for hs in self.seen), default=0)

    def held(self, name: str) -> list:
        """Each distinct holding of ``name``'s holders: (gpu shares, cpu)."""
        return sorted({(json.dumps(h.gpu, sort_keys=True), h.cpu)
                       for hs in self.seen for h in hs if h.name == name})


def _resources(device: str, share: float) -> dict:
    return {"CPU": 1} if device == "cpu" else {"GPU": share}


def _tokens(config: dict) -> int:
    return config["batch"] * config["seq_len"]


def _replay(events: list, make) -> list:
    """The decisions a fresh scheduler gives for the controller's own
    sequence of trials, results and completions."""
    class _T:
        def __init__(self, trial_id):
            self.trial_id = trial_id

    sched, trials, out = make(), {}, []
    sched.set_search_properties("loss", "min")
    for e in events:
        if e[0] == "add":
            trials[e[1]] = _T(e[1])
            sched.on_trial_add(trials[e[1]])
        elif e[0] == "result":
            out.append(sched.on_trial_result(trials[e[1]], e[2]))
        else:
            sched.on_trial_complete(trials[e[1]], e[2])
    return out


def asha_shared(device: str = "cuda") -> dict:
    """Four ASHA trials of a quarter card each, all on the card at once."""
    L = DEPTH if device != "cpu" else 2

    def asha():
        return tune.ASHAScheduler(max_t=ASHA_MAX_T, grace_period=2, reduction_factor=2)

    base = _loop_config(device, ASHA_MAX_T, LRS[0])
    with _host(device) as ledger, tempfile.TemporaryDirectory(prefix="asha-") as storage:
        align = os.path.join(storage, "align")
        os.makedirs(align)
        space = {**base, "align": {"dir": align, "n": len(LRS)},
                 "optimizer": {**base["optimizer"], "learning_rate": tune.grid_search(LRS)}}
        tuner = tune.Tuner(
            tune.with_resources(loss_history_loop, _resources(device, 0.25)),
            param_space=space,
            tune_config=tune.TuneConfig(metric="loss", mode="min", scheduler=asha()),
            run_config=RunConfig(name="asha", storage_path=storage),
        )
        t0 = time.perf_counter()
        with LedgerWatch(ledger) as watch:
            results = tuner.fit()
        fit_s = time.perf_counter() - t0
        holders_after = [str(h) for h in ledger.holders()]
    c = tuner._controller
    decisions = [e[3] for e in c.events if e[0] == "result"]
    replayed = _replay(c.events, asha)
    hist = {r.config["optimizer"]["learning_rate"]: r.metrics_history for r in results}
    # step 2 of the four trials, started together after the barrier
    step2 = [next(m for m in h if m["step"] == 2) for h in hist.values() if len(h) >= 2]
    window = (max(m["t_end"] for m in step2)
              - min(m["t_end"] - m["step_ms"] / 1e3 for m in step2)) if step2 else float("nan")
    per_step = [[m["launches"][k] for k in ATTENTION] for h in hist.values() for m in h]
    out = {
        "part": "asha_shared", "device": device, "layers": L, "fit_s": fit_s,
        "errors": results.errors, "most_trial_leases_held": watch.most("1 tune trial"),
        "trial_holdings": watch.held("1 tune trial"),
        "trial_startup_s": {t.config["optimizer"]["learning_rate"]: t.startup_s
                            for t in c.trials},
        "steps_run": {lr: len(h) for lr, h in hist.items()},
        "losses": {lr: [m["loss"] for m in h] for lr, h in hist.items()},
        "step_ms": {lr: [m["step_ms"] for m in h] for lr, h in hist.items()},
        "peak_memory_gb": {lr: max(m["peak_memory_gb"] for m in h) for lr, h in hist.items()},
        "decisions": decisions, "replayed_decisions": replayed,
        "best_lr": results.get_best_result().config["optimizer"]["learning_rate"],
        "step2_window_s": window,
        "shared_tokens_per_s": len(step2) * _tokens(base) / window if step2 else None,
        "launches": {k: sum(m["launches"][k] for h in hist.values() for m in h)
                     for k in ATTENTION},
        "steps_total": len(per_step), "holders_after": holders_after,
    }
    bad = []
    if results.errors:
        bad.append(f"trials failed: {results.errors}")
    if out["most_trial_leases_held"] != len(LRS):
        bad.append(f"{out['most_trial_leases_held']} trial leases at once, not {len(LRS)}")
    if replayed != decisions or "STOP" not in decisions:
        bad.append(f"ASHA replayed {replayed} != the controller's {decisions}")
    if len(step2) != len(LRS) or not math.isfinite(window) or window <= 0:
        bad.append(f"step 2 of the {len(LRS)} trials not measured together ({len(step2)})")
    if not all(math.isfinite(x) for ls in out["losses"].values() for x in ls):
        bad.append("a loss not finite")
    want = [0, 0, 0] if device == "cpu" else [2 * L, L, L]
    if any(s != want for s in per_step):
        bad.append(f"attention launches {per_step} != {want} a step")
    if holders_after:
        bad.append(f"leases left: {holders_after}")
    out["ok"] = not bad
    out["failed_checks"] = bad
    return out


def trainer_trainable(device: str = "cuda") -> dict:
    """A 1-rank TorchTrainer swept over 2 learning rates, one trial at a
    time, against direct fits."""
    L = DEPTH if device != "cpu" else 2
    scaling = (ScalingConfig(num_workers=1, use_gpu=False, resources_per_worker={"CPU": 1})
               if device == "cpu" else ScalingConfig(num_workers=1, use_gpu=True))
    base = _loop_config(device, TRAINER_STEPS, TRAINER_LRS[0])
    with _host(device) as ledger, tempfile.TemporaryDirectory(prefix="trainer-") as storage:
        trainer = TorchTrainer(loss_history_loop, train_loop_config=base, scaling_config=scaling,
                               run_config=RunConfig(name="inner", storage_path=storage))
        tuner = tune.Tuner(
            trainer,
            param_space={"train_loop_config": {"optimizer": {
                **base["optimizer"], "learning_rate": tune.grid_search(TRAINER_LRS)}}},
            tune_config=tune.TuneConfig(metric="loss", mode="min", max_concurrent_trials=1),
            run_config=RunConfig(name="trainer-sweep", storage_path=storage),
        )
        t0 = time.perf_counter()
        with LedgerWatch(ledger) as watch:
            results = tuner.fit()
        fit_s = time.perf_counter() - t0
        direct = {}
        for lr in TRAINER_LRS:
            cfg = {**base, "optimizer": {**base["optimizer"], "learning_rate": lr}}
            r = TorchTrainer(loss_history_loop, train_loop_config=cfg, scaling_config=scaling,
                             run_config=RunConfig(name=f"direct-{lr:g}",
                                                  storage_path=storage)).fit()
            direct[lr] = {"error": r.error, "losses": r.metrics.get("losses")}
        holders_after = [str(h) for h in ledger.holders()]
    trial = {r.config["train_loop_config"]["optimizer"]["learning_rate"]: r.metrics
             for r in results}
    rel = {}
    for lr in TRAINER_LRS:
        a, b = trial.get(lr, {}).get("losses"), direct[lr]["losses"]
        rel[lr] = (max(abs(x - y) / abs(y) for x, y in zip(a, b))
                   if a and b and len(a) == len(b) else float("inf"))
    # the nested rank's steps after its first (the warm-up)
    alone_ms = [ms for m in trial.values() for ms in m["steps_ms"][1:]]
    rank_name = "1 GPU ranks" if device != "cpu" else "1 CPU ranks"
    together = [hs for hs in watch.seen
                if {h.name for h in hs} >= {"1 tune trial", rank_name}]
    out = {
        "part": "trainer_trainable", "device": device, "layers": L, "fit_s": fit_s,
        "errors": results.errors, "losses": {lr: m.get("losses") for lr, m in trial.items()},
        "direct_losses": {lr: d["losses"] for lr, d in direct.items()},
        "max_rel_diff": rel, "trial_holdings": watch.held("1 tune trial"),
        "rank_holdings": watch.held(rank_name), "trial_and_rank_together": bool(together),
        "trial_startup_s": [t.startup_s for t in tuner._controller.trials],
        "alone_step_ms": alone_ms,
        "alone_tokens_per_s": (_tokens(base) / (sorted(alone_ms)[len(alone_ms) // 2] / 1e3)
                               if alone_ms else None),
        "launches": {k: sum(m["launches_total"][k] for m in trial.values()) for k in ATTENTION},
        "steps_total": sum(len(m["losses"]) for m in trial.values()),
        "holders_after": holders_after,
    }
    bad = []
    if results.errors or any(d["error"] for d in direct.values()):
        bad.append(f"a trial or direct fit failed: {results.errors}, {direct}")
    if not all(v <= LOSS_RTOL for v in rel.values()):
        bad.append(f"losses off a direct fit: {rel} (limit {LOSS_RTOL})")
    if not together or watch.most("1 tune trial") != 1:
        bad.append("the trial's CPU lease and its rank's lease were not held together")
    if any(json.loads(g) for g, _ in out["trial_holdings"]) or not out["rank_holdings"]:
        bad.append(f"the trial held a card or its rank none: {out['trial_holdings']}")
    want = [0, 0, 0] if device == "cpu" else [2 * L, L, L]
    for m in trial.values():
        n = len(m["losses"])
        if [m["launches_total"][k] for k in ATTENTION] != [w * n for w in want]:
            bad.append(f"attention launches {m['launches_total']} != {want} x {n}")
    if holders_after:
        bad.append(f"leases left: {holders_after}")
    out["ok"] = not bad
    out["failed_checks"] = bad
    return out


def ppo_trainable(device: str = "cuda") -> dict:
    """PPO.as_trainable at half a card a trial, two learning rates."""
    from ray_tpu_torch.rllib import PPO, PPOConfig

    base = (PPOConfig().environment("CartPole-v1")
            .env_runners(num_envs_per_env_runner=8, rollout_fragment_length=128)
            .training(minibatch_size=256, num_epochs=8, entropy_coeff=0.01, vf_clip_param=100.0))
    with _host(device) as ledger, tempfile.TemporaryDirectory(prefix="ppo-") as storage:
        tuner = tune.Tuner(
            tune.with_resources(PPO.as_trainable(base), _resources(device, 0.5)),
            param_space={"lr": tune.grid_search(PPO_LRS), "stop_iters": PPO_ITERS},
            tune_config=tune.TuneConfig(metric="episode_return_mean", mode="max"),
            run_config=RunConfig(name="ppo-sweep", storage_path=storage),
        )
        t0 = time.perf_counter()
        with LedgerWatch(ledger) as watch:
            results = tuner.fit()
        fit_s = time.perf_counter() - t0
        holders_after = [str(h) for h in ledger.holders()]
    out = {
        "part": "ppo_trainable", "device": device, "fit_s": fit_s, "errors": results.errors,
        "most_trial_leases_held": watch.most("1 tune trial"),
        "trial_holdings": watch.held("1 tune trial"),
        "iterations": {r.config["lr"]: [m["training_iteration"] for m in r.metrics_history]
                       for r in results},
        "returns": {r.config["lr"]: [m["episode_return_mean"] for m in r.metrics_history]
                    for r in results},
        "time_this_iter_s": {r.config["lr"]: [m["time_this_iter_s"] for m in r.metrics_history]
                             for r in results},
        "holders_after": holders_after,
    }
    bad = []
    if results.errors:
        bad.append(f"trials failed: {results.errors}")
    if any(v != list(range(1, PPO_ITERS + 1)) for v in out["iterations"].values()):
        bad.append(f"iterations {out['iterations']}")
    if out["most_trial_leases_held"] != len(PPO_LRS):
        bad.append(f"{out['most_trial_leases_held']} trial leases at once, not {len(PPO_LRS)}")
    if device != "cpu" and any(list(json.loads(g).values()) != [0.5]
                               for g, _ in out["trial_holdings"]):
        bad.append(f"a trial did not hold half a card: {out['trial_holdings']}")
    if holders_after:
        bad.append(f"leases left: {holders_after}")
    out["ok"] = not bad
    out["failed_checks"] = bad
    return out


def main(argv=None) -> int:
    import argparse

    from ray_tpu_torch.tools.decode_profile import card

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="CPU trials, tiny model (rehearsal)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    smi = "cpu (rehearsal)" if args.cpu else card()
    ok = True
    for part in (asha_shared(device), trainer_trainable(device), ppo_trainable(device)):
        print(json.dumps({**part, "card": smi}, default=str), flush=True)
        ok &= part["ok"]
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
