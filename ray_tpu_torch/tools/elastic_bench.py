"""Elastic training on the card: a capacity-capped start, the host's card
ledger, learners sharing a card, and a group growing from 2 to 4 ranks.

    python -m ray_tpu_torch.tools.elastic_bench               # four cards: 2 -> 4 from a checkpoint
    python -m ray_tpu_torch.tools.elastic_bench --one-card    # the smoke's elastic parts
    python -m ray_tpu_torch.tools.elastic_bench --cpu         # both on gloo ranks (rehearsal)

Every part drives ``examples/train_llama_dp.py:train_loop`` through
``TorchTrainer`` at the bench widths (``bench.py:31-47``: d_model 2048,
16/16 heads of 128, d_ff 8192, vocab 32000, bf16, remat "full", splash
attention; depth as given), on a global batch of sequences of 2048 drawn
from (seed, step), and prints one JSON line with the card's nvidia-smi
name and power limit. ``chip_smoke.py``'s elastic phase runs the
one-card parts:

- ``capped_start``: ``ScalingConfig(num_workers=2, min_workers=1)`` on one
  free card starts at world size 1, takes its steps with a state
  checkpoint every k, polls ``resize_decision`` (it never fires: no
  headroom), charges no failure; the rank's attention launches 2L / L / L
  a step.
- ``ledger_on_card``: a process actor holding the card makes a one-card
  ``TorchTrainer`` refuse to start, naming the holder's pid; after the
  holder is SIGKILLed the same trainer starts and finishes; no lease left.
- ``shared_learners``: two learner processes at
  ``resources_per_learner={"GPU": 0.5}`` on one card, each one's update
  bit-equal to a local learner's (a shifted-actions control must miss);
  two policies' learner groups at ``{"GPU": 1}``: the second raises,
  naming the first's learner.

``grow`` (four cards): a holder process leases 2 of the 4 cards;
``ScalingConfig(num_workers=4, min_workers=2)`` starts at 2 ranks with a
state checkpoint every k steps; the holder is SIGKILLed once the first
checkpoint is in; the group grows to 4 from the latest checkpoint. It
reports each step's world size, the resize's seconds (teardown, spawn and
rendezvous, checkpoint read, the first step), the steps replayed, tokens/s
at 2 and at 4, and the losses after the resize against a fixed 4-rank run
on the same global batches from step 0, and against one resumed from the
checkpoint the grown group resumed from (limit 1e-3 relative, the smoke's
parallel phase's, for both; the first also shows how far bf16 runs of 2
and 4 ranks part before any resize).

On the CPU (``--cpu``) the ranks are gloo ranks of one CPU slot on a
ledger of their own whose slots stand in for the cards, and the model is
tiny; nothing there is a device number.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import signal
import tempfile
import threading
import time

import numpy as np

from ray_tpu_torch._private.cards import CardLedger, LedgerError, default_ledger, use_ledger
from ray_tpu_torch._private.process_actor import ProcessActor, get
from ray_tpu_torch._private.spawn_env import assign_cards
from ray_tpu_torch.examples import train_llama_dp as ex
from ray_tpu_torch.train import Checkpoint, RunConfig, ScalingConfig, TorchTrainer

LOSS_RTOL = 1e-3  # the smoke's parallel phase's loss limit
ATTENTION = ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkdv")


def _loop_config(device: str, depth: int, steps: int, every, global_batch: int) -> dict:
    config = {"steps": steps, "global_batch": global_batch, "seed": 0,
              "state_checkpoint_every": every}
    if device == "cpu":
        return {**config, "model": "tiny", "seq_len": 16}
    return {**config, "model": "bench", "model_kwargs": {"n_layers": depth}, "seq_len": 2048}


def _scaling(device: str, num: int, lo=None) -> ScalingConfig:
    if device == "cpu":
        return ScalingConfig(num_workers=num, min_workers=lo, use_gpu=False,
                             resources_per_worker={"CPU": 1})
    return ScalingConfig(num_workers=num, min_workers=lo, use_gpu=True)


@contextlib.contextmanager
def _host(device: str, cards: int):
    """The ledger: the host's on the card; on the CPU one of its own with
    ``cards`` CPU slots standing in for the cards."""
    if device != "cpu":
        yield default_ledger()
        return
    with tempfile.TemporaryDirectory(prefix="elastic-ledger-") as d, \
            use_ledger(CardLedger(d, cards=[], cpus=cards)) as ledger:
        yield ledger


def _lease_holder(device: str, n: int):
    """A process actor holding ``n`` cards (CPU slots on the CPU): a learner
    that has touched its device."""
    from ray_tpu_torch.rllib import RLModuleSpec
    from ray_tpu_torch.rllib.core.learner import TorchLearner

    lease, = (assign_cards(1, n, "holders") if device != "cpu"
              else assign_cards(1, 0, "holders", cpu=n))
    holder = ProcessActor(TorchLearner, (RLModuleSpec(observation_dim=4, action_dim=2),),
                          {"device": "cuda" if device != "cpu" else "cpu"}, lease=lease,
                          name="holder")
    get(holder.ready)
    return holder


def _kill(actor) -> None:
    os.kill(actor.pid, signal.SIGKILL)
    actor._proc.join(30)
    actor.kill()


def _free(ledger, device: str) -> float:
    free = ledger.free()
    return free.cards if device != "cpu" else free.cpus


def _launches_ok(h: list, L: int, device: str) -> bool:
    if device == "cpu":  # no kernel runs on the CPU
        return all(m["launches"][k] == 0 for m in h for k in ATTENTION)
    want = (2 * L, L, L)
    return all(tuple(m["launches"][k] for k in ATTENTION) == want for m in h)


def capped_start(device: str = "cuda", depth: int = 4, steps: int = 6, every: int = 2) -> dict:
    """An elastic group of 2 (min 1) on a host with one free card."""
    config = _loop_config(device, depth, steps, every, global_batch=4)
    with _host(device, 1) as ledger, tempfile.TemporaryDirectory(prefix="capped-") as storage:
        free_before = _free(ledger, device)
        trainer = TorchTrainer(ex.train_loop, train_loop_config=config,
                               scaling_config=_scaling(device, 2, 1),
                               run_config=RunConfig(name="capped", storage_path=storage))
        t0 = time.perf_counter()
        result = trainer.fit()
        fit_s = time.perf_counter() - t0
        c = trainer._controller
        # the last state checkpoint read back to the device, as a resize
        # would read it
        state_step = max(s for s in range(1, steps) if s % every == 0)
        tc = next(tc for tc in c.checkpoint_manager.tracked
                  if tc.metrics.get("step") == state_step)
        read_s = _read_state(tc.checkpoint, config, device)
        holders_after = [str(h) for h in ledger.holders()]
    h = result.metrics_history
    L = ex.model_config(config).n_layers
    out = {
        "part": "capped_start", "device": device, "layers": L, "free_at_start": free_before,
        "error": result.error, "fit_s": fit_s,
        "attempts": c.attempts, "world_sizes": sorted({m["world_size"] for m in h}),
        "steps": [m["step"] for m in h], "losses": [m["loss"] for m in h],
        "resize_checks": c.resize_checks, "num_resizes": c.num_resizes,
        "failures": c.failure_policy.failures, "rank_startup_s": c.rank_startup_s,
        "step_ms": [m["step_ms"] for m in h],
        "launches_per_step": [[m["launches"][k] for k in ATTENTION] for m in h],
        "launches": {k: sum(m["launches"][k] for m in h) for k in ATTENTION},
        "state_checkpoint_gb": h[every - 1]["checkpoint_bytes"] / 1e9,
        "state_checkpoint_write_s": [m["checkpoint_write_s"] for m in h
                                     if "checkpoint_write_s" in m],
        "state_checkpoint_read_s": read_s, "holders_after": holders_after,
    }
    bad = []
    if result.error is not None:
        bad.append(f"fit failed: {result.error}")
    if out["world_sizes"] != [1] or [a["size"] for a in c.attempts] != [1]:
        bad.append(f"did not start at the one free card: {c.attempts}")
    if out["steps"] != list(range(1, steps + 1)) or not all(map(math.isfinite, out["losses"])):
        bad.append(f"steps {out['steps']} or a loss not finite")
    if c.resize_checks == 0 or c.num_resizes or c.failure_policy.failures:
        bad.append("resize_decision not polled, or a resize or failure")
    if not _launches_ok(h, L, device):
        bad.append(f"attention launches {out['launches_per_step']} != 2L/L/L a step")
    if holders_after:
        bad.append(f"leases left: {holders_after}")
    out["ok"] = not bad
    out["failed_checks"] = bad
    return out


def _read_state(checkpoint, config: dict, device: str) -> float:
    import torch

    from ray_tpu_torch.models.llama import param_template
    from ray_tpu_torch.models.training import TrainState, default_optimizer

    meta = param_template(ex.model_config(config))
    like = TrainState(meta, default_optimizer().init(meta), 0).state_dict()
    dev = "cuda" if device != "cpu" else "cpu"
    t0 = time.perf_counter()
    state = checkpoint.to_state_dict(like=like, device=dev)
    if dev == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    del state
    return seconds


def ledger_on_card(device: str = "cuda") -> dict:
    """A holder of the one card refuses a one-card trainer; killed, it
    frees the card for the same trainer."""
    config = _loop_config(device, depth=1, steps=1, every=None, global_batch=1)
    with _host(device, 1) as ledger, tempfile.TemporaryDirectory(prefix="held-") as storage:
        holder = _lease_holder(device, 1)
        seen = [str(h) for h in ledger.holders()]
        trainer = TorchTrainer(ex.train_loop, train_loop_config=config,
                               scaling_config=_scaling(device, 1),
                               run_config=RunConfig(name="held", storage_path=storage))
        refused = None
        try:
            try:
                trainer.fit()
            except LedgerError as e:
                refused = str(e)
        finally:
            holder_pid = holder.pid
            _kill(holder)
        free_after_kill = _free(ledger, device)
        t0 = time.perf_counter()
        result = trainer.fit()
        fit_s = time.perf_counter() - t0
        holders_after = [str(h) for h in ledger.holders()]
    out = {"part": "ledger_on_card", "device": device, "holder_pid": holder_pid,
           "holders_seen": seen, "refused": refused, "free_after_kill": free_after_kill,
           "fit_s": fit_s, "error": result.error,
           "steps": [m["step"] for m in result.metrics_history],
           "holders_after": holders_after}
    bad = []
    if refused is None or f"pid {holder_pid}" not in refused:
        bad.append(f"the trainer was not refused naming the holder: {refused}")
    if result.error is not None or out["steps"] != [1]:
        bad.append(f"the trainer did not finish once the holder died: {result.error}")
    if free_after_kill != 1 or holders_after:
        bad.append(f"the card not returned ({free_after_kill} free) or leases left "
                   f"{holders_after}")
    out["ok"] = not bad
    out["failed_checks"] = bad
    return out


PARAM_ATOL = 1e-5  # rllib_bench's learner limit


def shared_learners(device: str = "cuda") -> dict:
    """Two learner processes of half a card each, each update against a
    local learner's; then two policies' groups of a whole card each."""
    import functools

    from ray_tpu_torch.rllib import LearnerGroup, PPOConfig, RLModuleSpec
    from ray_tpu_torch.rllib.env.multi_agent import MultiAgentCartPole
    from ray_tpu_torch.tools.rllib_bench import _batches

    spec = RLModuleSpec(observation_dim=4, action_dim=2, hidden=(64, 64))
    kwargs = dict(lr=1e-3, seed=0)
    ledger = default_ledger()
    local = LearnerGroup(spec, learner_kwargs=kwargs, device=device)
    t0 = time.perf_counter()
    group = LearnerGroup(spec, num_learners=2, learner_kwargs=kwargs, device=device,
                         resources_per_learner={"GPU": 0.5})
    start_s = time.perf_counter() - t0
    batch, = _batches("ppo", 1, False)
    shifted, = _batches("ppo", 1, True)
    try:
        held = [str(h) for h in ledger.holders()]
        state = local.get_state()
        local.update_from_batch(batch, minibatch_size=64)
        want = local.get_weights()
        diffs, control = [], []
        for learner in group.learners:
            for b, out in ((batch, diffs), (shifted, control)):
                get(learner.call("set_state", state))
                get(learner.call("update_from_batch", b, 64, 1))
                w = get(learner.call("get_weights"))
                out.append(max(float(np.max(np.abs(w[k] - want[k]))) for k in want))
        placement = [get(learner.call("placement")) for learner in group.learners]
        pids = [learner.pid for learner in group.learners]
    finally:
        group.shutdown()
    out = {"part": "shared_learners", "device": device, "start_s": start_s,
           "holders_seen": held, "learner_pids": pids, "placement": placement,
           "param_max_diff": diffs, "control_param_max_diff": control, "limit": PARAM_ATOL}
    bad = []
    if any(d > PARAM_ATOL for d in diffs) or any(d <= PARAM_ATOL for d in control):
        bad.append(f"updates {diffs} (limit {PARAM_ATOL}) or controls {control}")
    if device != "cpu":
        shares = [h for h in ledger.holders()]  # empty: the group is shut down
        halves = [s for s in held if "0.5 of card" in s]
        if len(halves) != 2 or len({s.split("of card ")[1] for s in halves}) != 1 or shares:
            bad.append(f"the learners' leases {held} are not two halves of one card")
        # two policies, a whole card a learner: the second group raises
        cfg = (PPOConfig().environment(functools.partial(MultiAgentCartPole, 2))
               .multi_agent(policies={"p0": None, "p1": None},
                            policy_mapping_fn={"agent_0": "p0", "agent_1": "p1"}.__getitem__)
               .learners(num_learners=1, resources_per_learner={"GPU": 1}))
        refused = None
        try:
            cfg.build(device=device).stop()
        except LedgerError as e:
            refused = str(e)
        out["second_policy_refused"] = refused
        out["holders_after"] = [str(h) for h in ledger.holders()]
        if refused is None or "held by pid" not in refused or out["holders_after"]:
            bad.append(f"the second policy's group was not refused ({refused}) or leases "
                       f"were left {out['holders_after']}")
    out["ok"] = not bad
    out["failed_checks"] = bad
    return out


def grow(device: str = "cuda", num: int = 4, lo: int = 2, depth: int = 16, steps: int = 12,
         every: int = 4, global_batch: int = 8) -> dict:
    """A group of ``num`` (min ``lo``) started while a holder leases
    ``num - lo`` cards; the holder is killed once the first checkpoint is
    in, and the group grows. Then a fixed ``num``-rank run on the same
    global batches."""
    config = _loop_config(device, depth, steps, every, global_batch)
    with _host(device, num) as ledger, tempfile.TemporaryDirectory(prefix="grow-") as storage:
        holder = _lease_holder(device, num - lo)
        seen = [str(h) for h in ledger.holders()]
        trainer = TorchTrainer(ex.train_loop, train_loop_config=config,
                               scaling_config=_scaling(device, num, lo),
                               run_config=RunConfig(name="grow", storage_path=storage))
        box: dict = {}

        def fit():
            try:
                box["result"] = trainer.fit()
            except BaseException as e:  # re-raised below
                box["error"] = e

        t = threading.Thread(target=fit, name="fit", daemon=True)
        t.start()
        killed_at = first_full_at = None
        while t.is_alive():
            c = getattr(trainer, "_controller", None)
            if c is not None and killed_at is None and c.metrics_history and any(
                    "checkpoint_write_s" in m for m in c.metrics_history):
                _kill(holder)
                killed_at = time.time()
            if (c is not None and first_full_at is None
                    and any(m["world_size"] == num for m in c.metrics_history)):
                first_full_at = time.time()
            t.join(0.05)
        if killed_at is None:
            _kill(holder)
        if "error" in box:
            raise box["error"]
        result = box["result"]
        c = trainer._controller
        fixed_config = {**config, "state_checkpoint_every": None}
        fixed = TorchTrainer(ex.train_loop, train_loop_config=fixed_config,
                             scaling_config=_scaling(device, num),
                             run_config=RunConfig(name="fixed", storage_path=storage)).fit()
        h = result.metrics_history
        full = [m for m in h if m["world_size"] == num]
        # the resize's own control: a fixed group of num ranks resumed from
        # the checkpoint the grown group resumed from, on the same batches
        resumed_from = full[0].get("resumed_from") if full else None
        control = None if resumed_from is None else TorchTrainer(
            ex.train_loop, train_loop_config=fixed_config, scaling_config=_scaling(device, num),
            run_config=RunConfig(name="control", storage_path=storage),
            resume_from_checkpoint=Checkpoint(resumed_from)).fit()
        holders_after = [str(h) for h in ledger.holders()]
    part = [m for m in h if m["world_size"] == lo]
    fixed_loss = {m["step"]: m["loss"] for m in fixed.metrics_history}
    resumed = full[0].get("resumed_from_step") if full else None
    tokens = global_batch * config["seq_len"]

    def tok_s(ms):  # the first step of an attempt pays its warm-up
        return tokens / (np.median(ms[1:] or ms) / 1e3) if ms else None

    resize = c.attempts[0] if c.attempts else {}
    out = {
        "part": "grow", "device": device, "layers": ex.model_config(config).n_layers,
        "global_batch": global_batch, "seq_len": config["seq_len"], "every": every,
        "error": result.error, "fixed_error": fixed.error, "holders_seen": seen,
        "attempts": c.attempts, "num_resizes": c.num_resizes,
        "failures": c.failure_policy.failures, "resize_checks": c.resize_checks,
        "world_size_by_step": [(m["step"], m["world_size"]) for m in h],
        "resumed_from_step": resumed,
        "steps_replayed": (max(m["step"] for m in part) - resumed) if part and resumed else None,
        "resize_s": {
            "teardown": resize.get("teardown_s"),
            "spawn_and_rendezvous": c.rank_startup_s[1] if len(c.rank_startup_s) > 1 else None,
            "checkpoint_read": full[0].get("checkpoint_read_s") if full else None,
            "first_step": full[0]["step_ms"] / 1e3 if full else None,
            # the holder's death to the first report at full size (host clock)
            "holder_killed_to_first_full_step": (first_full_at - killed_at
                                                 if first_full_at and killed_at else None),
        },
        "checkpoint_gb": next((m["checkpoint_bytes"] / 1e9 for m in h
                               if "checkpoint_write_s" in m), None),
        "checkpoint_write_s": [m["checkpoint_write_s"] for m in h if "checkpoint_write_s" in m],
        "tokens_per_s": {lo: tok_s([m["step_ms"] for m in part]),
                         num: tok_s([m["step_ms"] for m in full])},
        "fixed_tokens_per_s": tok_s([m["step_ms"] for m in fixed.metrics_history]),
        "losses": [m["loss"] for m in h],
        "fixed_losses": [fixed_loss.get(s) for s in range(1, steps + 1)],
        "loss_rel_diff_after_resize": [abs(m["loss"] - fixed_loss[m["step"]])
                                       / abs(fixed_loss[m["step"]]) for m in full],
        "loss_rel_diff_before_resize": [abs(m["loss"] - fixed_loss[m["step"]])
                                        / abs(fixed_loss[m["step"]]) for m in part],
        "limit": LOSS_RTOL, "holders_after": holders_after,
    }
    control_loss = {m["step"]: m["loss"] for m in (control.metrics_history if control else [])}
    out["control_error"] = control.error if control else "no resize to control"
    out["loss_rel_diff_vs_control"] = [abs(m["loss"] - control_loss[m["step"]])
                                       / abs(control_loss[m["step"]])
                                       for m in full if m["step"] in control_loss]
    bad = []
    if result.error is not None or fixed.error is not None:
        bad.append(f"a fit failed: {result.error} / {fixed.error}")
    if ([a["size"] for a in c.attempts] != [lo, num] or c.num_resizes != 1
            or c.failure_policy.failures):
        bad.append(f"not one resize {lo} -> {num} without a failure: {c.attempts}")
    if not full or resumed is None or out["steps_replayed"] is None \
            or out["steps_replayed"] > every or h[-1]["step"] != steps:
        bad.append("the grown group did not resume from the latest checkpoint to the end")
    if any(d > LOSS_RTOL for d in out["loss_rel_diff_after_resize"]):
        bad.append(f"losses after the resize beyond {LOSS_RTOL} of the fixed run")
    if (out["control_error"] is not None or len(out["loss_rel_diff_vs_control"]) != len(full)
            or any(d > LOSS_RTOL for d in out["loss_rel_diff_vs_control"])):
        bad.append(f"losses after the resize beyond {LOSS_RTOL} of the fixed run resumed "
                   f"from the same checkpoint ({out['control_error']})")
    L = out["layers"]
    if not _launches_ok(h, L, device):
        bad.append("attention launches not 2L/L/L a step")
    if holders_after:
        bad.append(f"leases left: {holders_after}")
    out["ok"] = not bad
    out["failed_checks"] = bad
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="gloo ranks, tiny model (rehearsal)")
    ap.add_argument("--one-card", action="store_true", help="the smoke's one-card parts")
    ap.add_argument("--depth", type=int, default=16, help="layers of the grow run")
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--every", type=int, default=4, help="state checkpoint every k steps")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    card = "cpu (no device numbers)"
    if not args.cpu:
        import torch

        from ray_tpu_torch.tools.decode_profile import card as nvidia_smi

        if not torch.cuda.is_available():
            raise SystemExit("elastic_bench: no CUDA device (pass --cpu to rehearse)")
        card = f"{torch.cuda.get_device_name(0)} ({nvidia_smi()})"
        torch.backends.cuda.matmul.allow_tf32 = False
    # the tiny model's steps take milliseconds: on the CPU many more of them
    # give the controller's resize checks (0.5 s apart) time to run
    scale = 20 if args.cpu else 1
    parts = []
    if args.one_card or args.cpu:
        parts += [capped_start(device, steps=6 * scale, every=2 * scale),
                  ledger_on_card(device), shared_learners(device)]
    if not args.one_card:
        parts.append(grow(device, depth=args.depth, steps=args.steps * scale,
                          every=args.every * scale))
    for out in parts:
        print(json.dumps({**out, "card": card}, default=str), flush=True)
    return 0 if all(p["ok"] for p in parts) else 1


if __name__ == "__main__":
    raise SystemExit(main())
