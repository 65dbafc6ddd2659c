"""The RL stack on one device: PPO's training loop, and every algorithm's
update on the card held against the same update on the CPU.

    python -m ray_tpu_torch.tools.rllib_bench              # the card
    python -m ray_tpu_torch.tools.rllib_bench --cpu --iters 3   # rehearsal

``ppo_train`` runs ``PPOConfig().build(device)`` through ``Algorithm.train``
(CartPole-v1 at ``tests/test_rllib.py:48-69``'s settings: 8 envs x 128
steps, minibatch 256, 8 epochs, lr 1e-3, hidden (64, 64); or
MiniBreakout-v0 at ``:821-835``'s, the conv torso ((16, 4, 2), (32, 3, 2))
with hidden 128) and times the env runner's sample (host clock; the
runner's module is on the CPU by design) and the learner's
``update_from_batch`` (CUDA events on the card, which it ends by reading
the stats to the host).

``update_runs`` builds one algorithm (PPO vector and conv, DQN, IMPALA,
APPO, BC, MARWIL, SAC) at its own default widths on a device, from the
seeded init (drawn on the host, so equal on every device), and runs its
update 3 times on fixed numpy batches: the losses and the parameters
after. ``control=True`` shifts the batches' actions by one row.
``update_ms`` then times 20 more updates (CUDA events on the card, the
host clock on the CPU). ``profile_update`` counts the CUDA kernels of one
PPO minibatch update and the device's busy share of its span.

The remote half (``--remote``, or alone with ``--remote-only``):
``async_train`` runs IMPALA or APPO through ``Algorithm.train`` at
``tests/test_rllib.py:270-328``'s settings (2 runner processes x 4 envs x
50 steps, lr 5e-4, 8 batches an iteration, entropy 0.01) with the V-trace
update on the device: env steps/s, the update's ms (CUDA events on the
card) and the share of each iteration spent waiting in ``_next_batch``
(host clock), which says whether sampling overlaps the updates.
``runner_replacement`` SIGKILLs one of PPO's two runner processes between
iterations and times its replacement. ``remote_learner`` holds one
``update_from_batch`` of a learner process (``num_learners=1``) against a
local learner on the same device from the same state, with the
shifted-actions control, and times the remote round trip (update, get,
average, set) beside the local update. ``sac_remote`` runs SAC on
Reach-v0 with 2 runner processes, saves and restores. ``learner_scaling``
(``--learners 1 2 4``, one card a learner) times PPO's CartPole learner
step on 1, 2 and 4 learner processes beside the local learner.
``local_iterations`` (``--local-iterations``) times the iterations of
IMPALA without runners, DQN and BC on a local learner, whose parameters
go to and from the learner group as host copies each iteration; run as a
file with another checkout first on ``PYTHONPATH``, it times that
checkout's package the same way:

    PYTHONPATH=<checkout> python ray_tpu_torch/tools/rllib_bench.py --local-iterations

Runs in fp32 with TF32 off (cuDNN's convs default to TF32). Prints one
JSON line per part; the last line is the card's nvidia-smi name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import shutil
import signal
import tempfile
import time

import numpy as np
import torch

ALGOS = ("ppo", "ppo_conv", "dqn", "impala", "appo", "bc", "marwil", "sac")

# the CPU tests' limits (tests/test_torch_rllib*.py): losses rtol 1e-5 /
# atol 1e-6, parameters after 3 updates 1e-5 absolute
LOSS_RTOL, LOSS_ATOL, PARAM_ATOL = 1e-5, 1e-6, 1e-5


class _Clock:
    """Elapsed ms of a region: CUDA events on the card, the host clock
    otherwise (the region must end with the device idle or synced)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def __enter__(self):
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
            self.start.record()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self.end.record()
            self.end.synchronize()
            self.ms = self.start.elapsed_time(self.end)
        else:
            self.ms = (time.perf_counter() - self.t0) * 1e3


def ppo_train(env_id: str, device, iters: int, seed: int = 0) -> dict:
    """PPO through ``Algorithm.train`` for ``iters`` iterations; per
    iteration its sample seconds, learner ms and result."""
    from ray_tpu_torch import resolve_device
    from ray_tpu_torch.rllib import PPOConfig

    device = resolve_device(device)
    cfg = (PPOConfig().environment(env_id)
           .env_runners(num_env_runners=0, num_envs_per_env_runner=8, rollout_fragment_length=128)
           .debugging(seed=seed))
    if env_id == "CartPole-v1":
        cfg.training(lr=1e-3, minibatch_size=256, num_epochs=8, entropy_coeff=0.01,
                     vf_clip_param=100.0)
    else:
        cfg.training(lr=1e-3, minibatch_size=256, num_epochs=4)
    algo = cfg.build(device=device)
    group, runners = algo.learner_group, algo.env_runner_group
    sample_s, learn_ms = [], []
    sample, update = runners.sample, group.update_from_batch

    def timed_sample(*a, **k):
        t0 = time.perf_counter()
        out = sample(*a, **k)
        sample_s.append(time.perf_counter() - t0)
        return out

    def timed_update(*a, **k):
        with _Clock(device) as c:
            out = update(*a, **k)
        learn_ms.append(c.ms)
        return out

    runners.sample, group.update_from_batch = timed_sample, timed_update
    results = []
    t0 = time.perf_counter()
    for _ in range(iters):
        results.append(algo.train())
    wall = time.perf_counter() - t0
    returns = [r["episode_return_mean"] for r in results]
    seen = [m for m in returns if not np.isnan(m)]
    steps = results[0]["num_env_steps_sampled"]
    c = algo.config
    updates = c.num_epochs * (steps // c.minibatch_size)
    placement = group.placement()
    algo.stop()
    return {
        "env": env_id, "device": str(device), "iterations": iters, "env_steps_per_iter": steps,
        "arch": {"hidden": list(algo.module_spec.hidden),
                 "conv_filters": [list(f) for f in algo.module_spec.conv_filters]},
        "wall_s": wall,
        "env_steps_per_s": steps * iters / sum(sample_s),
        "sample_s_median": float(np.median(sample_s)),
        "learner_ms_median": float(np.median(learn_ms)),
        "updates_per_iter": updates,
        "update_ms_median": float(np.median(learn_ms)) / updates,
        "return_first": seen[0] if seen else None, "return_last": seen[-1] if seen else None,
        "returns": returns,
        "losses": [r["learner"]["total_loss"] for r in results],
        "learner_tensors_on": placement,
    }


def _rows(seed: int):
    from ray_tpu_torch.rllib import ExperienceRows

    rng = np.random.default_rng(seed)
    return ExperienceRows([{"obs": rng.normal(size=4).astype(np.float32),
                            "actions": int(rng.integers(0, 2)),
                            "advantages": float(rng.normal())} for _ in range(512)])


def _batches(name: str, n: int, control: bool) -> list:
    """``n`` fixed numpy batches at the algorithm's default shapes."""
    out = []
    for i in range(n):
        rng = np.random.default_rng(100 + i)
        if name in ("ppo", "ppo_conv"):
            B = 256
            obs = (rng.random((B, 24, 24, 1), dtype=np.float32) if name == "ppo_conv"
                   else rng.normal(size=(B, 4)).astype(np.float32))
            b = {"obs": obs, "actions": rng.integers(0, 3 if name == "ppo_conv" else 2, B),
                 "logp_old": rng.normal(-0.8, 0.2, B).astype(np.float32),
                 "advantages": rng.normal(size=B).astype(np.float32),
                 "value_targets": rng.normal(size=B).astype(np.float32)}
        elif name == "dqn":
            B = 64
            b = {"obs": rng.normal(size=(B, 4)).astype(np.float32),
                 "actions": rng.integers(0, 2, B), "rewards": rng.normal(size=B).astype(np.float32),
                 "next_obs": rng.normal(size=(B, 4)).astype(np.float32),
                 "terminals": (rng.random(B) < 0.1).astype(np.float32)}
        elif name in ("impala", "appo"):
            T, N = 50, 8  # a fragment of 50 steps x 8 envs
            ends = rng.random((T, N)) < 0.05
            b = {"obs": rng.normal(size=(T, N, 4)).astype(np.float32),
                 "next_obs": rng.normal(size=(T, N, 4)).astype(np.float32),
                 "actions": rng.integers(0, 2, (T, N)),
                 "rewards": np.ones((T, N), np.float32),
                 "terminals": (ends & (rng.random((T, N)) < 0.5)).astype(np.float32),
                 "ends": ends.astype(np.float32),
                 "logp_behavior": np.log(rng.uniform(0.3, 0.7, (T, N))).astype(np.float32)}
        elif name in ("bc", "marwil"):
            B = 256
            b = {"obs": rng.normal(size=(B, 4)).astype(np.float32),
                 "actions": rng.integers(0, 2, B),
                 "advantages": rng.normal(size=B).astype(np.float32)}
        else:  # sac, Pendulum-v1: obs 3, action 1
            B = 128
            b = {"obs": rng.normal(size=(B, 3)).astype(np.float32),
                 "actions": rng.uniform(-1, 1, (B, 1)).astype(np.float32),
                 "rewards": rng.normal(size=B).astype(np.float32),
                 "next_obs": rng.normal(size=(B, 3)).astype(np.float32),
                 "terminals": np.zeros(B, np.float32),
                 "eps_next": rng.normal(size=(B, 1)).astype(np.float32),
                 "eps_actor": rng.normal(size=(B, 1)).astype(np.float32)}
        if control:
            b["actions"] = np.roll(b["actions"], 1, axis=0)
        out.append(b)
    return out


def _algorithm(name: str, device):
    """(step(batch on device) -> loss, params() -> flat dict of tensors)."""
    from ray_tpu_torch.rllib import (APPOConfig, BCConfig, DQNConfig, IMPALAConfig,
                                     MARWILConfig, PPOConfig, SACConfig)

    def small(cfg, env="CartPole-v1"):
        return (cfg.environment(env).env_runners(num_env_runners=0, rollout_fragment_length=8)
                .debugging(seed=0))

    if name in ("ppo", "ppo_conv"):
        algo = small(PPOConfig(), "MiniBreakout-v0" if name == "ppo_conv" else "CartPole-v1")
        learner = algo.build(device=device).learner_group.learner
        return (lambda b: learner._update(learner.module.params, learner.opt_state, b)[2]
                ["total_loss"], lambda: dict(learner.module.params))
    if name == "dqn":
        algo = small(DQNConfig()).build(device=device)
        opt = algo.optimizer.init(algo._params)
        return (lambda b: algo._update_fn(algo._params, opt, algo._target, b)[2],
                lambda: dict(algo._params))
    if name in ("impala", "appo"):
        algo = small(IMPALAConfig() if name == "impala" else APPOConfig()).build(device=device)
        return (lambda b: algo._update_fn(algo._params, algo._opt_state, b)[2],
                lambda: dict(algo._params))
    if name in ("bc", "marwil"):
        cfg = BCConfig() if name == "bc" else MARWILConfig()
        algo = small(cfg).offline_data(_rows(0)).build(device=device)
        return (lambda b: algo._update_fn(algo._params, algo._opt_state, b)[2],
                lambda: dict(algo._params))
    algo = (SACConfig().environment("Pendulum-v1").env_runners(num_env_runners=0)
            .debugging(seed=0).build(device=device))

    def sac_step(b):
        b = dict(b)
        e1, e2 = b.pop("eps_next"), b.pop("eps_actor")
        algo._state, algo._opt_state, closs, aloss, _ = algo._update_fn(
            algo._state, algo._opt_state, b, e1, e2)
        return closs + aloss

    def sac_params():
        s = algo._state
        return {f"{net}.{k}": v for net in ("actor", "q1", "q2", "q1_target", "q2_target")
                for k, v in s[net].items()} | {"log_alpha": s["log_alpha"]}

    return sac_step, sac_params


def update_runs(name: str, device, control: bool = False, timed: int = 20) -> dict:
    """Three checked updates of ``name`` on ``device``, then ``timed``
    more, timed. Returns the losses, the parameters (host copies) and the
    update's ms."""
    from ray_tpu_torch import resolve_device
    from ray_tpu_torch.rllib.core.learner import to_device

    device = resolve_device(device)
    step, params = _algorithm(name, device)
    batches = [to_device(b, device) for b in _batches(name, 3 + timed, control)]
    losses = [float(step(b)) for b in batches[:3]]
    after = {k: v.detach().cpu().numpy().copy() for k, v in params().items()}
    step(batches[3])  # warm
    with _Clock(device) as c:
        for b in batches[3:]:
            step(b)
    return {"losses": losses, "params": after, "update_ms": c.ms / timed}


def agreement(card: dict, cpu: dict) -> dict:
    """The card's run against the CPU's: the losses' largest relative
    difference, the parameters' largest absolute one, and whether both are
    within the CPU tests' limits."""
    loss_rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(card["losses"], cpu["losses"]))
    loss_ok = all(abs(a - b) <= LOSS_ATOL + LOSS_RTOL * abs(b)
                  for a, b in zip(card["losses"], cpu["losses"]))
    diffs = {k: float(np.max(np.abs(card["params"][k] - cpu["params"][k])))
             for k in cpu["params"]}
    worst = max(diffs, key=diffs.get)
    return {"loss_rel_diff": loss_rel, "param_max_diff": diffs[worst], "param_worst": worst,
            "ok": loss_ok and diffs[worst] <= PARAM_ATOL}


def profile_update(device="cuda", n: int = 10) -> dict:
    """CUDA kernels of one PPO minibatch update (CartPole width, 256 rows)
    and the device's busy share of the updates' span (profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.rllib.core.learner import to_device

    step, _ = _algorithm("ppo", torch.device(device))
    batches = [to_device(b, device) for b in _batches("ppo", n + 2, False)]
    for b in batches[:2]:
        step(b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for b in batches[2:]:
            step(b)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return {"kernels_per_update": None, "note": "the profiler saw no device events"}
    busy_us = sum(e.device_time for e in kernels)
    span_us = max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels)
    return {"kernels_per_update": len(kernels) / n, "device_busy_us_per_update": busy_us / n,
            "span_us_per_update": span_us / n, "busy_share": busy_us / span_us}


def _children() -> set:
    return {p.pid for p in multiprocessing.active_children()}


def async_train(name: str, device, iters: int, seed: int = 0) -> dict:
    """IMPALA (``name="impala"``) or APPO over 2 runner processes for
    ``iters`` iterations; per iteration its host seconds, the updates' ms
    and the seconds spent waiting for a runner's fragment."""
    from ray_tpu_torch import resolve_device
    from ray_tpu_torch.rllib import APPOConfig, IMPALAConfig

    device = resolve_device(device)
    cfg = (IMPALAConfig() if name == "impala" else APPOConfig()).environment("CartPole-v1")
    cfg.env_runners(num_env_runners=2, num_envs_per_env_runner=4, rollout_fragment_length=50)
    cfg.training(lr=5e-4, num_batches_per_iteration=8, entropy_coeff=0.01).debugging(seed=seed)
    algo = cfg.build(device=device)
    wait_s, update_ms = [], []
    next_batch, update = algo._next_batch, algo._update

    def timed_next(*a, **k):
        t0 = time.perf_counter()
        out = next_batch(*a, **k)
        wait_s.append(time.perf_counter() - t0)
        return out

    def timed_update(out):
        with _Clock(device) as c:
            loss = update(out)
        update_ms.append(c.ms)
        return loss

    algo._next_batch, algo._update = timed_next, timed_update
    results, iter_s = [], []
    try:
        t0 = time.perf_counter()
        for _ in range(iters):
            t = time.perf_counter()
            results.append(algo.train())
            iter_s.append(time.perf_counter() - t)
        wall = time.perf_counter() - t0
        placement = sorted({t.device.type for tree in (algo._params, algo._opt_state["mu"],
                                                       algo._opt_state["nu"])
                            for t in tree.values()})
    finally:
        algo.stop()
    returns = [r["episode_return_mean"] for r in results]
    seen = [m for m in returns if not np.isnan(m)]
    steps = sum(r["num_env_steps_sampled"] for r in results)
    return {
        "algo": name, "env": "CartPole-v1", "device": str(device), "iterations": iters,
        "runners": 2, "envs_per_runner": 4, "fragment": 50, "batches_per_iter": 8,
        "wall_s": wall, "env_steps": steps, "env_steps_per_s": steps / wall,
        "update_ms_median": float(np.median(update_ms)),
        "update_ms_total": float(np.sum(update_ms)),
        "wait_share": float(np.sum(wait_s) / np.sum(iter_s)),
        "iter_s_median": float(np.median(iter_s)),
        "in_flight": [r["num_in_flight_samples"] for r in results],
        "return_first": seen[0] if seen else None, "return_last": seen[-1] if seen else None,
        "returns": returns, "losses": [r["learner"]["total_loss"] for r in results],
        "update_tensors_on": placement,
    }


def runner_replacement(device, seed: int = 0) -> dict:
    """PPO over 2 runner processes: one iteration, SIGKILL runner 0, two
    more. The healthy runners each iteration reports, the pids, and the
    seconds from ``replace_runner`` to the new process answering."""
    from ray_tpu_torch._private.process_actor import get
    from ray_tpu_torch.rllib import PPOConfig

    algo = (PPOConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=4, rollout_fragment_length=50)
            .training(minibatch_size=64, num_epochs=2).debugging(seed=seed).build(device=device))
    group = algo.env_runner_group
    replace, replaced_s = group.replace_runner, []

    def timed_replace(i):
        t0 = time.perf_counter()
        runner = replace(i)
        get(runner.ready)
        replaced_s.append(time.perf_counter() - t0)
        return runner

    group.replace_runner = timed_replace
    try:
        results = [algo.train()]
        old = group.runners[0].pid
        os.kill(old, signal.SIGKILL)
        results += [algo.train(), algo.train()]
        new = group.runners[0].pid
    finally:
        algo.stop()
    return {"healthy": [r["env_runners"]["num_healthy_runners"] for r in results],
            "iter_s": [r["time_this_iter_s"] for r in results],
            "old_pid": old, "new_pid": new, "replacement_s": replaced_s}


def remote_learner(device, repeats: int = 5) -> dict:
    """A learner process (``num_learners=1``) and a local learner on
    ``device`` from the same state: one ``update_from_batch`` each on the
    same 256-row CartPole batch (minibatch 64), the weights' largest
    difference; then each timed ``repeats`` times (host clock: both end
    with their stats on the host); then the control, the process given the
    batch with its actions shifted one row; and the kernel launches
    counted in the learner process."""
    from ray_tpu_torch import resolve_device
    from ray_tpu_torch._private.process_actor import get
    from ray_tpu_torch.ops import launch_counts
    from ray_tpu_torch.rllib import LearnerGroup, RLModuleSpec

    device = resolve_device(device)
    spec = RLModuleSpec(observation_dim=4, action_dim=2, hidden=(64, 64))
    kwargs = dict(lr=1e-3, seed=0)
    local = LearnerGroup(spec, learner_kwargs=kwargs, device=device)
    t0 = time.perf_counter()
    remote = LearnerGroup(spec, num_learners=1, learner_kwargs=kwargs, device=device)
    start_s = time.perf_counter() - t0
    batch, = _batches("ppo", 1, False)
    shifted, = _batches("ppo", 1, True)

    def diff():
        a, b = local.get_weights(), remote.get_weights()
        return max(float(np.max(np.abs(a[k] - b[k]))) for k in a)

    try:
        remote.set_state(local.get_state())
        local.update_from_batch(batch, minibatch_size=64)
        remote.update_from_batch(batch, minibatch_size=64)
        param_diff = diff()
        local_ms, remote_ms = [], []
        for _ in range(repeats):
            t = time.perf_counter()
            local.update_from_batch(batch, minibatch_size=64)
            local_ms.append((time.perf_counter() - t) * 1e3)
            t = time.perf_counter()
            remote.update_from_batch(batch, minibatch_size=64)
            remote_ms.append((time.perf_counter() - t) * 1e3)
        remote.set_state(local.get_state())
        local.update_from_batch(batch, minibatch_size=64)
        remote.update_from_batch(shifted, minibatch_size=64)
        control_diff = diff()
        remote_on = remote.placement()
        process_launches = get(remote.learners[0].call(launch_counts))
    finally:
        remote.shutdown()
    return {"device": str(device), "param_max_diff": param_diff, "limit": PARAM_ATOL,
            "ok": param_diff <= PARAM_ATOL, "control_param_max_diff": control_diff,
            "control_ok": control_diff <= PARAM_ATOL, "remote_tensors_on": remote_on,
            "process_launches": process_launches,
            "remote_start_s": start_s, "updates_per_call": 4,
            "remote_round_trip_ms_median": float(np.median(remote_ms)),
            "local_update_ms_median": float(np.median(local_ms))}


def learner_scaling(device, ks, repeats: int = 5) -> list:
    """PPO's CartPole learner step (``ppo_train``'s: 1,024 rows, minibatch
    256, 8 epochs) on ``k`` learner processes for each ``k`` in ``ks``, one
    card each, beside the local learner: the round trip of
    ``update_from_batch`` (host clock), median of ``repeats`` after a warm
    call, and each group's start seconds."""
    from ray_tpu_torch.rllib import LearnerGroup, RLModuleSpec

    spec = RLModuleSpec(observation_dim=4, action_dim=2, hidden=(64, 64))
    batch = {k: np.concatenate([b[k] for b in _batches("ppo", 4, False)])
             for k in _batches("ppo", 1, False)[0]}
    rows = []
    for k in (0, *ks):
        t0 = time.perf_counter()
        group = LearnerGroup(spec, num_learners=k, learner_kwargs=dict(lr=1e-3, seed=0),
                             device=device)
        start_s = time.perf_counter() - t0
        try:
            group.update_from_batch(batch, minibatch_size=256, num_epochs=8)
            ms = []
            for _ in range(repeats):
                t = time.perf_counter()
                group.update_from_batch(batch, minibatch_size=256, num_epochs=8)
                ms.append((time.perf_counter() - t) * 1e3)
            on = group.placement()
        finally:
            group.shutdown()
        rows.append({"num_learners": k, "rows_per_learner": len(batch["obs"]) // max(k, 1),
                     "update_from_batch_ms_median": float(np.median(ms)), "start_s": start_s,
                     "tensors_on": on})
    return rows


def sac_remote(device, seed: int = 0) -> dict:
    """SAC on Reach-v0 over 2 runner processes, 4 iterations of 20
    updates; then ``save``, and ``restore`` into a new algorithm."""
    from ray_tpu_torch.rllib import SACConfig

    cfg = (SACConfig().environment("Reach-v0")
           .env_runners(num_env_runners=2, rollout_fragment_length=100)
           .training(num_updates_per_iteration=20).debugging(seed=seed))
    path = tempfile.mkdtemp(prefix="rllib_sac_")
    try:
        algo = cfg.build(device=device)
        try:
            t0 = time.perf_counter()
            results = [algo.train() for _ in range(4)]
            wall = time.perf_counter() - t0
            algo.save(os.path.join(path, "ckpt"))
            before = algo.get_state()["sac"]["log_alpha"]
        finally:
            algo.stop()
        algo2 = cfg.build(device=device)
        try:
            algo2.restore(os.path.join(path, "ckpt"))
            after = algo2.get_state()["sac"]["log_alpha"]
            algo2.train()
        finally:
            algo2.stop()
    finally:
        shutil.rmtree(path, ignore_errors=True)
    return {"replay_size": results[-1]["replay_size"], "wall_s": wall,
            "learner": results[-1]["learner"], "log_alpha": float(before),
            "restored_log_alpha": float(after),
            "log_alpha_equal": bool(np.array_equal(before, after))}


def local_iterations(device, iters: int, warm: int = 3) -> dict:
    """``Algorithm.train`` of the algorithms that keep parameters of their
    own beside a local learner on ``device``, by the host clock (each
    iteration ends reading its loss): IMPALA without runner processes (a
    200-step fragment and one V-trace update), DQN (200 steps sampled and
    64 updates) and BC (50 updates, no evaluation). The median ms of
    ``iters`` iterations after ``warm``. Uses nothing but the public
    configs, so it times another checkout of the package too."""
    import ray_tpu_torch
    from ray_tpu_torch import resolve_device
    from ray_tpu_torch.rllib import BCConfig, DQNConfig, IMPALAConfig, record_experience

    device = resolve_device(device)
    configs = {
        "impala_sync": IMPALAConfig().training(lr=5e-4, entropy_coeff=0.01),
        "dqn": DQNConfig().training(num_steps_sampled_before_learning_starts=200),
        "bc": BCConfig().offline_data(record_experience(
            "CartPole-v1", num_fragments=4, num_envs=4, rollout_fragment_length=50))
        .training(evaluation_interval=0),
    }
    out = {}
    for name, cfg in configs.items():
        cfg.environment("CartPole-v1").debugging(seed=0)
        cfg.env_runners(num_env_runners=0, num_envs_per_env_runner=4, rollout_fragment_length=50)
        algo = cfg.build(device=device)
        ms = []
        try:
            for i in range(warm + iters):
                t = time.perf_counter()
                algo.train()
                if i >= warm:
                    ms.append((time.perf_counter() - t) * 1e3)
        finally:
            algo.stop()
        out[name] = {"iteration_ms_median": float(np.median(ms)), "iteration_ms": ms}
    return {"device": str(device), "package": os.path.dirname(ray_tpu_torch.__file__),
            "iterations": iters, **out}


def remote_parts(device, iters: int) -> dict:
    """Every remote part above, and whether any of their processes is left
    after each ``stop``."""
    before = _children()
    out = {}
    for name, run in (("impala", lambda: async_train("impala", device, iters)),
                      ("appo", lambda: async_train("appo", device, iters)),
                      ("replacement", lambda: runner_replacement(device)),
                      ("remote_learner", lambda: remote_learner(device)),
                      ("sac", lambda: sac_remote(device))):
        t0 = time.perf_counter()
        out[name] = run()
        out[name]["seconds"] = time.perf_counter() - t0
        out[name]["children_left"] = sorted(_children() - before)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="rehearse on the CPU (no card)")
    ap.add_argument("--iters", type=int, default=25)
    ap.add_argument("--remote", action="store_true", help="also the remote half")
    ap.add_argument("--remote-only", action="store_true", help="only the remote half")
    ap.add_argument("--learners", type=int, nargs="+",
                    help="only PPO's learner step on this many learner processes, one card each")
    ap.add_argument("--local-iterations", action="store_true",
                    help="only IMPALA's (no runners), DQN's and BC's iterations on a local learner")
    args = ap.parse_args(argv)
    dev = "cpu" if args.cpu else None
    # fp32 against fp32: cuDNN's convs default to TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.local_iterations:
        print(json.dumps({"local_iterations": local_iterations(dev, args.iters)}), flush=True)
    elif args.learners:
        for row in learner_scaling(dev, args.learners):
            print(json.dumps({"learner_scaling": row}), flush=True)
    elif args.remote or args.remote_only:
        for name, part in remote_parts(dev, args.iters).items():
            print(json.dumps({"remote": name, **part}), flush=True)
    if not (args.remote_only or args.learners or args.local_iterations):
        local_parts(dev, args.iters)
    if not args.cpu:
        from ray_tpu_torch.tools.decode_profile import card

        print(card(), flush=True)
    return 0


def local_parts(dev, iters: int) -> None:
    print(json.dumps(ppo_train("CartPole-v1", dev, iters)), flush=True)
    print(json.dumps(ppo_train("MiniBreakout-v0", dev, min(iters, 5))), flush=True)
    for name in ALGOS:
        run = update_runs(name, dev)
        cpu = update_runs(name, "cpu")
        print(json.dumps({"algo": name, **agreement(run, cpu), "update_ms": run["update_ms"],
                          "cpu_update_ms": cpu["update_ms"]}), flush=True)
    if dev is None:
        print(json.dumps({"profile_ppo_update": profile_update()}), flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
