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

Runs in fp32 with TF32 off (cuDNN's convs default to TF32). Prints one
JSON line per part; the last line is the card's nvidia-smi name and power
limit.
"""

from __future__ import annotations

import argparse
import json
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
    learner = group.learner
    placement = sorted({p.device.type for p in learner.module.params.values()}
                       | {t.device.type for m in ("mu", "nu") for t in learner.opt_state[m].values()})
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="rehearse on the CPU (no card)")
    ap.add_argument("--iters", type=int, default=25)
    args = ap.parse_args(argv)
    dev = "cpu" if args.cpu else None
    # fp32 against fp32: cuDNN's convs default to TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps(ppo_train("CartPole-v1", dev, args.iters)), flush=True)
    print(json.dumps(ppo_train("MiniBreakout-v0", dev, min(args.iters, 5))), flush=True)
    for name in ALGOS:
        run = update_runs(name, dev)
        cpu = update_runs(name, "cpu")
        print(json.dumps({"algo": name, **agreement(run, cpu), "update_ms": run["update_ms"],
                          "cpu_update_ms": cpu["update_ms"]}), flush=True)
    if not args.cpu:
        from ray_tpu_torch.tools.decode_profile import card

        print(json.dumps({"profile_ppo_update": profile_update()}), flush=True)
        print(card(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
