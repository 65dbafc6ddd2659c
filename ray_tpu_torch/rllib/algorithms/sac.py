"""SAC: soft actor-critic for continuous control.

Counterpart of ``ray_tpu/rllib/algorithms/sac.py`` (reference:
``rllib/algorithms/sac/sac.py``: tanh-squashed Gaussian actor, twin Q
critics with target networks, automatic entropy-temperature tuning against
``target_entropy = -|A|``). The nets are dicts of tensors on the learner's
device (JAX's names and [in, out] layouts); one update runs the critic
step, then the actor step against the critics AFTER their update, then the
alpha step and the Polyak averaging, in that order.

The normal draws of ``sample_action`` come from an explicit
``torch.Generator`` or are passed in (``eps``), so a test can feed JAX's
draws. The actor's env runner samples on the CPU, with a CPU copy of the
actor's weights: in this process, or with ``num_env_runners > 0`` in runner
processes seeded ``seed + i`` (``_private/process_actor.py``), each
collecting a fragment per iteration.
"""

from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._private.process_actor import ProcessActor, get, start_all
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.dqn import ReplayBuffer
from ray_tpu_torch.rllib.core.learner import adam, grad_step, host_copy, to_device
from ray_tpu_torch.rllib.env.continuous import make_continuous_env

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0


def _mlp_init(gen: torch.Generator, sizes, device="cpu") -> dict:
    """normal / sqrt(fan_in) weights [in, out], zero biases (the JAX init's
    distributions, drawn from ``gen`` on the host)."""
    params = {}
    for i in range(len(sizes) - 1):
        w = torch.randn((sizes[i], sizes[i + 1]), generator=gen) / np.sqrt(sizes[i])
        params[f"w{i}"] = w.to(device)
        params[f"b{i}"] = torch.zeros(sizes[i + 1], device=device)
    return params


def _mlp(params, x, n_layers):
    for i in range(n_layers - 1):
        x = torch.tanh(torch.addmm(params[f"b{i}"], x, params[f"w{i}"]))
    return torch.addmm(params[f"b{n_layers - 1}"], x, params[f"w{n_layers - 1}"])


def actor_dist(params, obs, n_layers):
    """(mu, log_std) of the pre-squash Gaussian."""
    mu, log_std = torch.chunk(_mlp(params, obs, n_layers), 2, dim=-1)
    return mu, torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)


def sample_action(params, obs, n_layers, eps: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None):
    """tanh-squashed sample + its log-prob (change-of-variables corrected).
    ``eps`` is the standard normal draw [B, A]; without it one is drawn
    from ``generator``."""
    mu, log_std = actor_dist(params, obs, n_layers)
    std = torch.exp(log_std)
    if eps is None:
        eps = torch.randn(mu.shape, generator=generator, device=mu.device, dtype=mu.dtype)
    pre = mu + std * eps
    act = torch.tanh(pre)
    logp = torch.sum(-0.5 * (eps**2 + 2 * log_std + np.log(2 * np.pi)), dim=-1)
    # tanh correction: log det of d tanh(u)/du (stable form)
    logp = logp - torch.sum(2.0 * (np.log(2.0) - pre - F.softplus(-2.0 * pre)), dim=-1)
    return act, logp


class ContinuousEnvRunner:
    """Steps a continuous env with the current actor weights, on the CPU
    (same role as SingleAgentEnvRunner for the discrete stack)."""

    def __init__(self, env_id: str, hidden, seed: int = 0):
        self.env = make_continuous_env(env_id)
        self.obs_dim = int(np.prod(self.env.observation_space.shape))
        self.act_dim = int(np.prod(self.env.action_space.shape))
        self.scale = np.asarray(self.env.action_space.high, np.float32)
        self.n_layers = len(hidden) + 1
        self._params = _mlp_init(torch.Generator().manual_seed(seed),
                                 [self.obs_dim, *hidden, 2 * self.act_dim])
        self._gen = torch.Generator().manual_seed(seed + 1)
        self._rng = np.random.default_rng(seed)
        self._obs, _ = self.env.reset(seed=seed)
        self._ep_ret = 0.0
        self.completed: "deque[float]" = deque(maxlen=200)

    def set_weights(self, params: dict) -> bool:
        self._params = {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v
                                           ).detach().to("cpu", torch.float32)
                        for k, v in params.items()}
        return True

    @torch.no_grad()
    def collect(self, n_steps: int, random_actions: bool = False) -> dict:
        T = n_steps
        obs_b = np.zeros((T, self.obs_dim), np.float32)
        act_b = np.zeros((T, self.act_dim), np.float32)
        rew_b = np.zeros(T, np.float32)
        next_b = np.zeros((T, self.obs_dim), np.float32)
        term_b = np.zeros(T, np.float32)
        for t in range(T):
            o = np.asarray(self._obs, np.float32).reshape(-1)
            if random_actions:
                a = self._rng.uniform(-1.0, 1.0, self.act_dim).astype(np.float32)
            else:
                a, _ = sample_action(self._params, torch.from_numpy(o[None]), self.n_layers,
                                     generator=self._gen)
                a = a[0].numpy()
            o2, r, term, trunc, _ = self.env.step(a * self.scale)
            obs_b[t], act_b[t], rew_b[t] = o, a, r
            next_b[t] = np.asarray(o2, np.float32).reshape(-1)
            term_b[t] = float(term)
            self._ep_ret += r
            if term or trunc:
                self.completed.append(float(self._ep_ret))
                self._ep_ret = 0.0
                o2, _ = self.env.reset()
            self._obs = o2
        recent = list(self.completed)[-50:]
        return {
            "batch": {
                "obs": obs_b,
                "actions": act_b,
                "rewards": rew_b,
                "next_obs": next_b,
                "terminals": term_b,
            },
            "metrics": {
                "episode_return_mean": (
                    float(np.mean(recent)) if recent else float("nan")
                ),
                "num_env_steps": T,
            },
        }


class SACConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=SAC)
        self.actor_lr = 3e-4
        self.critic_lr = 3e-4
        self.alpha_lr = 3e-4
        self.tau = 0.005
        self.initial_alpha = 1.0
        self.target_entropy: Optional[float] = None  # default -|A|
        self.replay_buffer_capacity = 100_000
        self.num_steps_sampled_before_learning_starts = 500
        self.rollout_fragment_length = 200
        self.train_batch_size = 128
        self.num_updates_per_iteration = 100
        self.model = {"hidden": (64, 64)}


def _merge(q_pair: tuple) -> dict:
    """The twin critics as one flat dict for one optimizer (``q1_w0``, ...)."""
    return {f"q{i + 1}_{k}": v for i, q in enumerate(q_pair) for k, v in q.items()}


class SAC(Algorithm):
    """Continuous control only: builds its own runner (the discrete
    env-runner stack assumes categorical actions)."""

    def __init__(self, config: SACConfig, device=None):
        from ray_tpu_torch import resolve_device

        if config.env is None:
            raise ValueError("config.environment(env=...) is required")
        self.config = config
        self.device = resolve_device(device)
        self.iteration = 0
        self._total_env_steps = 0
        env = make_continuous_env(config.env)
        self.obs_dim = int(np.prod(env.observation_space.shape))
        self.act_dim = int(np.prod(env.action_space.shape))
        hidden = tuple(config.model.get("hidden", (64, 64)))
        self.n_layers = len(hidden) + 1
        self._rng = np.random.default_rng(config.seed)
        self._local, self._runners = None, []
        if config.num_env_runners > 0:
            self._runners = start_all([
                ProcessActor(ContinuousEnvRunner, (config.env, hidden), {"seed": config.seed + i},
                             name=f"sac-runner-{i}")
                for i in range(config.num_env_runners)])
        else:
            self._local = ContinuousEnvRunner(config.env, hidden, config.seed)

        gen = torch.Generator().manual_seed(config.seed)
        q_sizes = [self.obs_dim + self.act_dim, *hidden, 1]
        dev = self.device
        self._state = {
            "actor": _mlp_init(gen, [self.obs_dim, *hidden, 2 * self.act_dim], dev),
            "q1": _mlp_init(gen, q_sizes, dev),
            "q2": _mlp_init(gen, q_sizes, dev),
            "log_alpha": torch.tensor(np.log(config.initial_alpha), dtype=torch.float32,
                                      device=dev),
        }
        self._state["q1_target"] = {k: v.clone() for k, v in self._state["q1"].items()}
        self._state["q2_target"] = {k: v.clone() for k, v in self._state["q2"].items()}
        self.target_entropy = (
            config.target_entropy
            if config.target_entropy is not None
            else -float(self.act_dim)
        )
        self._opt = {
            "actor": adam(config.actor_lr),
            "critic": adam(config.critic_lr),
            "alpha": adam(config.alpha_lr),
        }
        self._opt_state = self._init_opt_state()
        self.replay = ReplayBuffer(
            config.replay_buffer_capacity,
            self.obs_dim,
            act_shape=(self.act_dim,),
            act_dtype=np.float32,
        )
        self._update_fn = self._build_update()
        self._gen = torch.Generator(device=dev).manual_seed(config.seed + 7)

    def _init_opt_state(self) -> dict:
        s = self._state
        return {
            "actor": self._opt["actor"].init(s["actor"]),
            "critic": self._opt["critic"].init(_merge((s["q1"], s["q2"]))),
            "alpha": self._opt["alpha"].init({"log_alpha": s["log_alpha"]}),
        }

    def _build_update(self):
        n_layers = self.n_layers
        gamma = self.config.gamma
        tau = self.config.tau
        target_entropy = self.target_entropy
        opt = self._opt

        def q_val(q_params, obs, act):
            return _mlp(q_params, torch.cat([obs, act], -1), n_layers)[:, 0]

        def critic_loss(qs, state, batch, eps):
            with torch.no_grad():
                next_a, next_logp = sample_action(state["actor"], batch["next_obs"], n_layers,
                                                  eps=eps)
                alpha = torch.exp(state["log_alpha"])
                tq = torch.minimum(
                    q_val(state["q1_target"], batch["next_obs"], next_a),
                    q_val(state["q2_target"], batch["next_obs"], next_a),
                )
                target = batch["rewards"] + gamma * (1 - batch["terminals"]) * (
                    tq - alpha * next_logp
                )
            q1 = {k[3:]: v for k, v in qs.items() if k.startswith("q1_")}
            q2 = {k[3:]: v for k, v in qs.items() if k.startswith("q2_")}
            l1 = torch.mean((q_val(q1, batch["obs"], batch["actions"]) - target) ** 2)
            l2 = torch.mean((q_val(q2, batch["obs"], batch["actions"]) - target) ** 2)
            return l1 + l2, None

        def actor_loss(actor, state, batch, eps):
            a, logp = sample_action(actor, batch["obs"], n_layers, eps=eps)
            alpha = torch.exp(state["log_alpha"]).detach()
            q1 = {k: v.detach() for k, v in state["q1"].items()}
            q2 = {k: v.detach() for k, v in state["q2"].items()}
            q = torch.minimum(q_val(q1, batch["obs"], a), q_val(q2, batch["obs"], a))
            return torch.mean(alpha * logp - q), logp.detach()

        def alpha_loss(p, logp):
            return -torch.mean(p["log_alpha"] * (logp + target_entropy)), None

        def update(state, opt_state, batch, eps_next, eps_actor):
            """One SAC step in place: critics, then the actor against the
            updated critics, then alpha, then the Polyak targets. ``eps_next``
            and ``eps_actor`` are the normal draws [B, A] of the critic
            target's next action and the actor's action. Returns (state,
            opt_state, critic loss, actor loss, alpha)."""
            qs = _merge((state["q1"], state["q2"]))
            closs, _, _ = grad_step(critic_loss, qs, opt["critic"], opt_state["critic"],
                                    state, batch, eps_next)
            aloss, logp, _ = grad_step(actor_loss, state["actor"], opt["actor"],
                                       opt_state["actor"], state, batch, eps_actor)
            grad_step(alpha_loss, {"log_alpha": state["log_alpha"]}, opt["alpha"],
                      opt_state["alpha"], logp)
            with torch.no_grad():
                for t, s in (("q1_target", "q1"), ("q2_target", "q2")):
                    tgt = list(state[t].values())
                    torch._foreach_mul_(tgt, 1 - tau)
                    torch._foreach_add_(tgt, list(state[s].values()), alpha=tau)
            return state, opt_state, closs, aloss, torch.exp(state["log_alpha"].detach())

        return update

    # -- sampling ------------------------------------------------------------

    def _collect(self, random_actions: bool):
        n = self.config.rollout_fragment_length
        if self._local is not None:
            self._local.set_weights(self._state["actor"])
            return [self._local.collect(n, random_actions)]
        weights = host_copy(self._state["actor"])
        get([r.call("set_weights", weights) for r in self._runners])
        return get([r.call("collect", n, random_actions) for r in self._runners])

    def training_step(self) -> dict:
        warmup = (
            self.replay.size
            < self.config.num_steps_sampled_before_learning_starts
        )
        outs = self._collect(random_actions=warmup)
        steps = 0
        returns = []
        for out in outs:
            b = out["batch"]
            for t in range(len(b["rewards"])):
                self.replay.add(
                    b["obs"][t], b["actions"][t], b["rewards"][t],
                    b["next_obs"][t], b["terminals"][t],
                )
            steps += out["metrics"]["num_env_steps"]
            if not np.isnan(out["metrics"]["episode_return_mean"]):
                returns.append(out["metrics"]["episode_return_mean"])

        stats = {}
        if not warmup:
            closs = aloss = alpha = torch.zeros(())
            shape = (self.config.train_batch_size, self.act_dim)
            for _ in range(self.config.num_updates_per_iteration):
                mb = self.replay.sample(self.config.train_batch_size, self._rng)
                eps = torch.randn((2, *shape), generator=self._gen, device=self.device)
                self._state, self._opt_state, closs, aloss, alpha = self._update_fn(
                    self._state, self._opt_state, to_device(mb, self.device), eps[0], eps[1]
                )
            stats = {
                "critic_loss": float(closs),
                "actor_loss": float(aloss),
                "alpha": float(alpha),
            }
        return {
            "learner": stats,
            "episode_return_mean": (
                float(np.mean(returns)) if returns else float("nan")
            ),
            "num_env_steps_sampled": steps,
            "replay_size": self.replay.size,
        }

    @torch.no_grad()
    def evaluate(self, n_episodes: int = 10) -> float:
        """Mean return of the DETERMINISTIC policy (tanh of the Gaussian
        mean), on the CPU with a copy of the actor's weights."""
        env = make_continuous_env(self.config.env)
        scale = np.asarray(env.action_space.high, np.float32)
        actor = {k: v.detach().cpu() for k, v in self._state["actor"].items()}
        returns = []
        for ep in range(n_episodes):
            obs, _ = env.reset(seed=10_000 + ep)
            total, done = 0.0, False
            while not done:
                o = torch.from_numpy(np.asarray(obs, np.float32)[None])
                a = torch.tanh(actor_dist(actor, o, self.n_layers)[0])[0].numpy()
                obs, r, term, trunc, _ = env.step(a * scale)
                total += r
                done = term or trunc
            returns.append(total)
        return float(np.mean(returns))

    # -- lifecycle -----------------------------------------------------------

    def stop(self):
        for r in self._runners:
            r.kill()

    def get_state(self) -> dict:
        def host(v):
            return v.detach().cpu().numpy().copy()

        return {
            "sac": {k: host(v) if k == "log_alpha" else {kk: host(vv) for kk, vv in v.items()}
                    for k, v in self._state.items()},
            "iteration": self.iteration,
            "total_env_steps": self._total_env_steps,
        }

    def set_state(self, state: dict):
        def dev(v):
            return torch.tensor(np.asarray(v), dtype=torch.float32, device=self.device)

        self._state = {
            k: dev(v) if k == "log_alpha" else {kk: dev(vv) for kk, vv in v.items()}
            for k, v in state["sac"].items()
        }
        self.iteration = state.get("iteration", 0)
        self._total_env_steps = state.get("total_env_steps", 0)
