"""Multi-agent environments + env runner.

Counterpart of ``ray_tpu/rllib/env/multi_agent.py`` (reference:
``rllib/env/multi_agent_env.py``, dict-keyed obs/reward/term per agent with
``__all__`` termination, and ``rllib/env/multi_agent_env_runner.py``). The
env and the runner have no JAX in them; the runner's modules are the port's
RLModules on the CPU. With ``num_env_runners > 0`` the runners are spawned
CPU processes (``_private/process_actor.py``); the env factory and
``policy_mapping_fn`` then go to them with the standard pickle, by
reference (a class, a module-level function, a ``functools.partial`` or a
bound method such as ``{"agent_0": "p0"}.__getitem__``), and a lambda
raises ``TypeError`` when the group is built.

The runner samples the env with every agent's CURRENT policy, builds GAE
batches PER POLICY (agents sharing a policy concatenate), and returns
``{policy_id: batch}``.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Optional

import numpy as np

from ray_tpu_torch._private.process_actor import require_picklable
from ray_tpu_torch.rllib.env.env_runner import RunnerProcesses, _softmax


class MultiAgentEnv:
    """Protocol base (reference: ``MultiAgentEnv``): ``reset`` returns
    ``(obs_dict, info)``; ``step(action_dict)`` returns ``(obs, rewards,
    terminateds, truncateds, info)`` dicts keyed by agent id, with
    ``terminateds["__all__"]`` ending the episode."""

    agents: list

    def reset(self, *, seed=None, options=None):
        raise NotImplementedError

    def step(self, action_dict: dict):
        raise NotImplementedError


class MultiAgentCartPole(MultiAgentEnv):
    """N independent CartPole instances under one multi-agent wrapper
    (reference: ``rllib/examples/envs/classes/multi_agent.py``
    MultiAgentCartPole — the standard smoke env for the multi-agent stack).
    The episode ends when EVERY sub-episode has ended."""

    def __init__(self, num_agents: int = 2):
        from ray_tpu_torch.rllib.env.env_runner import _make_env

        self.agents = [f"agent_{i}" for i in range(num_agents)]
        self._envs = {a: _make_env("CartPole-v1") for a in self.agents}
        self._done: dict = {}

    @property
    def observation_dim(self) -> int:
        return 4

    @property
    def action_dim(self) -> int:
        return 2

    def reset(self, *, seed=None, options=None):
        obs = {}
        for i, a in enumerate(self.agents):
            o, _ = self._envs[a].reset(
                seed=None if seed is None else seed + i
            )
            obs[a] = np.asarray(o, np.float32)
        self._done = {a: False for a in self.agents}
        return obs, {}

    def step(self, action_dict: dict):
        obs, rew, term, trunc = {}, {}, {}, {}
        for a in self.agents:
            if self._done[a]:
                continue  # ended sub-episode: agent emits nothing
            o, r, te, tr, _ = self._envs[a].step(int(action_dict[a]))
            obs[a] = np.asarray(o, np.float32)
            rew[a] = float(r)
            term[a] = bool(te)
            trunc[a] = bool(tr)
            if te or tr:
                self._done[a] = True
        term["__all__"] = all(self._done.values())
        trunc["__all__"] = False
        return obs, rew, term, trunc, {}


class MultiAgentEnvRunner:
    """Collects multi-agent experience; GAE per agent, batched per policy.

    ``policy_mapping_fn(agent_id) -> policy_id`` routes each agent to a
    module (shared policies = several agents mapping to one id)."""

    def __init__(
        self,
        env_maker: Callable,
        module_specs: dict,
        policy_mapping_fn: Callable,
        *,
        rollout_fragment_length: int = 200,
        gamma: float = 0.99,
        lambda_: float = 0.95,
        seed: int = 0,
    ):
        self.mapping: Callable = policy_mapping_fn
        self.env: MultiAgentEnv = env_maker()
        # one CPU module per policy (host-side inference, as the
        # single-agent runner)
        self.modules = {
            pid: spec.build(seed + i, device="cpu")
            for i, (pid, spec) in enumerate(sorted(module_specs.items()))
        }
        self.rollout_fragment_length = rollout_fragment_length
        self.gamma = gamma
        self.lambda_ = lambda_
        self._rng = np.random.default_rng(seed)
        self._obs, _ = self.env.reset(seed=seed)
        self._ep_return = 0.0
        self.completed_returns: deque = deque(maxlen=500)

    def set_weights(self, weights: dict) -> bool:
        for pid, w in weights.items():
            self.modules[pid].set_state(w)
        return True

    def sample(self) -> dict:
        """One fragment of multi-agent steps → {policy_id: GAE batch}."""
        T = self.rollout_fragment_length
        # per-AGENT trajectories; "end" = term OR trunc (cuts GAE), "term" =
        # true termination (zero bootstrap); truncated steps keep a
        # pre-reset obs for value bootstrapping (same protocol as the
        # single-agent runner)
        traj: dict[str, dict[str, list]] = {
            a: {k: [] for k in ("obs", "act", "logp", "val", "rew", "end", "term")}
            for a in self.env.agents
        }
        trunc_boot: dict[str, list] = {a: [] for a in self.env.agents}
        episodes = 0
        env_steps = 0
        for _ in range(T):
            live = [a for a in self.env.agents if a in self._obs]
            if not live:
                self._obs, _ = self.env.reset()
                live = list(self._obs.keys())
            actions = {}
            for a in live:
                pid = self.mapping(a)
                logits, value = self.modules[pid].forward_exploration(
                    self._obs[a][None]
                )
                probs = _softmax(logits)[0]
                act = int(self._rng.choice(len(probs), p=probs))
                actions[a] = act
                tr = traj[a]
                tr["obs"].append(self._obs[a])
                tr["act"].append(act)
                tr["logp"].append(float(np.log(probs[act] + 1e-10)))
                tr["val"].append(float(value[0]))
            obs, rew, term, trunc, _ = self.env.step(actions)
            env_steps += 1
            for a in live:
                tr = traj[a]
                r = rew.get(a, 0.0)
                tr["rew"].append(float(r))
                self._ep_return += float(r)
                terminated = term.get(a, False)
                truncated = trunc.get(a, False)
                tr["end"].append(float(terminated or truncated))
                tr["term"].append(float(terminated))
                if truncated and not terminated and a in obs:
                    # bootstrap from the pre-reset final obs
                    trunc_boot[a].append((len(tr["rew"]) - 1, obs[a]))
            done_all = term.get("__all__", False) or trunc.get("__all__", False)
            if done_all:
                self.completed_returns.append(self._ep_return)
                self._ep_return = 0.0
                episodes += 1
                self._obs, _ = self.env.reset()
            else:
                self._obs = obs

        batches: dict[str, dict[str, list]] = {}
        for a, tr in traj.items():
            if not tr["obs"]:
                continue
            pid = self.mapping(a)
            n = len(tr["rew"])
            # bootstrap: V(current obs) if the trajectory is mid-episode
            if tr["end"][-1]:
                last_val = 0.0
            else:
                _, v = self.modules[pid].forward_inference(
                    np.asarray(tr["obs"][-1])[None]
                    if a not in self._obs
                    else self._obs[a][None]
                )
                last_val = float(v[0])
            adv = np.zeros(n, np.float32)
            last_gae = 0.0
            vals = np.asarray(tr["val"] + [last_val], np.float32)
            # next-state value per step: V(s_{t+1}) within the episode,
            # 0 on termination, V(pre-reset obs) on truncation
            next_val = vals[1:].copy()
            if trunc_boot[a]:
                obs_stack = np.stack([o for _, o in trunc_boot[a]])
                _, boot = self.modules[pid].forward_inference(obs_stack)
                for (t_idx, _), v in zip(trunc_boot[a], boot):
                    next_val[t_idx] = float(v)
            next_val = next_val * (1.0 - np.asarray(tr["term"], np.float32))
            for t in reversed(range(n)):
                not_end = 1.0 - tr["end"][t]
                delta = (
                    tr["rew"][t]
                    + self.gamma * next_val[t]
                    - vals[t]
                )
                last_gae = delta + self.gamma * self.lambda_ * not_end * last_gae
                adv[t] = last_gae
            targets = adv + vals[:n]
            dst = batches.setdefault(
                pid, {k: [] for k in ("obs", "actions", "logp_old",
                                      "advantages", "value_targets")}
            )
            dst["obs"].append(np.asarray(tr["obs"], np.float32))
            dst["actions"].append(np.asarray(tr["act"], np.int64))
            dst["logp_old"].append(np.asarray(tr["logp"], np.float32))
            dst["advantages"].append(adv)
            dst["value_targets"].append(targets)

        out_batches = {}
        for pid, cols in batches.items():
            b = {k: np.concatenate(v) for k, v in cols.items()}
            a = b["advantages"]
            b["advantages"] = (a - a.mean()) / (a.std() + 1e-8)
            out_batches[pid] = b
        recent = list(self.completed_returns)[-100:]
        metrics = {
            "episode_return_mean": (
                float(np.mean(recent)) if recent else float("nan")
            ),
            "num_env_steps": env_steps,
            "num_agent_steps": int(
                sum(len(c["actions"]) for c in out_batches.values())
            ),
            "num_episodes": episodes,
        }
        return {"batches": out_batches, "metrics": metrics}


class MultiAgentEnvRunnerGroup(RunnerProcesses):
    """The local multi-agent runner, or ``num_env_runners`` runner
    processes (runner i seeded ``seed + i``); a runner whose call fails is
    replaced, gets no weights and adds nothing to that sample, as in the
    JAX package."""

    _name = "multi-agent-runner"

    def __init__(
        self,
        env_maker: Callable,
        module_specs: dict,
        policy_mapping_fn: Callable,
        *,
        num_env_runners: int = 0,
        rollout_fragment_length: int = 200,
        gamma: float = 0.99,
        lambda_: float = 0.95,
        seed: int = 0,
    ):
        if num_env_runners > 0:
            require_picklable(env_maker, "the multi-agent env factory (environment(env=...))")
            require_picklable(policy_mapping_fn, "policy_mapping_fn")
        kwargs = dict(rollout_fragment_length=rollout_fragment_length, gamma=gamma,
                      lambda_=lambda_)
        self._start(MultiAgentEnvRunner, (env_maker, module_specs, policy_mapping_fn), kwargs,
                    seed, num_env_runners)

    def sample(self, weights: Optional[dict] = None):
        if self._local is not None:
            if weights is not None:
                self._local.set_weights(weights)
            out = self._local.sample()
            return out["batches"], out["metrics"]
        outs = self._fan_out(weights, push_to_replacement=False)
        if not outs:
            raise RuntimeError("all multi-agent env runners failed")
        pids = sorted({pid for o in outs for pid in o["batches"]})
        batches = {
            pid: {k: np.concatenate([o["batches"][pid][k] for o in outs if pid in o["batches"]])
                  for k in next(o["batches"][pid] for o in outs if pid in o["batches"])}
            for pid in pids
        }
        ms = [o["metrics"] for o in outs]
        metrics = {
            "episode_return_mean": float(np.nanmean([m["episode_return_mean"] for m in ms])),
            "num_env_steps": int(sum(m["num_env_steps"] for m in ms)),
            "num_episodes": int(sum(m["num_episodes"] for m in ms)),
        }
        return batches, metrics
