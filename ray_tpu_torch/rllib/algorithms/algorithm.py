"""Algorithm + AlgorithmConfig: the trainer surface.

Counterpart of ``ray_tpu/rllib/algorithms/algorithm.py`` (reference:
``rllib/algorithms/algorithm.py:207``, ``train()`` runs one
``training_step``; ``algorithm_config.py``, the fluent builder
``.environment().training().env_runners().learners()``). The config
builder is a copy. ``config.build(device=None)`` puts the learner on the
card unless the caller asks for the CPU; env runners sample on the CPU,
in this process or, with ``num_env_runners > 0``, in runner processes;
``num_learners > 0`` puts each learner in a process of its own, holding
``resources_per_learner`` of the host's cards (one card each unless it
says otherwise; ``_private/process_actor.py``). ``stop`` ends those
processes. ``save`` / ``restore`` go through ``train/checkpoint.py``, so a
JAX checkpoint restores here. ``as_trainable`` gives ``ray_tpu_torch.tune`` a
trainable that builds the algorithm in the trial's process.
"""

from __future__ import annotations

import copy
import time
from typing import Optional, Type

import numpy as np
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.rllib.core.learner import on_device
from ray_tpu_torch.rllib.core.learner_group import LearnerGroup
from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec
from ray_tpu_torch.rllib.env.env_runner import EnvRunnerGroup, env_spec
from ray_tpu_torch.train.checkpoint import Checkpoint, restore_state_dict


class AlgorithmConfig:
    def __init__(self, algo_class: Optional[Type["Algorithm"]] = None):
        self.algo_class = algo_class
        self.env = None  # env id str, or callable for multi-agent envs
        self.policies: Optional[dict] = None
        self.policy_mapping_fn = None
        self.seed = 0
        # env runners
        self.num_env_runners = 0
        self.num_envs_per_env_runner = 1
        self.rollout_fragment_length = 200
        self.env_to_module_connector = None  # factory -> ConnectorV2 piece(s)
        # training
        self.gamma = 0.99
        self.lr = 3e-4
        self.train_batch_size = 4000
        self.minibatch_size = 128
        self.num_epochs = 10
        # per-env defaults apply when a key is absent (MLP (64, 64);
        # pixel torso picks its own head) — see Algorithm.__init__
        self.model: dict = {}
        # learners
        self.num_learners = 0
        self.resources_per_learner: Optional[dict] = None

    # -- fluent builder (reference API names) -------------------------------

    def environment(self, env, **_) -> "AlgorithmConfig":
        """``env``: an env id string, or (multi-agent) a callable returning
        a ``MultiAgentEnv`` instance."""
        self.env = env
        return self

    def multi_agent(
        self,
        *,
        policies: dict,
        policy_mapping_fn,
        **_,
    ) -> "AlgorithmConfig":
        """Multi-agent setup (reference: ``AlgorithmConfig.multi_agent`` +
        ``MultiRLModuleSpec``): ``policies`` maps policy id →
        RLModuleSpec (or None to infer from the env); agents route to
        policies via ``policy_mapping_fn(agent_id)``. Several agents
        mapping to one id SHARE that policy; distinct ids train
        independent modules."""
        self.policies = dict(policies)
        self.policy_mapping_fn = policy_mapping_fn
        return self

    def env_runners(
        self,
        num_env_runners: Optional[int] = None,
        num_envs_per_env_runner: Optional[int] = None,
        rollout_fragment_length: Optional[int] = None,
        env_to_module_connector=None,
        **_,
    ) -> "AlgorithmConfig":
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_env_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        if env_to_module_connector is not None:
            # zero-arg factory returning ConnectorV2 piece(s) — built fresh
            # per runner (pieces are stateful); reference:
            # AlgorithmConfig.env_runners(env_to_module_connector=...)
            self.env_to_module_connector = env_to_module_connector
        return self

    def training(self, **kwargs) -> "AlgorithmConfig":
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown training option: {k}")
            setattr(self, k, v)
        return self

    def learners(
        self,
        num_learners: Optional[int] = None,
        resources_per_learner: Optional[dict] = None,
        **_,
    ) -> "AlgorithmConfig":
        if num_learners is not None:
            self.num_learners = num_learners
        if resources_per_learner is not None:
            self.resources_per_learner = resources_per_learner
        return self

    def debugging(self, seed: Optional[int] = None, **_) -> "AlgorithmConfig":
        if seed is not None:
            self.seed = seed
        return self

    def copy(self) -> "AlgorithmConfig":
        return copy.deepcopy(self)

    def build(self, device=None) -> "Algorithm":
        """The algorithm, its learner on ``device``: the card unless the
        caller names another (``device="cpu"``)."""
        if self.algo_class is None:
            raise ValueError("config has no algo_class")
        return self.algo_class(self.copy(), device=device)

    # back-compat alias used by reference examples
    build_algo = build


class Algorithm:
    """Base trainer: owns env-runner group + learner group."""

    learner_hparam_keys = ("lr",)
    # algorithms whose learner understands conv (pixel) modules set True
    # (others fall back to flattened-vector obs, the pre-conv behavior)
    supports_pixel_obs = False

    def __init__(self, config: AlgorithmConfig, device=None):
        if config.env is None:
            raise ValueError("config.environment(env=...) is required")
        self.config = config
        self.device = resolve_device(device)
        self.is_multi_agent = config.policies is not None
        if self.is_multi_agent:
            if config.env_to_module_connector is not None:
                # fail loudly rather than silently training on raw obs
                raise NotImplementedError(
                    "env_to_module_connector is not supported for "
                    "multi-agent configs yet"
                )
            self._setup_multi_agent()
            self.iteration = 0
            self._total_env_steps = 0
            return
        obs_shape, act_dim = env_spec(config.env)
        if config.env_to_module_connector is not None:
            # the module sees post-connector observations: size the spec
            # from a probe pipeline (reference: connector pipelines adapt
            # observation_space before RLModule build)
            from ray_tpu_torch.rllib.connectors import as_pipeline

            probe = as_pipeline(config.env_to_module_connector())
            obs_shape = tuple(probe.transform_obs_shape(tuple(obs_shape)))
        if len(obs_shape) == 3 and self.supports_pixel_obs:
            # pixel env: conv torso (Atari-CNN-style defaults scaled down)
            self.module_spec = RLModuleSpec(
                observation_dim=int(np.prod(obs_shape)),
                action_dim=act_dim,
                hidden=tuple(config.model.get("hidden", (128,))),  # conv head
                obs_shape=obs_shape,
                conv_filters=tuple(
                    config.model.get(
                        "conv_filters", ((16, 4, 2), (32, 3, 2))
                    )
                ),
            )
        else:
            self.module_spec = RLModuleSpec(
                observation_dim=int(np.prod(obs_shape)),
                action_dim=act_dim,
                hidden=tuple(config.model.get("hidden", (64, 64))),
            )
        self.learner_group = LearnerGroup(
            self.module_spec,
            num_learners=config.num_learners,
            learner_kwargs=self._learner_kwargs(),
            device=self.device,
            resources_per_learner=config.resources_per_learner,
        )
        self.env_runner_group = EnvRunnerGroup(
            config.env,
            self.module_spec,
            num_env_runners=config.num_env_runners,
            num_envs_per_runner=config.num_envs_per_env_runner,
            rollout_fragment_length=config.rollout_fragment_length,
            gamma=config.gamma,
            lambda_=getattr(config, "lambda_", 0.95),
            seed=config.seed,
            emit_sequences=getattr(config, "_emit_sequences", False),
            env_to_module_connector=config.env_to_module_connector,
        )
        self.iteration = 0
        self._total_env_steps = 0

    def _setup_multi_agent(self):
        """Per-policy learner groups + the multi-agent runner group
        (reference: MultiRLModule + MultiAgentEnvRunner)."""
        from ray_tpu_torch.rllib.env.multi_agent import MultiAgentEnvRunnerGroup

        config = self.config
        env_maker = config.env
        if not callable(env_maker):
            raise ValueError(
                "multi-agent configs need environment(env=<callable>) "
                "returning a MultiAgentEnv"
            )
        probe = env_maker()
        specs: dict[str, RLModuleSpec] = {}
        for pid, spec in config.policies.items():
            if spec is None:
                if not hasattr(probe, "observation_dim") or not hasattr(
                    probe, "action_dim"
                ):
                    raise ValueError(
                        f"policies[{pid!r}] is None, so the env must expose "
                        f"observation_dim and action_dim to infer the module "
                        f"spec — {type(probe).__name__} does not; pass an "
                        f"explicit RLModuleSpec"
                    )
                spec = RLModuleSpec(
                    observation_dim=int(probe.observation_dim),
                    action_dim=int(probe.action_dim),
                    hidden=tuple(config.model.get("hidden", (64, 64))),
                )
            specs[pid] = spec
        self.module_specs = specs
        # one group a policy, each holding cards of its own: when too few
        # are free a later group raises, and the groups built are stopped
        self.learner_groups = {}
        try:
            for pid, spec in specs.items():
                self.learner_groups[pid] = LearnerGroup(
                    spec,
                    num_learners=config.num_learners,
                    learner_kwargs=self._learner_kwargs(),
                    device=self.device,
                    resources_per_learner=config.resources_per_learner,
                )
        except BaseException:
            for group in self.learner_groups.values():
                group.shutdown()
            raise
        self.env_runner_group = MultiAgentEnvRunnerGroup(
            env_maker,
            specs,
            config.policy_mapping_fn,
            num_env_runners=config.num_env_runners,
            rollout_fragment_length=config.rollout_fragment_length,
            gamma=config.gamma,
            lambda_=getattr(config, "lambda_", 0.95),
            seed=config.seed,
        )

    def _learner_kwargs(self) -> dict:
        return {"lr": self.config.lr, "seed": self.config.seed}

    # -- the Tune-facing API ------------------------------------------------

    def train(self) -> dict:
        t0 = time.time()
        result = self.training_step()
        self.iteration += 1
        self._total_env_steps += result.get("num_env_steps_sampled", 0)
        result.update(
            {
                "training_iteration": self.iteration,
                "num_env_steps_sampled_lifetime": self._total_env_steps,
                "time_this_iter_s": time.time() - t0,
            }
        )
        return result

    def training_step(self) -> dict:
        raise NotImplementedError

    def _pull_params(self):
        """For an algorithm that keeps parameters of its own and sets them
        on the learner group after each iteration (IMPALA, APPO, BC,
        MARWIL): the group's weights as those parameters on its device,
        with fresh moments of its ``optimizer``. At the start, and after a
        restore, which fills the group (stale ones would overwrite it)."""
        self._params = on_device(self.learner_group.get_weights(), self.device)
        self._opt_state = self.optimizer.init(self._params)

    def stop(self):
        """End the runner and learner processes (none in local mode)."""
        self.env_runner_group.shutdown()
        if self.is_multi_agent:
            for lg in self.learner_groups.values():
                lg.shutdown()
        else:
            self.learner_group.shutdown()

    # -- checkpointing (Checkpointable contract) ----------------------------

    def get_state(self) -> dict:
        if self.is_multi_agent:
            learner = {
                pid: lg.get_state() for pid, lg in self.learner_groups.items()
            }
        else:
            learner = self.learner_group.get_state()
        out = {
            "learner": learner,
            "iteration": self.iteration,
            "total_env_steps": self._total_env_steps,
        }
        if not self.is_multi_agent:
            conn = self.env_runner_group.get_connector_state()
            if conn is not None:
                # stacks/filters survive checkpoints (a MeanStdFilter
                # restarted at count=0 would re-normalize with fresh
                # small-sample stats against a converged policy)
                out["connectors"] = conn
        return out

    def set_state(self, state: dict):
        if self.is_multi_agent:
            for pid, s in state["learner"].items():
                self.learner_groups[pid].set_state(s)
        else:
            self.learner_group.set_state(state["learner"])
            if state.get("connectors") is not None:
                self.env_runner_group.set_connector_state(state["connectors"])
        self.iteration = state.get("iteration", 0)
        self._total_env_steps = state.get("total_env_steps", 0)

    def save(self, path: str) -> str:
        """Write ``get_state()`` in the JAX package's checkpoint format
        (``train/checkpoint.py``); returns the directory."""
        return Checkpoint.from_state_dict(self.get_state(), path).path

    def restore(self, path: str):
        """Read a checkpoint written by ``save`` here or by the JAX
        package's ``Algorithm.save``, into this algorithm's own state as
        the template (a JAX checkpoint names no keys)."""
        self.set_state(_host(restore_state_dict(path, like=self.get_state())))

    @classmethod
    def as_trainable(cls, base_config: AlgorithmConfig) -> "AlgorithmTrainable":
        """Adapter for ray_tpu_torch.tune (reference: Algorithm IS a
        Trainable; the JAX package's closure,
        ``ray_tpu/rllib/algorithms/algorithm.py:330-352``, is a picklable
        object here)."""
        return AlgorithmTrainable(cls, base_config)


class AlgorithmTrainable:
    """An algorithm as a Tune trainable: each trial copies ``base_config``,
    sets the attributes the trial's config names, builds the algorithm with
    its learner on the trial's device (``train.get_device()``: the trial's
    card when it leases a share of one, else the CPU) and reports
    ``train()`` ``config["stop_iters"]`` times (default 10), then stops it.
    It travels to the trial process with the standard pickle."""

    def __init__(self, algo_class: type, base_config: AlgorithmConfig):
        self.algo_class = algo_class
        self.base_config = base_config
        self.__name__ = f"{algo_class.__name__}_trainable"

    def __call__(self, config: dict) -> None:
        from ray_tpu_torch.train.session import get_device, report

        c = self.base_config.copy()
        for k, v in (config or {}).items():
            if hasattr(c, k):
                setattr(c, k, v)
        algo = c.build(device=get_device())
        try:
            for _ in range((config or {}).get("stop_iters", 10)):
                report(algo.train())
        finally:
            algo.stop()


def _host(tree):
    """A restored state's tensors as numpy arrays (what ``get_state``
    gives and the connectors hold)."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree.numpy() if isinstance(tree, torch.Tensor) else tree
