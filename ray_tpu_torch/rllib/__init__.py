"""ray_tpu_torch.rllib — the port of ``ray_tpu/rllib``.

The reference's new-stack quartet: RLModule (a ``torch.nn.Module``) /
TorchLearner / LearnerGroup / EnvRunnerGroup, and the algorithms PPO,
APPO, IMPALA, DQN, BC, MARWIL and SAC: the learner on the card unless
``config.build(device="cpu")``, env runners on the CPU. The JAX package's
actors are the port's own spawned processes (``_private/process_actor.py``):
remote env runners (``num_env_runners > 0``, replaced when they fail),
IMPALA and APPO's asynchronous pipeline over them, remote learners
(``num_learners > 0``, one card each) and SAC's runners.
``Algorithm.as_trainable`` gives ``ray_tpu_torch.tune`` a trainable that
builds the algorithm in the trial's process, its learner on the trial's
device.
"""

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.appo import APPO, APPOConfig
from ray_tpu_torch.rllib.algorithms.bc import BC, BCConfig, MARWIL, MARWILConfig, ExperienceRows, record_experience
from ray_tpu_torch.rllib.algorithms.dqn import DQN, DQNConfig, ReplayBuffer
from ray_tpu_torch.rllib.algorithms.impala import IMPALA, IMPALAConfig
from ray_tpu_torch.rllib.algorithms.sac import SAC, SACConfig
from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig
from ray_tpu_torch.rllib.connectors import (
    ConnectorV2,
    EnvToModulePipeline,
    FlattenObservations,
    FrameStack,
    MeanStdFilter,
    PrevActionsPrevRewards,
)
from ray_tpu_torch.rllib.core.learner import TorchLearner
from ray_tpu_torch.rllib.core.learner_group import LearnerGroup
from ray_tpu_torch.rllib.core.rl_module import RLModule, RLModuleSpec, params_from_jax
from ray_tpu_torch.rllib.env.env_runner import EnvRunnerGroup, SingleAgentEnvRunner

__all__ = [
    "Algorithm",
    "AlgorithmConfig",
    "APPO",
    "APPOConfig",
    "BC",
    "BCConfig",
    "MARWIL",
    "MARWILConfig",
    "record_experience",
    "ExperienceRows",
    "ConnectorV2",
    "DQN",
    "DQNConfig",
    "EnvToModulePipeline",
    "FlattenObservations",
    "FrameStack",
    "MeanStdFilter",
    "PrevActionsPrevRewards",
    "ReplayBuffer",
    "EnvRunnerGroup",
    "IMPALA",
    "IMPALAConfig",
    "SAC",
    "SACConfig",
    "TorchLearner",
    "LearnerGroup",
    "PPO",
    "PPOConfig",
    "RLModule",
    "RLModuleSpec",
    "params_from_jax",
    "SingleAgentEnvRunner",
]
