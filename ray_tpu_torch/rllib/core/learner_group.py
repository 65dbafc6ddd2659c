"""LearnerGroup: the local learner.

Counterpart of ``ray_tpu/rllib/core/learner_group.py`` (reference:
``rllib/core/learner/learner_group.py:100``). The JAX package's remote mode
(``num_learners > 0``) runs learners as actors of ray_tpu's runtime, which
the port does not import; it raises here. Data parallelism inside one
learner is ``TorchLearner(mesh=...)`` over ranks of a process group.
"""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch.rllib.core.learner import TorchLearner
from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec

# ROADMAP's open question that every remote part of the RL stack waits on
RUNTIME_QUESTION = ("ROADMAP's open question 'Does the port ever run on ray_tpu's runtime?' "
                    "(remote actors are ray_tpu's runtime, which the port does not import)")


def remote_not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} are not ported: they wait on {RUNTIME_QUESTION}")


class LearnerGroup:
    def __init__(
        self,
        module_spec: RLModuleSpec,
        *,
        num_learners: int = 0,
        learner_kwargs: Optional[dict] = None,
        device=None,
    ):
        if num_learners > 0:
            raise remote_not_ported("remote learners (num_learners > 0)")
        self.num_learners = num_learners
        self._local = TorchLearner(module_spec, device=device, **(learner_kwargs or {}))

    @property
    def learner(self) -> TorchLearner:
        return self._local

    def update_from_batch(
        self, batch: dict, *, minibatch_size=None, num_epochs: int = 1
    ) -> dict:
        return self._local.update_from_batch(batch, minibatch_size, num_epochs)

    def get_weights(self) -> dict:
        return self._local.get_weights()

    def set_weights(self, weights: dict):
        self._local.set_weights(weights)

    def get_state(self) -> dict:
        return self._local.get_state()

    def set_state(self, state: dict):
        self._local.set_state(state)
