"""LearnerGroup: one local learner, or N learner processes.

Counterpart of ``ray_tpu/rllib/core/learner_group.py`` (reference:
``rllib/core/learner/learner_group.py:100``). With ``num_learners > 0``
each learner is a ``TorchLearner`` in a spawned process of its own
(``_private/process_actor.py``) holding one card, or the CPU when the
group was asked for it (``device="cpu"``). The JAX group's gradient sync
stays: every learner takes its ``np.array_split`` shard of the batch,
updates, and the calling process averages the participants' weights and
sets the average on every learner. Data parallelism inside one learner is
``TorchLearner(mesh=...)`` over the ranks of a process group.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch._private.process_actor import ProcessActor, get, start_all
from ray_tpu_torch._private.spawn_env import assign_cards
from ray_tpu_torch.rllib.core.learner import TorchLearner
from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec


class LearnerGroup:
    def __init__(
        self,
        module_spec: RLModuleSpec,
        *,
        num_learners: int = 0,
        learner_kwargs: Optional[dict] = None,
        device=None,
    ):
        self.num_learners = num_learners
        kwargs = learner_kwargs or {}
        self._local, self._remote = None, []
        if num_learners <= 0:
            self._local = TorchLearner(module_spec, device=device, **kwargs)
            return
        # the card unless the caller asks for the CPU; too few cards raise
        on_card = resolve_device(device).type == "cuda"
        cards = ([c[0] for c in assign_cards(num_learners, 1, "remote learners")] if on_card
                 else [None] * num_learners)
        self._remote = start_all([
            ProcessActor(TorchLearner, (module_spec,),
                         dict(kwargs, device="cuda" if on_card else "cpu"),
                         card=card, name=f"learner-{i}")
            for i, card in enumerate(cards)
        ])

    @property
    def learner(self) -> Optional[TorchLearner]:
        """The local learner (None when the learners are processes)."""
        return self._local

    @property
    def learners(self) -> list:
        """The learner processes (empty in local mode)."""
        return self._remote

    def update_from_batch(
        self, batch: dict, *, minibatch_size=None, num_epochs: int = 1
    ) -> dict:
        if self._local is not None:
            return self._local.update_from_batch(batch, minibatch_size, num_epochs)
        # shard the batch across learners: array_split covers the remainder;
        # with n < k some shards are empty and those learners sit the round out
        n = len(batch["obs"])
        k = len(self._remote)
        refs, participants = [], []
        for learner, idx in zip(self._remote, np.array_split(np.arange(n), k)):
            if len(idx) == 0:
                continue
            shard = {key: np.asarray(v)[idx] for key, v in batch.items()}
            refs.append(learner.call("update_from_batch", shard,
                                     minibatch_size and max(minibatch_size // k, 1), num_epochs))
            participants.append(learner)
        all_stats = [s for s in get(refs) if s]
        # averaging the participants' weights keeps the learners in sync;
        # idle learners receive the result too
        all_weights = get([l.call("get_weights") for l in participants])
        avg = {key: np.mean([w[key] for w in all_weights], axis=0) for key in all_weights[0]}
        get([l.call("set_weights", avg) for l in self._remote])
        if not all_stats:
            return {}
        return {k2: float(np.mean([s[k2] for s in all_stats])) for k2 in all_stats[0]}

    def get_weights(self) -> dict:
        if self._local is not None:
            return self._local.get_weights()
        return get(self._remote[0].call("get_weights"))

    def set_weights(self, weights: dict):
        """``weights`` as arrays, or as tensors on any device: a local
        learner copies them in place, learner processes get one host copy."""
        if self._local is not None:
            self._local.set_weights(weights)
            return
        weights = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
                   for k, v in weights.items()}
        get([l.call("set_weights", weights) for l in self._remote])

    def get_state(self) -> dict:
        if self._local is not None:
            return self._local.get_state()
        # the full state (Adam's moments too), so that a checkpoint of a
        # remote group restores into a local one and the other way round
        return get(self._remote[0].call("get_state"))

    def set_state(self, state: dict):
        if self._local is not None:
            self._local.set_state(state)
        elif "opt_state" in state:
            get([l.call("set_state", state) for l in self._remote])
        else:
            self.set_weights(state["weights"])

    def placement(self) -> list:
        """The device types holding the learners' parameters and Adam
        moments (learner 0's, for processes)."""
        if self._local is not None:
            return self._local.placement()
        return get(self._remote[0].call("placement"))

    def shutdown(self):
        for l in self._remote:
            l.kill()
