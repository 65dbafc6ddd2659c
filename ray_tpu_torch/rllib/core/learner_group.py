"""LearnerGroup: one local learner, or N learner processes.

Counterpart of ``ray_tpu/rllib/core/learner_group.py`` (reference:
``rllib/core/learner/learner_group.py:100``). With ``num_learners > 0``
each learner is a ``TorchLearner`` in a spawned process of its own
(``_private/process_actor.py``) holding what ``resources_per_learner``
asks of the host's card ledger (``_private/cards.py``): ``{"GPU": g}``
leases g of a card a learner (at 0.5 two learners share one card; whole
cards at 1 and above), one card when it names none, and nothing on the
CPU (``device="cpu"``). Too few free cards raise at once, naming the
holders, where the reference's actors would wait for placement; two
groups started by one process hold disjoint cards. The JAX group's
gradient sync stays: every learner takes its ``np.array_split`` shard of
the batch, updates, and the calling process averages the participants'
weights and sets the average on every learner. Data parallelism inside
one learner is ``TorchLearner(mesh=...)`` over the ranks of a process
group.
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


def learner_leases(num_learners: int, resources_per_learner: Optional[dict],
                   on_card: bool) -> list:
    """Each learner process's lease of the card ledger: ``{"GPU": g}`` of
    ``resources_per_learner`` (one card when it names none) on the card,
    none on the CPU."""
    if not on_card:
        return [None] * num_learners
    per = float((resources_per_learner or {}).get("GPU", 1))
    if per <= 0:
        raise ValueError(f"a learner on the card needs a share of one, got "
                         f"resources_per_learner={resources_per_learner}")
    return assign_cards(num_learners, per, "remote learners")


class LearnerGroup:
    def __init__(
        self,
        module_spec: RLModuleSpec,
        *,
        num_learners: int = 0,
        learner_kwargs: Optional[dict] = None,
        device=None,
        resources_per_learner: Optional[dict] = None,
    ):
        self.num_learners = num_learners
        kwargs = learner_kwargs or {}
        self._local, self._remote = None, []
        if num_learners <= 0:
            self._local = TorchLearner(module_spec, device=device, **kwargs)
            return
        # the card unless the caller asks for the CPU; too few cards raise
        on_card = resolve_device(device).type == "cuda"
        leases = learner_leases(num_learners, resources_per_learner, on_card)
        actors = []
        try:
            for i, lease in enumerate(leases):
                actors.append(ProcessActor(TorchLearner, (module_spec,),
                                           dict(kwargs, device="cuda" if on_card else "cpu"),
                                           lease=lease, name=f"learner-{i}"))
        except BaseException:
            for lease in leases[len(actors):]:
                if lease is not None:
                    lease.release()
            for a in actors:
                a.kill()
            raise
        self._remote = start_all(actors)

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
