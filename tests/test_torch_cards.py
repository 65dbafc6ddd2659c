"""The host's card ledger (``ray_tpu_torch/_private/cards.py``) and what
leases from it: the Train layer's ranks, process actors and RLlib's
learner groups.

Every test runs on a ledger of its own under ``tmp_path``, with declared
card ids and CPU slots, so the suite's workers never see each other's
leases; no process here runs on a card. A process a test spawns imports
this module by name, so it imports neither JAX nor ray_tpu.
"""

import multiprocessing
import os
import re
import signal
import subprocess
import sys
import threading
import time

import pytest
import torch

from ray_tpu_torch._private.cards import CardLedger, LedgerError, use_ledger
from ray_tpu_torch._private.process_actor import PendingResult, ProcessActor, get
from ray_tpu_torch._private import spawn_env
from ray_tpu_torch._private.spawn_env import assign_cards, end_process_group
from ray_tpu_torch.rllib import LearnerGroup, RLModuleSpec
from ray_tpu_torch.rllib.core import learner_group as lg
from ray_tpu_torch.train import ScalingConfig
from ray_tpu_torch.train._internal.worker_group import WorkerGroup, lease_ranks

pytestmark = pytest.mark.timeout(300)


@pytest.fixture
def ledger(tmp_path):
    with use_ledger(CardLedger(str(tmp_path / "ledger"), cards=["0", "1"], cpus=8)) as led:
        yield led


# ---- leases ------------------------------------------------------------------


def test_lease_and_release(ledger):
    assert ledger.free().cards == 2 and ledger.free().cpus == 8
    a, = ledger.acquire([{"GPU": 1, "CPU": 2}], "holder")
    assert a.cards == ["0"]
    free = ledger.free()
    assert (free.cards, free.shares, free.cpus) == (1, {"0": 0.0, "1": 1.0}, 6)
    h, = ledger.holders()
    assert (h.pid, h.name, h.gpu, h.cpu) == (os.getpid(), "holder", {"0": 1.0}, 2.0)
    a.release()
    a.release()  # a second release is a no-op
    assert ledger.holders() == [] and ledger.free().cards == 2
    assert not [f for f in os.listdir(ledger.root) if f.startswith("lease-")]


def test_whole_cards_and_shares(ledger):
    half, = ledger.acquire([{"GPU": 0.5}], "half")
    # a whole card never goes where a share is held; another share packs
    # onto the fullest card it fits
    whole, = ledger.acquire([{"GPU": 1}], "whole")
    assert (half.cards, whole.cards) == (["0"], ["1"])
    other, = ledger.acquire([{"GPU": 0.5}], "other half")
    assert other.cards == ["0"] and ledger.free().shares == {"0": 0.0, "1": 0.0}
    with pytest.raises(LedgerError):
        ledger.acquire([{"GPU": 0.25}], "quarter")
    for lease in (half, whole, other):
        lease.release()
    with pytest.raises(ValueError, match="a share below 1 or whole cards"):
        ledger.acquire([{"GPU": 1.5}], "bad")
    with pytest.raises(ValueError):
        ledger.acquire([{"TPU": 1}], "bad")


def test_acquisition_is_all_or_none(ledger):
    with pytest.raises(LedgerError):
        ledger.acquire([{"GPU": 1}, {"GPU": 1}, {"GPU": 1}], "three")
    assert ledger.holders() == [] and ledger.free().cards == 2


def test_over_ask_names_counts_and_holders(ledger):
    held = ledger.acquire([{"GPU": 1}], "1 GPU ranks")
    msg = (r"2 GPU ranks ask for 2 card\(s\), but 2 are visible and 1 free; "
           rf"held by pid {os.getpid()} \(1 GPU ranks: card 0\)")
    with pytest.raises(LedgerError, match=msg):
        assign_cards(2, 1, "GPU ranks")
    with pytest.raises(LedgerError, match=r"9 CPU slot\(s\), but the host has 8 and 8 are free"):
        ledger.acquire([{"CPU": 9}], "greedy")
    # more than are visible: both counts, before the ledger is read
    with pytest.raises(RuntimeError,
                       match="3 GPU ranks of 1 card.* need 3 cards, but 2 are visible"):
        assign_cards(3, 1, "GPU ranks")
    held[0].release()


def test_two_groups_in_one_process_hold_disjoint_cards(tmp_path):
    with use_ledger(CardLedger(str(tmp_path), cards=["3", "5", "6", "7"], cpus=8)) as led:
        first = assign_cards(2, 1, "GPU ranks")
        second = assign_cards(2, 1, "GPU ranks")
        ids = [c for lease in first + second for c in lease.cards]
        assert sorted(ids) == ["3", "5", "6", "7"]  # physical ids, none twice
        with pytest.raises(LedgerError, match="held by pid"):
            assign_cards(1, 1, "GPU ranks")
        for lease in first + second:
            lease.release()
        assert led.free().cards == 4


def test_train_ranks_lease_what_they_name(ledger):
    """A GPU rank leases its card; a CPU rank the CPU slots it names, and a
    fixed group that names none leases nothing; an elastic CPU group takes
    one slot a rank (the reference's default demand)."""
    gpu = lease_ranks(ScalingConfig(num_workers=2), 2)
    assert [lease.cards for lease in gpu] == [["0"], ["1"]]
    with pytest.raises(LedgerError):
        lease_ranks(ScalingConfig(num_workers=1), 1)
    for lease in gpu:
        lease.release()
    assert lease_ranks(ScalingConfig(num_workers=8, use_gpu=False), 8) == [None] * 8
    cpu = lease_ranks(ScalingConfig(num_workers=2, use_gpu=False,
                                    resources_per_worker={"CPU": 3}), 2)
    assert [(lease.cards, lease.cpu) for lease in cpu] == [([], 3.0), ([], 3.0)]
    elastic = lease_ranks(ScalingConfig(num_workers=2, min_workers=1, use_gpu=False), 2)
    assert [lease.cpu for lease in elastic] == [1.0, 1.0]
    assert ledger.free().cpus == 0
    for lease in cpu + elastic:
        lease.release()


# ---- across processes ----------------------------------------------------------


def _race(root, start, out):
    """A process racing for the ledger's last card: acquire when ``start``
    is set, report, hold until the parent ends this process."""
    led = CardLedger(root, cards=["0"], cpus=1)
    start.wait(60)
    try:
        lease, = led.acquire([{"GPU": 1}], "racer")
        out.put((os.getpid(), "won", lease.cards))
    except LedgerError as e:
        out.put((os.getpid(), "lost", str(e)))
    time.sleep(600)


def test_racing_processes_never_both_get_the_last_card(tmp_path):
    mp = multiprocessing.get_context("spawn")
    start, out = mp.Event(), mp.Queue()
    root = str(tmp_path)
    procs = [mp.Process(target=_race, args=(root, start, out), daemon=True) for _ in range(6)]
    for p in procs:
        p.start()
    try:
        start.set()
        results = [out.get(timeout=120) for _ in procs]
        won = [r for r in results if r[1] == "won"]
        assert len(won) == 1, results
        winner = won[0][0]
        for pid, what, msg in results:
            if what == "lost":
                assert f"held by pid {winner} (racer: card 0)" in msg, msg
        holders = CardLedger(root, cards=["0"]).holders()
        assert [h.pid for h in holders] == [winner]
    finally:
        for p in procs:
            p.kill()
            p.join(30)
    assert CardLedger(root, cards=["0"]).free().cards == 1  # every holder gone


def test_sigkilled_holder_frees_its_lease(ledger):
    """A process actor holding card 0 (a lease handed to its process):
    listed under its own pid, and SIGKILL returns the card."""
    lease, = assign_cards(1, 1, "holders")
    actor = ProcessActor(list, lease=lease, name="holder")
    try:
        get(actor.ready, timeout=120)
        h, = ledger.holders()
        assert (h.pid, h.gpu) == (actor.pid, {"0": 1.0})
        assert get(actor.call(os.getenv, "CUDA_VISIBLE_DEVICES")) == "0"
        assert ledger.free().cards == 1
        os.kill(actor.pid, signal.SIGKILL)
        actor._proc.join(30)
        assert ledger.holders() == [] and ledger.free().cards == 2
    finally:
        actor.kill()


def test_kill_and_shutdown_leave_no_lease(ledger):
    """``ProcessActor.kill`` and ``WorkerGroup.shutdown`` (two gloo ranks of
    2 CPU slots each) leave no lease behind."""
    lease, = assign_cards(1, 0, "actors", cpu=1)
    actor = ProcessActor(list, lease=lease, name="cpu-holder")
    get(actor.ready, timeout=120)
    assert ledger.free().cpus == 7
    actor.kill()
    assert ledger.holders() == [] and ledger.free().cpus == 8

    group = WorkerGroup(ScalingConfig(num_workers=2, use_gpu=False,
                                      resources_per_worker={"CPU": 2}), experiment_name="held")
    try:
        group.start_loop(_wait_for_stop, None)
        assert sorted(h.pid for h in ledger.holders()) == sorted(p.pid for p in group.procs)
        assert ledger.free().cpus == 4
    finally:
        group.shutdown()
    assert ledger.holders() == [] and ledger.free().cpus == 8


def test_ending_a_group_waits_for_its_leases(ledger, monkeypatch):
    """``end_process_group`` returns once the group's leases are free, not
    only once its processes are gone. Here the lock of the lease that the
    group's leader holds is also held by a process outside the group, so
    it outlasts the leader as a card host's kernel may make it outlast a
    killed rank: past the deadline the leader's pid is returned; once that
    lock goes, the group has ended."""
    lease, = ledger.acquire([{"CPU": 1}], "group")
    fd = lease.inheritable().fd
    sleep = [sys.executable, "-c", "import time; time.sleep(120)"]
    leader = subprocess.Popen(sleep, pass_fds=[fd], start_new_session=True)
    other = subprocess.Popen(sleep, pass_fds=[fd])
    lease.bind(leader.pid)
    try:
        monkeypatch.setattr(spawn_env, "GROUP_END_S", 0.3)
        assert end_process_group(leader.pid, ledger) == [leader.pid]
        assert [h.pid for h in ledger.holders()] == [leader.pid]
        monkeypatch.undo()
        t0 = time.monotonic()
        threading.Timer(0.5, other.kill).start()
        assert end_process_group(leader.pid, ledger) == []
        assert time.monotonic() - t0 >= 0.5 and ledger.holders() == []
    finally:
        for p in (leader, other):
            p.kill()
            p.wait(30)


def _wait_for_stop(config, conn, inbox, device):
    inbox.recv()


# ---- learner groups ----------------------------------------------------------------


class _NoProcess:
    """Stands in for ``ProcessActor`` where no process may start on a card:
    it keeps the lease it is given (held by this process) and is ready at
    once."""

    def __init__(self, cls, args=(), kwargs=None, *, lease=None, name=None):
        self.lease, self.name, self.kwargs = lease, name, kwargs
        self.ready = PendingResult(self, 0, "__init__")
        self.ready._set(True, None)

    def kill(self):
        self.lease.release()


@pytest.fixture
def on_card_without_processes(monkeypatch):
    monkeypatch.setattr(lg, "resolve_device", lambda device: torch.device("cuda", 0))
    monkeypatch.setattr(lg, "ProcessActor", _NoProcess)


SPEC = RLModuleSpec(observation_dim=4, action_dim=2, hidden=(8,))


def test_resources_per_learner_packs_two_learners_a_card(ledger, on_card_without_processes):
    group = LearnerGroup(SPEC, num_learners=4, resources_per_learner={"GPU": 0.5})
    assert [a.lease.cards for a in group.learners] == [["0"], ["0"], ["1"], ["1"]]
    assert all(a.kwargs["device"] == "cuda" for a in group.learners)
    with pytest.raises(LedgerError, match="ask for 0.5 card"):
        LearnerGroup(SPEC, num_learners=1, resources_per_learner={"GPU": 0.5})
    group.shutdown()
    # no resources named: one card a learner, as before
    group = LearnerGroup(SPEC, num_learners=2)
    assert [a.lease.gpu for a in group.learners] == [{"0": 1.0}, {"1": 1.0}]
    group.shutdown()
    assert ledger.free().cards == 2
    with pytest.raises(ValueError, match="needs a share"):
        LearnerGroup(SPEC, num_learners=1, resources_per_learner={"GPU": 0})


def test_two_policies_groups_get_disjoint_cards(ledger, on_card_without_processes):
    p0 = LearnerGroup(SPEC, num_learners=1, resources_per_learner={"GPU": 1})
    p1 = LearnerGroup(SPEC, num_learners=1, resources_per_learner={"GPU": 1})
    assert {p0.learners[0].lease.cards[0], p1.learners[0].lease.cards[0]} == {"0", "1"}
    # a third policy finds no free card: it raises at once, naming holders
    with pytest.raises(LedgerError, match=re.escape(f"held by pid {os.getpid()}")):
        LearnerGroup(SPEC, num_learners=1, resources_per_learner={"GPU": 1})
    p0.shutdown()
    p1.shutdown()
    assert ledger.holders() == []


def test_learners_on_the_cpu_lease_nothing(ledger):
    group = LearnerGroup(SPEC, num_learners=2, device="cpu",
                         resources_per_learner={"GPU": 0.5})
    try:
        assert ledger.holders() == []
        assert get(group.learners[0].call(os.getenv, "CUDA_VISIBLE_DEVICES")) == ""
    finally:
        group.shutdown()


def test_two_policy_algorithm_holds_disjoint_cards_or_refuses(tmp_path,
                                                            on_card_without_processes):
    """A multi-agent PPO passes ``resources_per_learner`` to each policy's
    group: on two cards the groups hold one each; on one card the second
    group raises, naming the first's learner, and the first is stopped."""
    import functools

    from ray_tpu_torch.rllib import PPOConfig
    from ray_tpu_torch.rllib.env.multi_agent import MultiAgentCartPole

    cfg = (PPOConfig().environment(functools.partial(MultiAgentCartPole, 2))
           .multi_agent(policies={"p0": None, "p1": None},
                        policy_mapping_fn={"agent_0": "p0", "agent_1": "p1"}.__getitem__)
           .learners(num_learners=1, resources_per_learner={"GPU": 1}))
    with use_ledger(CardLedger(str(tmp_path / "two"), cards=["0", "1"], cpus=4)) as led:
        algo = cfg.build(device="cpu")
        try:
            cards = {pid: g.learners[0].lease.cards for pid, g in algo.learner_groups.items()}
            assert cards == {"p0": ["0"], "p1": ["1"]}
        finally:
            algo.stop()
        assert led.holders() == []
    with use_ledger(CardLedger(str(tmp_path / "one"), cards=["0"], cpus=4)) as led:
        with pytest.raises(LedgerError, match=r"held by pid \d+ \(1 remote learners: card 0\)"):
            cfg.build(device="cpu")
        assert led.holders() == []
