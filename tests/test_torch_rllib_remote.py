"""RLlib's remote half in the port (runner and learner processes,
IMPALA's asynchronous pipeline) against the JAX package's actors, on the
CPU; and the process handle they run on (``_private/process_actor.py``).

The JAX side runs under the suite's ``ray_start_thread`` runtime; the port
side on its own spawned CPU processes. Both start from the same weights
(the JAX package's init, carried as numpy). Tolerances, fp32 on the CPU:
- env data (observations, actions, rewards, terminations): exact; logp,
  advantages and value targets 1e-5; the metrics equal;
- averaged learner weights and stats: 1e-5;
- IMPALA's losses with one runner (a fixed order): rtol 1e-4.

JAX and ray_tpu are imported inside the tests, and every class a child
process hosts lives in the port, so no child imports this module or JAX.
"""

import functools
import multiprocessing
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch._private.process_actor import (ActorDiedError, ProcessActor, RemoteError,
                                                  get, wait)
from ray_tpu_torch._private.cards import CardLedger, use_ledger
from ray_tpu_torch._private.spawn_env import assign_cards
from ray_tpu_torch.rllib import EnvRunnerGroup, IMPALAConfig, LearnerGroup, RLModuleSpec
from ray_tpu_torch.rllib.env.multi_agent import MultiAgentCartPole, MultiAgentEnvRunnerGroup

pytestmark = pytest.mark.timeout(300)

KW = dict(observation_dim=4, action_dim=2, hidden=(16, 16))


@pytest.fixture(autouse=True)
def _one_thread_and_no_child_left():
    """One intra-op thread here (the children start with one), and no
    child process of the test left alive after it: every process a test
    starts is ended by its ``stop``/``shutdown``/``kill``."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    before = {p.pid for p in multiprocessing.active_children()}
    yield
    torch.set_num_threads(n)
    deadline = time.monotonic() + 10.0
    left = [p for p in multiprocessing.active_children() if p.pid not in before]
    while left and time.monotonic() < deadline:
        time.sleep(0.05)
        left = [p for p in multiprocessing.active_children() if p.pid not in before]
    for p in left:
        p.kill()
        p.join(10.0)
    assert not left, f"child processes left running: {left}"


def _host(tree):
    import jax

    return jax.tree.map(np.asarray, jax.device_get(tree))


def _jax_weights(seed=0, scale=True) -> dict:
    """The JAX module's init; with ``scale`` a policy that prefers and
    values that vary (as tests/test_torch_rllib.py's runner test)."""
    from ray_tpu.rllib.core.rl_module import RLModuleSpec as JSpec

    w = _host(JSpec(**KW).build(seed=seed).get_state())
    if scale:
        w["w_pi"] = w["w_pi"] * 100.0
        w["w_v"] = w["w_v"] * 300.0
    return w


def _ppo_batch(n, seed):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.normal(size=(n, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, n),
        "logp_old": rng.normal(-0.8, 0.2, n).astype(np.float32),
        "advantages": rng.normal(size=n).astype(np.float32),
        "value_targets": rng.normal(size=n).astype(np.float32),
    }


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol,
                               err_msg=what)


# ---- runner processes against the JAX package's runner actors --------------------


def test_remote_runner_batches_match_jax(ray_start_thread):
    """Two runners (seeds 3 and 4), two fragments each of 2 envs x 32
    steps, weights pushed with each sample."""
    from ray_tpu.rllib.core.rl_module import RLModuleSpec as JSpec
    from ray_tpu.rllib.env.env_runner import EnvRunnerGroup as JGroup

    args = dict(num_env_runners=2, num_envs_per_runner=2, rollout_fragment_length=32, seed=3)
    jg = JGroup("CartPole-v1", JSpec(**KW), **args)
    tg = EnvRunnerGroup("CartPole-v1", RLModuleSpec(**KW), **args)
    try:
        w = _jax_weights()
        for _ in range(2):  # the second fragment continues mid-episode
            jb, jm = jg.sample(weights=w)
            tb, tm = tg.sample(weights=w)
            assert sorted(tb) == sorted(jb)
            for k in ("obs", "actions", "rewards", "terminals", "next_obs"):
                np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
            for k in ("logp_old", "advantages", "value_targets"):
                _close(tb[k], jb[k], 1e-5, k)
            assert tm == pytest.approx(jm, nan_ok=True)
            assert tm["num_healthy_runners"] == 2
    finally:
        jg.shutdown()
        tg.shutdown()


def test_remote_multi_agent_batches_match_jax(ray_start_thread):
    """Two multi-agent runners, two policies, one fragment of 64 steps."""
    from ray_tpu.rllib.core.rl_module import RLModuleSpec as JSpec
    from ray_tpu.rllib.env.multi_agent import (MultiAgentCartPole as JMACartPole,
                                               MultiAgentEnvRunnerGroup as JMAGroup)

    mapping = {"agent_0": "p0", "agent_1": "p1"}.__getitem__
    args = dict(num_env_runners=2, rollout_fragment_length=64, seed=1)
    jg = JMAGroup(functools.partial(JMACartPole, 2), {p: JSpec(**KW) for p in ("p0", "p1")},
                  mapping, **args)
    tg = MultiAgentEnvRunnerGroup(functools.partial(MultiAgentCartPole, 2),
                                  {p: RLModuleSpec(**KW) for p in ("p0", "p1")}, mapping, **args)
    try:
        weights = {"p0": _jax_weights(0, scale=False), "p1": _jax_weights(1, scale=False)}
        jb, jm = jg.sample(weights=weights)
        tb, tm = tg.sample(weights=weights)
        assert sorted(tb) == sorted(jb) == ["p0", "p1"]
        for pid in jb:
            for k in ("obs", "actions"):
                np.testing.assert_array_equal(tb[pid][k], jb[pid][k], err_msg=f"{pid} {k}")
            for k in ("logp_old", "advantages", "value_targets"):
                _close(tb[pid][k], jb[pid][k], 1e-5, f"{pid} {k}")
        assert tm == pytest.approx(jm, nan_ok=True)
    finally:
        jg.shutdown()
        tg.shutdown()


# ---- learner processes against the JAX package's learner actors ------------------


def _learner_groups(k):
    from ray_tpu.rllib.core.learner_group import LearnerGroup as JLearnerGroup
    from ray_tpu.rllib.core.rl_module import RLModuleSpec as JSpec

    kwargs = dict(lr=1e-3, seed=0)
    jg = JLearnerGroup(JSpec(**KW), num_learners=k, learner_kwargs=kwargs)
    tg = LearnerGroup(RLModuleSpec(**KW), num_learners=k, learner_kwargs=kwargs, device="cpu")
    tg.set_weights(_host(jg.get_weights()))
    return jg, tg


@pytest.mark.parametrize("k,n", [(2, 130), (3, 2)])
def test_remote_learners_average_like_jax(ray_start_thread, k, n):
    """``np.array_split`` shards (130 rows: 65 + 65; 2 rows over 3: one
    learner sits out), minibatch 32 // k, two updates from the same
    weights: the averaged weights and stats within 1e-5, and every learner
    (the idle one too) holding the average."""
    jg, tg = _learner_groups(k)
    try:
        for seed in (5, 6):
            batch = _ppo_batch(n, seed)
            js = jg.update_from_batch(batch, minibatch_size=32, num_epochs=1)
            ts = tg.update_from_batch(batch, minibatch_size=32, num_epochs=1)
            assert sorted(ts) == sorted(js)
            for key in js:
                _close(ts[key], js[key], 1e-5, key)
        want = _host(jg.get_weights())
        for learner in tg.learners:
            got = get(learner.call("get_weights"))
            for key in want:
                _close(got[key], want[key], 1e-5, key)
    finally:
        jg.shutdown()
        tg.shutdown()


@pytest.mark.parametrize("direction", ["remote_to_local", "local_to_remote"])
def test_learner_state_crosses_modes(direction):
    """``get_state`` of one mode (weights, Adam's count and moments)
    restores into the other, on every learner process."""
    spec = RLModuleSpec(**KW)
    local = LearnerGroup(spec, learner_kwargs=dict(lr=1e-3, seed=0), device="cpu")
    remote = LearnerGroup(spec, num_learners=2, learner_kwargs=dict(lr=1e-3, seed=0),
                          device="cpu")
    try:
        src, dst = (remote, local) if direction == "remote_to_local" else (local, remote)
        src.update_from_batch(_ppo_batch(128, 7), minibatch_size=32)
        state = src.get_state()
        assert int(state["opt_state"]["count"]) > 0
        dst.set_state(state)
        states = ([get(l.call("get_state")) for l in dst.learners] if dst is remote
                  else [dst.get_state()])
        for got in states:
            for part in ("weights",):
                for key, v in state[part].items():
                    np.testing.assert_array_equal(got[part][key], v, err_msg=key)
            assert int(got["opt_state"]["count"]) == int(state["opt_state"]["count"])
            for m in ("mu", "nu"):
                for key, v in state["opt_state"][m].items():
                    np.testing.assert_array_equal(got["opt_state"][m][key], v, err_msg=key)
    finally:
        remote.shutdown()


# ---- IMPALA's pipeline against the JAX package's ---------------------------------


def test_impala_pipeline_matches_jax_with_one_runner(ray_start_thread):
    """One runner keeps one sample in flight; its calls run in order, so
    both pipelines consume the same fragments under the same weights: 2
    iterations x 4 batches, the losses within rtol 1e-4."""
    from ray_tpu.rllib import IMPALAConfig as JIMPALAConfig

    cfgs = [c.environment("CartPole-v1")
            .env_runners(num_env_runners=1, num_envs_per_env_runner=4, rollout_fragment_length=50)
            .training(num_batches_per_iteration=4).debugging(seed=0)
            for c in (JIMPALAConfig(), IMPALAConfig())]
    jalgo = cfgs[0].build()
    talgo = cfgs[1].build(device="cpu")
    try:
        talgo.learner_group.set_weights(_host(jalgo.learner_group.get_weights()))
        talgo._pull_params()
        for _ in range(2):
            jr, tr = jalgo.train(), talgo.train()
            assert tr["num_in_flight_samples"] == jr["num_in_flight_samples"] == 1
            assert tr["num_env_steps_sampled"] == jr["num_env_steps_sampled"] == 800
            np.testing.assert_allclose(tr["learner"]["total_loss"], jr["learner"]["total_loss"],
                                       rtol=1e-4)
            assert tr["episode_return_mean"] == pytest.approx(jr["episode_return_mean"],
                                                              nan_ok=True)
    finally:
        jalgo.stop()
        talgo.stop()


# ---- the process handle --------------------------------------------------------------


def test_process_actor_runs_calls_in_order_and_reports_errors():
    """100 calls sent without waiting run in order; a method that raises
    comes back as RemoteError carrying the child's traceback; an argument
    that does not pickle by reference raises TypeError at once; a
    module-level function sent in place of a method name runs in the
    child."""
    a = ProcessActor(list, ([],), name="ordered")
    try:
        pushes = [a.call("append", i) for i in range(100)]
        assert get(a.call("copy"), timeout=60) == list(range(100))
        assert all(h.done for h in pushes)
        with pytest.raises(RemoteError, match=r"(?s)ordered\.index raised.*ValueError: 700 is not"):
            get(a.call("index", 700), timeout=60)
        with pytest.raises(TypeError, match="not a lambda or a closure"):
            a.call("append", lambda: 0)  # the pickle of a call fails in this process
        assert get(a.call("__len__"), timeout=60) == 100
        assert get(a.call(os.getpid), timeout=60) == a.pid != os.getpid()
    finally:
        a.kill()


def test_process_actor_death_fails_pending_calls_at_once():
    """A killed process turns its pending call into ActorDiedError as soon
    as its sentinel fires, long before the call's deadline; calls after it
    fail at once; a call still running past its deadline raises
    TimeoutError; ``kill`` reaps the process."""
    a = ProcessActor(threading.Event, name="event")
    b = ProcessActor(threading.Event, name="slow")
    try:
        get([a.ready, b.ready], timeout=120)
        pending = a.call("wait", 60.0)
        os.kill(a.pid, signal.SIGKILL)
        t0 = time.monotonic()
        with pytest.raises(ActorDiedError, match="exited with code -9 before wait returned"):
            get(pending, timeout=60)
        assert time.monotonic() - t0 < 10.0
        with pytest.raises(ActorDiedError):
            get(a.call("is_set"), timeout=1)
        slow = b.call("wait", 30.0)
        done, rest = wait([slow], timeout=0.2)
        assert done == [] and rest == [slow]
        with pytest.raises(TimeoutError, match="did not return"):
            get(slow, timeout=0.2)
    finally:
        a.kill()
        b.kill()
    assert a._proc.exitcode is not None and b._proc.exitcode is not None


def test_card_requests_name_both_counts(monkeypatch, tmp_path):
    """Remote learners take one card each, leased from the host's card
    ledger (here a test ledger of one card); too few visible cards raise
    naming both counts, and none visible raises (no CPU fallback)."""
    with use_ledger(CardLedger(str(tmp_path), cards=["0"], cpus=4)):
        leases = assign_cards(1, 1, "remote learners")
        assert [lease.cards for lease in leases] == [["0"]]
        leases[0].release()
        with pytest.raises(RuntimeError,
                           match="2 remote learners of 1 card.* need 2 cards, but 1 are"):
            assign_cards(2, 1, "remote learners")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    with pytest.raises(RuntimeError, match="need a CUDA device, but none is visible"):
        assign_cards(1, 1, "remote learners")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LearnerGroup(RLModuleSpec(**KW), num_learners=1)
