"""RLlib's remote half in the port, at the algorithm level, on the CPU:
``tests/test_rllib.py``'s remote tests against the port at their own
settings and limits (runner processes in place of runner actors), the
default IMPALA and APPO configs, factories that cannot go to a process,
and runners that fail or die.

Every child process is the port's (runner and learner classes of
``ray_tpu_torch.rllib``); after each test none of them is left running.
"""

import functools
import multiprocessing
import os
import signal
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch._private.process_actor import RemoteError, get
from ray_tpu_torch.rllib import (APPOConfig, EnvRunnerGroup, IMPALAConfig, MeanStdFilter,
                                 PPOConfig, RLModuleSpec, SACConfig)
from ray_tpu_torch.rllib.env.multi_agent import MultiAgentCartPole

pytestmark = pytest.mark.timeout(300)


@pytest.fixture(autouse=True)
def _one_thread_and_no_child_left():
    """One intra-op thread here (the children start with one), and no
    child process of the test left alive after it."""
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


def _learns(algo, iters, min_gain, in_flight=None):
    """``iters`` iterations; the return must rise by more than
    ``min_gain`` (and, for IMPALA/APPO, ``in_flight`` samples stay in
    flight every iteration with finite losses)."""
    first = last = None
    try:
        for _ in range(iters):
            r = algo.train()
            if in_flight is not None:
                assert r["num_in_flight_samples"] == in_flight
                assert np.isfinite(r["learner"]["total_loss"])
            m = r["episode_return_mean"]
            if not np.isnan(m):
                first = m if first is None else first
                last = m
    finally:
        algo.stop()
    assert first is not None
    assert last > first + min_gain, (first, last)


# ---- tests/test_rllib.py's remote tests, against the port ---------------------------


def test_ppo_remote_env_runners():
    algo = (PPOConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=2, rollout_fragment_length=50)
            .training(minibatch_size=64, num_epochs=2)
            .build(device="cpu"))
    try:
        r = algo.train()
        assert r["env_runners"]["num_healthy_runners"] == 2
        assert r["num_env_steps_sampled"] == 2 * 2 * 50
    finally:
        algo.stop()


def test_ppo_remote_learners():
    algo = (PPOConfig().environment("CartPole-v1")
            .env_runners(rollout_fragment_length=64)
            .training(minibatch_size=32, num_epochs=1)
            .learners(num_learners=2)
            .build(device="cpu"))
    try:
        r = algo.train()
        assert "total_loss" in r["learner"]
        assert algo.learner_group.placement() == ["cpu"]
    finally:
        algo.stop()


def test_env_runner_fault_tolerance():
    """A runner process killed (SIGKILL) between samples: the next sample
    has at least one healthy runner, the one after two, from a new pid."""
    spec = RLModuleSpec(observation_dim=4, action_dim=2, hidden=(8,))
    group = EnvRunnerGroup("CartPole-v1", spec, num_env_runners=2, rollout_fragment_length=16)
    try:
        _, m = group.sample()
        assert m["num_healthy_runners"] == 2
        old = group.runners[0].pid
        os.kill(old, signal.SIGKILL)
        _, m = group.sample()
        assert m["num_healthy_runners"] >= 1
        _, m = group.sample()
        assert m["num_healthy_runners"] == 2  # the replacement is live again
        assert group.runners[0].pid != old
    finally:
        group.shutdown()


def _impala_like(cfg):
    return (cfg.environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=4, rollout_fragment_length=50)
            .training(lr=5e-4, num_batches_per_iteration=8, entropy_coeff=0.01)
            .debugging(seed=0))


def test_impala_learns_cartpole():
    """IMPALA's pipeline keeps both runners' next samples in flight while
    the update runs, and the return rises by more than 20."""
    _learns(_impala_like(IMPALAConfig()).build(device="cpu"), 25, 20, in_flight=2)


def test_appo_learns_cartpole():
    _learns(_impala_like(APPOConfig()).build(device="cpu"), 25, 25, in_flight=2)


def test_sac_remote_runners_and_checkpoint(tmp_path):
    config = (SACConfig().environment("Reach-v0")
              .env_runners(num_env_runners=2, rollout_fragment_length=100)
              .training(num_updates_per_iteration=20)
              .debugging(seed=0))
    algo = config.build(device="cpu")
    try:
        for _ in range(4):
            r = algo.train()
        assert r["replay_size"] >= 700  # 2 runners x 100 steps x 4 iters
        path = algo.save(str(tmp_path / "sac_ckpt"))
        before = algo.get_state()["sac"]["log_alpha"]
    finally:
        algo.stop()
    algo2 = config.build(device="cpu")
    try:
        algo2.restore(path)
        np.testing.assert_array_equal(algo2.get_state()["sac"]["log_alpha"], before)
        algo2.train()  # the restored state keeps training
    finally:
        algo2.stop()


def test_connector_remote_runners():
    """The connector factory (the class itself) goes to the runner
    processes by reference, each builds its own pipeline, and sampling
    still trains."""
    algo = (PPOConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=4, rollout_fragment_length=50,
                         env_to_module_connector=MeanStdFilter)
            .training(lr=5e-4)
            .debugging(seed=0)
            .build(device="cpu"))
    try:
        for _ in range(3):
            r = algo.train()
        assert np.isfinite(r["learner"]["total_loss"])
        assert r["num_env_steps_sampled"] > 0
        state = algo.env_runner_group.get_connector_state()
        assert state is not None and algo.get_state()["connectors"] is not None
    finally:
        algo.stop()


# ---- building -----------------------------------------------------------------------


@pytest.mark.parametrize("cfg", [IMPALAConfig, APPOConfig])
def test_default_async_configs_build(cfg):
    """IMPALA's and APPO's default configs (2 runner processes) build and
    train one iteration with both samples in flight."""
    algo = cfg().environment("CartPole-v1").build(device="cpu")
    try:
        assert algo.config.num_env_runners == 2 and len(algo.env_runner_group.runners) == 2
        r = algo.train()
        assert r["num_in_flight_samples"] == 2 and np.isfinite(r["learner"]["total_loss"])
    finally:
        algo.stop()


@pytest.mark.parametrize("what", ["connector", "multi_agent_env", "policy_mapping_fn"])
def test_lambda_factories_raise_type_error(what):
    """A factory a runner process must receive goes by reference: a lambda
    raises TypeError when the algorithm is built, saying why."""
    if what == "connector":
        cfg = (PPOConfig().environment("CartPole-v1")
               .env_runners(num_env_runners=2, env_to_module_connector=lambda: MeanStdFilter()))
        name = "env_to_module_connector"
    else:
        env = (lambda: MultiAgentCartPole(2)) if what == "multi_agent_env" else \
            functools.partial(MultiAgentCartPole, 2)
        mapping = (lambda aid: "p") if what == "policy_mapping_fn" else \
            {"agent_0": "p", "agent_1": "p"}.__getitem__
        cfg = (PPOConfig().environment(env)
               .multi_agent(policies={"p": None}, policy_mapping_fn=mapping)
               .env_runners(num_env_runners=1))
        name = "multi-agent env factory" if what == "multi_agent_env" else "policy_mapping_fn"
    with pytest.raises(TypeError, match=f"(?s){name}.*by reference.*not a lambda"):
        cfg.build(device="cpu")


def test_remote_multi_agent_ppo_trains():
    """The multi-agent group's runner processes feed two policies."""
    algo = (PPOConfig().environment(functools.partial(MultiAgentCartPole, 2))
            .multi_agent(policies={"p0": None, "p1": None},
                         policy_mapping_fn={"agent_0": "p0", "agent_1": "p1"}.__getitem__)
            .env_runners(num_env_runners=2, rollout_fragment_length=64)
            .training(minibatch_size=64, num_epochs=1)
            .debugging(seed=0)
            .build(device="cpu"))
    try:
        r = algo.train()
        assert sorted(r["learner"]) == ["p0", "p1"]
        assert r["num_env_steps_sampled"] == 2 * 64
        assert all(np.isfinite(s["total_loss"]) for s in r["learner"].values())
    finally:
        algo.stop()


@pytest.mark.parametrize("which", ["dqn", "bc"])
def test_learner_processes_under_dqn_and_bc(which):
    """DQN and BC take their parameters from the learner group and set them
    back, so their learners may be processes as well."""
    from ray_tpu_torch.rllib import BCConfig, DQNConfig, ExperienceRows

    if which == "dqn":
        cfg = (DQNConfig().environment("CartPole-v1")
               .env_runners(num_env_runners=0, num_envs_per_env_runner=2, rollout_fragment_length=8)
               .training(num_steps_sampled_before_learning_starts=8))
    else:
        rng = np.random.default_rng(0)
        cfg = BCConfig().environment("CartPole-v1").offline_data(ExperienceRows([
            {"obs": rng.normal(size=4).astype(np.float32), "actions": int(rng.integers(0, 2))}
            for _ in range(64)]))
    algo = cfg.learners(num_learners=2).debugging(seed=0).build(device="cpu")
    try:
        before = algo.learner_group.get_weights()
        for _ in range(2):
            r = algo.train()
        loss = r["learner"]["td_loss" if which == "dqn" else "imitation_loss"]
        assert np.isfinite(loss)
        after = algo.learner_group.get_weights()
        assert any(not np.array_equal(after[k], before[k]) for k in after)
        # both processes hold the algorithm's parameters
        w1 = get(algo.learner_group.learners[1].call("get_weights"))
        for k in after:
            np.testing.assert_array_equal(w1[k], after[k])
        np.testing.assert_array_equal(after["w_pi"], algo._params["w_pi"].detach().numpy())
    finally:
        algo.stop()


@pytest.mark.parametrize("which,num_learners", [("bc", 0), ("marwil", 0), ("bc", 2)])
def test_bc_trains_on_from_a_restored_checkpoint(tmp_path, which, num_learners):
    """BC and MARWIL keep parameters of their own and set them on the
    learner group after each iteration, so a restore must reload them:
    a BC built from another seed, restored and trained once, ends near
    the checkpoint's weights, not near those it was built with."""
    from ray_tpu_torch.rllib import BCConfig, ExperienceRows, MARWILConfig

    rng = np.random.default_rng(0)
    rows = ExperienceRows([{"obs": rng.normal(size=4).astype(np.float32),
                            "actions": int(rng.integers(0, 2)),
                            "advantages": float(rng.normal())} for _ in range(64)])

    def build(seed):
        cfg = (BCConfig() if which == "bc" else MARWILConfig()).environment("CartPole-v1")
        cfg.offline_data(rows).training(lr=1e-3, num_updates_per_iteration=5,
                                        train_batch_size=32, evaluation_interval=0)
        return cfg.learners(num_learners=num_learners).debugging(seed=seed).build(device="cpu")

    algo = build(0)
    try:
        algo.train()
        path = algo.save(str(tmp_path / "ckpt"))
        saved = algo.learner_group.get_weights()
    finally:
        algo.stop()
    algo = build(1)
    try:
        built = algo.learner_group.get_weights()
        algo.restore(path)
        algo.train()
        after = algo.learner_group.get_weights()
    finally:
        algo.stop()
    # 5 Adam steps of lr 1e-3 move a weight by about 5e-3 at most
    assert max(float(np.max(np.abs(after[k] - saved[k]))) for k in saved) < 1e-2
    assert max(float(np.max(np.abs(built[k] - saved[k]))) for k in saved) > 0.1


def test_runner_that_cannot_start_raises():
    """No fallback to a local runner: the group raises with the child's
    error, and leaves no process behind."""
    spec = RLModuleSpec(observation_dim=4, action_dim=2, hidden=(8,))
    with pytest.raises(RemoteError, match=r"(?s)env-runner-0\.__init__ raised.*NoSuchEnv"):
        EnvRunnerGroup("NoSuchEnv-v0", spec, num_env_runners=2)


# ---- failures -------------------------------------------------------------------------


def test_runner_application_error_replaces_it():
    """A runner whose sample raises (its env broken), not one that died,
    is replaced all the same: its sample is dropped, its old process is
    gone, and the next sample has both runners."""
    spec = RLModuleSpec(observation_dim=4, action_dim=2, hidden=(8,))
    group = EnvRunnerGroup("CartPole-v1", spec, num_env_runners=2, rollout_fragment_length=16)
    try:
        old = group.runners[0]
        old.call("__setattr__", "venv", None)
        _, m = group.sample()
        assert m["num_healthy_runners"] == 1
        assert not old.is_alive() and old._proc.exitcode is not None
        assert group.runners[0] is not old and group.runners[0].pid != old.pid
        _, m = group.sample()
        assert m["num_healthy_runners"] == 2
    finally:
        group.shutdown()


def test_impala_replaces_a_dead_runner():
    """A runner killed mid-pipeline: ``_next_batch`` replaces it, pushes
    it the weights and resubmits it, so both samples stay in flight."""
    algo = _impala_like(IMPALAConfig()).training(num_batches_per_iteration=4).build(device="cpu")
    try:
        algo.train()
        old = algo.env_runner_group.runners[1].pid
        os.kill(old, signal.SIGKILL)
        for _ in range(2):
            r = algo.train()
            assert r["num_in_flight_samples"] == 2
        assert algo.env_runner_group.runners[1].pid != old
        assert all(r.is_alive() for r in algo.env_runner_group.runners)
    finally:
        algo.stop()
