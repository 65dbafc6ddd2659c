"""The port's algorithm losses and updates (DQN, IMPALA, APPO, BC, MARWIL,
SAC) against the JAX package's ``_build_update``, on the CPU; then
``tests/test_rllib.py``'s single-process learning tests for them against
the port, at their own settings and limits.

Each parity test starts both packages from the JAX algorithm's weights
(numpy, through ``params_from_jax``) and feeds both the same numpy batch.
The losses are the functions each ``_build_update`` closes over, so the
test holds the code the update runs. SAC's normal draws are JAX's
(``jax.random.normal`` of the update's split keys), passed to the port as
``eps``. Tolerances, fp32 on the CPU:
- losses and their aux values: rtol 1e-5, atol 1e-6;
- gradients: rtol 1e-4, atol 1e-5;
- after 3 updates (Adam, lr 1e-3 unless the config's default): losses
  rtol 1e-5, parameters (and SAC's targets and log-alpha) 1e-5 absolute.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rllib import (
    APPOConfig as JAPPOConfig,
    BCConfig as JBCConfig,
    DQNConfig as JDQNConfig,
    IMPALAConfig as JIMPALAConfig,
    MARWILConfig as JMARWILConfig,
    SACConfig as JSACConfig,
)
from ray_tpu_torch.rllib import (
    APPOConfig,
    BCConfig,
    DQNConfig,
    ExperienceRows,
    IMPALAConfig,
    MARWILConfig,
    PPOConfig,
    SACConfig,
    params_from_jax,
    record_experience,
)

pytestmark = pytest.mark.timeout(300)

LOSS = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)
AFTER_3 = dict(rtol=0, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while a test runs: the RL stack's CPU work is
    thousands of tiny ops, and with the suite's workers sharing the host
    each multithreaded op waits on descheduled OpenMP threads (a [256, 64]
    matmul measured 9 ms instead of 14 µs beside 7 busy processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def closure(fn, name):
    """A name a (jitted) update function closes over."""
    fn = getattr(fn, "__wrapped__", fn)
    return inspect.getclosurevars(fn).nonlocals[name]


def host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def jx(tree):
    return jax.tree.map(jnp.asarray, tree)


def tt(tree, grad=False):
    """numpy leaves -> fresh fp32/int64 CPU tensors (leaf tensors)."""
    def one(a):
        a = np.asarray(a)
        t = torch.tensor(a, dtype=torch.int64 if a.dtype.kind in "iu" else torch.float32)
        return t.requires_grad_() if grad else t

    return {k: tt(v, grad) if isinstance(v, dict) else one(v) for k, v in tree.items()}


def to_np(tree):
    if isinstance(tree, dict):
        return {k: to_np(v) for k, v in tree.items()}
    return tree.detach().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


def assert_close(got, want, tol, what=""):
    got, want = to_np(got), host(want)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), (what, sorted(got), sorted(want))
        for k in want:
            assert_close(got[k], want[k], tol, f"{what}{k}.")
    else:
        np.testing.assert_allclose(got, want, err_msg=what, **tol)


def torch_grads(loss, params: dict) -> dict:
    return dict(zip(params, torch.autograd.grad(loss, list(params.values()), allow_unused=True,
                                                materialize_grads=True)))


def _build(jcfg, tcfg):
    jalgo = jcfg.build()
    talgo = tcfg.build(device="cpu")
    return jalgo, talgo


def _cartpole(cfg, **training):
    return (cfg.environment("CartPole-v1")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=2, rollout_fragment_length=8)
            .training(**training).debugging(seed=0))


def _perturbed(w: dict, seed: int, scale=0.05) -> dict:
    rng = np.random.default_rng(seed)
    return {k: (v + scale * rng.normal(size=v.shape)).astype(np.float32) for k, v in w.items()}


# ---- DQN -------------------------------------------------------------------------


def _dqn_batch(n, seed):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.normal(size=(n, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, n),
        "rewards": rng.normal(size=n).astype(np.float32),
        "next_obs": rng.normal(size=(n, 4)).astype(np.float32),
        "terminals": (rng.random(n) < 0.2).astype(np.float32),
    }


@pytest.mark.parametrize("double_q", [True, False])
def test_dqn_update_matches_jax(double_q):
    jalgo, talgo = _build(_cartpole(JDQNConfig(), double_q=double_q),
                          _cartpole(DQNConfig(), double_q=double_q))
    w = host(jalgo.learner_group.get_weights())
    tgt = _perturbed(w, 1)
    b = _dqn_batch(64, 2)
    jloss, jgrads = jax.value_and_grad(closure(jalgo._update_fn, "loss_fn"))(
        jx(w), jx(tgt), jx(b))
    params = tt(w, grad=True)
    loss, _ = closure(talgo._update_fn, "loss_fn")(params, tt(tgt), tt(b))
    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS)
    assert_close(torch_grads(loss, params), jgrads, GRAD, "grad ")

    jp, jopt = jx(w), jalgo.optimizer.init(jx(w))
    tp = params_from_jax(w)
    topt = talgo.optimizer.init(tp)
    for i in range(3):
        b = _dqn_batch(64, 10 + i)
        jp, jopt, jl = jalgo._update_fn(jp, jopt, jx(tgt), jx(b))
        tp, topt, tl = talgo._update_fn(tp, topt, tt(tgt), tt(b))
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5, err_msg=f"update {i}")
    assert_close(tp, jp, AFTER_3, "param ")
    assert int(topt["count"]) == int(host(jopt)[0].count) == 3


# ---- IMPALA and APPO: V-trace ----------------------------------------------------


def _seq(T, N, seed):
    rng = np.random.default_rng(seed)
    ends = rng.random((T, N)) < 0.15
    terms = ends & (rng.random((T, N)) < 0.5)
    return {
        "obs": rng.normal(size=(T, N, 4)).astype(np.float32),
        "next_obs": rng.normal(size=(T, N, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, (T, N)),
        "rewards": rng.normal(size=(T, N)).astype(np.float32),
        "terminals": terms.astype(np.float32),
        "ends": ends.astype(np.float32),
        "logp_behavior": np.log(rng.uniform(0.2, 0.8, (T, N))).astype(np.float32),
    }


def _scaled(w):
    # policy and value heads that matter: rho far from 1 on both sides
    return {**w, "w_pi": w["w_pi"] * 150.0, "w_v": w["w_v"] * 100.0}


def test_impala_vtrace_update_matches_jax():
    jalgo, talgo = _build(_cartpole(JIMPALAConfig(), lr=1e-3),
                          _cartpole(IMPALAConfig(), lr=1e-3))
    w = _scaled(host(jalgo.learner_group.get_weights()))
    seq = _seq(12, 4, 3)
    (jloss, jaux), jgrads = jax.value_and_grad(
        closure(jalgo._update_fn, "loss_fn"), has_aux=True)(jx(w), jx(seq))
    params = tt(w, grad=True)
    loss, aux = closure(talgo._update_fn, "loss_fn")(params, tt(seq))
    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS)
    for a, b in zip(aux, jaux):
        np.testing.assert_allclose(a.item(), float(b), **LOSS)
    assert 0.1 < float(jaux[3]) and np.isfinite(float(jaux[3]))
    assert_close(torch_grads(loss, params), jgrads, GRAD, "grad ")

    jp, jopt = jx(w), jalgo.optimizer.init(jx(w))
    tp = params_from_jax(w)
    topt = talgo.optimizer.init(tp)
    for i in range(3):
        s = _seq(12, 4, 20 + i)
        jp, jopt, jl, _ = jalgo._update_fn(jp, jopt, jx(s))
        tp, topt, tl, _ = talgo._update_fn(tp, topt, tt(s))
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5, err_msg=f"update {i}")
    assert_close(tp, jp, AFTER_3, "param ")


@pytest.mark.parametrize("use_kl", [False, True])
def test_appo_update_matches_jax(use_kl):
    """V-trace under the target network, PPO's clip on those advantages,
    the KL term; 3 updates with target_network_update_freq 2, so the
    snapshot is retaken after the second."""
    kw = dict(lr=1e-3, use_kl_loss=use_kl, target_network_update_freq=2)
    jalgo, talgo = _build(_cartpole(JAPPOConfig(), **kw), _cartpole(APPOConfig(), **kw))
    w = _scaled(host(jalgo.learner_group.get_weights()))
    tgt = _perturbed(w, 4, scale=0.2)
    seq = _seq(12, 4, 5)
    jloss_fn = closure(closure(jalgo._update_fn, "jitted"), "loss_fn")
    (jloss, jaux), jgrads = jax.value_and_grad(jloss_fn, has_aux=True)(jx(w), jx(tgt), jx(seq))
    params = tt(w, grad=True)
    loss, aux = closure(talgo._update_fn, "loss_fn")(params, tt(tgt), tt(seq))
    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS)
    for a, b in zip(aux, jaux):
        np.testing.assert_allclose(a.item(), float(b), **LOSS)
    assert_close(torch_grads(loss, params), jgrads, GRAD, "grad ")

    jalgo._target_params, jalgo._updates_since_target = jx(tgt), 0
    talgo._target_params, talgo._updates_since_target = tt(tgt), 0
    jp, jopt = jx(w), jalgo.optimizer.init(jx(w))
    tp = params_from_jax(w)
    topt = talgo.optimizer.init(tp)
    for i in range(3):
        s = _seq(12, 4, 30 + i)
        jp, jopt, jl, _ = jalgo._update_fn(jp, jopt, jx(s))
        tp, topt, tl, _ = talgo._update_fn(tp, topt, tt(s))
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5, err_msg=f"update {i}")
    assert_close(tp, jp, AFTER_3, "param ")
    assert talgo._updates_since_target == jalgo._updates_since_target == 1
    assert_close(talgo._target_params, jalgo._target_params, AFTER_3, "target ")


# ---- BC and MARWIL ---------------------------------------------------------------


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    return ExperienceRows([
        {"obs": rng.normal(size=4).astype(np.float32), "actions": int(rng.integers(0, 2)),
         "advantages": float(rng.normal() * 3), "logp_old": -0.7} for _ in range(n)])


@pytest.mark.parametrize("which", ["bc", "marwil"])
def test_bc_marwil_update_matches_jax(which):
    jcls, tcls = (JBCConfig, BCConfig) if which == "bc" else (JMARWILConfig, MARWILConfig)
    rows = _rows(64, 6)
    # the JAX algorithm reads the port's rows: any object with iter_rows()
    jalgo, talgo = _build(_cartpole(jcls()).offline_data(rows),
                          _cartpole(tcls()).offline_data(rows))
    for k in ("obs", "actions", "advantages"):
        np.testing.assert_array_equal(talgo._rows[k], jalgo._rows[k])
    w = _scaled(host(jalgo.learner_group.get_weights()))
    b = {k: v[:32] for k, v in talgo._rows.items()}
    jloss, jgrads = jax.value_and_grad(closure(jalgo._update_fn, "loss_fn"))(jx(w), jx(b))
    params = tt(w, grad=True)
    loss, _ = closure(talgo._update_fn, "loss_fn")(params, tt(b))
    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS)
    assert_close(torch_grads(loss, params), jgrads, GRAD, "grad ")

    jp, jopt = jx(w), jalgo.optimizer.init(jx(w))
    tp = params_from_jax(w)
    topt = talgo.optimizer.init(tp)
    for i in range(3):
        b = {k: v[16 * i: 16 * i + 32] for k, v in talgo._rows.items()}
        jp, jopt, jl = jalgo._update_fn(jp, jopt, jx(b))
        tp, topt, tl = talgo._update_fn(tp, topt, tt(b))
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5, err_msg=f"update {i}")
    assert_close(tp, jp, AFTER_3, "param ")


def test_bc_reads_a_ray_tpu_dataset(ray_start_thread):
    """``offline_data`` takes a JAX-side ``record_experience`` Dataset:
    the port's BC reads its rows as the JAX BC does."""
    from ray_tpu.rllib import record_experience as jrecord

    ds = jrecord("CartPole-v1", num_fragments=1, num_envs=2, rollout_fragment_length=16, seed=1)
    talgo = BCConfig().environment("CartPole-v1").offline_data(ds).build(device="cpu")
    jalgo = JBCConfig().environment("CartPole-v1").offline_data(ds).build()
    assert talgo._rows["obs"].shape == (32, 4)
    for k in ("obs", "actions", "advantages"):
        np.testing.assert_array_equal(talgo._rows[k], jalgo._rows[k])


# ---- SAC -------------------------------------------------------------------------


def _sac_batch(n, seed):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.normal(size=(n, 1)).astype(np.float32),
        "actions": rng.uniform(-1, 1, (n, 1)).astype(np.float32),
        "rewards": rng.normal(size=n).astype(np.float32),
        "next_obs": rng.normal(size=(n, 1)).astype(np.float32),
        "terminals": (rng.random(n) < 0.1).astype(np.float32),
    }


def _eps(key, n, a):
    k1, k2 = jax.random.split(key)
    return np.array(jax.random.normal(k1, (n, a))), np.array(jax.random.normal(k2, (n, a)))


def test_sac_update_matches_jax():
    """The critic, actor and alpha losses and their gradients at one state,
    each with JAX's normal draws; then 3 whole updates (critics, the actor
    against the updated critics, alpha, Polyak) with JAX's split keys."""
    kw = dict(actor_lr=1e-3, critic_lr=1e-3, alpha_lr=1e-3, tau=0.1)
    jcfg = JSACConfig().environment("Reach-v0").training(**kw).debugging(seed=0)
    tcfg = SACConfig().environment("Reach-v0").training(**kw).debugging(seed=0)
    jalgo, talgo = _build(jcfg, tcfg)
    talgo.set_state(host(jalgo.get_state()))
    state = host(jalgo._state)
    b = _sac_batch(32, 7)
    key = jax.random.PRNGKey(11)
    e1, e2 = _eps(key, 32, 1)
    k1, k2 = jax.random.split(key)
    jupdate = jalgo._update_fn
    # critic
    jq = (jx(state["q1"]), jx(state["q2"]))
    jc, jcg = jax.value_and_grad(closure(jupdate, "critic_loss"))(jq, jx(state), jx(b), k1)
    ts = tt(state)
    qs = {**{f"q1_{k}": v.requires_grad_() for k, v in ts["q1"].items()},
          **{f"q2_{k}": v.requires_grad_() for k, v in ts["q2"].items()}}
    c, _ = closure(talgo._update_fn, "critic_loss")(qs, ts, tt(b), torch.from_numpy(e1))
    np.testing.assert_allclose(c.item(), float(jc), **LOSS)
    g = torch_grads(c, qs)
    assert_close({"q1": {k[3:]: v for k, v in g.items() if k.startswith("q1_")},
                  "q2": {k[3:]: v for k, v in g.items() if k.startswith("q2_")}},
                 {"q1": jcg[0], "q2": jcg[1]}, GRAD, "critic grad ")
    # actor
    (ja, jlogp), jag = jax.value_and_grad(closure(jupdate, "actor_loss"), has_aux=True)(
        jx(state["actor"]), jx(state), jx(b), k2)
    ts = tt(state)
    actor = {k: v.requires_grad_() for k, v in ts["actor"].items()}
    a, logp = closure(talgo._update_fn, "actor_loss")(actor, ts, tt(b), torch.from_numpy(e2))
    np.testing.assert_allclose(a.item(), float(ja), **LOSS)
    np.testing.assert_allclose(logp.numpy(), np.asarray(jlogp), rtol=1e-5, atol=1e-5)
    assert_close(torch_grads(a, actor), jag, GRAD, "actor grad ")
    # alpha
    jal, jalg = jax.value_and_grad(closure(jupdate, "alpha_loss"))(jnp.asarray(0.3), jlogp)
    la = torch.tensor(0.3, requires_grad=True)
    al, _ = closure(talgo._update_fn, "alpha_loss")({"log_alpha": la}, logp)
    np.testing.assert_allclose(al.item(), float(jal), **LOSS)
    np.testing.assert_allclose(torch.autograd.grad(al, la)[0].item(), float(jalg), **GRAD)

    # three whole updates
    jstate, jopt = jx(state), jalgo._opt_state
    tstate, topt = talgo._state, talgo._opt_state
    for i in range(3):
        b = _sac_batch(32, 40 + i)
        key = jax.random.PRNGKey(100 + i)
        e1, e2 = _eps(key, 32, 1)
        jstate, jopt, jc, ja, jalpha = jupdate(jstate, jopt, jx(b), key)
        tstate, topt, c, a, alpha = talgo._update_fn(tstate, topt, tt(b), torch.from_numpy(e1),
                                                     torch.from_numpy(e2))
        for got, want in ((c, jc), (a, ja), (alpha, jalpha)):
            np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-6,
                                       err_msg=f"update {i}")
    assert_close(tstate, jstate, AFTER_3, "state ")


# ---- tests/test_rllib.py's single-process learning tests, against the port ------


def test_dqn_learns_cartpole():
    config = (
        DQNConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=0, num_envs_per_env_runner=8,
                     rollout_fragment_length=64)
        .training(
            lr=1e-3,
            train_batch_size=64,
            num_updates_per_iteration=64,
            num_steps_sampled_before_learning_starts=500,
            target_network_update_freq=200,
        )
        .debugging(seed=0)
    )
    algo = config.build(device="cpu")
    first = last = None
    for _ in range(30):
        r = algo.train()
        m = r["episode_return_mean"]
        if not np.isnan(m):
            if first is None:
                first = m
            last = m
    algo.stop()
    assert first is not None
    assert last > first + 15, (first, last)


def test_impala_vtrace_offpolicy_correction():
    config = (
        IMPALAConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=0, num_envs_per_env_runner=8,
                     rollout_fragment_length=50)
        .debugging(seed=1)
    )
    algo = config.build(device="cpu")
    first = last = None
    for _ in range(45):
        r = algo.train()
        assert np.isfinite(r["learner"]["total_loss"])
        m = r["episode_return_mean"]
        if not np.isnan(m):
            if first is None:
                first = m
            last = m
    algo.stop()
    assert last > first + 12, (first, last)


def test_sac_learns_reach():
    config = (
        SACConfig()
        .environment("Reach-v0")
        .env_runners(num_env_runners=0, rollout_fragment_length=200)
        .training(
            num_updates_per_iteration=100,
            train_batch_size=128,
            num_steps_sampled_before_learning_starts=400,
            alpha_lr=1e-3,
        )
        .debugging(seed=0)
    )
    algo = config.build(device="cpu")
    for _ in range(12):
        algo.train()
    learned = algo.evaluate(n_episodes=10)
    algo.stop()
    assert learned > -8, learned


def test_sac_checkpoint_roundtrip(tmp_path):
    config = (SACConfig().environment("Reach-v0")
              .env_runners(rollout_fragment_length=100)
              .training(num_updates_per_iteration=20, num_steps_sampled_before_learning_starts=100)
              .debugging(seed=0))
    algo = config.build(device="cpu")
    for _ in range(3):
        r = algo.train()
    assert r["replay_size"] == 300
    path = algo.save(str(tmp_path / "sac_ckpt"))
    state_before = algo.get_state()["sac"]["log_alpha"]
    algo2 = config.build(device="cpu")
    algo2.restore(path)
    assert np.allclose(algo2.get_state()["sac"]["log_alpha"], state_before)
    assert algo2.iteration == 3
    algo2.train()  # restored state keeps training
    algo.stop()
    algo2.stop()


def test_bc_learns_from_expert_dataset():
    expert = (
        PPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=0, num_envs_per_env_runner=8,
                     rollout_fragment_length=128)
        .training(lr=1e-3, minibatch_size=256, num_epochs=8,
                  entropy_coeff=0.01, vf_clip_param=100.0)
        .debugging(seed=0)
        .build(device="cpu")
    )
    expert_return = 0.0
    for _ in range(40):
        r = expert.train()
        m = r["episode_return_mean"]
        if not np.isnan(m):
            expert_return = m
        if expert_return > 90:
            break
    weights = expert.learner_group.get_weights()
    expert.stop()
    assert expert_return > 50, expert_return

    ds = record_experience(
        "CartPole-v1", num_fragments=8, num_envs=4,
        rollout_fragment_length=100, weights=weights, seed=1,
    )
    assert ds.count() == 8 * 4 * 100

    bc = (
        BCConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=0, num_envs_per_env_runner=4,
                     rollout_fragment_length=100)
        .training(lr=1e-3, num_updates_per_iteration=100)
        .offline_data(ds)
        .debugging(seed=2)
        .build(device="cpu")
    )
    last = float("nan")
    for _ in range(8):
        r = bc.train()
        assert r["num_env_steps_sampled"] == 0  # pure offline
        if not np.isnan(r["episode_return_mean"]):
            last = r["episode_return_mean"]
    bc.stop()
    assert last > expert_return * 0.5, (expert_return, last)


def test_marwil_beats_bc_on_mixed_data():
    ds = record_experience(
        "CartPole-v1", num_fragments=10, num_envs=4,
        rollout_fragment_length=100, weights=None, seed=3,
    )

    def train(config_cls):
        cfg = (
            config_cls()
            .environment("CartPole-v1")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=4,
                         rollout_fragment_length=100)
            .training(num_updates_per_iteration=80)
            .offline_data(ds)
            .debugging(seed=4)
        )
        algo = cfg.build(device="cpu")
        last = float("nan")
        for _ in range(6):
            r = algo.train()
            if not np.isnan(r["episode_return_mean"]):
                last = r["episode_return_mean"]
        algo.stop()
        return last

    marwil_ret = train(MARWILConfig)
    bc_ret = train(BCConfig)
    assert marwil_ret > bc_ret + 10, (bc_ret, marwil_ret)
