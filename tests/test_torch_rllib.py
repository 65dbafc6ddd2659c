"""The port's RLlib core (``ray_tpu_torch.rllib``) against the JAX package's
``ray_tpu.rllib``, on the CPU.

Weights come from the JAX module's init and reach the port through
``params_from_jax``; observations and batches are numpy arrays from a
seed given to both. Tolerances, fp32 on the CPU (the two frameworks sum
in other orders):
- the module's logits and values: 1e-5 (relative and absolute);
- the PPO loss and its stats: rtol 1e-5 (atol 1e-6 for stats near 0);
- gradients: rtol 1e-4, atol 1e-5;
- parameters after 3 Adam updates at lr 1e-3: 1e-5 absolute (Adam's step
  is lr * m / (sqrt(v) + eps), so a leaf's whole change is ~lr a step);
- the env runner's rollout: actions equal for a whole 8 x 128 fragment,
  logp, advantages and value targets 1e-5.

Then the single-process tests of ``tests/test_rllib.py`` against the
port, at their own settings and limits, and ``as_trainable``'s trainable
(the Tune path itself is ``tests/test_torch_tune_trials.py``). The remote half is
``tests/test_torch_rllib_remote*.py``.
"""

import inspect

import cloudpickle
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rllib import JaxLearner, PPOConfig as JPPOConfig
from ray_tpu.rllib.core.rl_module import RLModule as JRLModule, RLModuleSpec as JSpec
from ray_tpu.rllib.env.env_runner import SingleAgentEnvRunner as JRunner
from ray_tpu_torch.rllib import (
    PPO,
    PPOConfig,
    RLModuleSpec,
    SingleAgentEnvRunner,
    TorchLearner,
    params_from_jax,
)
from ray_tpu_torch.rllib.core import rl_module as trm
from ray_tpu_torch.rllib.core.learner import ppo_loss

pytestmark = pytest.mark.timeout(300)

FWD = dict(rtol=1e-5, atol=1e-5)
LOSS = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)
PARAMS_3 = dict(rtol=0, atol=1e-5)


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

SPECS = {
    "mlp": dict(observation_dim=4, action_dim=2, hidden=(16, 16)),
    # MiniBreakout's conv torso: SAME padding is asymmetric at the second
    # conv on 24 x 24 (12 -> 6: one row below, none above)
    "conv24": dict(observation_dim=24 * 24, action_dim=3, hidden=(128,), obs_shape=(24, 24, 1),
                   conv_filters=((16, 4, 2), (32, 3, 2))),
    "conv10": dict(observation_dim=10 * 10 * 2, action_dim=3, hidden=(32,),
                   obs_shape=(10, 10, 2), conv_filters=((16, 4, 2), (32, 3, 2))),
}


def jax_closure(fn, name):
    """A function a JAX ``_build_update`` closed over (its loss), through
    the jitted function's ``__wrapped__``."""
    fn = getattr(fn, "__wrapped__", fn)
    return inspect.getclosurevars(fn).nonlocals[name]


def host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def obs_for(kw, n, rng):
    shape = kw.get("obs_shape") or (kw["observation_dim"],)
    return rng.random((n, *shape), dtype=np.float32) if kw.get("obs_shape") else \
        rng.normal(size=(n, *shape)).astype(np.float32)


def ppo_batch(kw, n, seed):
    rng = np.random.default_rng(seed)
    return {
        "obs": obs_for(kw, n, rng),
        "actions": rng.integers(0, kw["action_dim"], n),
        "logp_old": rng.normal(-0.8, 0.2, n).astype(np.float32),
        "advantages": rng.normal(size=n).astype(np.float32),
        "value_targets": rng.normal(size=n).astype(np.float32),
    }


def torch_batch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def assert_tree_close(got: dict, want: dict, tol, what=""):
    assert sorted(got) == sorted(want), (what, sorted(got), sorted(want))
    for k in want:
        g = got[k].detach().numpy() if isinstance(got[k], torch.Tensor) else np.asarray(got[k])
        np.testing.assert_allclose(g, np.asarray(want[k]), err_msg=f"{what}{k}", **tol)


# ---- the module ------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(SPECS))
def test_module_forward_matches_jax(case):
    kw = SPECS[case]
    jspec, spec = JSpec(**kw), RLModuleSpec(**kw)
    jmod = jspec.build(seed=3)
    obs = obs_for(kw, 7, np.random.default_rng(1))
    jl, jv = JRLModule.forward(jmod.params, jnp.asarray(obs), jspec.arch())
    mod = spec.build(seed=3, device="cpu")
    # the port's own init has JAX's names, shapes and dtypes
    want = host(jmod.get_state())
    got = mod.get_state()
    assert {k: (v.shape, v.dtype) for k, v in got.items()} == \
        {k: (v.shape, v.dtype) for k, v in want.items()}
    mod.set_state(want)
    tl, tv = mod.forward_inference(obs)
    np.testing.assert_allclose(tl, np.asarray(jl), **FWD)
    np.testing.assert_allclose(tv, np.asarray(jv), **FWD)
    assert tl.shape == (7, kw["action_dim"]) and tv.shape == (7,)
    # the functional forward on params_from_jax is the same function
    fl, fv = trm.forward(params_from_jax(want), torch.from_numpy(obs), spec.arch())
    np.testing.assert_array_equal(fl.detach().numpy(), tl)
    np.testing.assert_array_equal(fv.detach().numpy(), tv)


def test_same_padding_is_xla_s():
    # (size, kernel, stride) -> (low, high): asymmetric when the total is odd
    assert trm._same_pad(24, 4, 2) == (1, 1)
    assert trm._same_pad(12, 3, 2) == (0, 1)
    assert trm._same_pad(10, 4, 2) == (1, 1)
    assert trm._same_pad(5, 3, 2) == (1, 1)
    assert trm._same_pad(7, 1, 1) == (0, 0)


# ---- the PPO learner -----------------------------------------------------------------


def _learners(kw, lr=1e-3, **hp):
    spec = RLModuleSpec(**kw)
    jl = JaxLearner(JSpec(**kw), lr=lr, seed=0, **hp)
    tl = TorchLearner(spec, lr=lr, seed=0, device="cpu", **hp)
    tl.set_weights(host(jl.get_weights()))
    return jl, tl


@pytest.mark.parametrize("case", ["mlp", "conv24"])
def test_ppo_update_matches_jax(case):
    """One update: loss, stats and grads; then 3 updates: the params and
    Adam's state (optax's count, mu, nu)."""
    kw = SPECS[case]
    jl, tl = _learners(kw, entropy_coeff=0.01, vf_clip_param=1.0)
    batch = ppo_batch(kw, 64, seed=5)
    # the loss and its gradient, JAX's own loss_fn
    jloss_fn = jax_closure(jl._update, "loss_fn")
    jp = jax.tree.map(jnp.array, jl.module.params)
    (jtotal, jstats), jgrads = jax.value_and_grad(jloss_fn, has_aux=True)(jp, jax_batch(batch))
    params = params_from_jax(host(jp))
    for p in params.values():
        p.requires_grad_()
    total, stats = ppo_loss(params, torch_batch(batch), tl.spec.arch(), tl.hparams)
    grads = dict(zip(params, torch.autograd.grad(total, list(params.values()))))
    np.testing.assert_allclose(total.item(), float(jtotal), **LOSS)
    assert_tree_close(stats, host(jstats), LOSS, "stat ")
    assert_tree_close(grads, host(jgrads), GRAD, "grad ")

    # three updates through each learner's own step, on one minibatch each
    for i in range(3):
        mb = ppo_batch(kw, 64, seed=10 + i)
        jl.module.params, jl.opt_state, js = jl._update(jl.module.params, jl.opt_state,
                                                        jax_batch(mb))
        _, _, ts = tl._update(tl.module.params, tl.opt_state, torch_batch(mb))
        assert_tree_close(ts, host(js), dict(rtol=1e-5, atol=1e-5), f"update {i} ")
    assert_tree_close(tl.get_weights(), host(jl.get_weights()), PARAMS_3, "param ")
    jstate = host(jl.opt_state)
    adam = jstate[1][0]
    got = tl.get_state()["opt_state"]
    assert got["count"].dtype == np.int32 and int(got["count"]) == int(adam.count) == 3
    assert_tree_close(got["mu"], adam.mu, dict(rtol=1e-4, atol=1e-7), "mu ")
    assert_tree_close(got["nu"], adam.nu, dict(rtol=1e-4, atol=1e-9), "nu ")


def test_update_from_batch_matches_jax():
    """The whole learner call: the same permutations from the same seed,
    only the five PPO keys, 2 epochs of 4 minibatches; the last stats."""
    kw = SPECS["mlp"]
    jl, tl = _learners(kw)
    batch = ppo_batch(kw, 256, seed=2)
    batch.update(rewards=np.ones(256, np.float32), terminals=np.zeros(256, np.float32),
                 next_obs=batch["obs"] + 1)
    js = jl.update_from_batch(batch, minibatch_size=64, num_epochs=2)
    ts = tl.update_from_batch(batch, minibatch_size=64, num_epochs=2)
    assert sorted(ts) == sorted(js)
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-5, atol=1e-5, err_msg=k)
    assert_tree_close(tl.get_weights(), host(jl.get_weights()), dict(rtol=0, atol=2e-5))
    assert tl.update_from_batch({"obs": np.zeros((0, 4))}) == {}


# ---- the env runner ------------------------------------------------------------------


def test_runner_sample_matches_jax():
    """A whole 8 x 128 CartPole fragment: the same weights and seed give
    the same actions (the Gumbel argmax over the same numpy draws) and
    logp, GAE advantages and value targets within 1e-5."""
    kw = dict(observation_dim=4, action_dim=2, hidden=(64, 64))
    jr = JRunner("CartPole-v1", cloudpickle.dumps(JSpec(**kw)), num_envs=8,
                 rollout_fragment_length=128, seed=4, emit_sequences=True)
    tr = SingleAgentEnvRunner("CartPole-v1", RLModuleSpec(**kw), num_envs=8,
                              rollout_fragment_length=128, seed=4, emit_sequences=True)
    w = host(jr.module.get_state())
    w["w_pi"] = w["w_pi"] * 100.0  # a policy that prefers, values that vary
    w["w_v"] = w["w_v"] * 300.0
    jr.set_weights({k: jnp.asarray(v) for k, v in w.items()})
    tr.set_weights(w)
    for _ in range(2):  # the second fragment continues mid-episode
        j, t = jr.sample(), tr.sample()
        np.testing.assert_array_equal(t["batch"]["actions"], j["batch"]["actions"])
        np.testing.assert_array_equal(t["batch"]["obs"], j["batch"]["obs"])
        for k in ("logp_old", "advantages", "value_targets"):
            np.testing.assert_allclose(t["batch"][k], j["batch"][k], rtol=1e-5, atol=1e-5,
                                       err_msg=k)
        for k in ("rewards", "terminals", "next_obs"):
            np.testing.assert_array_equal(t["batch"][k], j["batch"][k])
        for k in j["seq"]:
            np.testing.assert_allclose(t["seq"][k], j["seq"][k], rtol=1e-5, atol=1e-5)
        assert t["metrics"] == pytest.approx(j["metrics"], nan_ok=True)


# ---- checkpoints that cross ----------------------------------------------------------


def _ppo_configs(jcls, tcls):
    return [
        c.environment("CartPole-v1")
        .env_runners(rollout_fragment_length=32, num_envs_per_env_runner=2)
        .training(minibatch_size=32, num_epochs=1)
        .debugging(seed=0)
        for c in (jcls(), tcls())
    ]


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    """A JAX PPO ``Algorithm.save`` read by the port's ``restore``:
    weights, Adam's count and moments and the iteration are equal, and the
    next update on one minibatch agrees within the single-update test's
    limits."""
    jcfg, tcfg = _ppo_configs(JPPOConfig, PPOConfig)
    jalgo = jcfg.build()
    jalgo.train()
    jalgo.train()
    path = jalgo.save(str(tmp_path / "jax_ppo"))
    talgo = tcfg.build(device="cpu")
    talgo.restore(path)
    assert talgo.iteration == 2
    assert talgo._total_env_steps == jalgo._total_env_steps
    jstate, tstate = host(jalgo.get_state()), talgo.get_state()
    for k, v in jstate["learner"]["weights"].items():
        np.testing.assert_array_equal(tstate["learner"]["weights"][k], v)
    adam = jstate["learner"]["opt_state"][1][0]
    opt = tstate["learner"]["opt_state"]
    # 2 iterations x 64 rows / minibatch 32
    assert opt["count"].dtype == np.int32 and int(opt["count"]) == int(adam.count) == 4
    for k in adam.mu:
        np.testing.assert_array_equal(opt["mu"][k], adam.mu[k])
        np.testing.assert_array_equal(opt["nu"][k], adam.nu[k])

    jl, tl = jalgo.learner_group._local, talgo.learner_group.learner
    mb = ppo_batch(SPECS["mlp"] | dict(hidden=(64, 64)), 32, seed=9)
    jl.module.params, jl.opt_state, js = jl._update(jl.module.params, jl.opt_state, jax_batch(mb))
    _, _, ts = tl._update(tl.module.params, tl.opt_state, torch_batch(mb))
    assert_tree_close(ts, host(js), dict(rtol=1e-5, atol=1e-5), "stat ")
    assert_tree_close(tl.get_weights(), host(jl.get_weights()), PARAMS_3, "param ")
    jalgo.stop()
    talgo.stop()


def test_port_checkpoint_roundtrip_keeps_the_full_state(tmp_path):
    _, tcfg = _ppo_configs(JPPOConfig, PPOConfig)
    algo = tcfg.build(device="cpu")
    algo.train()
    path = algo.save(str(tmp_path / "port_ppo"))
    algo2 = tcfg.build(device="cpu")
    algo2.restore(path)
    a, b = algo.get_state(), algo2.get_state()
    for part in ("weights",):
        for k in a["learner"][part]:
            np.testing.assert_array_equal(b["learner"][part][k], a["learner"][part][k])
    for m in ("mu", "nu"):
        for k in a["learner"]["opt_state"][m]:
            np.testing.assert_array_equal(b["learner"]["opt_state"][m][k],
                                          a["learner"]["opt_state"][m][k])
    assert int(b["learner"]["opt_state"]["count"]) == int(a["learner"]["opt_state"]["count"])
    assert b["iteration"] == 1 and b["total_env_steps"] == a["total_env_steps"]


# ---- devices and Tune ------------------------------------------------


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchLearner(RLModuleSpec())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _ppo_configs(JPPOConfig, PPOConfig)[1].build()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RLModuleSpec().build()


def test_as_trainable_raises_tune_is_not_ported(monkeypatch):
    """Its name is from before Tune was ported. It checks the adapter that
    ``as_trainable`` now gives (it pickles by reference, as it travels to a
    trial process) and its refusal to run without a card: called outside a
    trial on a host that shows none, it raises rather than put the learner
    on the CPU."""
    import pickle

    from ray_tpu_torch.rllib.algorithms.algorithm import AlgorithmTrainable

    base = PPOConfig().environment("CartPole-v1").env_runners(rollout_fragment_length=8)
    trainable = PPO.as_trainable(base)
    assert isinstance(trainable, AlgorithmTrainable) and trainable.algo_class is PPO
    again = pickle.loads(pickle.dumps(trainable))
    assert again.algo_class is PPO and again.base_config.lr == base.lr
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainable({"stop_iters": 1})


# ---- tests/test_rllib.py's single-process tests, against the port ----------------


def test_rl_module_forward_shapes():
    spec = RLModuleSpec(observation_dim=4, action_dim=2, hidden=(16, 16))
    mod = spec.build(seed=0, device="cpu")
    logits, value = mod.forward_inference(np.zeros((7, 4), np.float32))
    assert logits.shape == (7, 2)
    assert value.shape == (7,)


def test_learner_update_reduces_loss():
    spec = RLModuleSpec(observation_dim=4, action_dim=2, hidden=(16,))
    learner = TorchLearner(spec, lr=1e-2, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    n = 256
    batch = {
        "obs": rng.normal(size=(n, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, n),
        "logp_old": np.full(n, -0.693, np.float32),
        "advantages": rng.normal(size=n).astype(np.float32),
        "value_targets": rng.normal(size=n).astype(np.float32),
    }
    s1 = learner.update_from_batch(batch, minibatch_size=64, num_epochs=1)
    for _ in range(20):
        s2 = learner.update_from_batch(batch, minibatch_size=64, num_epochs=1)
    assert s2["vf_loss"] < s1["vf_loss"]


def test_ppo_single_process_learns_cartpole():
    config = (
        PPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=0, num_envs_per_env_runner=8,
                     rollout_fragment_length=128)
        .training(lr=1e-3, minibatch_size=256, num_epochs=8,
                  entropy_coeff=0.01, vf_clip_param=100.0)
        .debugging(seed=0)
    )
    algo = config.build(device="cpu")
    first, last = None, None
    for _ in range(25):
        result = algo.train()
        if not np.isnan(result["episode_return_mean"]):
            if first is None:
                first = result["episode_return_mean"]
            last = result["episode_return_mean"]
    algo.stop()
    assert first is not None and last is not None
    assert last > first + 20, (first, last)


def test_checkpoint_roundtrip(tmp_path):
    config = (
        PPOConfig()
        .environment("CartPole-v1")
        .env_runners(rollout_fragment_length=32)
        .training(minibatch_size=32, num_epochs=1)
    )
    algo = config.build(device="cpu")
    algo.train()
    path = algo.save(str(tmp_path / "chk"))
    w1 = algo.learner_group.get_weights()

    algo2 = config.build(device="cpu")
    algo2.restore(path)
    w2 = algo2.learner_group.get_weights()
    for k in w1:
        np.testing.assert_allclose(np.asarray(w1[k]), np.asarray(w2[k]))
    assert algo2.iteration == 1
    algo.stop()
    algo2.stop()


def test_multi_agent_ppo_two_policies_learn():
    from ray_tpu_torch.rllib.env.multi_agent import MultiAgentCartPole

    config = (
        PPOConfig()
        .environment(lambda: MultiAgentCartPole(2))
        .multi_agent(
            policies={"p0": None, "p1": None},
            policy_mapping_fn=lambda aid: "p0" if aid == "agent_0" else "p1",
        )
        .env_runners(num_env_runners=0, rollout_fragment_length=256)
        .training(lr=1e-3, minibatch_size=128, num_epochs=6)
        .debugging(seed=0)
    )
    algo = config.build(device="cpu")
    first, last = None, None
    stats = None
    for _ in range(18):
        result = algo.train()
        if not np.isnan(result["episode_return_mean"]):
            if first is None:
                first = result["episode_return_mean"]
            last = result["episode_return_mean"]
            stats = result["learner"]
    algo.stop()
    assert first is not None and last is not None
    assert last > first + 20, (first, last)
    assert set(stats.keys()) == {"p0", "p1"}


def test_multi_agent_shared_policy():
    from ray_tpu_torch.rllib.env.multi_agent import MultiAgentCartPole

    config = (
        PPOConfig()
        .environment(lambda: MultiAgentCartPole(2))
        .multi_agent(
            policies={"shared": None},
            policy_mapping_fn=lambda aid: "shared",
        )
        .env_runners(num_env_runners=0, rollout_fragment_length=128)
        .training(lr=1e-3, minibatch_size=64, num_epochs=4)
        .debugging(seed=0)
    )
    algo = config.build(device="cpu")
    result = None
    for _ in range(3):
        result = algo.train()
    algo.stop()
    assert list(result["learner"].keys()) == ["shared"]
    assert np.isfinite(result["learner"]["shared"]["total_loss"])


def test_connector_pieces_unit():
    from ray_tpu_torch.rllib.connectors import (
        EnvToModulePipeline,
        FrameStack,
        MeanStdFilter,
        PrevActionsPrevRewards,
    )

    fs = FrameStack(k=3)
    f0 = np.zeros((2, 4, 4, 1), np.float32)
    out = fs.transform(f0, update=True, initial=True)
    assert out.shape == (2, 4, 4, 3)
    f1 = np.ones((2, 4, 4, 1), np.float32)
    peek = fs.transform(f1)  # no state advance
    np.testing.assert_array_equal(peek[..., 2], f1[..., 0])
    np.testing.assert_array_equal(peek[..., 0], 0.0)
    out1 = fs.transform(f1, update=True, dones=np.array([False, True]))
    np.testing.assert_array_equal(out1[0, ..., :2], 0.0)
    np.testing.assert_array_equal(out1[0, ..., 2], 1.0)
    np.testing.assert_array_equal(out1[1], 1.0)

    ms = MeanStdFilter()
    rng = np.random.default_rng(0)
    for _ in range(50):
        ms.transform(rng.normal(5.0, 2.0, (64, 3)), update=True)
    out = ms.transform(rng.normal(5.0, 2.0, (512, 3)))
    assert abs(float(out.mean())) < 0.2
    assert abs(float(out.std()) - 1.0) < 0.2

    pa = PrevActionsPrevRewards(action_dim=2)
    o = np.zeros((3, 4), np.float32)
    out = pa.transform(o, update=True, initial=True)
    assert out.shape == (3, 7)
    np.testing.assert_array_equal(out[:, 4:], 0.0)
    pa.note_step(
        np.array([0, 1, 1]), np.array([1.0, 2.0, 3.0]),
        np.array([False, False, True]),
    )
    out = pa.transform(o)
    np.testing.assert_array_equal(out[0, 4:], [1.0, 0.0, 1.0])
    np.testing.assert_array_equal(out[1, 4:], [0.0, 1.0, 2.0])
    np.testing.assert_array_equal(out[2, 4:], [0.0, 1.0, 3.0])
    out = pa.transform(o, update=True)
    np.testing.assert_array_equal(out[0, 4:], [1.0, 0.0, 1.0])
    np.testing.assert_array_equal(out[1, 4:], [0.0, 1.0, 2.0])
    np.testing.assert_array_equal(out[2, 4:], [0.0, 0.0, 0.0])

    pipe = EnvToModulePipeline(FrameStack(k=2), MeanStdFilter())
    pipe.transform(rng.normal(0, 1, (2, 4, 4, 1)), update=True, initial=True)
    state = pipe.get_state()
    pipe2 = EnvToModulePipeline(FrameStack(k=2), MeanStdFilter())
    pipe2.set_state(state)
    x = rng.normal(0, 1, (2, 4, 4, 1))
    np.testing.assert_allclose(pipe.transform(x), pipe2.transform(x))


def test_connector_pipeline_e2e_learning(tmp_path):
    from ray_tpu_torch.rllib import FrameStack, MeanStdFilter

    config = (
        PPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=0, num_envs_per_env_runner=8,
                     rollout_fragment_length=64,
                     env_to_module_connector=lambda: MeanStdFilter())
        .training(lr=5e-4, minibatch_size=128, num_epochs=6)
        .debugging(seed=0)
    )
    algo = config.build(device="cpu")
    first = last = None
    for _ in range(12):
        m = algo.train()["episode_return_mean"]
        if not np.isnan(m):
            if first is None:
                first = m
            last = m
    # filter statistics survive checkpoints
    path = algo.save(str(tmp_path / "conn"))
    algo2 = config.copy().build(device="cpu")
    algo2.restore(path)
    st = algo2.env_runner_group.get_connector_state()
    assert st is not None and st["0"]["count"] > 0
    np.testing.assert_array_equal(st["0"]["mean"],
                                  algo.env_runner_group.get_connector_state()["0"]["mean"])
    algo2.stop()
    algo.stop()
    assert last > first + 15, (first, last)

    config = (
        PPOConfig()
        .environment("MiniBreakout-v0")
        .env_runners(num_env_runners=0, num_envs_per_env_runner=2,
                     rollout_fragment_length=32,
                     env_to_module_connector=lambda: FrameStack(k=2))
        .training(lr=5e-4, minibatch_size=64, num_epochs=1)
        .debugging(seed=0)
    )
    algo = config.build(device="cpu")
    assert algo.module_spec.obs_shape == (24, 24, 2)  # C * k channels
    r = algo.train()
    algo.stop()
    assert np.isfinite(r["learner"]["total_loss"])


def test_vector_envs_match_scalar_envs():
    from ray_tpu_torch.rllib.env.breakout import MiniBreakout
    from ray_tpu_torch.rllib.env.cartpole import CartPole
    from ray_tpu_torch.rllib.env.vector import VecCartPole, VecMiniBreakout

    rng = np.random.default_rng(0)
    N, steps = 3, 300

    venv = VecMiniBreakout(N)
    vobs = venv.reset(seed=42)
    scalars = [MiniBreakout() for _ in range(N)]
    sobs = [e.reset(seed=42 + i)[0] for i, e in enumerate(scalars)]
    np.testing.assert_array_equal(vobs, np.stack(sobs))
    for _ in range(steps):
        acts = rng.integers(0, 3, N)
        vobs, vrew, vterm, vtrunc, vfinal = venv.step(acts)
        for i, e in enumerate(scalars):
            o2, r, tm, tr, _ = e.step(int(acts[i]))
            np.testing.assert_array_equal(vfinal[i], o2)
            assert (vrew[i], vterm[i], vtrunc[i]) == (r, tm, tr)
            if tm or tr:
                o2, _ = e.reset()
            np.testing.assert_array_equal(vobs[i], o2)

    venv = VecCartPole(N)
    vobs = venv.reset(seed=7)
    scalars = [CartPole() for _ in range(N)]
    sobs = [e.reset(seed=7 + i)[0] for i, e in enumerate(scalars)]
    np.testing.assert_array_equal(vobs, np.stack(sobs))
    for _ in range(steps):
        acts = rng.integers(0, 2, N)
        vobs, vrew, vterm, vtrunc, vfinal = venv.step(acts)
        for i, e in enumerate(scalars):
            o2, r, tm, tr, _ = e.step(int(acts[i]))
            np.testing.assert_allclose(vfinal[i], o2, atol=1e-6)
            assert (vterm[i], vtrunc[i]) == (tm, tr)
            if tm or tr:
                o2, _ = e.reset()
            np.testing.assert_allclose(vobs[i], o2, atol=1e-6)


def test_minibreakout_conv_ppo_runs():
    config = (
        PPOConfig()
        .environment("MiniBreakout-v0")
        .env_runners(num_env_runners=0, num_envs_per_env_runner=2,
                     rollout_fragment_length=64)
        .training(lr=5e-4, minibatch_size=64, num_epochs=2)
        .debugging(seed=0)
    )
    algo = config.build(device="cpu")
    assert algo.module_spec.conv_filters  # conv torso selected for pixels
    result = None
    for _ in range(3):
        result = algo.train()
    algo.stop()
    assert np.isfinite(result["learner"]["total_loss"])
    assert result["num_env_steps_sampled"] == 128
