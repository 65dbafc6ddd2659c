"""``TorchLearner(mesh=)`` on 8 gloo ranks against ``JaxLearner(mesh=dp8)``
on the conftest's virtual 8-device mesh: the counterparts of
``tests/test_rllib.py::test_learner_dp_mesh_sharding`` (:72) and
``::test_conv_learner_on_dp_mesh`` (:846).

Both start from the JAX learner's weights (numpy) and see the same global
batches. Every rank's stats, after each update, and its replicated
parameters must equal JAX's within 1e-5 (rtol and atol): the dp ranks
split each minibatch's rows as JAX's ``PartitionSpec("dp")`` does,
all-reduce the gradients before the clip and average the stats, so the
update is the unsharded one. Parameters are equal bit for bit across the
ranks.

One spawn of 8 ranks for the module (``run_ranks``, with a deadline). The
rank loop is module level and this module imports neither JAX nor ray_tpu
at its top: the ranks import it by name.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.timeout(300)

TOL = dict(rtol=1e-5, atol=1e-5)

CASES = {
    # test_learner_dp_mesh_sharding: 11 updates of one 256-row minibatch,
    # with the extra transition keys the learner must drop
    "mlp": dict(spec=dict(observation_dim=4, action_dim=2, hidden=(16,)), lr=1e-2, rows=256,
                updates=11),
    # test_conv_learner_on_dp_mesh: MiniBreakout frames, 64 rows (8 a rank)
    "conv": dict(spec=dict(observation_dim=24 * 24, action_dim=3, hidden=(64,),
                           obs_shape=(24, 24, 1), conv_filters=((8, 4, 2), (16, 3, 2))),
                 lr=1e-3, rows=64, updates=3),
}


def _batch(case: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    n, spec = case["rows"], case["spec"]
    obs = (rng.random((n, *spec["obs_shape"]), dtype=np.float32) if "obs_shape" in spec
           else rng.normal(size=(n, spec["observation_dim"])).astype(np.float32))
    batch = {
        "obs": obs,
        "actions": rng.integers(0, spec["action_dim"], n),
        "logp_old": np.full(n, -0.693, np.float32),
        "advantages": rng.normal(size=n).astype(np.float32),
        "value_targets": rng.normal(size=n).astype(np.float32),
    }
    if "obs_shape" not in spec:
        batch.update(rewards=np.ones(n, np.float32), next_obs=obs + 1,
                     terminals=np.zeros(n, np.float32))
    return batch


def _loop_dp(config):
    import ray_tpu_torch.train as train
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.rllib import RLModuleSpec, TorchLearner

    mesh = build_mesh(MeshSpec(dp=8), "cpu")
    out = {}
    for name, case in config.items():
        learner = TorchLearner(RLModuleSpec(**case["spec"]), lr=case["lr"], seed=0, mesh=mesh)
        learner.set_weights(case["weights"])
        stats = [learner.update_from_batch(case["batch"], minibatch_size=case["rows"])
                 for _ in range(case["updates"])]
        out[name] = {"stats": stats, "weights": learner.get_weights()}
    train.report(out)


@pytest.fixture(scope="module")
def dp8():
    """(JAX's dp8 stats and weights, each rank's) per case."""
    import jax
    from jax.sharding import Mesh

    from ray_tpu.rllib import JaxLearner
    from ray_tpu.rllib.core.rl_module import RLModuleSpec as JSpec
    from ray_tpu_torch.train._internal.worker_group import run_ranks

    mesh = Mesh(np.array(jax.devices("cpu")[:8]).reshape(8), ("dp",))
    config, want = {}, {}
    for name, case in CASES.items():
        jl = JaxLearner(JSpec(**case["spec"]), lr=case["lr"], seed=0, mesh=mesh)
        batch = _batch(case, seed=0)
        weights = jax.device_get(jl.get_weights())
        config[name] = {**case, "batch": batch, "weights": weights}
        stats = [jl.update_from_batch(batch, minibatch_size=case["rows"])
                 for _ in range(case["updates"])]
        want[name] = {"stats": stats, "weights": jax.device_get(jl.get_weights())}
    ranks = run_ranks(_loop_dp, config, 8, use_gpu=False, timeout_s=240)
    return config, want, [r[0] for r in ranks]


def _check(name, dp8):
    config, want, got = dp8
    assert len(got) == 8
    for rank, out in enumerate(got):
        assert len(out[name]["stats"]) == len(want[name]["stats"])
        for i, (s, w) in enumerate(zip(out[name]["stats"], want[name]["stats"])):
            assert sorted(s) == sorted(w)
            for k in w:
                np.testing.assert_allclose(s[k], w[k], err_msg=f"rank {rank} update {i} {k}",
                                           **TOL)
        for k, v in want[name]["weights"].items():
            np.testing.assert_array_equal(out[name]["weights"][k], got[0][name]["weights"][k])
            np.testing.assert_allclose(out[name]["weights"][k], np.asarray(v),
                                       err_msg=f"rank {rank} {k}", **TOL)
    return config[name], got[0][name]


def test_learner_dp_mesh_sharding(dp8):
    from ray_tpu_torch.rllib import RLModuleSpec, TorchLearner

    case, out = _check("mlp", dp8)
    stats = out["stats"]
    assert stats[-1]["vf_loss"] < stats[0]["vf_loss"]
    # the sharded step is the unsharded one (same seed and data)
    ref = TorchLearner(RLModuleSpec(**case["spec"]), lr=case["lr"], seed=0, device="cpu")
    ref.set_weights(case["weights"])
    r1 = ref.update_from_batch(case["batch"], minibatch_size=case["rows"])
    for k in r1:
        np.testing.assert_allclose(stats[0][k], r1[k], err_msg=k, **TOL)


def test_conv_learner_on_dp_mesh(dp8):
    _, out = _check("conv", dp8)
    assert all(np.isfinite(s["total_loss"]) for s in out["stats"])
