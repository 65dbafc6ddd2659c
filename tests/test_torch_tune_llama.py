"""An ASHA sweep over the tiny Llama's learning rate through both packages'
``Tuner``, on the CPU.

The JAX package's trials run JAX's ``make_train_step`` on a 1-device mesh
inside ray_tpu's thread-mode runtime; the port's trials are the port's own
processes running its ``make_train_step``. Both start from the same
well-conditioned fp32 weights (``tests/test_torch_elastic.py``'s draw) and
step on the example's global batches (``examples/train_llama_dp.py:
global_batch``), reporting each step's loss, with ``max_concurrent_trials=1``
so that the sweep's order is the grid's. The two sweeps must give the same
trial configs, the same decisions (which trial ASHA stopped at which
iteration), the same best config, and each trial's losses within rtol 1e-5
(as ``tests/test_torch_elastic.py`` holds the port's steps to JAX's).

Trial processes import this module by name (the port's trainable lives
here), so it imports neither JAX nor ray_tpu at its top.
"""

import multiprocessing

import numpy as np
import pytest

from ray_tpu_torch import tune as ttune
from ray_tpu_torch._private.cards import CardLedger, use_ledger
from tests.test_torch_elastic import _conditioned

pytestmark = pytest.mark.timeout(300)

STEPS = 6
LRS = [3e-3, 1e-4]
LLAMA = {"model": "tiny", "steps": STEPS, "global_batch": 8, "seq_len": 16, "seed": 3}
WEIGHT_SEED = 11


def _opt_kwargs(lr: float) -> dict:
    return dict(learning_rate=lr, warmup_steps=1, total_steps=STEPS)


def port_trainable(config):
    """The port's train step from the shared weights, a loss report a step."""
    import torch

    from ray_tpu_torch.examples import train_llama_dp as ex
    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.models import training as tt

    cfg = ex.model_config(LLAMA)
    params = {k: torch.from_numpy(v) for k, v in
              _conditioned(tl._param_shapes(cfg), WEIGHT_SEED).items()}
    opt = tt.default_optimizer(**_opt_kwargs(config["lr"]))
    _, step_fn = tt.make_train_step(cfg, opt, device=torch.device("cpu"))
    state = tt.TrainState(params, opt.init(params), 0)
    for step in range(STEPS):
        tokens = ex.global_batch(cfg, LLAMA, LLAMA["seed"], step)
        state, m = step_fn(state, {"tokens": torch.from_numpy(tokens)})
        ttune.report({"loss": m["loss"].item()})


def _sweep(tune, trainable, run_config_cls, storage):
    return tune.Tuner(
        trainable,
        param_space={"lr": tune.grid_search(LRS)},
        tune_config=tune.TuneConfig(
            metric="loss", mode="min", max_concurrent_trials=1,
            scheduler=tune.ASHAScheduler(max_t=STEPS, grace_period=2, reduction_factor=2)),
        run_config=run_config_cls(name="asha-lr", storage_path=storage),
    ).fit()


def _summary(results):
    return [(r.config["lr"], [m["loss"] for m in r.metrics_history]) for r in results]


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    from ray_tpu_torch.train import RunConfig

    tmp = tmp_path_factory.mktemp("port-sweep")
    with use_ledger(CardLedger(str(tmp / "ledger"), cards=[], cpus=2)) as ledger:
        results = _sweep(ttune, port_trainable, RunConfig, str(tmp / "results"))
        holders = ledger.holders()
    return results, holders


def test_asha_sweep_matches_jax(port_results, ray_start_thread, tmp_path):
    import jax
    import jax.numpy as jnp

    from ray_tpu import tune as jtune
    from ray_tpu.models import llama as jl
    from ray_tpu.models import training as jt
    from ray_tpu.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu.train import RunConfig as JRunConfig
    from ray_tpu_torch.examples import train_llama_dp as ex
    from ray_tpu_torch.models import llama as tl

    cfg = ex.model_config(LLAMA)
    weights = _conditioned(tl._param_shapes(cfg), WEIGHT_SEED)
    batches = [ex.global_batch(cfg, LLAMA, LLAMA["seed"], s) for s in range(STEPS)]

    def jax_trainable(config):
        jcfg = jl.LlamaConfig.tiny(max_seq_len=LLAMA["seq_len"])
        mesh = build_mesh(MeshSpec(dp=1), devices=jax.devices()[:1])
        jopt = jt.default_optimizer(**_opt_kwargs(config["lr"]))
        _, jstep = jt.make_train_step(jcfg, mesh, optimizer=jopt)
        jp = {k: jnp.asarray(v) for k, v in weights.items()}
        state = jt.TrainState(jp, jopt.init(jp), jnp.zeros((), jnp.int32))
        for tokens in batches:
            jbatch = jax.device_put({"tokens": jnp.asarray(tokens)}, jt.batch_sharding(mesh))
            state, m = jstep(state, jbatch)
            jtune.report({"loss": float(m["loss"])})

    want = _sweep(jtune, jax_trainable, JRunConfig, str(tmp_path / "jax"))
    got, holders = port_results
    assert want.num_errors == 0 and got.num_errors == 0, (want.errors, got.errors)
    w, g = _summary(want), _summary(got)
    assert [lr for lr, _ in g] == [lr for lr, _ in w] == LRS
    # the same trials stopped at the same iterations
    assert [len(losses) for _, losses in g] == [len(losses) for _, losses in w]
    assert len({len(losses) for _, losses in g}) > 1  # ASHA stopped some trials early
    for (_, gl), (_, wl) in zip(g, w):
        np.testing.assert_allclose(gl, wl, rtol=1e-5)
    assert got.get_best_result().config == want.get_best_result().config
    assert holders == [] and multiprocessing.active_children() == []
