"""The port's train step on the seven meshes of the JAX package's multi-chip
dry run, on 8 gloo ranks, against the JAX step on its virtual 8-device
mesh: the counterpart of ``__graft_entry__``'s ``_dryrun_inline`` (:133).

One spawn of 8 CPU ranks (the port's worker group, with a deadline) runs
the whole sweep of ``__graft_entry__._mesh_sweep(8)`` through
``graft_entry.sweep_loop``: one train step on each of the seven meshes
from the same numpy params and batch as JAX's ``make_train_step`` on the
same mesh; loss and grad norm within 1e-5 relative, the params after the
step within 1e-5 norm-relative error per tensor.

The weights are drawn well-conditioned (norms one, N(0, 1) / sqrt(d)
elsewhere), as in ``test_torch_trainer.py``. The optimizer is AdamW at lr
1e-4 with no warmup: at lr 1e-2 the first AdamW step, lr g / (|g| + eps),
turns an element's summation-order difference where |g| is near eps into
up to 2 lr, so JAX's own 8-device step differs from its 1-device step by
1.6e-5 (norm-relative, w_gate) there; at 1e-4 a wrong gradient shard
would still read ~1e-3.

This module imports neither JAX nor ray_tpu at its top: the ranks import
the modules of their loops by name.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.timeout(300)

SWEEP_OPT = dict(learning_rate=1e-4, warmup_steps=0, total_steps=10)
LABELS = ("pure-dp", "pure-fsdp", "dp2-sp2-tp2", "pp2-dp2-tp2", "ep2-moe", "pp2-ep2-moe",
          "pp2-sp2")


def _conditioned(shapes: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    d = shapes["final_norm"][0]
    return {k: (np.ones(s, np.float32) if "norm" in k
                else (rng.standard_normal(s) / np.sqrt(d)).astype(np.float32))
            for k, s in sorted(shapes.items())}


def _sweep_params():
    from ray_tpu_torch.graft_entry import mesh_sweep, sweep_config
    from ray_tpu_torch.models import llama as tl

    return {label: _conditioned(tl._param_shapes(sweep_config(kw)), seed=3)
            for label, _, kw in mesh_sweep(8)}


@pytest.fixture(scope="module")
def port():
    from ray_tpu_torch.graft_entry import dryrun_multichip

    params = _sweep_params()
    recs = dryrun_multichip(8, "cpu", params=params, optimizer=SWEEP_OPT, gather=True,
                            timeout_s=240)
    return params, {r["label"]: r for r in recs}


@pytest.mark.parametrize("label", LABELS)
def test_sweep_mesh_matches_jax_train_step(port, label):
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as ge
    from ray_tpu.models import LlamaConfig
    from ray_tpu.models.training import TrainState, default_optimizer, make_train_step
    from ray_tpu.parallel.mesh import build_mesh
    from ray_tpu_torch.graft_entry import mesh_sweep, sweep_batch, sweep_config

    sweep_params, sweep = port
    (_, spec, kw), = [m for m in ge._mesh_sweep(8) if m[0] == label]
    (_, tspec, tkw), = [m for m in mesh_sweep(8) if m[0] == label]
    assert tspec.sizes() == spec.sizes() and tkw == kw  # config for config
    cfg = LlamaConfig.tiny(n_heads=4, n_kv_heads=2, max_seq_len=64, **kw)
    mesh = build_mesh(spec, devices=jax.devices()[:8])
    opt = default_optimizer(**SWEEP_OPT)
    _, step = make_train_step(cfg, mesh, optimizer=opt)
    p = {k: jnp.asarray(v) for k, v in sweep_params[label].items()}
    batch = sweep_batch(tspec, sweep_config(tkw))
    state, m = step(TrainState(p, opt.init(p), jnp.zeros((), jnp.int32)),
                    {"tokens": jnp.asarray(batch["tokens"])})
    got = sweep[label]
    np.testing.assert_allclose(got["loss"], float(m["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], float(m["grad_norm"]), rtol=1e-5)
    for k, v in state.params.items():
        v = np.asarray(v)
        assert np.linalg.norm(got["params"][k] - v) / np.linalg.norm(v) <= 1e-5, k
