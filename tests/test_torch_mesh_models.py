"""The port's model on meshes of 8 gloo ranks against the JAX package's on
its virtual 8-device mesh: the counterparts of the mesh tests of
``tests/test_models.py`` (:50, 61, 174, 190, 206, 225, 246, 262).

One spawn of 8 CPU ranks (the port's worker group, with a deadline) runs
the sharded forward (dp=2, fsdp=2, tp=2), the ring model (sp=4, tp=2),
the pipeline model (dp=2, pp=2, tp=2), MoE on ep (dp=4, ep=2), pipeline +
MoE (dp=2, pp=2, ep=2) and pipeline + ring (dp=2, pp=2, sp=2), each held
to JAX on the same mesh (1e-4 relative on outputs, 1e-5 on losses) and,
as the JAX tests hold them, to the unsharded model; and train steps on
the pipeline, pipeline + MoE and MoE meshes, whose losses must fall, as
in the JAX tests; and one train step with the cross-entropy vocab-parallel
over tp (dp=2, fsdp=2, tp=2), fused and unfused with tied embeddings, held
to JAX's step on the same mesh (loss and grad norm 1e-5 relative) (``test_torch_sharded.py`` holds one step of each mesh
to JAX's).

The weights are drawn well-conditioned (norms one, N(0, 1) / sqrt(d)
elsewhere). The rank loop is module level and this module imports
neither JAX nor ray_tpu at its top: the ranks import it by name.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.timeout(300)


def _conditioned(shapes: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    d = shapes["final_norm"][0]
    return {k: (np.ones(s, np.float32) if "norm" in k
                else (rng.standard_normal(s) / np.sqrt(d)).astype(np.float32))
            for k, s in sorted(shapes.items())}


def _tokens(seed, vocab, shape):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


# (name, model kwargs, mesh sizes, tokens shape, what runs)
MODEL_CASES = {
    "sharded_forward": ({}, dict(dp=2, fsdp=2, tp=2), (4, 16), "forward"),
    "ring_model": ({"attention": "ring"}, dict(sp=4, tp=2), (2, 32), "forward"),
    "pipeline_model": ({"n_layers": 4}, dict(dp=2, pp=2, tp=2), (8, 16), "hidden"),
    "pipeline_train": ({"n_layers": 4}, dict(dp=2, pp=2, tp=2), (8, 33), "train"),
    "moe_ep": ({"moe_experts": 4, "moe_capacity_factor": 8.0}, dict(dp=4, ep=2), (4, 17),
               "loss"),
    "pipeline_moe": ({"n_layers": 4, "moe_experts": 4, "moe_capacity_factor": 8.0,
                      "moe_aux_weight": 0.0}, dict(dp=2, pp=2, ep=2), (8, 17), "loss"),
    "pipeline_moe_train": ({"n_layers": 4, "moe_experts": 4}, dict(dp=2, pp=2, ep=2), (8, 33),
                           "train"),
    "pipeline_ring": ({"n_layers": 4, "attention": "ring"}, dict(dp=2, pp=2, sp=2), (8, 16),
                      "hidden"),
    "moe_train": ({"moe_experts": 4}, dict(dp=4, ep=2), (8, 33), "train"),
    "vocab_parallel_ce": ({"fused_ce": False, "tie_embeddings": True}, dict(dp=2, fsdp=2, tp=2),
                          (4, 17), "step"),
    "vocab_parallel_fused_ce": ({"fused_ce": True}, dict(dp=2, fsdp=2, tp=2), (4, 17), "step"),
}
TRAIN_STEPS = 4


def _model_inputs():
    from ray_tpu_torch.models import llama as tl

    out = {}
    for i, (name, (kw, _, shape, _)) in enumerate(MODEL_CASES.items()):
        cfg = tl.LlamaConfig.tiny(**kw)
        out[name] = {"params": _conditioned(tl._param_shapes(cfg), seed=10 + i),
                     "tokens": _tokens(20 + i, cfg.vocab_size, shape)}
    return out


# ---- the rank loop (module level: the ranks import it by name) ---------------


def _loop(config):
    import torch.distributed as dist

    import ray_tpu_torch.train as train
    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.models import training as tt
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh, shard_params

    out = {}
    for name, (kw, sizes, shape, what) in MODEL_CASES.items():
        cfg = tl.LlamaConfig.tiny(**kw)
        mesh = build_mesh(MeshSpec(**sizes), "cpu")
        inp = config["models"][name]
        params = shard_params(mesh, {k: torch.from_numpy(v.copy())
                                     for k, v in inp["params"].items()})
        tokens = torch.from_numpy(inp["tokens"])
        if what == "train":
            opt = tt.default_optimizer()
            _, step = tt.make_train_step(cfg, opt, device="cpu", mesh=mesh)
            state = tt.TrainState(params, opt.init(params), 0)
            batch = tt.shard_batch({"tokens": tokens}, mesh, cfg)
            losses = []
            for _ in range(TRAIN_STEPS):
                state, m = step(state, batch)
                losses.append(m["loss"].item())
            out[name] = losses
        elif what == "step":
            opt = tt.default_optimizer()
            _, step = tt.make_train_step(cfg, opt, device="cpu", mesh=mesh)
            _, m = step(tt.TrainState(params, opt.init(params), 0),
                        tt.shard_batch({"tokens": tokens}, mesh, cfg))
            out[name] = {"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item()}
        elif what == "loss":
            share = tl.loss_fn(params, tt.shard_batch({"tokens": tokens}, mesh, cfg), cfg,
                               mesh=mesh).detach()
            dist.all_reduce(share)
            out[name] = share.item()
        else:
            rows, cols = tt.batch_index(mesh, cfg, *tokens.shape)
            local = tokens[rows][:, cols]
            with torch.no_grad():
                y = (tl.forward(params, local, cfg, mesh=mesh) if what == "forward"
                     else tl.forward_hidden(params, local, cfg, mesh=mesh))
            out[name] = {"rows": rows.numpy(), "cols": (cols.start, cols.stop), "y": y.numpy()}
    train.report(out)


@pytest.fixture(scope="module")
def port():
    from ray_tpu_torch.train._internal.worker_group import run_ranks

    models = _model_inputs()
    ranks = run_ranks(_loop, {"models": models}, 8, use_gpu=False, timeout_s=240)
    return models, [r[-1] for r in ranks]


def _assemble(per_rank: list, name: str, shape: tuple) -> np.ndarray:
    """The whole output from every rank's piece (copies over tp/ep/pp agree)."""
    out = np.full(shape, np.nan, np.float32)
    for r in per_rank:
        piece = r[name]
        out[piece["rows"], piece["cols"][0]:piece["cols"][1]] = piece["y"]
    assert not np.isnan(out).any()
    return out


# ---- the JAX side --------------------------------------------------------------


def _jax(name):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import llama as jl
    from ray_tpu.parallel.mesh import MeshSpec, build_mesh

    kw, sizes, _, _ = MODEL_CASES[name]
    spec = MeshSpec(**sizes)
    cfg = jl.LlamaConfig.tiny(**kw)
    return cfg, build_mesh(spec, devices=jax.devices()[: spec.total()]), jl, jnp


def test_sharded_forward_matches_jax(port):
    models, per_rank = port
    cfg, mesh, jl, jnp = _jax("sharded_forward")
    inp = models["sharded_forward"]
    p, t = {k: jnp.asarray(v) for k, v in inp["params"].items()}, jnp.asarray(inp["tokens"])
    want = np.asarray(jl.forward(p, t, cfg, mesh))
    got = _assemble(per_rank, "sharded_forward", want.shape)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jl.forward(p, t, cfg)), rtol=2e-4, atol=2e-4)


def test_ring_attention_model_matches_jax(port):
    models, per_rank = port
    cfg, mesh, jl, jnp = _jax("ring_model")
    inp = models["ring_model"]
    p, t = {k: jnp.asarray(v) for k, v in inp["params"].items()}, jnp.asarray(inp["tokens"])
    want = np.asarray(jl.forward(p, t, cfg, mesh))
    got = _assemble(per_rank, "ring_model", want.shape)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jl.forward(p, t, cfg)), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("name", ["pipeline_model", "pipeline_ring"])
def test_pipeline_hidden_matches_jax(port, name):
    models, per_rank = port
    cfg, mesh, jl, jnp = _jax(name)
    inp = models[name]
    p, t = {k: jnp.asarray(v) for k, v in inp["params"].items()}, jnp.asarray(inp["tokens"])
    want = np.asarray(jl.forward_hidden(p, t, cfg, mesh))
    got = _assemble(per_rank, name, want.shape)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    seq = jl.forward_hidden(p, t, jl.LlamaConfig.tiny(n_layers=4, attention="full"))
    np.testing.assert_allclose(got, np.asarray(seq), atol=3e-4)


@pytest.mark.parametrize("name", ["moe_ep", "pipeline_moe"])
def test_moe_loss_matches_jax_same_mesh_and_dense(port, name):
    models, per_rank = port
    cfg, mesh, jl, jnp = _jax(name)
    inp = models[name]
    p = {k: jnp.asarray(v) for k, v in inp["params"].items()}
    b = {"tokens": jnp.asarray(inp["tokens"])}
    got = per_rank[0][name]
    assert all(r[name] == got for r in per_rank)  # the loss on every rank
    np.testing.assert_allclose(got, float(jl.loss_fn(p, b, cfg, mesh)), rtol=1e-5)
    np.testing.assert_allclose(got, float(jl.loss_fn(p, b, cfg)), rtol=2e-3)


@pytest.mark.parametrize("name", ["pipeline_train", "pipeline_moe_train", "moe_train"])
def test_train_steps_learn(port, name):
    _, per_rank = port
    got = per_rank[0][name]
    assert all(r[name] == got for r in per_rank)  # the loss on every rank
    assert np.isfinite(got[0]) and got[-1] < got[0]


@pytest.mark.parametrize("name", ["vocab_parallel_ce", "vocab_parallel_fused_ce"])
def test_vocab_parallel_loss_step_matches_jax(port, name):
    """The cross-entropy with the vocabulary split over tp, unfused (tied
    embeddings, the logits kept) and fused (chunked): one train step's loss
    and grad norm against JAX's step on the same mesh, 1e-5 relative."""
    from ray_tpu.models.training import TrainState, default_optimizer, make_train_step

    models, per_rank = port
    cfg, mesh, jl, jnp = _jax(name)
    inp = models[name]
    p = {k: jnp.asarray(v) for k, v in inp["params"].items()}
    opt = default_optimizer()
    _, step = make_train_step(cfg, mesh, optimizer=opt)
    _, m = step(TrainState(p, opt.init(p), jnp.zeros((), jnp.int32)),
                {"tokens": jnp.asarray(inp["tokens"])})
    got = per_rank[0][name]
    assert all(r[name] == got for r in per_rank)  # the same metrics on every rank
    np.testing.assert_allclose(got["loss"], float(m["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], float(m["grad_norm"]), rtol=1e-5)
