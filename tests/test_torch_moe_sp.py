"""MoE with expert parallelism and sequence parallelism together: the port's
train step on a dp2-sp2-ep2 mesh of 8 gloo ranks against the JAX
package's ``make_train_step`` on the same mesh of its 8 virtual CPU devices.

The JAX ``_moe_ffn`` flattens [B, T, e] to [B T, e] and shards the token
dim over (dp, fsdp, sp), so each device routes a contiguous chunk of its
data shard's flattened rows, not its sequence shard; the port moves its
tokens into that layout and back (``parallel/moe.py:token_chunks``). The
two layouts agree only when a data shard holds one row, so the batch is
8 x 65: 4 rows a dp shard. The model is the JAX sweep's
(``LlamaConfig.tiny(n_heads=4, n_kv_heads=2, max_seq_len=64)``) with ring
attention and 4 experts of top 2, from well-conditioned numpy weights.

Limit: loss and grad norm within rtol 1e-5 of JAX's (the multi-chip
sweep's limit, ``tests/test_torch_sharded.py``). A control step that
routes over each rank's own sequence shard (``token_chunks`` replaced by
the identity) must miss it. The layout moves themselves are held, on one
process, to the flat-chunk definition for several (rows, sp) shapes.

This module imports neither JAX nor ray_tpu at its top: the ranks import
it by name.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.timeout(300)

SIZES = dict(dp=2, sp=2, ep=2)
MODEL_KW = dict(n_heads=4, n_kv_heads=2, max_seq_len=64, attention="ring", moe_experts=4,
                moe_top_k=2)
BATCH = (8, 65)
RTOL = 1e-5


def _conditioned(shapes: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    d = shapes["final_norm"][0]
    return {k: (np.ones(s, np.float32) if "norm" in k
                else (rng.standard_normal(s) / np.sqrt(d)).astype(np.float32))
            for k, s in sorted(shapes.items())}


def _inputs() -> dict:
    from ray_tpu_torch.models import llama as tl

    cfg = tl.LlamaConfig.tiny(**MODEL_KW)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, BATCH).astype(np.int32)
    return {"params": _conditioned(tl._param_shapes(cfg), seed=11), "tokens": tokens}


# ---- the rank loop (module level: the ranks import it by name) ---------------


def _loop(config):
    import torch

    import ray_tpu_torch.train as train
    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.models import training as tt
    from ray_tpu_torch.parallel import moe
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh, shard_params

    cfg = tl.LlamaConfig.tiny(**MODEL_KW)
    mesh = build_mesh(MeshSpec(**SIZES), "cpu")
    batch = tt.shard_batch({"tokens": torch.from_numpy(config["tokens"])}, mesh, cfg)

    def step():
        params = shard_params(mesh, {k: torch.from_numpy(v.copy())
                                     for k, v in config["params"].items()})
        opt = tt.default_optimizer()
        _, fn = tt.make_train_step(cfg, opt, device="cpu", mesh=mesh)
        _, m = fn(tt.TrainState(params, opt.init(params), 0), batch)
        return {"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item()}

    out = {"step": step()}
    chunks = moe.token_chunks
    moe.token_chunks = lambda x, mesh, rows, inverse=False: x  # each rank's own shard
    try:
        out["control"] = step()
    finally:
        moe.token_chunks = chunks
    train.report(out)


@pytest.fixture(scope="module")
def port():
    from ray_tpu_torch.train._internal.worker_group import run_ranks

    inp = _inputs()
    ranks = run_ranks(_loop, inp, 8, use_gpu=False, timeout_s=240)
    return inp, [r[-1] for r in ranks]


@pytest.fixture(scope="module")
def jax_step(port):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import LlamaConfig
    from ray_tpu.models.training import TrainState, default_optimizer, make_train_step
    from ray_tpu.parallel.mesh import MeshSpec, build_mesh

    inp, _ = port
    cfg = LlamaConfig.tiny(**MODEL_KW)
    mesh = build_mesh(MeshSpec(**SIZES), devices=jax.devices()[:8])
    opt = default_optimizer()
    _, step = make_train_step(cfg, mesh, optimizer=opt)
    p = {k: jnp.asarray(v) for k, v in inp["params"].items()}
    _, m = step(TrainState(p, opt.init(p), jnp.zeros((), jnp.int32)),
                {"tokens": jnp.asarray(inp["tokens"])})
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}


def test_dp2_sp2_ep2_moe_step_matches_jax(port, jax_step):
    _, ranks = port
    got = ranks[0]["step"]
    assert all(r["step"] == got for r in ranks)  # the same metrics on every rank
    assert np.isfinite(got["loss"])
    np.testing.assert_allclose(got["loss"], jax_step["loss"], rtol=RTOL)
    np.testing.assert_allclose(got["grad_norm"], jax_step["grad_norm"], rtol=RTOL)


def test_sequence_shard_routing_control_misses_the_limit(port, jax_step):
    """Routing each rank's own sequence shard is a different function at 4
    rows a shard: the loss or the grad norm must leave the 1e-5 limit."""
    _, ranks = port
    ctl = ranks[0]["control"]
    assert np.isfinite(ctl["loss"])
    rel = max(abs(ctl[k] - jax_step[k]) / abs(jax_step[k]) for k in ("loss", "grad_norm"))
    assert rel > RTOL, (ctl, jax_step)


@pytest.mark.parametrize("rows,t_local,sp", [(4, 32, 2), (3, 4, 4), (1, 8, 2), (2, 5, 3)])
def test_token_chunk_moves_follow_the_flat_chunks(rows, t_local, sp):
    """``_chunk_moves`` on one process: what rank s sends, concatenated at
    each destination in source order and taken in its order, is exactly
    the destination's chunk of the flattened [rows, sp t_local] tokens, and
    the inverse moves bring every shard back."""
    import torch

    from ray_tpu_torch.parallel.moe import _chunk_moves

    T, N = sp * t_local, rows * t_local
    flat = np.arange(rows * T).reshape(rows, T)
    shards = [flat[:, s * t_local:(s + 1) * t_local].ravel() for s in range(sp)]
    moves = [_chunk_moves(rows, t_local, sp, s, torch.device("cpu")) for s in range(sp)]

    def exchange(parts, direction):
        sent = []
        for s, part in enumerate(parts):
            send, n_send, _, _ = moves[s][direction]
            out = part[send.numpy()]
            sent.append(np.split(out, np.cumsum(n_send)[:-1]))
        got = []
        for r in range(sp):
            _, _, take, n_recv = moves[r][direction]
            raw = np.concatenate([sent[s][r] for s in range(sp)])
            assert [len(sent[s][r]) for s in range(sp)] == n_recv
            got.append(raw[take.numpy()])
        return got

    chunks = exchange(shards, 0)
    for r in range(sp):
        np.testing.assert_array_equal(chunks[r], np.arange(r * N, (r + 1) * N))
    back = exchange(chunks, 1)
    for s in range(sp):
        np.testing.assert_array_equal(back[s], shards[s])
    if rows == 1:  # the one shape where the layouts agree
        for s in range(sp):
            np.testing.assert_array_equal(chunks[s], shards[s])
