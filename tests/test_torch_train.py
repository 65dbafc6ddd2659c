"""The port's training path against the JAX package's, on the CPU.

Params come from the JAX package's ``init_params`` and reach the port
through ``params_from_jax``; tokens, masks and gradients are numpy arrays
from a seed given to both. Configs are ``LlamaConfig.tiny()`` in fp32
(GQA with 2 kv heads of 4, and 1 of 4). Tolerances: 2e-4 on logits and
losses, as the decode tests and the JAX package's own sharded-vs-unsharded
tests use for fp32 on the CPU (the frameworks sum in other orders). Param
grads: 2e-4 of each grad's largest magnitude (plus 2e-4 relative): the
JAX init draws wq/wk with fan_in = head count, so attention scores are
large and the backward amplifies summation-order differences to ~5e-5 of
a grad's scale (the embedding's grad reaches magnitude 10). The
optimizer, which only adds and scales, 1e-6 relative.
On the CPU "splash" runs dense attention in both packages (the kernels are
the card's; they are held against their plain versions on the card).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ray_tpu.models import llama as jl
from ray_tpu.models import training as jt
from ray_tpu.ops.cross_entropy import fused_cross_entropy as jax_fused_ce
from ray_tpu.parallel.mesh import MeshSpec, build_mesh
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models import training as tt
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.ops.cross_entropy import fused_cross_entropy

TOL = dict(rtol=2e-4, atol=2e-4)


def _cfgs(**kw):
    return jl.LlamaConfig.tiny(**kw), tl.LlamaConfig.tiny(**kw)


def _params(jcfg, seed):
    jp = jl.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_jax(jax.device_get(jp), "cpu")


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _batch(cfg, shape, seed, mask: bool):
    batch = {"tokens": _tokens(cfg, shape, seed)}
    if mask:
        m = (np.random.default_rng(seed + 100).random(shape) < 0.7).astype(np.int32)
        m[0] = 0  # one row with nothing to predict
        batch["mask"] = m
    return batch


@pytest.mark.parametrize("attention", ["full", "splash"])
@pytest.mark.parametrize("kv", [2, 1], ids=["kv2", "kv1"])
def test_forward_matches_jax(kv, attention):
    """Mirrors tests/test_models.py:test_forward_shapes and test_gqa_heads,
    with values held to the JAX package's."""
    jcfg, tcfg = _cfgs(n_kv_heads=kv, attention=attention)
    jp, tp = _params(jcfg, seed=kv)
    tokens = _tokens(jcfg, (2, 16), seed=kv)
    want = np.asarray(jl.forward(jp, jnp.asarray(tokens), jcfg))
    got = tl.forward(tp, torch.from_numpy(tokens), tcfg)
    assert got.shape == (2, 16, tcfg.vocab_size) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def test_forward_hidden_with_positions_and_aux_matches_jax():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, seed=5)
    tokens = _tokens(jcfg, (2, 8), seed=5)
    positions = np.asarray([[3, 4, 5, 6, 7, 8, 9, 10], [0, 2, 4, 6, 8, 10, 12, 14]], np.int32)
    jx, jaux = jl.forward_hidden(jp, jnp.asarray(tokens), jcfg, positions=jnp.asarray(positions),
                                 with_aux=True)
    tx, taux = tl.forward_hidden(tp, torch.from_numpy(tokens), tcfg,
                                 positions=torch.from_numpy(positions), with_aux=True)
    np.testing.assert_allclose(tx.detach().numpy(), np.asarray(jx), **TOL)
    assert float(taux) == float(jaux) == 0.0


@pytest.mark.parametrize("mask", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("fused_ce", [False, True], ids=["plain_ce", "fused_ce"])
@pytest.mark.parametrize("attention", ["full", "splash"])
def test_loss_matches_jax(attention, fused_ce, mask):
    jcfg, tcfg = _cfgs(attention=attention, fused_ce=fused_ce)
    jp, tp = _params(jcfg, seed=7)
    batch = _batch(jcfg, (3, 17), seed=7, mask=mask)
    want = float(jl.loss_fn(jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg))
    got = tl.loss_fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), want, **TOL)


def test_loss_with_explicit_labels_matches_jax():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, seed=8)
    batch = {"tokens": _tokens(jcfg, (2, 8), 8), "labels": _tokens(jcfg, (2, 8), 9),
             "mask": np.asarray([[1] * 8, [1, 1, 0, 0, 1, 0, 1, 0]], np.int32)}
    want = float(jl.loss_fn(jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg))
    got = tl.loss_fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    np.testing.assert_allclose(got.item(), want, **TOL)


def _port_grads(tp, batch, tcfg):
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    loss = tl.loss_fn(leaves, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    names = sorted(leaves)
    return loss, dict(zip(names, torch.autograd.grad(loss, [leaves[k] for k in names])))


@pytest.mark.parametrize(
    "attention,kv,fused_ce,mask",
    [("full", 2, False, False), ("splash", 2, True, True), ("splash", 1, False, True)],
    ids=["full-kv2", "splash-kv2-fused-mask", "splash-kv1-mask"],
)
def test_param_grads_match_jax_grad(attention, kv, fused_ce, mask):
    jcfg, tcfg = _cfgs(attention=attention, n_kv_heads=kv, fused_ce=fused_ce)
    jp, tp = _params(jcfg, seed=11)
    batch = _batch(jcfg, (2, 13), seed=11, mask=mask)
    jgrads = jax.grad(jl.loss_fn)(jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    _, tgrads = _port_grads(tp, batch, tcfg)
    assert set(tgrads) == set(jgrads)
    for name, g in tgrads.items():
        want = np.asarray(jgrads[name])
        np.testing.assert_allclose(g.numpy(), want, rtol=2e-4, atol=2e-4 * np.abs(want).max(),
                                   err_msg=name)


def test_remat_on_and_off_give_equal_grads():
    _, tcfg = _cfgs(remat=False)
    jcfg = jl.LlamaConfig.tiny()
    _, tp = _params(jcfg, seed=12)
    batch = _batch(jcfg, (2, 13), seed=12, mask=True)
    l0, g0 = _port_grads(tp, batch, tcfg)
    l1, g1 = _port_grads(tp, batch, dataclasses.replace(tcfg, remat=True))
    assert torch.equal(l0, l1)
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], rtol=1e-6, atol=1e-7)


class _CountDots(TorchDispatchMode):
    """Counts the matmul ops that "dots" saves, as they reach the
    dispatcher."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in tl._DOTS
        return func(*args, **(kwargs or {}))


def _backward_dots(tp, batch, tcfg):
    """(loss, grads, matmuls run by the forward, matmuls run by the backward)."""
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    with _CountDots() as fwd:
        loss = tl.loss_fn(leaves, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    with _CountDots() as bwd:
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss, dict(zip(leaves, grads)), fwd.n, bwd.n


_DOTS_CASES = {"dense": {}, "moe": {"moe_experts": 4, "moe_top_k": 2}}


@pytest.mark.parametrize("kind", list(_DOTS_CASES))
def test_remat_dots_equals_full_and_recomputes_no_matmul(kind):
    """"dots" gives "full"'s loss and grads (rtol 1e-6). Its backward runs
    exactly the matmuls of a backward without remat (every forward matmul
    output is saved), while "full" re-runs the layers' forward matmuls.
    Any other policy is full remat, as in the JAX package."""
    jcfg, base = _cfgs(**_DOTS_CASES[kind])
    _, tp = _params(jcfg, seed=15)
    batch = _batch(jcfg, (2, 13), seed=15, mask=True)
    runs = {
        name: _backward_dots(tp, batch, dataclasses.replace(base, **kw))
        for name, kw in (("none", {"remat": False}),
                         ("full", {"remat": True, "remat_policy": "full"}),
                         ("dots", {"remat": True, "remat_policy": "dots"}),
                         ("other", {"remat": True, "remat_policy": "everything"}))
    }
    loss, grads, _, _ = runs["full"]
    for name in ("dots", "other", "none"):
        torch.testing.assert_close(runs[name][0], loss, rtol=1e-6, atol=0)
        for k, g in grads.items():
            torch.testing.assert_close(runs[name][1][k], g, rtol=1e-6, atol=1e-7, msg=k)
    with _CountDots() as layers:  # the layers' own matmuls: forward_hidden's
        tl.forward_hidden(tp, torch.from_numpy(batch["tokens"][:, :-1]), base)
    bwd_none = runs["none"][3]
    assert layers.n > 0 and runs["none"][2] == runs["full"][2] == runs["dots"][2]
    assert runs["dots"][3] == bwd_none
    # "full" re-runs the layers' matmuls, up to each layer's last whose
    # output no backward reads (the checkpoint stops recomputing once it
    # holds every tensor the backward needs)
    assert runs["full"][3] == runs["other"][3]
    assert bwd_none + layers.n - base.n_layers <= runs["full"][3] <= bwd_none + layers.n


@pytest.mark.parametrize("kind", list(_DOTS_CASES))
def test_remat_dots_matches_jax_dots(kind):
    jcfg, tcfg = _cfgs(remat=True, remat_policy="dots", **_DOTS_CASES[kind])
    jp, tp = _params(jcfg, seed=16)
    batch = _batch(jcfg, (2, 13), seed=16, mask=False)
    jloss, jgrads = jax.value_and_grad(jl.loss_fn)(jp, {"tokens": jnp.asarray(batch["tokens"])}, jcfg)
    loss, grads, _, _ = _backward_dots(tp, batch, tcfg)
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    for name, g in grads.items():
        want = np.asarray(jgrads[name])
        np.testing.assert_allclose(g.numpy(), want, rtol=2e-4, atol=2e-4 * np.abs(want).max(),
                                   err_msg=name)


@pytest.mark.parametrize("mask", [False, True], ids=["nomask", "mask"])
def test_fused_cross_entropy_matches_jax_with_chunk_padding(mask):
    """B*S = 21 tokens in chunks of 8: the last chunk is short (JAX pads it)."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal((3, 7, 16), dtype=np.float32)
    w = (rng.standard_normal((16, 50)) * 0.25).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    m = (rng.random((3, 7)) < 0.6).astype(np.float32) if mask else None

    def jloss(x, w):
        return jax_fused_ce(x, w, jnp.asarray(labels), None if m is None else jnp.asarray(m), chunk_size=8)

    want, (jdx, jdw) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(w).requires_grad_(True)
    got = fused_cross_entropy(tx, tw, torch.from_numpy(labels),
                              None if m is None else torch.from_numpy(m), chunk_size=8)
    dx, dw = torch.autograd.grad(got, (tx, tw))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), rtol=1e-5, atol=1e-6)


def test_optimizer_matches_optax_over_five_steps():
    """default_optimizer vs the JAX package's optax chain on fixed numpy
    grads: step 1 has lr 0 (warmup from 0, evaluated before the count
    moves), step 3's grads are scaled up so that the clip engages."""
    kw = dict(learning_rate=1e-2, weight_decay=0.1, warmup_steps=2, total_steps=6, grad_clip=1.0)
    rng = np.random.default_rng(14)
    params = {"a": rng.standard_normal((4, 3), dtype=np.float32),
              "b": rng.standard_normal((5,), dtype=np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * (30.0 if step == 2 else 0.1)).astype(np.float32)
              for k, v in params.items()} for step in range(5)]
    assert float(optax.global_norm(grads[2])) > 1.0 > float(optax.global_norm(grads[0]))

    jopt = jt.default_optimizer(**kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jp)
    topt = tt.default_optimizer(**kw)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = topt.init(tp)
    for step, g in enumerate(grads):
        jup, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, jup)
        tup, tstate = topt.update({k: torch.from_numpy(v) for k, v in g.items()}, tstate, tp)
        if step == 0:
            assert all(torch.count_nonzero(u) == 0 for u in tup.values())
        tt.apply_updates(tp, tup)
        for k in params:
            np.testing.assert_allclose(tup[k].numpy(), np.asarray(jup[k]), rtol=1e-6, atol=1e-9)
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
    assert tstate["count"] == 5
    for k in params:
        np.testing.assert_allclose(tstate["mu"][k].numpy(), np.asarray(jstate[1][0].mu[k]), rtol=1e-6)
        np.testing.assert_allclose(tstate["nu"][k].numpy(), np.asarray(jstate[1][0].nu[k]), rtol=1e-6)


def test_schedule_matches_optax():
    jsched = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 10, 50)
    tsched = tt.warmup_cosine_decay_schedule(0.0, 3e-4, 10, 50)
    for count in (0, 1, 5, 9, 10, 11, 30, 49, 50, 80):
        # JAX evaluates in fp32, the port in double: they agree to fp32
        # rounding of the peak (3e-4 x 2^-23 = 3.6e-11)
        np.testing.assert_allclose(tsched(count), float(jsched(count)), rtol=1e-6, atol=1e-10)


def test_train_step_tracks_jax_over_five_steps():
    """5 steps of make_train_step from the same params and batch as the JAX
    package's on a 1-device mesh (mirrors test_loss_decreases_under_training):
    losses and pre-clip grad norms agree, and the loss goes down."""
    jcfg, tcfg = _cfgs()
    mesh = build_mesh(MeshSpec(dp=1), devices=jax.devices()[:1])
    jinit, jstep = jt.make_train_step(jcfg, mesh)
    jstate = jinit(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.device_get(jstate.params), "cpu")
    _, tstep = tt.make_train_step(tcfg, device="cpu")
    opt = tt.default_optimizer()
    tstate = tt.TrainState(tparams, opt.init(tparams), 0)
    tokens = _tokens(jcfg, (8, 33), seed=0)
    jbatch, tbatch = {"tokens": jnp.asarray(tokens)}, {"tokens": torch.from_numpy(tokens)}
    jl_, tl_ = [], []
    for i in range(5):
        jstate, jm = jstep(jstate, jbatch)
        tstate, tm = tstep(tstate, tbatch)
        jl_.append(float(jm["loss"]))
        tl_.append(tm["loss"].item())
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=2e-4)
        assert tm["step"] == int(jm["step"]) == i + 1
    np.testing.assert_allclose(tl_, jl_, **TOL)
    assert tl_[-1] < tl_[0], tl_
    for name, p in tstate.params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jstate.params[name]), err_msg=name,
                                   **TOL)


def test_init_fn_is_seeded_on_the_asked_device():
    _, tcfg = _cfgs()
    init_fn, step_fn = tt.make_train_step(tcfg, device="cpu")
    a, b = init_fn(3), init_fn(3)
    assert a.step == 0 and a.opt_state["count"] == 0
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)
    assert all(p.device.type == "cpu" for p in a.params.values())
    state, metrics = step_fn(a, {"tokens": torch.from_numpy(_tokens(tcfg, (2, 9), 3))})
    assert state is a and metrics["step"] == 1 and torch.isfinite(metrics["loss"])


def test_throughput_formulas_match_jax():
    jcfg, tcfg = jl.LlamaConfig(), tl.LlamaConfig()
    assert tt.flops_per_token(tcfg) == jt.flops_per_token(jcfg)
    assert tt.tokens_per_step(tcfg, 4, 2048) == jt.tokens_per_step(jcfg, 4, 2048) == 8192
    assert tt.mfu(tcfg, 1e4, 1, peak_flops=197e12) == jt.mfu(jcfg, 1e4, 1)
    # the port's default peak is the H100 SXM's dense bf16, not v5e's
    assert tt.mfu(tcfg, 1e4, 1) == pytest.approx(1e4 * tt.flops_per_token(tcfg) / 989e12)
