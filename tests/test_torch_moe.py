"""The port's mixture-of-experts against the JAX package's, on the CPU.

The routing functions of ``parallel/moe.py`` (``topk_gates``, ``_route``,
``moe_dense``), the MoE model's forward, loss and gradients, a MoE train
step, MoE prefill and decode, and MoE serving through the engine. Weights
come from the JAX package's ``init_params`` (or numpy, from a seed) through
``params_from_jax``; inputs are numpy arrays given to both packages. Widths
are ``LlamaConfig.tiny``'s, fp32. Tolerance ``TOL`` (rtol = atol = 2e-4),
the JAX package's own MoE decode-vs-forward limit (tests/test_models.py);
param grads, as in tests/test_torch_train.py, at 2e-4 of each grad's
largest magnitude. Capacity factors 8.0 (no token dropped) and 0.5
(drops), and inputs with tied gate probabilities.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import JaxEngine
from ray_tpu.llm import config as jcfgmod
from ray_tpu.models import llama as jl
from ray_tpu.models import training as jt
from ray_tpu.parallel import moe as jm
from ray_tpu.parallel.mesh import MeshSpec, build_mesh
from ray_tpu_torch.llm import SamplingParams, TorchEngine
from ray_tpu_torch.llm import config as tcfgmod
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models import training as tt
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.parallel import moe as tm

TOL = dict(rtol=2e-4, atol=2e-4)
G, D, F_, E, K = 48, 16, 24, 4, 2
MOE = dict(moe_experts=4, moe_top_k=2)


def _bank(seed, tie=False):
    rng = np.random.default_rng(seed)
    bank = {
        "router": (rng.standard_normal((D, E)) * D**-0.5).astype(np.float32),
        "w_gate": (rng.standard_normal((E, D, F_)) * D**-0.5).astype(np.float32),
        "w_up": (rng.standard_normal((E, D, F_)) * D**-0.5).astype(np.float32),
        "w_down": (rng.standard_normal((E, F_, D)) * F_**-0.5).astype(np.float32),
    }
    if tie:
        # experts 2 and 3 route exactly as 0 and 1: every token sees two
        # tied pairs, and the lower index must win each tie
        bank["router"][:, 2:] = bank["router"][:, :2]
    return bank


def _x(seed, n=G):
    x = np.random.default_rng(seed + 100).standard_normal((n, D)).astype(np.float32)
    x[:4] = 0.0  # all-zero router logits: all E probabilities tied
    return x


def _both(bank, x):
    return ({k: jnp.asarray(v) for k, v in bank.items()}, jnp.asarray(x),
            {k: torch.from_numpy(v) for k, v in bank.items()}, torch.from_numpy(x))


@pytest.mark.parametrize("tie", [False, True], ids=["distinct", "tied"])
def test_topk_gates_match_jax_with_ties(tie):
    jb, jx, tb, tx = _both(_bank(0, tie), _x(0))
    jp, jv, ji = jm.topk_gates(jb, jx, K)
    tp, tv, ti = tm.topk_gates(tb, tx, K)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    # the all-tied rows take experts 0 and 1, at equal gates
    assert (ti[:4].numpy() == [0, 1]).all()
    if tie:
        assert (tv[:, 0] == tv[:, 1]).all()  # each token's two picks are a tied pair


@pytest.mark.parametrize("tie", [False, True], ids=["distinct", "tied"])
@pytest.mark.parametrize("cf", [8.0, 0.5], ids=["dropless", "drops"])
def test_route_matches_jax(cf, tie):
    C = max(1, int(cf * G * K / E))
    jb, jx, tb, tx = _both(_bank(1, tie), _x(1))
    jd, jc, ja = jm._route(jb, jx, E, K, C)
    td, tc, ta = tm._route(tb, tx, E, K, C)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_allclose(ta.item(), float(ja), **TOL)
    kept = td.sum().item()
    assert kept == G * K if cf == 8.0 else kept < G * K  # overflow is dropped


@pytest.mark.parametrize("tie", [False, True], ids=["distinct", "tied"])
@pytest.mark.parametrize("cf", [8.0, 0.5], ids=["dropless", "drops"])
def test_moe_dense_matches_jax(cf, tie):
    jb, jx, tb, tx = _both(_bank(2, tie), _x(2))
    jy, ja = jm.moe_dense(jb, jx, num_experts=E, top_k=K, capacity_factor=cf)
    ty, ta = tm.moe_dense(tb, tx, num_experts=E, top_k=K, capacity_factor=cf)
    assert ty.shape == (G, D) and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(ta.item(), float(ja), **TOL)


@pytest.mark.parametrize("cf", [8.0, 0.5], ids=["dropless", "drops"])
def test_moe_dense_grads_match_jax(cf):
    """d/dx and d/d(bank) of sum(y * r) + aux against jax.grad."""
    bank, x = _bank(3), _x(3)
    r = np.random.default_rng(33).standard_normal((G, D)).astype(np.float32)

    def jloss(b, x):
        y, aux = jm.moe_dense(b, x, num_experts=E, top_k=K, capacity_factor=cf)
        return (y * r).sum() + aux

    jgb, jgx = jax.grad(jloss, argnums=(0, 1))(*_both(bank, x)[:2])
    tb = {k: torch.from_numpy(v).requires_grad_(True) for k, v in bank.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = tm.moe_dense(tb, tx, num_experts=E, top_k=K, capacity_factor=cf)
    grads = torch.autograd.grad((y * torch.from_numpy(r)).sum() + aux, [tx, *tb.values()])
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx), **TOL)
    for name, g in zip(tb, grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgb[name]), err_msg=name, **TOL)


def test_moe_init_shapes_and_seed():
    a = tm.moe_init(E, D, F_, seed=3, device="cpu")
    b = tm.moe_init(E, D, F_, seed=3, device="cpu")
    want = jm.moe_init(jax.random.PRNGKey(0), E, D, F_)
    assert {k: tuple(v.shape) for k, v in a.items()} == {k: v.shape for k, v in want.items()}
    assert all(torch.equal(a[k], b[k]) for k in a)


# ---- the MoE model -----------------------------------------------------------

def _cfgs(**kw):
    kw = {**MOE, **kw}
    return jl.LlamaConfig.tiny(**kw), tl.LlamaConfig.tiny(**kw)


def _params(jcfg, seed):
    jp = jl.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_jax(jax.device_get(jp), "cpu")


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("cf", [8.0, 0.5], ids=["dropless", "drops"])
def test_moe_forward_and_aux_match_jax(cf):
    jcfg, tcfg = _cfgs(moe_capacity_factor=cf)
    jp, tp = _params(jcfg, 4)
    tokens = _tokens(jcfg, (2, 16), 4)
    jx, jaux = jl.forward_hidden(jp, jnp.asarray(tokens), jcfg, with_aux=True)
    tx, taux = tl.forward_hidden(tp, torch.from_numpy(tokens), tcfg, with_aux=True)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), **TOL)
    assert taux.item() > 0
    want = np.asarray(jl.forward(jp, jnp.asarray(tokens), jcfg))
    np.testing.assert_allclose(tl.forward(tp, torch.from_numpy(tokens), tcfg).numpy(), want, **TOL)


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
@pytest.mark.parametrize("fused_ce", [False, True], ids=["plain_ce", "fused_ce"])
def test_moe_loss_and_grads_match_jax(fused_ce, remat):
    """The loss with its aux term, moe_aux_weight * aux, and every grad."""
    jcfg, tcfg = _cfgs(fused_ce=fused_ce, remat=remat, moe_capacity_factor=1.0)
    jp, tp = _params(jcfg, 5)
    batch = {"tokens": _tokens(jcfg, (2, 13), 5)}
    jloss, jgrads = jax.value_and_grad(jl.loss_fn)(jp, {"tokens": jnp.asarray(batch["tokens"])}, jcfg)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    loss = tl.loss_fn(leaves, {"tokens": torch.from_numpy(batch["tokens"])}, tcfg)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    _, aux = tl.forward_hidden(tp, torch.from_numpy(batch["tokens"][:, :-1]), tcfg, with_aux=True)
    dense = tl.loss_fn(tp, {"tokens": torch.from_numpy(batch["tokens"])},
                       tl.LlamaConfig.tiny(**{**MOE, "fused_ce": fused_ce, "moe_capacity_factor": 1.0,
                                              "moe_aux_weight": 0.0}))
    np.testing.assert_allclose(loss.item() - dense.item(), 0.01 * aux.item(), rtol=1e-4, atol=1e-7)
    assert set(grads) == set(jgrads) and "moe_router" in grads
    for name, g in grads.items():
        want = np.asarray(jgrads[name])
        np.testing.assert_allclose(g.numpy(), want, rtol=2e-4, atol=2e-4 * np.abs(want).max(),
                                   err_msg=name)


def test_moe_train_step_learns_and_tracks_jax():
    """Mirrors tests/test_models.py:test_moe_train_step_learns on one
    device: 5 steps from the JAX step's initial params, losses equal to
    the JAX step's on a 1-device mesh, and the last below the first."""
    jcfg, tcfg = _cfgs()
    mesh = build_mesh(MeshSpec(dp=1), devices=jax.devices()[:1])
    jinit, jstep = jt.make_train_step(jcfg, mesh)
    jstate = jinit(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.device_get(jstate.params), "cpu")
    _, tstep = tt.make_train_step(tcfg, device="cpu")
    tstate = tt.TrainState(tparams, tt.default_optimizer().init(tparams), 0)
    tokens = _tokens(jcfg, (8, 33), 0)
    jl_, tl_ = [], []
    for _ in range(5):
        jstate, jmet = jstep(jstate, {"tokens": jnp.asarray(tokens)})
        tstate, tmet = tstep(tstate, {"tokens": torch.from_numpy(tokens)})
        jl_.append(float(jmet["loss"]))
        tl_.append(tmet["loss"].item())
    assert all(np.isfinite(tl_))
    np.testing.assert_allclose(tl_, jl_, **TOL)
    assert tl_[-1] < tl_[0], tl_


@pytest.mark.parametrize("prompt_len", [8, 40], ids=["batched_branch", "expert_loop_branch"])
def test_moe_prefill_and_decode_match_jax_and_forward(prompt_len):
    """Mirrors tests/test_models.py:test_moe_decode_matches_forward. 2 x 8
    prompt tokens (G = 16) take the batched all-experts branch; 2 x 40
    (G = 80 > 64) the expert-by-expert one; decode steps are G = 2."""
    jcfg, tcfg = _cfgs(moe_capacity_factor=8.0)
    jp, tp = _params(jcfg, 7)
    prompt = _tokens(jcfg, (2, prompt_len), 7)
    S = prompt_len + 8
    jlog, jc = jl.prefill(jp, jl.init_kv_cache(jcfg, 2, S), jnp.asarray(prompt), jcfg)
    tlog, tc = tl.prefill(tp, tl.init_kv_cache(tcfg, 2, S, "cpu"), torch.from_numpy(prompt), tcfg)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    full = tl.forward(tp, torch.from_numpy(prompt), tcfg)
    np.testing.assert_allclose(tlog.numpy(), full[:, -1].numpy(), **TOL)
    seq = prompt
    nxt = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    for _ in range(4):
        seq = np.concatenate([seq, nxt[:, None]], axis=1)
        jlog, jc = jl.decode_step(jp, jc, jnp.asarray(nxt), jcfg)
        tlog, tc = tl.decode_step(tp, tc, torch.from_numpy(nxt), tcfg)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        ref = tl.forward(tp, torch.from_numpy(seq), tcfg)[:, -1]
        np.testing.assert_allclose(tlog.numpy(), ref.numpy(), **TOL)
        np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), **TOL)
        nxt = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)


def test_moe_decode_is_dropless_where_training_drops():
    """At capacity factor 0.5 the forward drops tokens; the serving FFN
    never does: its prefill logits equal the dropless forward's."""
    _, drops = _cfgs(moe_capacity_factor=0.5)
    _, dropless = _cfgs(moe_capacity_factor=8.0)
    _, tp = _params(jl.LlamaConfig.tiny(**MOE), 8)
    prompt = torch.from_numpy(_tokens(drops, (2, 12), 8))
    logits, _ = tl.prefill(tp, tl.init_kv_cache(drops, 2, 16, "cpu"), prompt, drops)
    np.testing.assert_allclose(logits.numpy(), tl.forward(tp, prompt, dropless)[:, -1].numpy(), **TOL)
    assert not np.allclose(logits.numpy(), tl.forward(tp, prompt, drops)[:, -1].numpy(), **TOL)


def test_moe_engine_greedy_matches_jax_engine_and_full_forward():
    """Mirrors tests/test_llm.py:test_moe_engine_greedy_matches_full_forward:
    a MoE model served through the port's engine (continuous batching,
    chunked prefill, the prefix cache) gives the JAX engine's greedy tokens
    on the same weights, and each equals the teacher-forced forward's."""
    kw = dict(model_kwargs={**MOE, "moe_capacity_factor": 8.0})

    def cfg(mod):
        return mod.LLMConfig(
            model=mod.ModelConfig(model_id="tiny", tokenizer="byte", seed=0, **kw),
            engine=mod.EngineConfig(max_num_seqs=4, max_seq_len=128, prefill_buckets=(16, 32, 64, 128),
                                    prefill_chunk=16, dtype="float32"),
        )

    jeng = JaxEngine(cfg(jcfgmod))
    teng = TorchEngine(cfg(tcfgmod), device="cpu")
    try:
        assert teng.model_cfg.moe_experts == 4
        teng.params = params_from_jax(jax.device_get(jeng.params), "cpu")
        sp = SamplingParams(max_tokens=5, temperature=0.0, ignore_eos=True)
        prompts = ["abc", "a mixture of experts serves this prompt", "x" * 20]
        for prompt in prompts:
            ids = teng.tokenizer.encode(prompt)
            out = teng.generate(prompt_token_ids=ids, sampling_params=sp)
            assert out.token_ids == jeng.generate(prompt_token_ids=ids, sampling_params=sp).token_ids
            seq = list(ids)
            for _ in range(5):
                logits = tl.forward(teng.params, torch.tensor([seq]), teng.model_cfg)
                seq.append(int(logits[0, -1].argmax()))
            assert out.token_ids == seq[len(ids):]
        assert teng.get_stats()["prefill_mid_chunks"] >= 2  # the 41-token prompt: 3 chunks
    finally:
        jeng.shutdown()
        teng.shutdown()


def test_onehot_dispatch_twin_equals_gather_dispatch():
    """The dispatch benchmark's one-hot einsum twin (the JAX package's
    formulation) and the package's gather dispatch: equal values and
    grads, with and without drops."""
    from ray_tpu_torch.tools.moe_train_bench import moe_dense_onehot

    for cf in (8.0, 0.5):
        bank, x = _bank(9), _x(9)
        outs = []
        for fn in (tm.moe_dense, moe_dense_onehot):
            tb = {k: torch.from_numpy(v).requires_grad_(True) for k, v in bank.items()}
            tx = torch.from_numpy(x).requires_grad_(True)
            y, aux = fn(tb, tx, num_experts=E, top_k=K, capacity_factor=cf)
            outs.append((y, aux, torch.autograd.grad(y.square().sum() + aux, [tx, *tb.values()])))
        (y0, a0, g0), (y1, a1, g1) = outs
        torch.testing.assert_close(y0, y1, **TOL)
        torch.testing.assert_close(a0, a1, **TOL)
        for a, b in zip(g0, g1):
            torch.testing.assert_close(a, b, **TOL)


def test_moe_flop_count_and_depth_rule():
    """The MoE train benchmark's FLOPs a token: with every expert used it
    is training.flops_per_token's count; top-2 of 8 counts a quarter of
    the expert params, capacity slots 1.25x that. The depth rule keeps 16
    layers only under the memory budget."""
    from ray_tpu_torch.tools import moe_train_bench as mb

    cfg = mb.moe_train_config(8)
    every = tl.LlamaConfig(**{**{f: getattr(cfg, f) for f in ("vocab_size", "d_model", "n_layers",
                                                              "n_heads", "n_kv_heads", "d_ff",
                                                              "max_seq_len")},
                              "moe_experts": 8, "moe_top_k": 8, "moe_capacity_factor": 1.0})
    assert mb.flops_per_token(every) == tt.flops_per_token(every)
    expert = 6 * 8 * 3 * cfg.d_model * cfg.d_ff * cfg.n_layers
    assert mb.flops_per_token(cfg) == pytest.approx(tt.flops_per_token(cfg) - expert * 6 / 8)
    assert mb.flops_per_token(cfg, capacity_slots=True) - mb.flops_per_token(cfg) == \
        pytest.approx(expert * 0.25 * 2 / 8)
    layers, why = mb.moe_layers()
    assert (layers == 16) == (mb.reckoned_peak_bytes(mb.moe_train_config(16)) < mb.PEAK_BUDGET_BYTES)
    assert why.startswith(f"{layers} layers")
