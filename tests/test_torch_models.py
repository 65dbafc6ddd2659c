"""The port's decode path against the JAX package's, on the CPU.

Weights come from the JAX package's ``init_params`` (or numpy, from a seed)
and reach the port through ``params_from_jax``; inputs are numpy arrays
given to both. Configs are ``LlamaConfig.tiny()`` in fp32 with GQA
(n_kv_heads=2 of 4 heads). Tolerance 2e-4, as the JAX package's own
decode-vs-forward tests use for fp32 on the CPU: the two frameworks sum in
different orders.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models.convert import params_from_jax

TOL = dict(rtol=2e-4, atol=2e-4)
PRESETS = ["tiny", "llama2_7b", "llama3_8b", "llama32_3b", "llama3_70b"]


def _cfgs(**kw):
    return jl.LlamaConfig.tiny(**kw), tl.LlamaConfig.tiny(**kw)


def _params(jcfg, seed):
    jp = jl.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_jax(jax.device_get(jp), "cpu")


def _np(t):
    return t.detach().numpy()


def _close_cache(tcache, jcache):
    np.testing.assert_allclose(_np(tcache["k"]), np.asarray(jcache["k"]), **TOL)
    np.testing.assert_allclose(_np(tcache["v"]), np.asarray(jcache["v"]), **TOL)
    np.testing.assert_array_equal(_np(tcache["length"]), np.asarray(jcache["length"]))


@pytest.mark.parametrize("preset", PRESETS)
def test_param_shapes_and_count_match_jax(preset):
    """Shapes come from the config alone: no preset allocates anything."""
    jcfg, tcfg = getattr(jl.LlamaConfig, preset)(), getattr(tl.LlamaConfig, preset)()
    assert tl._param_shapes(tcfg) == jl._param_shapes(jcfg)
    assert tl._layer_keys(tcfg) == jl._layer_keys(jcfg)
    assert tcfg.num_params() == jcfg.num_params()
    assert tcfg.head_dim == jcfg.head_dim


def test_param_shapes_match_jax_for_moe_and_untied():
    for kw in ({"moe_experts": 4}, {"tie_embeddings": True}):
        jcfg, tcfg = _cfgs(**kw)
        assert tl._param_shapes(tcfg) == jl._param_shapes(jcfg)
        assert tcfg.num_params() == jcfg.num_params()


def test_init_params_shapes_dtypes_and_seed():
    tcfg = tl.LlamaConfig.tiny(dtype=torch.bfloat16)
    p1 = tl.init_params(tcfg, seed=3, device="cpu")
    p2 = tl.init_params(tcfg, seed=3, device="cpu")
    shapes = tl._param_shapes(tcfg)
    assert set(p1) == set(shapes)
    for name, t in p1.items():
        assert tuple(t.shape) == shapes[name] and t.dtype == torch.bfloat16
        assert torch.equal(t, p2[name])
    assert torch.all(p1["attn_norm"] == 1) and torch.all(p1["final_norm"] == 1)
    # N(0, 1) * fan_in^-1/2 with fan_in = shape[-2], the JAX package's rule
    for name in ("w_gate", "wq"):
        want = tl._param_shapes(tcfg)[name][-2] ** -0.5
        assert abs(p1[name].float().std().item() - want) < 0.2 * want
    assert sum(t.numel() for t in p1.values()) == tcfg.num_params()


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["fp32", "bf16"])
def test_params_from_jax_roundtrip(dtype):
    jcfg = jl.LlamaConfig.tiny(dtype=dtype)
    jp = jax.device_get(jl.init_params(jax.random.PRNGKey(0), jcfg))
    tp = params_from_jax(jp, "cpu")
    assert set(tp) == set(jp)
    want = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    for k, v in jp.items():
        assert tuple(tp[k].shape) == v.shape and tp[k].dtype == want
        np.testing.assert_array_equal(tp[k].float().numpy(), np.asarray(v, np.float32))
    cast = params_from_jax(jp, "cpu", dtype=torch.float32)
    assert all(t.dtype == torch.float32 for t in cast.values())


def test_rope_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 100, (2, 5)).astype(np.int32)
    ref = jl._rope(jnp.asarray(x), jnp.asarray(pos), 500000.0)
    out = tl._rope(torch.from_numpy(x), torch.from_numpy(pos), 500000.0)
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_prefill_and_decode_match_jax(fused):
    """Prefill logits and cache, then 4 greedy decode steps, with the plain
    norm and with the fused one (JAX: the Pallas kernel in interpret mode;
    port: the kernel's plain version on the CPU)."""
    jcfg, tcfg = _cfgs(fused_rmsnorm=fused)
    jp, tp = _params(jcfg, 3)
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, jcfg.vocab_size, (2, 8)).astype(np.int32)

    jlog, jcache = jl.prefill(jp, jl.init_kv_cache(jcfg, 2, 32), jnp.asarray(prompt), jcfg)
    tcache = tl.init_kv_cache(tcfg, 2, 32, "cpu")
    tlog, tcache2 = tl.prefill(tp, tcache, torch.from_numpy(prompt), tcfg)
    assert tcache2 is tcache  # updated in place
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **TOL)
    _close_cache(tcache, jcache)

    nxt = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    for _ in range(4):
        jlog, jcache = jl.decode_step(jp, jcache, jnp.asarray(nxt), jcfg)
        tlog, tcache = tl.decode_step(tp, tcache, torch.from_numpy(nxt), tcfg)
        np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **TOL)
        assert np.array_equal(_np(tlog.argmax(-1)), np.asarray(jnp.argmax(jlog, -1)))
        nxt = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    _close_cache(tcache, jcache)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_add_norm_prefill_and_decode_match_jax(dtype):
    """fused_rmsnorm=True, where each norm after a residual add is one
    add_rmsnorm: a right-padded batch of two lengths (logits_at gathers
    between the last add and the final norm), then 5 decode steps.

    fp32: logits within TOL and greedy tokens equal, each package decoding
    its own tokens. bf16: both packages round the residual stream to bf16
    at every add; both decode JAX's greedy tokens (near-ties of random
    weights may order differently in bf16), and the logits stay within
    5e-2 of the logit scale (8 significant bits, and the port's LM head
    rounds to bf16 before the upcast: ROADMAP Queue C)."""
    fp32 = dtype == "float32"
    jcfg = jl.LlamaConfig.tiny(fused_rmsnorm=True, dtype=jnp.float32 if fp32 else jnp.bfloat16)
    tcfg = tl.LlamaConfig.tiny(fused_rmsnorm=True, dtype=getattr(torch, dtype))
    jp, tp = _params(jcfg, 11)
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, jcfg.vocab_size, (2, 9)).astype(np.int32)
    lengths = np.asarray([9, 4], np.int32)

    def close(t, j):
        t, j = _np(t.float()), np.asarray(j, np.float32)
        if fp32:
            np.testing.assert_allclose(t, j, **TOL)
        else:
            assert np.abs(t - j).max() <= 5e-2 * np.abs(j).max()

    jlog, jc = jl.prefill(jp, jl.init_kv_cache(jcfg, 2, 32), jnp.asarray(prompt), jcfg,
                          lengths=jnp.asarray(lengths))
    tc = tl.init_kv_cache(tcfg, 2, 32, "cpu")
    tlog, _ = tl.prefill(tp, tc, torch.from_numpy(prompt), tcfg,
                         lengths=torch.from_numpy(lengths))
    for _ in range(5):
        close(tlog, jlog)
        jnxt = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
        if fp32:
            assert np.array_equal(_np(tlog.argmax(-1)), jnxt)
        jlog, jc = jl.decode_step(jp, jc, jnp.asarray(jnxt), jcfg)
        tlog, tc = tl.decode_step(tp, tc, torch.from_numpy(jnxt), tcfg)
    close(tlog, jlog)
    np.testing.assert_array_equal(_np(tc["length"]), np.asarray(jc["length"]))


@pytest.mark.parametrize("call", ["decode", "prefill_final", "prefill_mid"])
def test_fused_decode_forward_norm_wiring(call, monkeypatch):
    """Which norms the fused decode path runs as add_rmsnorm: 2L+1 norms a
    decode step, all but the first fused with their residual add; a final
    prefill chunk gathers (logits_at) before the final norm, so that norm
    runs alone; a mid chunk has no final norm. The unfused path gives the
    same logits on the same weights (fp32, TOL)."""
    tcfg = tl.LlamaConfig.tiny(fused_rmsnorm=True, n_layers=3)
    tp = tl.init_params(tcfg, seed=2, device="cpu")
    tp = {k: v + 0.1 * torch.randn_like(v) if "norm" in k else v for k, v in tp.items()}
    calls = {"add_rmsnorm": 0, "rmsnorm": 0}
    real_add, real_norm = tl.add_rmsnorm, tl._rmsnorm

    def add(*a):
        calls["add_rmsnorm"] += 1
        return real_add(*a)

    def norm(*a):
        calls["rmsnorm"] += 1
        return real_norm(*a)

    monkeypatch.setattr(tl, "add_rmsnorm", add)
    monkeypatch.setattr(tl, "_rmsnorm", norm)
    toks = torch.tensor([[5, 9, 2, 7]], dtype=torch.int32)

    def run(cfg):
        cache = tl.init_kv_cache(cfg, 1, 16, "cpu")
        if call == "decode":
            tl.prefill(tp, cache, toks, cfg)
            calls.update(add_rmsnorm=0, rmsnorm=0)
            return tl.decode_step(tp, cache, toks[:, 0], cfg)[0]
        return tl.prefill(tp, cache, toks, cfg, with_logits=call == "prefill_final")[0]

    fused = run(tcfg)
    L = tcfg.n_layers
    want = {"decode": (2 * L, 1), "prefill_final": (2 * L - 1, 2), "prefill_mid": (2 * L - 1, 1)}
    assert (calls["add_rmsnorm"], calls["rmsnorm"]) == want[call]
    plain = run(dataclasses.replace(tcfg, fused_rmsnorm=False))
    if call == "prefill_mid":
        assert fused is None and plain is None
    else:
        np.testing.assert_allclose(_np(fused), _np(plain), **TOL)


def test_ragged_prefill_ignores_padding():
    """Right-padded prompts never write their padding into the cache, and
    decoding after a padded prompt matches decoding after the same prompt
    unpadded — and JAX on the padded batch."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, 5)
    rng = np.random.default_rng(5)
    short = rng.integers(1, jcfg.vocab_size, (1, 5)).astype(np.int32)
    padded = np.concatenate([short, np.full((1, 3), 7, np.int32)], axis=1)

    ca = tl.init_kv_cache(tcfg, 1, 32, "cpu")
    la, _ = tl.prefill(tp, ca, torch.from_numpy(short), tcfg)
    cb = tl.init_kv_cache(tcfg, 1, 32, "cpu")
    lb, _ = tl.prefill(tp, cb, torch.from_numpy(padded), tcfg, lengths=torch.tensor([5]))
    np.testing.assert_allclose(_np(la), _np(lb), **TOL)
    assert torch.all(cb["k"][:, :, :, 5:] == 0) and torch.all(cb["v"][:, :, :, 5:] == 0)
    jlog, jc = jl.prefill(
        jp, jl.init_kv_cache(jcfg, 1, 32), jnp.asarray(padded), jcfg,
        lengths=jnp.asarray([5]),
    )
    np.testing.assert_allclose(_np(lb), np.asarray(jlog), **TOL)
    _close_cache(cb, jc)

    nxt = la.argmax(-1)
    for _ in range(6):  # past the padded region (slots 5..7)
        sa, ca = tl.decode_step(tp, ca, nxt, tcfg)
        sb, cb = tl.decode_step(tp, cb, nxt, tcfg)
        np.testing.assert_allclose(_np(sa), _np(sb), **TOL)
        nxt = sa.argmax(-1)


def test_mixed_lengths_batch_matches_jax():
    """Rows of one batch with different lengths: each row's padding is
    dropped independently, including a row whose length is 0."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, 6)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, jcfg.vocab_size, (3, 8)).astype(np.int32)
    lengths = np.asarray([8, 3, 0], np.int32)
    jlog, jc = jl.prefill(
        jp, jl.init_kv_cache(jcfg, 3, 16), jnp.asarray(toks), jcfg,
        lengths=jnp.asarray(lengths),
    )
    tc = tl.init_kv_cache(tcfg, 3, 16, "cpu")
    tlog, _ = tl.prefill(tp, tc, torch.from_numpy(toks), tcfg, lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(_np(tlog)[:2], np.asarray(jlog)[:2], **TOL)
    _close_cache(tc, jc)


def test_suffix_prefill_with_start_pos_matches_jax():
    """A mid chunk without the LM head, then the suffix from start_pos,
    equals one full prefill — and JAX doing the same two calls."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, 7)
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, jcfg.vocab_size, (1, 12)).astype(np.int32)
    head, tail = prompt[:, :8], np.concatenate([prompt[:, 8:], np.zeros((1, 4), np.int32)], 1)

    full_log, full_c = tl.prefill(tp, tl.init_kv_cache(tcfg, 1, 32, "cpu"), torch.from_numpy(prompt), tcfg)

    tc = tl.init_kv_cache(tcfg, 1, 32, "cpu")
    none, _ = tl.prefill(tp, tc, torch.from_numpy(head), tcfg, with_logits=False)
    assert none is None and int(tc["length"][0]) == 8
    tlog, _ = tl.prefill(
        tp, tc, torch.from_numpy(tail), tcfg,
        lengths=torch.tensor([4]), start_pos=torch.tensor([8]),
    )
    assert int(tc["length"][0]) == 12
    np.testing.assert_allclose(_np(tlog), _np(full_log), **TOL)
    np.testing.assert_allclose(_np(tc["k"]), _np(full_c["k"]), **TOL)

    jc = jl.init_kv_cache(jcfg, 1, 32)
    _, jc = jl.prefill(jp, jc, jnp.asarray(head), jcfg, with_logits=False)
    jlog, jc = jl.prefill(
        jp, jc, jnp.asarray(tail), jcfg,
        lengths=jnp.asarray([4]), start_pos=jnp.asarray([8]),
    )
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **TOL)
    _close_cache(tc, jc)


def test_decode_past_stripe_end_drops_writes_like_jax():
    """Positions at or past the stripe end are never written (JAX drops
    the out-of-range scatter); the logits still match."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, 8)
    rng = np.random.default_rng(8)
    prompt = rng.integers(0, jcfg.vocab_size, (2, 6)).astype(np.int32)
    jlog, jc = jl.prefill(jp, jl.init_kv_cache(jcfg, 2, 8), jnp.asarray(prompt), jcfg)
    tc = tl.init_kv_cache(tcfg, 2, 8, "cpu")
    tlog, _ = tl.prefill(tp, tc, torch.from_numpy(prompt), tcfg)
    nxt = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    for _ in range(4):  # positions 6, 7, then 8 and 9 (dropped)
        jlog, jc = jl.decode_step(jp, jc, jnp.asarray(nxt), jcfg)
        tlog, tc = tl.decode_step(tp, tc, torch.from_numpy(nxt), tcfg)
        np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **TOL)
        _close_cache(tc, jc)
        nxt = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)


def test_untied_head_and_no_gqa_match_jax():
    """The untied ``unembed`` head and the n_kv_heads == n_heads branch."""
    jcfg, tcfg = _cfgs(n_kv_heads=4, tie_embeddings=False)
    jp, tp = _params(jcfg, 9)
    prompt = np.random.default_rng(9).integers(0, 256, (2, 5)).astype(np.int32)
    jlog, _ = jl.prefill(jp, jl.init_kv_cache(jcfg, 2, 16), jnp.asarray(prompt), jcfg)
    tlog, _ = tl.prefill(tp, tl.init_kv_cache(tcfg, 2, 16, "cpu"), torch.from_numpy(prompt), tcfg)
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **TOL)


def _entry_logits():
    """The JAX entry's forward on its own weights, and the port's entry
    function on the same weights (bf16 on both)."""
    import __graft_entry__ as jentry

    from ray_tpu_torch import graft_entry

    jfn, (jp, jtokens) = jentry.entry()
    fn, (own, tokens) = graft_entry.entry("cpu")
    tp = params_from_jax(jax.device_get(jp), "cpu")
    with torch.no_grad():
        got = fn(tp, tokens).float().numpy()
    return jp, jtokens, np.asarray(jax.jit(jfn)(jp, jtokens), np.float32), own, tokens, tp, got


def _rel_rms(a, b):
    return float(np.sqrt(((a - b) ** 2).mean() / (b**2).mean()))


def test_graft_entry_twin_matches_the_jax_entry():
    """The port's entry() is the JAX entry's configuration, tokens and
    parameter layout, and computes its function. Limits, on the logits'
    RMS error relative to their RMS: bf16 on both, 0.25; fp32 on both (the
    same bf16 weights upcast), 1e-2. These weights are ill-conditioned:
    init_params draws wq/wk with fan_in = the head count, so attention
    scores have a std near 64 and the softmax is nearly one-hot. On the CPU
    each package's bf16 logits lie 0.56 from its own fp32 logits, the
    port's fp32 lies 8.2e-4 from its fp64, and the two bf16 runs, which
    round at different points, lie 0.16 apart (fp32: 2.1e-3)."""
    from ray_tpu_torch import graft_entry

    jp, jtokens, want, own, tokens, tp, got = _entry_logits()
    assert got.shape == want.shape == (2, 128, 4096) and np.isfinite(got).all()
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jtokens))
    jcfg = jl.LlamaConfig(vocab_size=4096, d_model=512, n_layers=4, n_heads=8, n_kv_heads=4,
                          d_ff=1408, max_seq_len=512, remat=False)
    tcfg = graft_entry.entry_config()
    assert {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "dtype"} == \
        {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    assert tcfg.dtype == torch.bfloat16 and jcfg.dtype == jnp.bfloat16
    assert {k: (tuple(v.shape), v.dtype) for k, v in own.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in tp.items()}
    assert _rel_rms(got, want) < 0.25
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    want32 = np.asarray(jl.forward(jp32, jtokens, dataclasses.replace(jcfg, dtype=jnp.float32)))
    with torch.no_grad():
        got32 = tl.forward({k: v.float() for k, v in tp.items()}, tokens,
                           dataclasses.replace(tcfg, dtype=torch.float32)).numpy()
    assert _rel_rms(got32, want32) < 1e-2


def test_graft_entry_is_seeded_and_needs_cuda_unless_cpu_asked(monkeypatch):
    from ray_tpu_torch import graft_entry

    _, (a, ta) = graft_entry.entry("cpu")
    _, (b, tb) = graft_entry.entry("cpu")
    assert all(torch.equal(a[k], b[k]) for k in a) and torch.equal(ta, tb)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()


def test_model_entry_points_need_cuda_unless_cpu_asked(monkeypatch):
    """No device means the card: on a box without one they raise, never
    quietly building a model or cache on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg = tl.LlamaConfig.tiny()
    np_params = {"final_norm": np.ones(tcfg.d_model, np.float32)}
    for call in (lambda: tl.init_params(tcfg),
                 lambda: tl.init_kv_cache(tcfg, 1, 8),
                 lambda: params_from_jax(np_params)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
