"""The port's decode path against the JAX package's, on the CPU.

Weights come from the JAX package's ``init_params`` (or numpy, from a seed)
and reach the port through ``params_from_jax``; inputs are numpy arrays
given to both. Configs are ``LlamaConfig.tiny()`` in fp32 with GQA
(n_kv_heads=2 of 4 heads). Tolerance 2e-4, as the JAX package's own
decode-vs-forward tests use for fp32 on the CPU: the two frameworks sum in
different orders.
"""

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


def test_lora_and_moe_decode_not_ported_yet():
    tcfg = tl.LlamaConfig.tiny()
    tp = tl.init_params(tcfg, device="cpu")
    with pytest.raises(NotImplementedError, match="LoRA"):
        tl.decode_step(tp, tl.init_kv_cache(tcfg, 1, 8, "cpu"), torch.zeros(1, dtype=torch.int32),
                       tcfg, loras={})
    moe = tl.LlamaConfig.tiny(moe_experts=4)
    with pytest.raises(NotImplementedError, match="MoE"):
        tl.prefill(tl.init_params(moe, device="cpu"), tl.init_kv_cache(moe, 1, 8, "cpu"),
                   torch.zeros(1, 2, dtype=torch.int32), moe)


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
