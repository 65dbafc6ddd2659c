"""The port's CUDA kernels on the card, against their plain versions.

These tests need a CUDA card and skip themselves (inside the test body)
where there is none. The file imports neither JAX nor ray_tpu, so it runs
on a machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py imports JAX for the rest of the suite.)
"""

import time

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import rmsnorm
from ray_tpu_torch.ops.rmsnorm import rmsnorm_plain


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.parametrize(
    "shape,xdt,wdt",
    [
        ((16, 3072), torch.bfloat16, torch.bfloat16),
        ((256, 3072), torch.bfloat16, torch.bfloat16),
        ((15, 3072), torch.bfloat16, torch.float32),
        ((64, 128), torch.float32, torch.float32),
        ((7, 100), torch.float32, torch.bfloat16),  # unaligned width: scalar path
        ((3, 5, 4096), torch.bfloat16, torch.bfloat16),
        ((2, 40000), torch.bfloat16, torch.bfloat16),  # wider than the registers hold
    ],
)
def test_kernel_matches_plain_on_card(shape, xdt, wdt):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(shape, generator=g, device="cuda").to(xdt)
    w = torch.randn(shape[-1], generator=g, device="cuda").to(wdt)
    before = rmsnorm.launches
    out = rmsnorm(x, w)
    torch.cuda.synchronize()
    assert rmsnorm.launches == before + 1
    ref = rmsnorm_plain(x, w)
    tol = (2**-7, 1e-6) if xdt == torch.bfloat16 else (1e-5, 1e-5)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol[0], atol=tol[1])


def test_kernel_refuses_on_card():
    _need_card()
    x = torch.randn(4, 64, device="cuda")
    with pytest.raises(TypeError):
        rmsnorm(x.half(), torch.ones(64, device="cuda"))
    with pytest.raises(ValueError):
        rmsnorm(x.t().contiguous().t(), torch.ones(64, device="cuda"))  # strided
    with pytest.raises(ValueError):
        rmsnorm(x, torch.ones(64))  # w on the CPU


# ---- flash attention ----------------------------------------------------------

from ray_tpu_torch.models.llama import LlamaConfig, init_params, loss_fn  # noqa: E402
from ray_tpu_torch.ops.flash_attention import (  # noqa: E402
    agreement,
    flash_attention,
    flash_attention_bwd_kernel,
    flash_attention_bwd_plain,
    flash_attention_fwd_kernel,
    flash_attention_fwd_plain,
    reset_launches,
)

# (B, T, H, KV, D): the train bench shape, the 3B GQA head shape, ragged T
# (not a multiple of the 64-row or the 32-row block), T = 1, D = 64
ATTN_SHAPES = {
    "bench": (4, 2048, 16, 16, 128),
    "gqa3b": (2, 2048, 24, 8, 128),
    "ragged": (2, 200, 4, 2, 128),
    "t1": (1, 1, 2, 1, 128),
    "d64": (2, 333, 8, 2, 64),
}


def _attn_inputs(shape, seed=0):
    B, T, H, KV, D = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=g, device="cuda").bfloat16()  # noqa: E731
    return mk(B, T, H, D), mk(B, T, KV, D), mk(B, T, KV, D), mk(B, T, H, D)


def _assert_agree(out, ref, what):
    a = agreement(out, ref)
    assert a["ok"], (what, a)


# every shape causal (the training path's mask), the small ones also without
ATTN_CASES = [(n, True) for n in ATTN_SHAPES] + [(n, False) for n in ("ragged", "t1", "d64")]


@pytest.mark.parametrize("name,causal", ATTN_CASES,
                         ids=[f"{n}-{'causal' if c else 'full'}" for n, c in ATTN_CASES])
def test_flash_attention_kernels_match_plain_on_card(name, causal):
    _need_card()
    q, k, v, do = _attn_inputs(ATTN_SHAPES[name])
    reset_launches()
    o, lse = flash_attention_fwd_kernel(q, k, v, causal=causal)
    dq, dk, dv = flash_attention_bwd_kernel(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    f = flash_attention
    assert (f.launches_fwd, f.launches_bwd_dq, f.launches_bwd_dkdv) == (1, 1, 1)
    o_p, lse_p = flash_attention_fwd_plain(q, k, v, causal=causal)
    _assert_agree(o, o_p, "o")
    torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=1e-5)  # fp32 both sides
    # the backward against the plain closed form from the kernel's own o/lse
    for what, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv),
                               flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)):
        _assert_agree(got, want, what)


# the forward's tiles: 128 query rows a CTA, 128 keys a tile. T at a tile's
# edges, causal and full, G 1 and 4, D 64 and 128
TILE_EDGE_CASES = [(T, causal, G, D) for T in (64, 127, 128, 129, 320) for causal in (True, False)
                   for G in (1, 4) for D in (64, 128)]


@pytest.mark.parametrize("T,causal,G,D", TILE_EDGE_CASES,
                         ids=[f"T{T}-{'causal' if c else 'full'}-G{G}-D{D}"
                              for T, c, G, D in TILE_EDGE_CASES])
def test_flash_attention_fwd_tile_edges_on_card(T, causal, G, D):
    _need_card()
    q, k, v, do = _attn_inputs((2, T, 2 * G, 2, D), seed=T + G + D)
    o, lse = flash_attention_fwd_kernel(q, k, v, causal=causal)
    o_p, lse_p = flash_attention_fwd_plain(q, k, v, causal=causal)
    _assert_agree(o, o_p, "o")
    torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=1e-5)
    for what, got, want in zip(("dq", "dk", "dv"),
                               flash_attention_bwd_kernel(q, k, v, o, lse, do, causal=causal),
                               flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)):
        _assert_agree(got, want, what)


def test_flash_attention_fwd_runs_several_waves_on_card():
    """B x H x T/128 = 1,024 work items, above 4 x 132: each of the 132
    persistent CTAs takes about eight from the counter."""
    _need_card()
    q, k, v, _ = _attn_inputs((8, 1024, 16, 4, 128), seed=7)
    o, lse = flash_attention_fwd_kernel(q, k, v)
    o_p, lse_p = flash_attention_fwd_plain(q, k, v)
    _assert_agree(o, o_p, "o")
    torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=1e-5)


def test_flash_attention_reads_strided_views_on_card():
    """Head-major storage seen as [B, T, H, D] and a head_dim slice: the
    kernels read both through their strides (no copy)."""
    _need_card()
    B, T, H, D = 2, 130, 4, 64
    g = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn(B, H, T, D, generator=g, device="cuda").bfloat16().transpose(1, 2)
    kv = torch.randn(B, T, 2, 2 * D, generator=g, device="cuda").bfloat16()
    k, v = kv[..., :D], kv[..., D:]
    assert not q.is_contiguous() and not k.is_contiguous()
    o, lse = flash_attention_fwd_kernel(q, k, v)
    _assert_agree(o, flash_attention_fwd_plain(q, k, v)[0], "o")
    do = torch.randn(B, T, H, D, generator=g, device="cuda").bfloat16()
    for what, got, want in zip(("dq", "dk", "dv"), flash_attention_bwd_kernel(q, k, v, o, lse, do),
                               flash_attention_bwd_plain(q, k, v, o, lse, do)):
        _assert_agree(got, want, what)


def test_flash_attention_autograd_on_card_is_the_kernels():
    _need_card()
    q, k, v, do = _attn_inputs(ATTN_SHAPES["ragged"], seed=2)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    reset_launches()
    out = flash_attention(*leaves)
    grads = torch.autograd.grad(out, leaves, do)
    f = flash_attention
    assert (f.launches_fwd, f.launches_bwd_dq, f.launches_bwd_dkdv) == (1, 1, 1)
    o, lse = flash_attention_fwd_kernel(q, k, v)
    assert torch.equal(out.detach(), o)
    for got, want in zip(grads, flash_attention_bwd_kernel(q, k, v, o, lse, do)):
        assert torch.equal(got, want)


def test_flash_attention_refuses_on_card():
    _need_card()
    q, k, v, _ = _attn_inputs((1, 16, 2, 1, 64))
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention(q.float(), k.float(), v.float())  # no fp32 kernel
    q96, k96, v96, _ = _attn_inputs((1, 16, 2, 1, 96))
    with pytest.raises(ValueError, match="head_dim 96"):
        flash_attention(q96, k96, v96)
    wide = torch.randn(1, 16, 2, 72, device="cuda").bfloat16()
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(wide[..., 1:65], k, v)  # rows start 2 bytes off
    with pytest.raises(ValueError, match="do not match"):
        flash_attention(q[:, :8], k, v)  # T differs
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention(q, k.cpu(), v)


# the backward's tiles: dQ takes 128 query rows an item against 64-key
# tiles, dK/dV 128 keys an item against 64-row Q tiles. T at both tiles'
# edges, causal and full, G 1, 3 and 4, D 64 and 128
BWD_EDGE_CASES = [(T, causal, G, D) for T in (63, 64, 65, 127, 128, 129, 320)
                  for causal in (True, False) for G in (1, 3, 4) for D in (64, 128)]


@pytest.mark.parametrize("T,causal,G,D", BWD_EDGE_CASES,
                         ids=[f"T{T}-{'causal' if c else 'full'}-G{G}-D{D}"
                              for T, c, G, D in BWD_EDGE_CASES])
def test_flash_attention_bwd_tile_edges_on_card(T, causal, G, D):
    _need_card()
    q, k, v, do = _attn_inputs((2, T, 2 * G, 2, D), seed=3 * T + G + D)
    o, lse = flash_attention_fwd_kernel(q, k, v, causal=causal)
    reset_launches()
    got = flash_attention_bwd_kernel(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert (flash_attention.launches_bwd_dq, flash_attention.launches_bwd_dkdv) == (1, 1)
    for what, x, want in zip(("dq", "dk", "dv"), got,
                             flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)):
        _assert_agree(x, want, what)


def test_flash_attention_bwd_runs_several_waves_on_card():
    """B x H x T/128 = 1,024 dQ items and B x KV x T/128 = 512 dK/dV items,
    above 3 x 132: each of the 132 persistent CTAs of either kernel takes
    several from its counter."""
    _need_card()
    q, k, v, do = _attn_inputs((8, 1024, 16, 8, 128), seed=8)
    o, lse = flash_attention_fwd_kernel(q, k, v)
    for what, got, want in zip(("dq", "dk", "dv"), flash_attention_bwd_kernel(q, k, v, o, lse, do),
                               flash_attention_bwd_plain(q, k, v, o, lse, do)):
        _assert_agree(got, want, what)


def test_flash_attention_bwd_is_deterministic_on_card():
    """No atomics and no order-dependent sums: two calls on the same inputs
    give the same bits, whichever CTA takes which item."""
    _need_card()
    q, k, v, do = _attn_inputs((4, 1024, 24, 8, 128), seed=9)
    o, lse = flash_attention_fwd_kernel(q, k, v)
    first = flash_attention_bwd_kernel(q, k, v, o, lse, do)
    second = flash_attention_bwd_kernel(q, k, v, o, lse, do)
    for what, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), what


TRAIN_COUNT_CASES = {
    "remat": dict(remat=True),
    "no_remat": dict(remat=False),
    "dots": dict(remat=True, remat_policy="dots"),
    "moe": dict(remat=True, moe_experts=4, moe_top_k=2),
}


@pytest.mark.parametrize("case", list(TRAIN_COUNT_CASES))
def test_train_forward_launch_counts_on_card(case):
    """Through loss_fn and its backward: remat re-runs each layer's forward
    (and so its attention kernel) in the backward pass; under "dots" too,
    since the attention kernel is no matmul op that the policy saves."""
    _need_card()
    L = 3
    remat = TRAIN_COUNT_CASES[case]["remat"]
    cfg = LlamaConfig.tiny(d_model=256, n_heads=2, n_kv_heads=1, n_layers=L, dtype=torch.bfloat16,
                           attention="splash", fused_ce=False, **TRAIN_COUNT_CASES[case])
    params = init_params(cfg, seed=0, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (2, 65), device="cuda")
    reset_launches()
    leaves = list(params.values())
    for p in leaves:
        p.requires_grad_(True)
    loss = loss_fn(params, {"tokens": tokens}, cfg)
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    assert torch.isfinite(loss) and all(torch.isfinite(g).all() for g in grads)
    f = flash_attention
    assert (f.launches_fwd, f.launches_bwd_dq, f.launches_bwd_dkdv) == ((2 if remat else 1) * L, L, L)


# ---- int8 quantize / dequantize ---------------------------------------------

from ray_tpu_torch.ops import dequantize_int8, quantize_int8  # noqa: E402
from ray_tpu_torch.ops import quant  # noqa: E402

# the CPU tests' shapes (ragged rows, widths no multiple of 16: the scalar
# path) and llama3.2-3b's weight matrices by output row (wq/wo, wk/wv,
# w_gate/w_up, w_down, the tied embedding)
QUANT_SHAPES = [(64, 256), (13, 100), (520, 257), (3, 5), (256, 3072),
                (3072, 3072), (1024, 3072), (8192, 3072), (3072, 8192), (128256, 3072)]
QUANT_DTYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.mark.parametrize("xdt", QUANT_DTYPES, ids=lambda d: str(d).split(".")[-1])
@pytest.mark.parametrize("shape", QUANT_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_quant_kernels_bit_equal_to_plain_on_card(shape, xdt):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(shape[0] * 7 + shape[1])
    x = (0.02 * torch.randn(shape, generator=g, device="cuda")).to(xdt)
    x[0] = 0  # an all-zero row: the floor scale
    quant.reset_launches()
    q, s = quantize_int8(x)
    torch.cuda.synchronize()
    assert quantize_int8.launches == 1
    q_p, s_p = quant.quantize_int8_plain(x)
    assert torch.equal(q, q_p) and torch.equal(s, s_p)
    for odt in QUANT_DTYPES:
        out = dequantize_int8(q, s, dtype=odt)
        assert out.dtype == odt
        ref = quant.dequantize_int8_plain(q, s, dtype=odt)
        assert torch.equal(out.view(torch.int8), ref.view(torch.int8)), odt  # bit for bit
    assert dequantize_int8.launches == len(QUANT_DTYPES)


@pytest.mark.parametrize("special", [float("nan"), float("inf")], ids=["nan", "inf"])
@pytest.mark.parametrize("shape", [(4, 64), (3, 5), (8, 3072)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_quant_nonfinite_row_on_card(shape, special):
    """A NaN carries through the kernel's absmax as through the plain
    version's (and jnp.max): that row's scale is NaN (inf for an inf) and its
    q 0, every other row as usual."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn(shape, generator=g, device="cuda").bfloat16()
    x[1, shape[1] - 1] = special  # in the last thread's share of the row
    q, s = quantize_int8(x)
    q_p, s_p = quant.quantize_int8_plain(x)
    assert torch.equal(q, q_p)
    torch.testing.assert_close(s, s_p, rtol=0, atol=0, equal_nan=True)
    assert (q[1] == 0).all()
    assert s[1].isnan().item() if special != special else s[1].item() == float("inf")
    assert torch.isfinite(s[[0, *range(2, shape[0])]]).all()
    out = dequantize_int8(q, s, dtype=torch.float32)
    torch.testing.assert_close(out, quant.dequantize_int8_plain(q, s, dtype=torch.float32),
                               rtol=0, atol=0, equal_nan=True)


def test_quant_reads_a_transposed_weight_on_card():
    """Per-output-row scales of w.T, a strided view, through the public
    function (contiguous at the boundary), as the reference's test does."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(5)
    w = torch.randn(3072, 1024, generator=g, device="cuda").bfloat16()
    assert not w.T.is_contiguous()
    quant.reset_launches()
    q, s = quantize_int8(w.T)
    q_p, s_p = quant.quantize_int8_plain(w.T.contiguous())
    assert torch.equal(q, q_p) and torch.equal(s, s_p)
    x = torch.randn(16, 3072, generator=g, device="cuda")
    w_deq = dequantize_int8(q, s).T.float()
    rel = (torch.linalg.norm(x @ w_deq - x @ w.float()) / torch.linalg.norm(x @ w.float())).item()
    assert rel < 0.01, rel
    assert (quantize_int8.launches, dequantize_int8.launches) == (1, 1)


def test_quant_refuses_on_card():
    _need_card()
    x = torch.randn(4, 64, device="cuda")
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        quantize_int8(x.to(torch.int32))
    with pytest.raises(ValueError, match="2-D"):
        quantize_int8(x[0])
    q, s = quantize_int8(x)
    with pytest.raises(TypeError, match="dtype must be"):
        dequantize_int8(q, s, dtype=torch.float64)
    with pytest.raises(TypeError, match="int8"):
        dequantize_int8(q.to(torch.int32), s)
    with pytest.raises(ValueError, match="CUDA device"):
        dequantize_int8(q, s.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        quant.quantize_int8_kernel(x.t())


# ---- the residual add fused into RMSNorm, and the decode step as a graph -----

from ray_tpu_torch.llm import EngineConfig, LLMConfig, ModelConfig, SamplingParams  # noqa: E402
from ray_tpu_torch.llm import engine as engine_mod  # noqa: E402
from ray_tpu_torch.models.llama import decode_step, init_kv_cache, prefill  # noqa: E402
from ray_tpu_torch.ops import add_rmsnorm  # noqa: E402

# decode rows at 3B width, one row, a width no multiple of 8 (the scalar
# path), a row wider than the registers hold (the general loop), leading
# dims; bf16 and fp32 x with bf16 and fp32 w
FUSED_CASES = [
    ((16, 3072), torch.bfloat16, torch.bfloat16),
    ((16, 3072), torch.bfloat16, torch.float32),
    ((16, 3072), torch.float32, torch.float32),
    ((16, 3072), torch.float32, torch.bfloat16),
    ((1, 3072), torch.bfloat16, torch.bfloat16),
    ((1, 3072), torch.float32, torch.float32),
    ((16, 3000), torch.bfloat16, torch.bfloat16),
    ((16, 3001), torch.float32, torch.bfloat16),
    ((2, 40000), torch.bfloat16, torch.bfloat16),
    ((2, 40000), torch.float32, torch.float32),
    ((3, 5, 4096), torch.bfloat16, torch.float32),
]


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


@pytest.mark.parametrize("shape,xdt,wdt", FUSED_CASES,
                         ids=[f"{'x'.join(map(str, s))}-{str(x)[6:]}-w{str(w)[6:]}"
                              for s, x, w in FUSED_CASES])
def test_add_rmsnorm_bit_equal_to_add_then_kernel_on_card(shape, xdt, wdt):
    """One launch computes s = x + r and y = rmsnorm(s): both bit for bit
    (tolerance 0) what the eager add followed by the unfused kernel give."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(shape[-1])
    x, r = (torch.randn(shape, generator=g, device="cuda").to(xdt) for _ in range(2))
    w = (1.0 + 0.1 * torch.randn(shape[-1], generator=g, device="cuda")).to(wdt)
    before = rmsnorm.launches
    s, y = add_rmsnorm(x, r, w)
    torch.cuda.synchronize()
    assert rmsnorm.launches == before + 1
    s_ref = x + r
    y_ref = rmsnorm(s_ref, w)
    assert s.dtype == y.dtype == xdt
    assert torch.equal(_bits(s), _bits(s_ref))
    assert torch.equal(_bits(y), _bits(y_ref))


def test_add_rmsnorm_refuses_on_card():
    _need_card()
    x = torch.randn(4, 64, device="cuda")
    w = torch.ones(64, device="cuda")
    for bad in (x.bfloat16(), x[:, :32], x.t().contiguous().t(), x.cpu()):
        with pytest.raises(ValueError, match="r must be"):
            add_rmsnorm(x, bad, w)


def _graph_engine(**kw):
    ek = dict(max_num_seqs=4, max_seq_len=64, prefill_buckets=(16, 32, 64), dtype="float32",
              decode_steps=4, enable_prefix_caching=False)
    ek.update(kw)
    cfg = LLMConfig(model=ModelConfig(model_id="tiny", tokenizer="byte", seed=0,
                                      model_kwargs={"fused_rmsnorm": True}),
                    engine=EngineConfig(**ek))
    return engine_mod.TorchEngine(cfg, device="cuda")


def _eager_greedy(eng, prompt: str, n: int) -> list:
    """The engine's request by hand, eagerly: a prefill at the engine's
    bucket width into a one-row stripe, copied into slot 0 of a cache of
    the pool's shape, then n - 1 eager decode_steps."""
    cfg, pool = eng.model_cfg, eng._pools[0]
    ids = eng.tokenizer.encode(prompt)
    width = eng._bucket(len(ids))
    toks = torch.zeros((1, width), dtype=torch.int32)
    toks[0, : len(ids)] = torch.tensor(ids)
    with torch.inference_mode():
        one = init_kv_cache(cfg, 1, pool.stripe_len, "cuda")
        logits, _ = prefill(eng.params, one, toks.cuda(), cfg,
                            lengths=torch.tensor([len(ids)], device="cuda"))
        cache = init_kv_cache(cfg, pool.n_slots, pool.stripe_len, "cuda")
        cache["k"][:, 0].copy_(one["k"][:, 0])
        cache["v"][:, 0].copy_(one["v"][:, 0])
        cache["length"][0] = len(ids)
        tok = torch.zeros(pool.n_slots, dtype=torch.int32, device="cuda")
        tok[0] = logits[0].argmax()
        out = [int(tok[0])]
        for _ in range(n - 1):
            logits, _ = decode_step(eng.params, cache, tok, cfg)
            tok = logits.argmax(-1).to(torch.int32)
            out.append(int(tok[0]))
    return out


def test_engine_decodes_by_graph_replay_on_card():
    """Every decode step on the card is a replay of the pool's graph; its
    greedy tokens equal an eager decode_step loop's on the same weights,
    and the RMSNorm count is 2L+1 per replay plus the prefills' norms."""
    _need_card()
    eng = _graph_engine()
    try:
        assert all(p.graph is not None for p in eng._pools)
        L = eng.model_cfg.n_layers
        sp = SamplingParams(max_tokens=13, temperature=0.0, ignore_eos=True)
        prompts = ["graph replay", "a longer prompt for the decode graph to serve"]
        stats0 = eng.get_stats()
        rmsnorm.launches = 0
        outs = [eng.generate(p, sampling_params=sp) for p in prompts]
        launches = rmsnorm.launches
        stats = eng.get_stats()
        delta = {k: stats[k] - stats0[k] for k in
                 ("decode_steps", "decode_graph_replays", "prefill_final_chunks",
                  "prefill_mid_chunks")}
        assert delta["decode_graph_replays"] == delta["decode_steps"] > 0
        assert launches == ((2 * L + 1) * (delta["decode_graph_replays"] + delta["prefill_final_chunks"])
                            + 2 * L * delta["prefill_mid_chunks"])
        for prompt, out in zip(prompts, outs):
            assert out.token_ids == _eager_greedy(eng, prompt, 13)
    finally:
        eng.shutdown()


def test_engine_recaptures_after_a_failed_replay_on_card():
    """A replay that raises fails the pool's requests (no eager fallback);
    the pool captures a new graph over its fresh cache and serves the same
    tokens again."""
    _need_card()
    eng = _graph_engine()
    try:
        sp = SamplingParams(max_tokens=9, temperature=0.0, ignore_eos=True)
        want = eng.generate("recapture me", sampling_params=sp).token_ids
        pool = eng._pools[0]
        old = pool.graph

        def broken():
            raise RuntimeError("forced replay failure")

        old.replay = broken
        with pytest.raises(RuntimeError, match="forced replay failure"):
            eng.generate("recapture me", sampling_params=sp)
        # the loop thread fails the request first, then resets and recaptures
        deadline = time.monotonic() + 60
        while pool.graph is old and time.monotonic() < deadline:
            time.sleep(0.01)
        assert pool.graph is not None and pool.graph is not old
        steps0 = eng.get_stats()
        assert eng.generate("recapture me", sampling_params=sp).token_ids == want
        stats = eng.get_stats()
        assert (stats["decode_graph_replays"] - steps0["decode_graph_replays"]
                == stats["decode_steps"] - steps0["decode_steps"] > 0)
    finally:
        eng.shutdown()


def test_engine_refuses_new_params_on_card():
    """The graphs read the captured params: assigning new ones raises
    (decoding would silently keep the old weights); in-place updates reach
    the graph."""
    _need_card()
    eng = _graph_engine()
    try:
        sp = SamplingParams(max_tokens=6, temperature=0.0, ignore_eos=True)
        with pytest.raises(RuntimeError, match="in place"):
            eng.params = {k: v.clone() for k, v in eng.params.items()}
        with torch.no_grad():
            for v in eng.params.values():
                v.mul_(-1.0)
        assert eng.generate("new weights", sampling_params=sp).token_ids == _eager_greedy(
            eng, "new weights", 6)
    finally:
        eng.shutdown()


def test_engine_capture_failure_raises_on_card(monkeypatch):
    """A capture that fails raises from the constructor; it never leaves an
    engine that decodes eagerly on the card."""
    _need_card()

    class Refused:
        def __init__(self, *a, **k):
            raise RuntimeError("capture refused")

    monkeypatch.setattr(engine_mod, "DecodeGraph", Refused)
    with pytest.raises(RuntimeError, match="capture refused"):
        _graph_engine()


def test_decode_graph_equals_eager_steps_on_card():
    """DecodeGraph alone, on a bf16 fused model: replays with the next
    tokens copied in give eager decode_step's logits bit for bit on a
    cloned cache; replays without the copy (a broken control) give other
    tokens."""
    _need_card()
    from ray_tpu_torch.models.llama import LlamaConfig, init_params

    cfg = LlamaConfig.tiny(dtype=torch.bfloat16, fused_rmsnorm=True, n_layers=3)
    params = init_params(cfg, seed=1, device="cuda")
    B, S = 4, 32
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (B, 6), generator=gen, device="cuda", dtype=torch.int32)
    with torch.inference_mode():
        cache = init_kv_cache(cfg, B, S, "cuda")
        logits, _ = prefill(params, cache, prompt, cfg)
        first = logits.argmax(-1).to(torch.int32)
        eager_cache = {k: v.clone() for k, v in cache.items()}
        tokens = first.clone()
        graph = engine_mod.DecodeGraph(params, cache, tokens, cfg)
        assert torch.equal(cache["length"], eager_cache["length"])

        def run(copy: bool):
            tokens.copy_(first)
            out = []
            for _ in range(6):
                lg = graph.replay()
                nxt = lg.argmax(-1).to(torch.int32)
                if copy:
                    tokens.copy_(nxt)
                out.append((lg.clone(), nxt))
            return out

        control_cache = {k: v.clone() for k, v in cache.items()}
        got = run(True)
        tok, want = first, []
        for _ in range(6):
            lg, _ = decode_step(params, eager_cache, tok, cfg)
            tok = lg.argmax(-1).to(torch.int32)
            want.append((lg, tok))
        for (gl, gt), (wl, wt) in zip(got, want):
            assert torch.equal(gt, wt)
            assert torch.equal(gl, wl)
        for k in cache:
            cache[k].copy_(control_cache[k])
        control = run(False)
        assert not all(torch.equal(c[1], w[1]) for c, w in zip(control, want))


def _graph_vs_eager(cfg, params, lora_kw, ids_at_step=None):
    """Replays of a DecodeGraph against eager decode_steps on a cloned cache
    (bit for bit), the next tokens, and each step's adapter ids when
    ``ids_at_step`` gives them, written in place before each replay."""
    B, S = 4, 48
    gen = torch.Generator(device="cuda").manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (B, 6), generator=gen, device="cuda", dtype=torch.int32)
    with torch.inference_mode():
        cache = init_kv_cache(cfg, B, S, "cuda")
        logits, _ = prefill(params, cache, prompt, cfg, **lora_kw)
        first = logits.argmax(-1).to(torch.int32)
        eager_cache = {k: v.clone() for k, v in cache.items()}
        tokens = first.clone()
        graph = engine_mod.DecodeGraph(params, cache, tokens, cfg, **lora_kw)
        tok = first
        for step in range(6):
            if ids_at_step is not None:
                lora_kw["adapter_ids"].copy_(ids_at_step(step))
            got = graph.replay().clone()
            want, _ = decode_step(params, eager_cache, tok, cfg, **lora_kw)
            assert torch.equal(got, want), step
            tok = want.argmax(-1).to(torch.int32)
            tokens.copy_(tok)
        assert torch.equal(cache["k"], eager_cache["k"]) and torch.equal(cache["v"], eager_cache["v"])


def test_moe_decode_graph_equals_eager_steps_on_card():
    """The MoE decode step (G = 4 <= 64: every expert batched, static
    shapes) captured as one graph gives eager decode_step's logits bit for
    bit."""
    _need_card()
    from ray_tpu_torch.models.llama import LlamaConfig, init_params

    cfg = LlamaConfig.tiny(dtype=torch.bfloat16, fused_rmsnorm=True, n_layers=3, moe_experts=4)
    _graph_vs_eager(cfg, init_params(cfg, seed=3, device="cuda"), {})


def test_lora_decode_graph_equals_eager_with_changing_adapters_on_card():
    """The LoRA decode step as one graph: the adapter ids are rewritten in
    place between replays (each row changes adapter), and every replay
    equals eager decode_step with the same ids bit for bit."""
    _need_card()
    from ray_tpu_torch.models.llama import LlamaConfig, init_lora_stack, init_params

    cfg = LlamaConfig.tiny(dtype=torch.bfloat16, fused_rmsnorm=True, n_layers=3)
    loras = init_lora_stack(cfg, 2, 4, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(4)
    for stack in loras.values():
        stack[:, 1:].normal_(0.0, 0.5, generator=gen)
    ids = torch.zeros(4, dtype=torch.int32, device="cuda")
    base = torch.tensor([0, 1, 2, 1], dtype=torch.int32, device="cuda")
    _graph_vs_eager(cfg, init_params(cfg, seed=4, device="cuda"), {"loras": loras, "adapter_ids": ids},
                    ids_at_step=lambda step: (base + step) % 3)


def test_moe_and_lora_engines_decode_by_graph_replay_on_card():
    """A MoE engine and a LoRA engine on the card: every decode step is a
    graph replay, and the greedy tokens equal the eager loop's (MoE) or
    the sequential run's of each request in a mixed batch (LoRA)."""
    _need_card()
    sp = SamplingParams(max_tokens=9, temperature=0.0, ignore_eos=True)
    eng = engine_mod.TorchEngine(LLMConfig(
        model=ModelConfig(model_id="tiny", tokenizer="byte", seed=0,
                          model_kwargs={"fused_rmsnorm": True, "moe_experts": 4}),
        engine=EngineConfig(max_num_seqs=4, max_seq_len=64, prefill_buckets=(16, 32, 64),
                            dtype="float32", decode_steps=4, enable_prefix_caching=False)),
        device="cuda")
    try:
        out = eng.generate("experts on the card", sampling_params=sp)
        assert out.token_ids == _eager_greedy(eng, "experts on the card", 9)
        stats = eng.get_stats()
        assert stats["decode_graph_replays"] == stats["decode_steps"] > 0
    finally:
        eng.shutdown()
    eng = _graph_engine(max_loras=2, lora_rank=4)
    try:
        gen = torch.Generator().manual_seed(5)
        for name in ("a", "b"):
            eng.add_lora(name, {k: torch.randn(v.shape[:1] + v.shape[2:], generator=gen) * 0.5
                                for k, v in eng.loras.items()})
        jobs = [("one", "a"), ("two", "b"), ("three", None), ("four", "a")]
        seq = [eng.generate(p, sampling_params=sp, lora=lora).token_ids for p, lora in jobs]
        reqs = [eng.submit(p, sampling_params=sp, lora=lora) for p, lora in jobs]
        for r in reqs:
            assert r.done.wait(timeout=120) and r.error is None
        assert [r.out_tokens for r in reqs] == seq
        assert seq[0] != eng.generate("one", sampling_params=sp).token_ids
        stats = eng.get_stats()
        assert stats["decode_graph_replays"] == stats["decode_steps"] > 0
    finally:
        eng.shutdown()


# ---- the Train layer on the card ------------------------------------------------


def test_torch_trainer_one_nccl_rank_on_card(tmp_path):
    """TorchTrainer with one GPU rank at a tiny size: the rank's process
    group is NCCL, each step launches the attention kernels L / L / L (no
    remat), the final checkpoint restores on the card to the rank's bits,
    and no rank outlives fit()."""
    _need_card()
    import multiprocessing

    from ray_tpu_torch.examples import train_llama_dp as ex
    from ray_tpu_torch.models.llama import param_template
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    kw = dict(d_model=128, n_heads=2, n_kv_heads=2, d_ff=256, dtype=torch.bfloat16,
              attention="splash")
    config = {"model": "tiny", "model_kwargs": kw, "steps": 2, "batch": 2, "seq_len": 64}
    result = TorchTrainer(
        ex.train_loop, train_loop_config=config,
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
        run_config=RunConfig(name="nccl", storage_path=str(tmp_path)),
    ).fit()
    assert result.error is None, result.error
    assert not [p for p in multiprocessing.active_children() if "-rank-" in p.name]
    h = result.metrics_history
    assert [m["step"] for m in h] == [1, 2] and {m["backend"] for m in h} == {"nccl"}
    L = 2
    for m in h:
        assert (m["launches"]["flash_attention_fwd"], m["launches"]["flash_attention_bwd_dq"],
                m["launches"]["flash_attention_bwd_dkdv"]) == (L, L, L)
    params = result.checkpoint.to_state_dict(like=param_template(ex.model_config(config)),
                                             device="cuda")
    assert ex.bit_checksums(params) == h[-1]["checksums"]


def test_tensor_serializer_on_a_cuda_tensor():
    """A CUDA tensor is copied to the host; its one array goes out-of-band
    under pickle protocol 5; bf16 travels as int16 bits."""
    _need_card()
    import pickle

    from ray_tpu_torch._private.serialization import deserialize_tensor, serialize_tensor

    t = torch.randn(64, 48, device="cuda").to(torch.bfloat16)[:, ::2]
    buffers = []
    blob = pickle.dumps(serialize_tensor(t), protocol=5, buffer_callback=buffers.append)
    assert len(buffers) == 1
    back = deserialize_tensor(pickle.loads(blob, buffers=buffers))
    assert back.device.type == "cpu" and back.dtype == torch.bfloat16
    assert torch.equal(back, t.cpu())


# ---- the parallel layer on the card ----------------------------------------------


def test_ring_blocks_match_the_whole_kernel_on_card():
    """Ring attention's per-block steps for 4 simulated sequence shards
    (forward, LSE merge, backward from the merged o and lse) against one
    whole-sequence call of the kernels, within the attention limits; 10
    launches of each kernel (causal block skipping)."""
    _need_card()
    from ray_tpu_torch.ops.flash_attention import (
        agreement, flash_attention, flash_attention_bwd_kernel, flash_attention_fwd_kernel,
        reset_launches)
    from ray_tpu_torch.parallel.ring_attention import (
        block_backward, block_forward, merge_blocks, ring_steps)

    B, T, H, KV, D, P = 1, 512, 4, 2, 128, 4
    t, scale = T // P, D**-0.5
    g = torch.Generator(device="cuda").manual_seed(5)
    q, do = (torch.randn(B, T, H, D, generator=g, device="cuda").bfloat16() for _ in range(2))
    k, v = (torch.randn(B, T, KV, D, generator=g, device="cuda").bfloat16() for _ in range(2))
    o_whole, lse_whole = flash_attention_fwd_kernel(q, k, v)
    whole = (o_whole, lse_whole) + flash_attention_bwd_kernel(q, k, v, o_whole, lse_whole, do)
    reset_launches()
    outs, lses, dq = [], [], []
    dk = [torch.zeros(B, t, KV, D, device="cuda") for _ in range(P)]
    dv = [torch.zeros(B, t, KV, D, device="cuda") for _ in range(P)]
    sl = lambda x, i: x[:, i * t:(i + 1) * t].contiguous()  # noqa: E731
    for i in range(P):
        o_acc = lse = None
        steps = [(src, m) for src, m in ring_steps(i, P, True) if m is not None]
        for src, mode in steps:
            o_acc, lse = merge_blocks(o_acc, lse, *block_forward(
                sl(q, i), sl(k, src), sl(v, src), mode, scale))
        o_i = o_acc.bfloat16()
        acc = torch.zeros(B, t, H, D, device="cuda")
        for src, mode in steps:
            a, b, c = block_backward(sl(q, i), sl(k, src), sl(v, src), o_i, lse, sl(do, i),
                                     mode, scale)
            acc += a
            dk[src] += b
            dv[src] += c
        outs.append(o_i)
        lses.append(lse)
        dq.append(acc)
    f = flash_attention
    assert (f.launches_fwd, f.launches_bwd_dq, f.launches_bwd_dkdv) == (10, 10, 10)
    ring = (torch.cat(outs, 1), torch.cat(lses, -1), torch.cat(dq, 1), torch.cat(dk, 1),
            torch.cat(dv, 1))
    for name, a, b in zip(("o", "lse", "dq", "dk", "dv"), ring, whole):
        assert agreement(a, b)["ok"], (name, agreement(a, b))


def test_dryrun_multichip_one_nccl_rank_on_card():
    """graft_entry.dryrun_multichip(1): every mesh of the sweep (every axis
    1 on one card) on one NCCL rank, bf16 at head_dim 64 (the kernels' D),
    each mesh's loss within 1e-3 of the unsharded step on the same batch,
    the attention kernels launched L / L / L a step (no remat)."""
    _need_card()
    import multiprocessing

    from ray_tpu_torch.graft_entry import dryrun_multichip

    kw = dict(d_model=128, n_heads=2, n_kv_heads=2, d_ff=256, dtype=torch.bfloat16,
              attention="splash")
    recs = dryrun_multichip(1, model_kwargs=kw, reference=True, timeout_s=300)
    assert not [p for p in multiprocessing.active_children() if "-rank-" in p.name]
    assert len(recs) == 7
    for r in recs:
        assert abs(r["loss"] - r["ref_loss"]) <= 1e-3 * abs(r["ref_loss"]), r["label"]
        L = 4 if r["label"].startswith("pp2") else 2
        assert r["launches"] == {"fwd": L, "bwd_dq": L, "bwd_dkdv": L}, r["label"]


def test_iter_device_batches_pinned_non_blocking_on_card():
    """Batches land on the card with the source's values; each host array
    goes through a pinned buffer (``pin_memory``) before its non-blocking
    copy."""
    _need_card()
    from unittest import mock

    import numpy as np

    from ray_tpu_torch.data import iter_device_batches

    class Source:
        def iter_batches(self, batch_size, batch_format, drop_last):
            for i in range(3):
                yield {"x": np.full((batch_size, 4), i, np.int32)}

    pinned = []
    real = torch.Tensor.pin_memory

    def spy(self, *a, **kw):
        out = real(self, *a, **kw)
        pinned.append(out.is_pinned())
        return out

    with mock.patch.object(torch.Tensor, "pin_memory", spy):
        batches = list(iter_device_batches(Source(), batch_size=2, prefetch=2))
    assert pinned == [True] * 3
    for i, b in enumerate(batches):
        assert b["x"].device.type == "cuda"
        assert torch.equal(b["x"].cpu(), torch.full((2, 4), i, dtype=torch.int32))


# ---- the host's card ledger on the card -----------------------------------------


def test_process_actor_on_the_card_holds_its_lease_on_card():
    """A process actor with a lease of one card (a learner on cuda): its
    pid holds the card in ``free()``, and its SIGKILL returns the card."""
    _need_card()
    import os
    import signal

    from ray_tpu_torch._private.cards import default_ledger
    from ray_tpu_torch._private.process_actor import ProcessActor, get
    from ray_tpu_torch._private.spawn_env import assign_cards
    from ray_tpu_torch.rllib import RLModuleSpec
    from ray_tpu_torch.rllib.core.learner import TorchLearner

    ledger = default_ledger()
    before = ledger.free().cards
    lease, = assign_cards(1, 1, "holders")
    actor = ProcessActor(TorchLearner, (RLModuleSpec(observation_dim=4, action_dim=2),),
                         {"device": "cuda"}, lease=lease, name="holder")
    try:
        get(actor.ready, timeout=300)
        assert get(actor.call("placement")) == ["cuda"]
        assert ledger.free().cards == before - 1
        assert [h.pid for h in ledger.holders()] == [actor.pid]
        os.kill(actor.pid, signal.SIGKILL)
        actor._proc.join(30)
        assert ledger.free().cards == before and ledger.holders() == []
    finally:
        actor.kill()


def test_worker_group_shutdown_leaves_no_lease_on_card():
    """One NCCL rank (``start_loop``) holds its card while it lives;
    ``WorkerGroup.shutdown`` leaves no lease behind."""
    _need_card()
    from ray_tpu_torch._private.cards import default_ledger
    from ray_tpu_torch.train import ScalingConfig
    from ray_tpu_torch.train._internal.worker_group import WorkerGroup

    ledger = default_ledger()
    before = ledger.free().cards
    group = WorkerGroup(ScalingConfig(num_workers=1), experiment_name="held")
    try:
        group.start_loop(_wait_for_stop, None)
        h, = ledger.holders()
        assert h.pid == group.procs[0].pid and list(h.gpu.values()) == [1.0]
        assert ledger.free().cards == before - 1
    finally:
        group.shutdown()
    assert ledger.holders() == [] and ledger.free().cards == before


def _wait_for_stop(config, conn, inbox, device):
    inbox.recv()


def test_elastic_fit_one_rank_on_card(tmp_path):
    """``ScalingConfig(num_workers=n + 1, min_workers=1)`` with n free
    cards starts at n ranks (the capacity cap), checkpoints its state every
    2 steps, polls ``resize_decision`` without firing, charges no failure
    and leaves no lease; tiny bf16 model, splash attention."""
    _need_card()
    from ray_tpu_torch._private.cards import default_ledger
    from ray_tpu_torch.examples import train_llama_dp as ex
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    free = default_ledger().free().cards
    kw = dict(d_model=128, n_heads=2, n_kv_heads=2, d_ff=256, dtype=torch.bfloat16,
              attention="splash")
    config = {"model": "tiny", "model_kwargs": kw, "steps": 40, "global_batch": 2 * free,
              "seq_len": 64, "state_checkpoint_every": 2}
    trainer = TorchTrainer(
        ex.train_loop, train_loop_config=config,
        scaling_config=ScalingConfig(num_workers=free + 1, min_workers=1),
        run_config=RunConfig(name="elastic", storage_path=str(tmp_path)),
    )
    result = trainer.fit()
    assert result.error is None, result.error
    c = trainer._controller
    assert [a["size"] for a in c.attempts] == [free]
    assert {m["world_size"] for m in result.metrics_history} == {free}
    assert [m["step"] for m in result.metrics_history] == list(range(1, 41))
    assert (c.num_resizes, c.failure_policy.failures) == (0, 0)
    assert default_ledger().holders() == []


# ---- the Data layer on the card ---------------------------------------------------


class _DeviceRows:
    """A UDF that reports, for each row, the card its actor's process sees
    (an actor stage's UDF: module level, so the actors import it by name)."""

    def __call__(self, batch):
        import os

        n = len(batch["id"])
        name = torch.cuda.get_device_name(0) if torch.cuda.is_available() else ""
        return {"id": batch["id"], "cuda": np.full(n, torch.cuda.is_available()),
                "pid": np.full(n, os.getpid()),
                "visible": np.full(n, os.environ.get("CUDA_VISIBLE_DEVICES", ""), dtype=object),
                "device": np.full(n, name, dtype=object),
                "on_card": np.full(n, torch.ones(1, device="cuda").device.type == "cuda")}


def test_actor_stage_with_a_gpu_share_gets_its_card_on_card():
    """``ActorPoolStrategy(size=2, resources={"GPU": 0.5})``: two actors,
    each leasing half of one card from the host's ledger while the stage
    runs, each seeing that card as its CUDA device; rows in input order; no
    lease after."""
    _need_card()
    import ray_tpu_torch.data as td
    from ray_tpu_torch._private.cards import default_ledger
    from ray_tpu_torch.data.execution import StreamingExecutor, _resolve

    ds = td.range(16, parallelism=4).map_batches(
        _DeviceRows, batch_size=4, compute=td.ActorPoolStrategy(size=2, resources={"GPU": 0.5}))
    blocks, held = [], []
    for item in StreamingExecutor().execute(ds._plan):
        blocks.append(_resolve(item))
        held.append(default_ledger().holders())
    rows = [{k: b[k][i] for k in b} for b in blocks for i in range(len(b["id"]))]
    assert [int(r["id"]) for r in rows] == list(range(16))
    assert all(r["cuda"] and r["on_card"] for r in rows)
    assert {r["device"] for r in rows} == {torch.cuda.get_device_name(0)}
    pids = {int(r["pid"]) for r in rows}
    shares = [h for h in max(held, key=len) if h.pid in pids]
    assert len(pids) == 2 and len(shares) == 2
    assert all(list(h.gpu.values()) == [0.5] for h in shares)
    assert {r["visible"] for r in rows} == {c for h in shares for c in h.gpu}
    assert default_ledger().holders() == []


def test_iter_torch_batches_on_card():
    """``Dataset.iter_torch_batches`` puts each batch on the card (the
    default device), the short last batch kept (the reference's
    drop_last=False), values and dtypes equal to the host batches."""
    _need_card()
    import ray_tpu_torch.data as td

    rng = np.random.default_rng(0)
    items = [{"tokens": rng.integers(0, 100, 9).astype(np.int32), "w": float(i)}
             for i in range(10)]
    ds = td.from_items(items, parallelism=3)
    got = list(ds.iter_torch_batches(batch_size=4, dtypes={"w": np.float32}))
    want = list(ds.iter_batches(batch_size=4))
    assert [b["tokens"].shape[0] for b in got] == [4, 4, 2]
    for b, w in zip(got, want):
        assert b["tokens"].device.type == "cuda" and b["w"].dtype == torch.float32
        np.testing.assert_array_equal(b["tokens"].cpu().numpy(), w["tokens"])
        np.testing.assert_array_equal(b["w"].cpu().numpy(), w["w"].astype(np.float32))
