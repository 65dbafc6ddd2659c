"""The port's CUDA kernels on the card, against their plain versions.

These tests need a CUDA card and skip themselves (inside the test body)
where there is none. The file imports neither JAX nor ray_tpu, so it runs
on a machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py imports JAX for the rest of the suite.)
"""

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


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
def test_train_forward_launch_counts_on_card(remat):
    """Through loss_fn and its backward: remat re-runs each layer's forward
    (and so its attention kernel) in the backward pass."""
    _need_card()
    L = 3
    cfg = LlamaConfig.tiny(d_model=256, n_heads=2, n_kv_heads=1, n_layers=L, dtype=torch.bfloat16,
                           attention="splash", remat=remat, fused_ce=False)
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
