"""The port's attention against the JAX package's, on the CPU.

``dense_attention`` / ``full_attention_reference`` are held against
``ray_tpu/parallel/ring_attention.py``; the flash-attention kernels' plain
versions (what a CPU tensor runs, and what the card's kernels are held
against in ``chip_smoke.py`` and ``tests/test_torch_cuda.py``) are held
against dense attention, ``torch.autograd`` and ``jax.grad``. Inputs are
numpy arrays from a seed given to both packages, in fp32. Tolerance 1e-5
(2e-5 for gradients): both sides compute in fp32 and differ only in the
order of their sums over T and D.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.parallel.ring_attention import dense_attention as jax_dense
from ray_tpu.parallel.ring_attention import full_attention_reference as jax_full
from ray_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd_kernel,
    flash_attention_bwd_plain,
    flash_attention_fwd_kernel,
    flash_attention_fwd_plain,
    reset_launches,
)
from ray_tpu_torch.parallel.ring_attention import dense_attention, full_attention_reference

TOL = dict(rtol=1e-5, atol=1e-5)
GTOL = dict(rtol=2e-5, atol=2e-5)
# (B, T, H, KV, D): GQA, MHA, and one query head per group of 4
SHAPES = [(2, 13, 4, 2, 8), (2, 13, 4, 4, 8), (1, 9, 4, 1, 16)]
IDS = ["gqa", "mha", "kv1"]


def _qkv(shape, seed=0):
    B, T, H, KV, D = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, D), dtype=np.float32)
    k = rng.standard_normal((B, T, KV, D), dtype=np.float32)
    v = rng.standard_normal((B, T, KV, D), dtype=np.float32)
    do = rng.standard_normal((B, T, H, D), dtype=np.float32)
    return q, k, v, do


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_dense_attention_matches_jax(shape, causal):
    q, k, v, _ = _qkv(shape)
    want = np.asarray(jax_dense(q, k, v, causal=causal))
    got = dense_attention(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_full_attention_reference_matches_jax(causal):
    q, k, v, _ = _qkv((2, 11, 4, 4, 8), seed=1)
    want = np.asarray(jax_full(q, k, v, causal=causal))
    got = full_attention_reference(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _lse_np(q, k, causal):
    """Row log-sum-exp [B, H, T] in float64, kv head h // G for head h."""
    B, T, H, D = q.shape
    kr = np.repeat(k.astype(np.float64), H // k.shape[2], axis=2)
    s = np.einsum("bthd,bshd->bhts", q.astype(np.float64), kr) * D**-0.5
    if causal:
        s = np.where(np.tril(np.ones((T, T), bool)), s, -np.inf)
    m = s.max(-1, keepdims=True)
    return (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_fwd_plain_matches_dense_and_logsumexp(shape, causal):
    q, k, v, _ = _qkv(shape, seed=2)
    o, lse = flash_attention_fwd_plain(*_t(q, k, v), causal=causal)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (shape[0], shape[2], shape[1])
    np.testing.assert_allclose(o.numpy(), np.asarray(jax_dense(q, k, v, causal=causal)), **TOL)
    np.testing.assert_allclose(lse.numpy(), _lse_np(q, k, causal), **TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_bwd_plain_matches_autograd_and_jax_grad(shape, causal):
    q, k, v, do = _qkv(shape, seed=3)
    tq, tk, tv, tdo = _t(q, k, v, do)
    o, lse = flash_attention_fwd_plain(tq, tk, tv, causal=causal)
    dq, dk, dv = flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, causal=causal)

    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    out = dense_attention(*leaves, causal=causal)
    auto = torch.autograd.grad(out, leaves, tdo)

    _, vjp = jax.vjp(lambda a, b, c: jax_dense(a, b, c, causal=causal), q, k, v)
    jgrads = vjp(jnp.asarray(do))
    for got, a, j in zip((dq, dk, dv), auto, jgrads):
        np.testing.assert_allclose(got.numpy(), a.numpy(), **GTOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(j), **GTOL)


def test_flash_attention_on_cpu_runs_the_plain_versions_and_launches_nothing():
    q, k, v, do = _qkv(SHAPES[0], seed=4)
    tq, tk, tv, tdo = _t(q, k, v, do)
    reset_launches()
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    out = flash_attention(*leaves)
    grads = torch.autograd.grad(out, leaves, tdo)
    o, lse = flash_attention_fwd_plain(tq, tk, tv)
    assert torch.equal(out.detach(), o)
    for got, want in zip(grads, flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo)):
        assert torch.equal(got, want)
    f = flash_attention
    assert (f.launches_fwd, f.launches_bwd_dq, f.launches_bwd_dkdv) == (0, 0, 0)


def test_flash_attention_sm_scale_matches_scaled_inputs():
    """sm_scale multiplies the scores: scaling q by c/sqrt(D) with sm_scale 1
    is the same function as the default."""
    q, k, v, _ = _qkv(SHAPES[0], seed=5)
    tq, tk, tv = _t(q, k, v)
    want = flash_attention(tq, tk, tv)
    got = flash_attention(tq * q.shape[-1] ** -0.5, tk, tv, sm_scale=1.0)
    torch.testing.assert_close(got, want, **TOL)


def test_non_cpu_non_cuda_tensor_raises():
    q, k, v = (torch.empty(s, device="meta") for s in ((1, 4, 2, 8), (1, 4, 1, 8), (1, 4, 1, 8)))
    with pytest.raises(ValueError, match="no kernel for device"):
        flash_attention(q, k, v)


def test_kernel_entry_points_refuse_cpu_tensors():
    """The kernels' own entry points never run a CPU tensor: they raise
    before any build is attempted."""
    q, k, v, do = _t(*_qkv((1, 8, 2, 1, 64), seed=6))
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention_fwd_kernel(q, k, v)
    o, lse = flash_attention_fwd_plain(q, k, v)
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention_bwd_kernel(q, k, v, o, lse, do)


@pytest.mark.parametrize("err,message", [
    (-1, "no cuTensorMapEncodeTiled"),
    (-1001, "refused a tensor map: CUresult 1"),
    (700, "launch failed: cudaError 700"),
])
def test_forward_launch_errors_name_their_cause(err, message):
    from ray_tpu_torch.ops.flash_attention import _raise_if

    _raise_if(0, "forward")  # success raises nothing
    with pytest.raises(RuntimeError, match=message):
        _raise_if(err, "forward")


@pytest.mark.parametrize("err,message", [
    (-1, "no cuTensorMapEncodeTiled"),
    (-1001, "refused a tensor map: CUresult 1"),
    (700, "launch failed: cudaError 700"),
])
@pytest.mark.parametrize("kernel", ["dq", "dkdv"])
def test_backward_launch_errors_name_their_cause(kernel, err, message, monkeypatch):
    """The backward wrappers hand what their C entry point returns to
    _raise_if and count no launch when it fails: the entry point is stubbed
    to return `err`, and the device checks and stream are stubbed so that
    CPU tensors reach it."""
    import contextlib
    import importlib
    import types

    # the module (ray_tpu_torch.ops re-exports a function of the same name)
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

    calls = []

    def entry(*args):
        calls.append(len(args))
        return err

    lib = types.SimpleNamespace(rt_flash_attn_bwd_dq=entry, rt_flash_attn_bwd_dkdv=entry)
    monkeypatch.setattr(fa, "_lib", lambda: lib)
    monkeypatch.setattr(fa, "_check", lambda q, k, v: None)
    monkeypatch.setattr(fa, "_check_rows", lambda name, t: None)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: types.SimpleNamespace(cuda_stream=0))
    q, k, v, do = (t.bfloat16() for t in _t(*_qkv((1, 8, 2, 1, 64), seed=7)))
    o, lse = flash_attention_fwd_plain(q, k, v)
    reset_launches()
    what = {"dq": "backward dQ", "dkdv": "backward dK/dV"}[kernel]
    with pytest.raises(RuntimeError, match=f"flash_attention {what}.*{message}"):
        if kernel == "dq":
            fa.flash_attention_bwd_dq_kernel(q, k, v, o, lse, do)
        else:
            fa.flash_attention_bwd_dkdv_kernel(q, k, v, lse, torch.zeros_like(lse), do)
    # 9 pointers, strides, B, T, H, KV, D, scale, causal, stream
    assert calls == [18]
    assert (fa.flash_attention.launches_bwd_dq, fa.flash_attention.launches_bwd_dkdv) == (0, 0)
