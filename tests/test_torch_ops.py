"""Port kernels against the JAX package's Pallas kernels.

On the CPU the port's wrapper runs its plain version (the CUDA kernel needs
the card); the JAX kernel runs in Pallas interpret mode, as the JAX
package's own tests run it. The same numpy inputs go to both. The kernel
itself is checked on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import rmsnorm as jax_rmsnorm
from ray_tpu_torch._native import build
from ray_tpu_torch.ops import add_rmsnorm, rmsnorm
from ray_tpu_torch.ops.rmsnorm import rmsnorm_plain


@pytest.mark.parametrize("shape", [(4, 16, 128), (3, 5, 128)], ids=["batched", "ragged"])
def test_rmsnorm_matches_jax_kernel(shape):
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32)
    w = rng.normal(size=(shape[-1],)).astype(np.float32)
    ref = np.asarray(jax_rmsnorm(jnp.asarray(x), jnp.asarray(w)))
    out = rmsnorm(torch.from_numpy(x), torch.from_numpy(w))
    assert out.dtype == torch.float32 and tuple(out.shape) == shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_rmsnorm_bf16_matches_jax_kernel():
    """bf16 x, fp32 w: math in fp32, one cast at the end (the kernel's
    order) — within one bf16 rounding step of the JAX kernel."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(6, 256)).astype(np.float32)
    w = rng.normal(size=(256,)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    ref = np.asarray(jax_rmsnorm(xj, jnp.asarray(w)).astype(jnp.float32))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)
    out = rmsnorm(xt, torch.from_numpy(w))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=2**-7, atol=1e-6)


@pytest.mark.parametrize("shape", [(4, 16, 128), (3, 5, 128), (16, 96)],
                         ids=["batched", "ragged", "decode_rows"])
def test_add_rmsnorm_matches_jax_kernel(shape):
    """s = x + r, then the norm of s: JAX adds, then runs its Pallas kernel
    (interpret mode); the port's add_rmsnorm on CPU tensors runs its plain
    twin. fp32 within 1e-5."""
    rng = np.random.default_rng(4)
    x, r = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    w = rng.normal(size=(shape[-1],)).astype(np.float32)
    s_ref = jnp.asarray(x) + jnp.asarray(r)
    y_ref = np.asarray(jax_rmsnorm(s_ref, jnp.asarray(w)))
    before = rmsnorm.launches
    s, y = add_rmsnorm(torch.from_numpy(x), torch.from_numpy(r), torch.from_numpy(w))
    assert rmsnorm.launches == before  # the CPU runs the plain twin
    assert s.dtype == y.dtype == torch.float32 and tuple(s.shape) == tuple(y.shape) == shape
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("wdt", [np.float32, "bf16"], ids=["w_fp32", "w_bf16"])
def test_add_rmsnorm_bf16_matches_jax_kernel(wdt):
    """bf16 x and r: s is rounded to bf16 (x's dtype) before the norm, in
    both packages; y within one bf16 rounding step of the JAX kernel (the
    tolerance of test_rmsnorm_bf16_matches_jax_kernel)."""
    rng = np.random.default_rng(5)
    x, r = (jnp.asarray(rng.normal(size=(6, 256)).astype(np.float32)).astype(jnp.bfloat16)
            for _ in range(2))
    w = jnp.asarray(rng.normal(size=(256,)).astype(np.float32))
    if wdt == "bf16":
        w = w.astype(jnp.bfloat16)
    s_ref = x + r
    y_ref = np.asarray(jax_rmsnorm(s_ref, w).astype(jnp.float32))

    def to_torch(a):
        t = torch.from_numpy(np.array(a.astype(jnp.float32)))
        return t.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else t

    before = rmsnorm.launches
    s, y = add_rmsnorm(to_torch(x), to_torch(r), to_torch(w))
    assert rmsnorm.launches == before
    assert s.dtype == y.dtype == torch.bfloat16
    np.testing.assert_array_equal(s.float().numpy(), np.asarray(s_ref.astype(jnp.float32)))
    np.testing.assert_allclose(y.float().numpy(), y_ref, rtol=2**-7, atol=1e-6)


def test_add_rmsnorm_is_inference_only_and_refuses_devices_without_a_kernel():
    x = torch.ones(2, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        add_rmsnorm(x, torch.ones(2, 8), torch.ones(8))
    with torch.no_grad():
        s, _ = add_rmsnorm(x, torch.ones(2, 8), torch.ones(8))
    assert torch.equal(s, torch.full((2, 8), 2.0))
    meta = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        add_rmsnorm(meta, meta, torch.empty(8, device="meta"))


def test_rmsnorm_grads_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(8, 128)).astype(np.float32)
    w = rng.normal(size=(128,)).astype(np.float32)
    gx_ref, gw_ref = jax.grad(
        lambda a, b: jnp.sum(jax_rmsnorm(a, b) ** 2), argnums=(0, 1)
    )(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    (rmsnorm(xt, wt) ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_ref), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw_ref), rtol=1e-4, atol=1e-4)


def test_rmsnorm_grads_match_autograd_of_plain():
    """The closed-form backward equals autograd through the plain version."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 5, 64)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(2, 5, 64)).astype(np.float32))
    x1, w1 = x.clone().requires_grad_(), w.clone().requires_grad_()
    x2, w2 = x.clone().requires_grad_(), w.clone().requires_grad_()
    (rmsnorm(x1, w1) * g).sum().backward()
    (rmsnorm_plain(x2, w2) * g).sum().backward()
    torch.testing.assert_close(x1.grad, x2.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(w1.grad, w2.grad, rtol=1e-5, atol=1e-5)


def test_cpu_path_does_not_launch():
    before = rmsnorm.launches
    rmsnorm(torch.ones(2, 8), torch.ones(8))
    assert rmsnorm.launches == before


def test_launch_counts_read_and_add_every_counter():
    """``launch_counts`` snapshots every kernel's counter by name and
    ``add_launch_counts`` adds a difference of two snapshots back."""
    from ray_tpu_torch.ops import add_launch_counts, flash_attention, launch_counts, quantize_int8

    before = launch_counts()
    assert set(before) == {"rmsnorm", "quantize_int8", "dequantize_int8", "flash_attention_fwd",
                           "flash_attention_bwd_dq", "flash_attention_bwd_dkdv"}
    add_launch_counts({"rmsnorm": 3, "flash_attention_fwd": 2, "quantize_int8": 1})
    try:
        assert rmsnorm.launches == before["rmsnorm"] + 3
        assert flash_attention.launches_fwd == before["flash_attention_fwd"] + 2
        assert quantize_int8.launches == before["quantize_int8"] + 1
        after = launch_counts()
        assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {
            "rmsnorm": 3, "flash_attention_fwd": 2, "quantize_int8": 1}
    finally:
        add_launch_counts({"rmsnorm": -3, "flash_attention_fwd": -2, "quantize_int8": -1})
    assert launch_counts() == before


def test_non_cpu_tensor_never_reaches_plain_version():
    """A tensor off the CPU goes to a kernel or raises: a device with no
    kernel (meta) is refused, not quietly computed by the plain version."""
    x = torch.empty(4, 8, device="meta")
    w = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        rmsnorm(x, w)


def test_build_lists_sources_and_keys_on_content():
    assert "rmsnorm" in build.sources()
    path = build.library_path("rmsnorm")
    assert path.parent == build.BUILD_DIR and path.name.startswith("librmsnorm-")
    assert build.library_path("rmsnorm") == path  # stable for unchanged sources
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(build.BuildError, match="nvcc not found"):
        build.nvcc_path()
