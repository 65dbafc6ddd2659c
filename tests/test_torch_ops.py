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
from ray_tpu_torch.ops import rmsnorm
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
