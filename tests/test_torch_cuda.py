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
