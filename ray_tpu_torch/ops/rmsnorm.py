"""Fused RMSNorm: a hand-written CUDA kernel (forward) with a closed-form
backward in plain PyTorch.

Counterpart of ``ray_tpu/ops/rmsnorm.py``. ``rmsnorm(x, w, eps)`` is a
``torch.autograd.Function``:

- forward: a CPU tensor goes to ``rmsnorm_plain``; a CUDA tensor goes to
  the kernel in ``csrc/rmsnorm.cu`` and nowhere else — a CUDA tensor the
  kernel does not take (dtype, layout, device) raises, it never falls back;
- backward: plain torch, the closed form of the reference's ``_bwd``. The
  reference has no backward kernel, so neither does the port.

``rmsnorm.launches`` counts kernel launches (a plain integer; callers reset
it to show that a path went through the kernel).
"""

from __future__ import annotations

import ctypes
import functools

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def rmsnorm_plain(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The kernel's function in plain PyTorch, in the kernel's order: fp32
    math, multiply by w in fp32, cast to x's dtype last. (The model's
    non-fused ``_rmsnorm`` casts first and then multiplies.)"""
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale * w.float()).to(x.dtype)


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(
            f"rmsnorm kernel: x and w must be on one CUDA device, got {x.device} and {w.device}"
        )
    if x.dtype not in _DTYPE_CODES or w.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"rmsnorm kernel: x and w must be float32 or bfloat16, got {x.dtype} and {w.dtype}"
        )
    if w.dim() != 1 or w.shape[0] != x.shape[-1]:
        raise ValueError(
            f"rmsnorm kernel: w must be [{x.shape[-1]}], got {list(w.shape)}"
        )
    if not x.is_contiguous() or not w.is_contiguous():
        raise ValueError("rmsnorm kernel: x and w must be contiguous")


@functools.cache
def _kernel():
    """The C entry point, built and loaded on first use."""
    from ray_tpu_torch._native.build import load

    fn = load("rmsnorm").rt_rmsnorm_fwd
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _launch(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    _check(x, w)
    y = torch.empty_like(x)
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    if rows == 0:
        return y
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), rows, d, float(eps),
            _DTYPE_CODES[x.dtype], _DTYPE_CODES[w.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: cudaError {err}")
    rmsnorm.launches += 1
    return y


def _forward(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    if x.device.type == "cpu":
        return rmsnorm_plain(x, w, eps)
    if x.device.type == "cuda":
        return _launch(x, w, eps)
    raise ValueError(f"rmsnorm: no kernel for device {x.device}")


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _forward(x, w, eps)

    @staticmethod
    def backward(ctx, g):
        # with s = rsqrt(mean(x^2) + eps) and y = x*s*w:
        #   dx = s*(g*w) - x * s^3 / d * sum(g*w*x),  dw = sum_rows(g * x*s)
        x, w = ctx.saved_tensors
        xf = x.float()
        gf = (g * w).float()
        d = x.shape[-1]
        s = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + ctx.eps)
        dot = (gf * xf).sum(dim=-1, keepdim=True)
        dx = (s * gf - xf * s**3 * dot / d).to(x.dtype)
        dw = (g * (xf * s).to(g.dtype)).reshape(-1, d).sum(dim=0).to(w.dtype)
        return dx, dw, None


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """rmsnorm(x) * w over the last axis, any leading shape; output dtype =
    x's dtype."""
    return _RMSNorm.apply(x, w, eps)


rmsnorm.launches = 0
