"""Per-row absmax int8 quantization: hand-written CUDA kernels for
quantize and dequantize, with their plain PyTorch versions.

Counterpart of ``ray_tpu/ops/quant.py``: ``quantize_int8`` replaces its
``_quant_kernel`` and ``dequantize_int8`` its ``_dequant_kernel``, with the
same signatures and return types. Per output row of a weight matrix:

    scale = max(absmax(row), 1e-8) * float32(1/127)
    q     = clip(round_half_even(x / scale), -127, 127)   int8
    out   = (float(q) * scale)                            fp32, rounded once to dtype

The scale multiplies by the fp32 constant 1/127 and does not divide by 127:
the reference writes ``/ 127.0``, which XLA compiles to that multiply, and
an IEEE division differs from it by 1 ulp in some rows (and then q by 1 in
some elements). ``x / scale`` stays a true IEEE division, as in XLA. A
NaN in a row carries through the absmax, as ``jnp.max`` does: the row's
scale is NaN and its q 0 (an inf gives an inf scale and q 0).

- A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel
  in ``csrc/quant.cu`` and nowhere else: one the kernel does not take
  (dtype, layout) raises, it never falls back.
- The public functions take any 2-D tensor (a transposed view too, as the
  reference does) and make it contiguous at the boundary. The TPU's row
  padding (``ray_tpu/ops/_common.py``) has no counterpart: the kernels take
  any row count.

Both kernels are bound by bytes: quantize moves rows*cols*(in_bytes + 1) +
4*rows bytes, dequantize rows*cols*(1 + out_bytes) + 4*rows.

``quantize_int8.launches`` and ``dequantize_int8.launches`` count kernel
launches (plain integers; ``reset_launches`` sets both to 0).
"""

from __future__ import annotations

import ctypes
import functools

import torch

# fp32(1/127): the constant XLA multiplies by for the reference's `/ 127.0`
INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()
SCALE_FLOOR = 1e-8
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def quantize_int8_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The quantize kernel's function in plain PyTorch, in the reference's
    order of operations: (int8 [rows, cols], fp32 scales [rows])."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(absmax, min=SCALE_FLOOR) * INV_127
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def dequantize_int8_plain(
    q: torch.Tensor, scales: torch.Tensor, dtype: torch.dtype = torch.bfloat16
) -> torch.Tensor:
    """The dequantize kernel's function in plain PyTorch: an fp32 product,
    cast once to ``dtype``."""
    return (q.float() * scales.float()[:, None]).to(dtype)


def _check_2d(name: str, t: torch.Tensor) -> None:
    if t.dim() != 2:
        raise ValueError(f"{name}: expected a 2-D [rows, cols] tensor, got shape {list(t.shape)}")


def _check_scales(q: torch.Tensor, scales: torch.Tensor) -> None:
    if scales.dim() != 1 or scales.shape[0] != q.shape[0]:
        raise ValueError(
            f"dequantize_int8: scales must be [{q.shape[0]}], got {list(scales.shape)}"
        )


def _check_cuda(name: str, *ts: torch.Tensor) -> None:
    dev = ts[0].device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError(f"{name} kernel: tensors must be on one CUDA device, got "
                         f"{[str(t.device) for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name} kernel: tensors must be contiguous")


@functools.cache
def _lib():
    """The C entry points, built and loaded on first use."""
    from ray_tpu_torch._native.build import load

    lib = load("quant")
    args = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    for fn in (lib.rt_quantize_int8, lib.rt_dequantize_int8):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def quantize_int8_kernel(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The quantize kernel on a contiguous 2-D CUDA tensor of fp32, bf16 or
    fp16; raises on anything else."""
    _check_2d("quantize_int8", x)
    _check_cuda("quantize_int8", x)
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"quantize_int8 kernel: x must be float32, bfloat16 or float16, got {x.dtype}")
    rows, cols = x.shape
    q = torch.empty((rows, cols), dtype=torch.int8, device=x.device)
    scales = torch.empty((rows,), dtype=torch.float32, device=x.device)
    if q.numel() == 0:
        return q, scales
    with torch.cuda.device(x.device):
        err = _lib().rt_quantize_int8(x.data_ptr(), q.data_ptr(), scales.data_ptr(), rows, cols,
                                      _DTYPE_CODES[x.dtype], _stream(x))
    if err != 0:
        raise RuntimeError(f"quantize_int8 kernel launch failed: cudaError {err}")
    quantize_int8.launches += 1
    return q, scales


def dequantize_int8_kernel(
    q: torch.Tensor, scales: torch.Tensor, dtype: torch.dtype = torch.bfloat16
) -> torch.Tensor:
    """The dequantize kernel on contiguous CUDA tensors: int8 q [rows, cols],
    fp32 scales [rows], output fp32, bf16 or fp16; raises on anything else."""
    _check_2d("dequantize_int8", q)
    _check_scales(q, scales)
    _check_cuda("dequantize_int8", q, scales)
    if q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"dequantize_int8 kernel: q must be int8 and scales float32, got "
                        f"{q.dtype} and {scales.dtype}")
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"dequantize_int8 kernel: dtype must be float32, bfloat16 or float16, got {dtype}")
    rows, cols = q.shape
    out = torch.empty((rows, cols), dtype=dtype, device=q.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        err = _lib().rt_dequantize_int8(q.data_ptr(), scales.data_ptr(), out.data_ptr(), rows, cols,
                                        _DTYPE_CODES[dtype], _stream(q))
    if err != 0:
        raise RuntimeError(f"dequantize_int8 kernel launch failed: cudaError {err}")
    dequantize_int8.launches += 1
    return out


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[rows, cols] float -> (int8 values, fp32 per-row scales [rows])."""
    _check_2d("quantize_int8", x)
    x = x.contiguous()
    if x.device.type == "cpu":
        return quantize_int8_plain(x)
    if x.device.type == "cuda":
        return quantize_int8_kernel(x)
    raise ValueError(f"quantize_int8: no kernel for device {x.device}")


def dequantize_int8(
    q: torch.Tensor, scales: torch.Tensor, dtype: torch.dtype = torch.bfloat16
) -> torch.Tensor:
    """int8 [rows, cols] and fp32 scales [rows] -> ``dtype`` [rows, cols]."""
    _check_2d("dequantize_int8", q)
    _check_scales(q, scales)
    q, scales = q.contiguous(), scales.contiguous()
    if q.device.type == "cpu":
        return dequantize_int8_plain(q, scales, dtype)
    if q.device.type == "cuda":
        return dequantize_int8_kernel(q, scales, dtype)
    raise ValueError(f"dequantize_int8: no kernel for device {q.device}")


def reset_launches() -> None:
    quantize_int8.launches = 0
    dequantize_int8.launches = 0


reset_launches()
