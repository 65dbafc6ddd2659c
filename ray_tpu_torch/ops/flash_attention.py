"""Causal flash attention: hand-written CUDA kernels for the forward, the
backward dQ and the backward dK/dV, with their plain PyTorch versions.

Counterpart of the TPU kernels that ``ray_tpu/models/llama.py`` reaches
through ``_splash_attention`` and ``_flash_attention`` (JAX's Pallas splash
and flash kernels, forward and backward). ``flash_attention(q, k, v)`` is a
``torch.autograd.Function`` on q ``[B, T, H, D]`` and k/v ``[B, T, KV, D]``
(GQA: H a multiple of KV; query head h reads kv head h // (H // KV)):

- a CPU tensor goes to ``flash_attention_fwd_plain`` /
  ``flash_attention_bwd_plain`` (fp32 math);
- a CUDA tensor goes to the kernels and nowhere else: the forward in
  ``csrc/flash_attention_fwd.cu``, the backward dQ and dK/dV in
  ``csrc/flash_attention.cu`` (all three TMA, wgmma, warp-specialised and
  persistent, on the helpers of ``csrc/hopper.cuh``). A CUDA tensor the
  kernels do not take (dtype other than bf16, head_dim other than 64 or
  128, a layout whose rows are not 16-byte aligned, differing lengths)
  raises, as does a failed build, tensor-map encoding or launch.

The forward saves ``o`` and the fp32 row log-sum-exp ``lse [B, H, T]``; the
backward reads them and does not recompute the forward. Under
``torch.utils.checkpoint`` the forward runs again in the backward pass, so
a remat train step launches the forward kernel twice per layer and each
backward kernel once.

Launch counts are plain integers on the function: ``launches_fwd``,
``launches_bwd_dq``, ``launches_bwd_dkdv``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ray_tpu_torch.parallel.ring_attention import gqa_scores

# Agreement of a bf16 kernel output with its plain version (fp32 math on the
# same bf16 inputs), fixed before the kernels' first run on the card. The
# kernels round P and dS to bf16 for the tensor cores and their outputs to
# bf16: ~2^-9 relative each, so a sound run reads ~2-3e-3 relative RMS and
# a max error of about one bf16 step at the largest magnitude (2^-7 of it).
REL_RMS_LIMIT = 1e-2  # RMS error over the RMS of the reference (floor 1e-3)
MAX_ABS_LIMIT = 2e-2  # max abs error over max(max |reference|, 1)
KERNEL_HEAD_DIMS = (64, 128)  # the D the kernels are built for
# order of the [batch, time, head] stride triples the C entry points read
_STRIDE_ORDER = ("q", "k", "v", "o", "do", "dq", "dk", "dv")


def _scale(q: torch.Tensor, sm_scale: Optional[float]) -> float:
    return q.shape[-1] ** -0.5 if sm_scale is None else float(sm_scale)


def flash_attention_fwd_plain(q, k, v, sm_scale=None, causal: bool = True):
    """The forward kernel's function in plain PyTorch, fp32 math:
    returns (o [B, T, H, D] in q's dtype, lse [B, H, T] fp32)."""
    B, T, H, D = q.shape
    KV = k.shape[2]
    s = gqa_scores(q, k, _scale(q, sm_scale), causal)
    lse = torch.logsumexp(s, dim=-1)  # [B, KV, G, T]
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bkgts,bskd->btkgd", p, v.float()).reshape(B, T, H, D)
    return o.to(q.dtype), lse.reshape(B, H, T)


def flash_attention_bwd_plain(q, k, v, o, lse, do, sm_scale=None, causal: bool = True):
    """The backward kernels' function in plain PyTorch, fp32 math: the
    FlashAttention-2 closed form from the saved lse,
    P = exp(S - lse), dV = P^T dO, dP = dO V^T, dS = P (dP - rowsum(O dO)),
    dQ = scale dS K, dK = scale dS^T Q, with dK/dV summed over the G query
    heads of each kv head. Returns (dq, dk, dv) in q/k/v's dtypes."""
    B, T, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = _scale(q, sm_scale)
    s = gqa_scores(q, k, scale, causal)
    p = torch.exp(s - lse.float().reshape(B, KV, G, T)[..., None])
    dof = do.float().reshape(B, T, KV, G, D)
    delta = (o.float() * do.float()).sum(-1).reshape(B, T, KV, G).permute(0, 2, 3, 1)
    dv = torch.einsum("bkgts,btkgd->bskd", p, dof)
    dp = torch.einsum("btkgd,bskd->bkgts", dof, v.float())
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bkgts,bskd->btkgd", ds, k.float()).reshape(B, T, H, D) * scale
    dk = torch.einsum("bkgts,btkgd->bskd", ds, q.float().reshape(B, T, KV, G, D)) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def agreement(out: torch.Tensor, ref: torch.Tensor) -> dict:
    """How far a kernel output is from its plain version, against the
    fixed limits: {"max_abs_err", "rel_rms_err", "ok"}."""
    ref = ref.float()
    err = out.float() - ref
    rel_rms = (err.pow(2).mean().sqrt() / ref.pow(2).mean().sqrt().clamp_min(1e-3)).item()
    max_abs = err.abs().max().item()
    ok = rel_rms <= REL_RMS_LIMIT and max_abs <= MAX_ABS_LIMIT * max(ref.abs().max().item(), 1.0)
    return {"max_abs_err": max_abs, "rel_rms_err": rel_rms, "ok": ok}


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_TAIL = [_P, _I, _I, _I, _I, _I, _F, _I, _P]  # strides, B, T, H, KV, D, scale, causal, stream


@functools.cache
def _lib():
    """The backward kernels' C entry points, built and loaded on first use."""
    from ray_tpu_torch._native.build import load

    lib = load("flash_attention")
    lib.rt_flash_attn_bwd_dq.argtypes = [_P] * 9 + _TAIL
    lib.rt_flash_attn_bwd_dkdv.argtypes = [_P] * 9 + _TAIL
    for fn in (lib.rt_flash_attn_bwd_dq, lib.rt_flash_attn_bwd_dkdv):
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _fwd_lib():
    """The forward kernel's C entry point, built and loaded on first use."""
    from ray_tpu_torch._native.build import load

    lib = load("flash_attention_fwd")
    lib.rt_flash_attn_fwd.argtypes = [_P] * 6 + _TAIL
    lib.rt_flash_attn_fwd.restype = ctypes.c_int
    return lib


def _check_rows(name: str, t: torch.Tensor) -> None:
    """Rows of head_dim elements must be contiguous and 16-byte aligned:
    the kernels' TMA tensor maps need 16-byte strides and a 16-byte aligned
    start."""
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:-1]) or t.data_ptr() % 16:
        raise ValueError(
            f"flash_attention kernel: {name} must have a unit head_dim stride, other "
            f"strides a multiple of 8 elements and a 16-byte aligned start; got "
            f"strides {tuple(t.stride())}"
        )


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(
            f"flash_attention kernel: q, k, v must be on one CUDA device, got "
            f"{q.device}, {k.device}, {v.device}"
        )
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(
            f"flash_attention kernel: q, k, v must be bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"flash_attention kernel: q [B, T, H, D], k/v [B, T, KV, D]; got "
            f"{list(q.shape)}, {list(k.shape)}, {list(v.shape)}"
        )
    B, T, H, D = q.shape
    if k.shape[0] != B or k.shape[1] != T or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(
            f"flash_attention kernel: q {list(q.shape)} and k/v {list(k.shape)} do not "
            f"match (equal B, T, D and H a multiple of KV)"
        )
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"flash_attention kernel: head_dim {D} not built (built for {KERNEL_HEAD_DIMS})"
        )
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_rows(name, t)


def _strides(**tensors) -> ctypes.Array:
    vals = []
    for name in _STRIDE_ORDER:
        t = tensors.get(name)
        vals += [t.stride(0), t.stride(1), t.stride(2)] if t is not None else [0, 0, 0]
    return (ctypes.c_longlong * len(vals))(*vals)


def _raise_if(err: int, what: str) -> None:
    if err == -1:
        raise RuntimeError(f"flash_attention {what}: the driver has no cuTensorMapEncodeTiled")
    if err <= -1000:
        raise RuntimeError(
            f"flash_attention {what}: cuTensorMapEncodeTiled refused a tensor map: "
            f"CUresult {-err - 1000}"
        )
    if err != 0:
        raise RuntimeError(f"flash_attention {what} kernel launch failed: cudaError {err}")


def flash_attention_fwd_kernel(q, k, v, sm_scale=None, causal: bool = True):
    """The forward kernel (CUDA tensors): (o, lse)."""
    _check(q, k, v)
    scale = _scale(q, sm_scale)
    B, T, H, D = q.shape
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return o, lse
    lib = _fwd_lib()
    next_work = torch.zeros((), dtype=torch.int32, device=q.device)  # the scheduler's counter
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.rt_flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            next_work.data_ptr(), _strides(q=q, k=k, v=v, o=o), B, T, H, k.shape[2], D, scale,
            int(causal), stream,
        )
    _raise_if(err, "forward")
    flash_attention.launches_fwd += 1
    return o, lse


def _grad_rows(q: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    if do.dtype != torch.bfloat16 or do.shape != q.shape or do.device != q.device:
        raise TypeError(f"flash_attention kernel: do must match q, got {do.dtype} {list(do.shape)}")
    if do.stride(-1) != 1 or any(s % 8 for s in do.stride()[:-1]) or do.data_ptr() % 16:
        # an incoming gradient may be expanded or strided (e.g. from a sum):
        # give the kernels rows they can copy
        do = do.contiguous()
    return do


def flash_attention_bwd_dq_kernel(q, k, v, o, lse, do, sm_scale=None, causal: bool = True):
    """The backward dQ kernel: (dq [B, T, H, D], delta = rowsum(o * do)
    [B, H, T] for the dK/dV kernel)."""
    _check(q, k, v)
    scale = _scale(q, sm_scale)
    B, T, H, D = q.shape
    if o.shape != q.shape or o.dtype != q.dtype or lse.shape != (B, H, T) or lse.dtype != torch.float32:
        raise ValueError(
            f"flash_attention kernel: o must match q and lse be fp32 [B, H, T]; got o "
            f"{o.dtype} {list(o.shape)}, lse {lse.dtype} {list(lse.shape)}"
        )
    _check_rows("o", o)
    do = _grad_rows(q, do)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    delta = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return dq, delta
    lse = lse.contiguous()
    next_work = torch.zeros((), dtype=torch.int32, device=q.device)  # the scheduler's counter
    with torch.cuda.device(q.device):
        err = _lib().rt_flash_attn_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), dq.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), next_work.data_ptr(),
            _strides(q=q, k=k, v=v, o=o, do=do, dq=dq),
            B, T, H, k.shape[2], D, scale, int(causal), torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_if(err, "backward dQ")
    flash_attention.launches_bwd_dq += 1
    return dq, delta


def flash_attention_bwd_dkdv_kernel(q, k, v, lse, delta, do, sm_scale=None, causal: bool = True):
    """The backward dK/dV kernel, given the dQ kernel's delta: (dk, dv)
    [B, T, KV, D]."""
    _check(q, k, v)
    scale = _scale(q, sm_scale)
    do = _grad_rows(q, do)
    B, T, H, D = q.shape
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    if q.numel() == 0:
        return dk.zero_(), dv.zero_()
    lse, delta = lse.contiguous(), delta.contiguous()
    next_work = torch.zeros((), dtype=torch.int32, device=q.device)  # the scheduler's counter
    with torch.cuda.device(q.device):
        err = _lib().rt_flash_attn_bwd_dkdv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), next_work.data_ptr(),
            _strides(q=q, k=k, v=v, do=do, dk=dk, dv=dv),
            B, T, H, k.shape[2], D, scale, int(causal), torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_if(err, "backward dK/dV")
    flash_attention.launches_bwd_dkdv += 1
    return dk, dv


def flash_attention_bwd_kernel(q, k, v, o, lse, do, sm_scale=None, causal: bool = True):
    """The two backward kernels, dQ then dK/dV (CUDA tensors): (dq, dk, dv)."""
    _check(q, k, v)
    do = _grad_rows(q, do)  # once, for both kernels
    dq, delta = flash_attention_bwd_dq_kernel(q, k, v, o, lse, do, sm_scale, causal)
    dk, dv = flash_attention_bwd_dkdv_kernel(q, k, v, lse, delta, do, sm_scale, causal)
    return dq, dk, dv


def _route(t: torch.Tensor) -> str:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"flash_attention: no kernel for device {t.device}")


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        if _route(q) == "cpu":
            o, lse = flash_attention_fwd_plain(q, k, v, scale, causal)
        else:
            o, lse = flash_attention_fwd_kernel(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if _route(q) == "cpu":
            dq, dk, dv = flash_attention_bwd_plain(q, k, v, o, lse, do, ctx.scale, ctx.causal)
        else:
            dq, dk, dv = flash_attention_bwd_kernel(q, k, v, o, lse, do, ctx.scale, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True, sm_scale: Optional[float] = None):
    """softmax(q k^T * sm_scale + causal mask) v; sm_scale defaults to
    D^-1/2. q [B, T, H, D], k/v [B, T, KV, D] -> [B, T, H, D] in q's dtype."""
    return _FlashAttention.apply(q, k, v, bool(causal), _scale(q, sm_scale))


def reset_launches() -> None:
    flash_attention.launches_fwd = 0
    flash_attention.launches_bwd_dq = 0
    flash_attention.launches_bwd_dkdv = 0


reset_launches()
