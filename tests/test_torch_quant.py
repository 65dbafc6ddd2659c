"""The port's int8 quantize/dequantize against the JAX package's Pallas
kernels.

On the CPU the port's wrappers run their plain versions (the CUDA kernels
need the card); the JAX kernels run in Pallas interpret mode, as the JAX
package's own tests run them. The same numpy inputs go to both, and q,
scales and the dequantized output must be equal, bit for bit. The kernels
themselves are held against the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.ops as jax_ops
from ray_tpu.ops import dequantize_int8 as jax_dequantize
from ray_tpu.ops import quantize_int8 as jax_quantize
import ray_tpu_torch.ops as port_ops
from ray_tpu_torch._native import build
from ray_tpu_torch.ops import dequantize_int8, quantize_int8
from ray_tpu_torch.ops import quant

# ragged rows (13), rows < 8 (3), several of the TPU's 256-row blocks
# (520), widths that are no multiple of 16 (100, 257, 5), a model width
SHAPES = [(64, 256), (13, 100), (520, 257), (3, 5), (256, 3072)]
IN_DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
OUT_DTYPES = {
    "f32": (jnp.float32, torch.float32),
    "bf16": (jnp.bfloat16, torch.bfloat16),
    "f16": (jnp.float16, torch.float16),
}
SIGMAS = [3.0, 0.02]
CASES = [(shape, d, s) for shape in SHAPES for d in IN_DTYPES for s in SIGMAS]
CASE_IDS = [f"{r}x{c}-{d}-sigma{s}" for (r, c), d, s in CASES]


def _pair(x: np.ndarray, in_dtype: str):
    """The same values as a JAX array and a torch tensor of one dtype."""
    jdt, tdt = IN_DTYPES[in_dtype]
    xj = jnp.asarray(x).astype(jdt)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)  # exact: bf16 in fp32
    return xj, xt


@functools.cache
def _quantized(shape, in_dtype, sigma):
    """(JAX q, JAX scales, port q, port scales) for one case, as numpy."""
    seed = CASES.index((shape, in_dtype, sigma))
    x = (np.random.default_rng(seed).normal(size=shape) * sigma).astype(np.float32)
    xj, xt = _pair(x, in_dtype)
    qj, sj = jax_quantize(xj)
    q, s = quantize_int8(xt)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(q.shape) == shape and tuple(s.shape) == shape[:1]
    return np.asarray(qj), np.asarray(sj), q.numpy(), s.numpy()


@pytest.mark.parametrize("shape,in_dtype,sigma", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("out_dtype", list(OUT_DTYPES))
def test_quantize_and_dequantize_bit_equal_to_jax(shape, in_dtype, sigma, out_dtype):
    qj, sj, q, s = _quantized(shape, in_dtype, sigma)
    np.testing.assert_array_equal(q, qj)  # tolerance 0
    np.testing.assert_array_equal(s.view(np.uint32), sj.view(np.uint32))
    jdt, tdt = OUT_DTYPES[out_dtype]
    ref = jax_dequantize(jnp.asarray(qj), jnp.asarray(sj), dtype=jdt)
    out = dequantize_int8(torch.from_numpy(q), torch.from_numpy(s), dtype=tdt)
    assert out.dtype == tdt and tuple(out.shape) == shape
    ref32 = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_array_equal(out.float().numpy().view(np.uint32), ref32.view(np.uint32))


def test_ties_round_half_to_even():
    row = np.array([[127.0, 2.5, -3.5, 0.5, -0.5, 1.5]], np.float32)
    q, s = quantize_int8(torch.from_numpy(row))
    assert q.tolist() == [[127, 2, -4, 0, 0, 2]] and s.tolist() == [1.0]
    qj, sj = jax_quantize(jnp.asarray(row))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))


def test_all_zero_row_takes_the_floor_scale():
    x = np.zeros((2, 16), np.float32)
    x[1] = np.linspace(-1.0, 1.0, 16)
    q, s = quantize_int8(torch.from_numpy(x))
    floor = np.float32(1e-8) * np.float32(1.0 / 127.0)
    assert s[0].item() == floor and np.isclose(floor, 7.874015e-11, rtol=1e-7, atol=0)
    assert (q[0] == 0).all()
    qj, sj = jax_quantize(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))


@pytest.mark.parametrize("special", [np.nan, np.inf, -np.inf], ids=["nan", "inf", "-inf"])
@pytest.mark.parametrize("in_dtype", list(IN_DTYPES))
@pytest.mark.parametrize("shape", [(4, 64), (3, 5), (2, 3072)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_nonfinite_row_matches_jax(shape, in_dtype, special):
    """A NaN carries through the row's absmax, as in the reference: its
    scale is NaN (inf for an inf) and its q 0; the other rows are untouched."""
    x = np.random.default_rng(11).normal(size=shape).astype(np.float32)
    x[1, 3] = special
    xj, xt = _pair(x, in_dtype)
    qj, sj = jax_quantize(xj)
    q, s = quantize_int8(xt)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy().view(np.uint32), np.asarray(sj).view(np.uint32))
    assert (q[1] == 0).all()
    assert np.isnan(s[1].item()) if np.isnan(special) else s[1].item() == np.inf
    assert torch.isfinite(s[[0, *range(2, shape[0])]]).all()
    ref = jax_dequantize(qj, sj, dtype=jnp.float32)
    out = dequantize_int8(q, s, dtype=torch.float32)
    np.testing.assert_array_equal(out.numpy().view(np.uint32), np.asarray(ref).view(np.uint32))


def test_scale_multiplies_by_fp32_reciprocal_of_127():
    """The reference's ``max(absmax, 1e-8) / 127.0`` comes out of XLA as a
    multiply by fp32(1/127): an IEEE division by 127 gives other scales in
    some rows, and with them other q."""
    x = (np.random.default_rng(7).normal(size=(256, 3072)) * 0.02).astype(np.float32)
    xj, xt = _pair(x, "bf16")
    _, sj = jax_quantize(xj)
    absmax = np.maximum(np.abs(np.asarray(xj.astype(jnp.float32))).max(axis=1), np.float32(1e-8))
    by_mul = absmax * np.float32(1.0 / 127.0)
    by_div = absmax / np.float32(127.0)
    np.testing.assert_array_equal(np.asarray(sj), by_mul)
    assert (by_div != by_mul).any()  # the trap is live at this shape
    np.testing.assert_array_equal(quantize_int8(xt)[1].numpy(), by_mul)


def test_int8_quant_roundtrip():
    """Port twin of tests/test_ops.py::test_int8_quant_roundtrip."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(64, 256)).astype(np.float32) * 3.0)
    q, scales = quantize_int8(x)
    assert q.dtype == torch.int8 and tuple(scales.shape) == (64,)
    back = dequantize_int8(q, scales, dtype=torch.float32)
    err = (back - x).abs()
    # absmax int8: max error bounded by scale/2 per row
    bound = scales[:, None] * 0.5 + 1e-6
    assert (err <= bound).all()


def test_int8_quant_preserves_matmul_quality():
    """Port twin of tests/test_ops.py::test_int8_quant_preserves_matmul_quality:
    per-output-row scales of a transposed (strided) view."""
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.normal(size=(256, 128)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(8, 256)).astype(np.float32))
    assert not w.T.is_contiguous()
    q, s = quantize_int8(w.T)  # per-output-row scales
    w_deq = dequantize_int8(q, s, dtype=torch.float32).T
    ref = x @ w
    got = x @ w_deq
    rel = (torch.linalg.norm(got - ref) / torch.linalg.norm(ref)).item()
    assert rel < 0.01, rel
    qj, sj = jax_quantize(jnp.asarray(w.numpy()).T)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))


def test_cpu_route_launches_nothing():
    quant.reset_launches()
    q, s = quantize_int8(torch.randn(4, 32))
    dequantize_int8(q, s)
    assert (quantize_int8.launches, dequantize_int8.launches) == (0, 0)


def test_non_cpu_tensor_never_reaches_plain_version(monkeypatch):
    """A tensor off the CPU goes to a kernel or raises: a device with no
    kernel (meta) is refused, not computed by the plain versions."""

    def plain(*args, **kwargs):
        raise AssertionError("a meta tensor reached the plain version")

    monkeypatch.setattr(quant, "quantize_int8_plain", plain)
    monkeypatch.setattr(quant, "dequantize_int8_plain", plain)
    with pytest.raises(ValueError, match="no kernel"):
        quantize_int8(torch.empty(4, 8, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        dequantize_int8(torch.empty(4, 8, dtype=torch.int8, device="meta"),
                        torch.empty(4, device="meta"))


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_non_2d_input_raises(device):
    with pytest.raises(ValueError, match="2-D"):
        quantize_int8(torch.zeros(8, device=device))
    with pytest.raises(ValueError, match="2-D"):
        quantize_int8(torch.zeros(2, 4, 8, device=device))
    with pytest.raises(ValueError, match="2-D"):
        dequantize_int8(torch.zeros(8, dtype=torch.int8, device=device), torch.ones(8, device=device))
    with pytest.raises(ValueError, match="scales"):
        dequantize_int8(torch.zeros(4, 8, dtype=torch.int8, device=device),
                        torch.ones(3, device=device))


def test_kernel_entries_refuse_cpu_tensors():
    """The kernel entry points never compute on the CPU."""
    with pytest.raises(ValueError, match="CUDA"):
        quant.quantize_int8_kernel(torch.zeros(4, 16))
    with pytest.raises(ValueError, match="CUDA"):
        quant.dequantize_int8_kernel(torch.zeros(4, 16, dtype=torch.int8), torch.ones(4))


def test_ops_exports_cover_the_jax_package():
    assert set(jax_ops.__all__) <= set(port_ops.__all__)
    assert "quant" in build.sources()
    assert build.library_path("quant").name.startswith("libquant-")
