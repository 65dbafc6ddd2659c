"""Carry the JAX package's params over to the port.

The tests build weights once with the JAX package, fetch them as numpy
arrays (``jax.device_get(params)``) and hand the same values to the port.
The port never imports JAX to do so: it reads plain numpy arrays, whose
keys and stacked shapes the two packages share.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ray_tpu_torch import resolve_device


def _to_tensor(a) -> torch.Tensor:
    a = np.array(a)  # an owned, writable, contiguous copy
    if a.dtype.name == "bfloat16":
        # numpy's bfloat16 (ml_dtypes) has no torch counterpart in
        # from_numpy: reinterpret the same 16 bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(
    np_params: dict,
    device: Union[str, torch.device, None] = None,
    dtype: Optional[torch.dtype] = None,
) -> dict[str, torch.Tensor]:
    """{name: numpy array} -> {name: tensor on ``device``}, same keys and
    shapes; cast to ``dtype`` when given, else the arrays' own dtype.
    ``device`` is CUDA unless the caller names another (``resolve_device``)."""
    device = resolve_device(device)
    out = {}
    for name, arr in np_params.items():
        t = _to_tensor(arr)
        out[name] = t.to(device=device, dtype=dtype or t.dtype)
    return out
