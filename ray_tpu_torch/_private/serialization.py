"""Tensor serialization: the torch half of ``ray_tpu/_private/serialization.py``.

The JAX package's serialization context gives JAX arrays a device-to-host
copy and an out-of-band buffer (:109-116) and takes other types through
``SerializationContext.register_custom_serializer`` (:139). This module is
the pair to register for ``torch.Tensor``; the port itself imports nothing
of ray_tpu and registers nothing:

    ctx.register_custom_serializer(torch.Tensor, serialize_tensor, deserialize_tensor)

``serialize_tensor`` returns a small payload whose one numpy array a
pickle of protocol 5 sends out-of-band: a CUDA tensor is copied to the
host first, a strided one made contiguous, and bfloat16 (which numpy has
no type for) travels as its int16 bits. ``deserialize_tensor`` rebuilds a
CPU tensor of the same dtype, shape and values.
"""

from __future__ import annotations

import numpy as np
import torch


def serialize_tensor(t: torch.Tensor) -> tuple:
    """(dtype name, shape, contiguous host numpy array)."""
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        return ("bfloat16", tuple(t.shape), t.view(torch.int16).numpy())
    return (str(t.dtype).removeprefix("torch."), tuple(t.shape), t.numpy())


def deserialize_tensor(payload: tuple) -> torch.Tensor:
    dtype, shape, arr = payload
    if not arr.flags.writeable:  # an out-of-band buffer may be read-only
        arr = arr.copy()
    t = torch.from_numpy(np.asarray(arr))
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.reshape(shape)
