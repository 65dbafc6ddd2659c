"""The port's twin of ``__graft_entry__.entry()``: the forward of the
flagship model's small check configuration.

    fn, (params, tokens) = entry()          # on the card
    logits = fn(params, tokens)             # [2, 128, 4096] fp32

A 4-layer Llama (d_model 512, 8 heads / 4 kv heads, d_ff 1408, vocab 4096,
bf16, no remat) on 2 x 128 tokens drawn by numpy from seed 0, as the JAX
entry draws them. The weights are the port's own, seeded; to hold the two
entries against each other, give ``fn`` the JAX entry's weights through
``models.convert.params_from_jax``.

The JAX file's multi-chip dry run comes with the port's multi-device slice.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models.llama import LlamaConfig, forward, init_params


def entry_config() -> LlamaConfig:
    return LlamaConfig(
        vocab_size=4096, d_model=512, n_layers=4, n_heads=8, n_kv_heads=4, d_ff=1408,
        max_seq_len=512, dtype=torch.bfloat16, remat=False,
    )


def entry(device: Union[str, torch.device, None] = None):
    """(fn, (params, tokens)): the forward step and its example arguments,
    on ``device`` (CUDA unless the caller names another)."""
    device = resolve_device(device)
    cfg = entry_config()
    params = init_params(cfg, seed=0, device=device)
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 128)).astype(np.int32)
    ).to(device)

    def fn(params, tokens):
        return forward(params, tokens, cfg)

    return fn, (params, tokens)
