"""RLModule: the policy/value network, as a ``torch.nn.Module``.

Counterpart of ``ray_tpu/rllib/core/rl_module.py`` (reference:
``rllib/core/rl_module/rl_module.py:258``). An optional conv torso (ReLU)
feeds an MLP torso (tanh), then a policy head and a value head:
``forward(obs) -> (logits [B, A], value [B])``.

The parameters keep the JAX package's names and layouts, so the two
packages' weights compare key by key and a checkpoint crosses without a
map: ``w{i}`` / ``w_pi`` / ``w_v`` are [in, out], ``conv{i}`` is HWIO,
biases are 1-d. Pixel observations stay NHWC at the public function, as
JAX's ``conv_general_dilated(..., ("NHWC", "HWIO", "NHWC"))``; the conv
runs in NCHW inside and the activations go back to NHWC before the
flatten, so ``w0`` sees JAX's feature order. ``padding="SAME"`` with
stride 2 pads asymmetrically (``F.conv2d(padding="same")`` refuses a
stride), so the input is padded with ``F.pad`` first.

``params_from_jax`` is the one function that carries JAX parameters (as
numpy arrays) across; the init draws from torch's generator, so a fresh
module has the JAX module's distributions, not its values.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch import resolve_device


@dataclasses.dataclass
class RLModuleSpec:
    """Reference: ``rllib/core/rl_module/rl_module.py`` RLModuleSpec."""

    observation_dim: int = 4
    action_dim: int = 2
    hidden: Sequence[int] = (64, 64)
    # discrete only for now (PPO on classic control / Atari-ram scale)
    free_log_std: bool = False
    # pixel observations: obs_shape (H, W, C) + conv torso
    # [(out_channels, kernel, stride), ...] ahead of the MLP (reference:
    # the Atari CNN catalog defaults, rllib/core/models/catalog.py)
    obs_shape: Optional[tuple] = None
    conv_filters: Sequence[tuple] = ()

    def arch(self) -> tuple:
        """Static architecture descriptor: (conv_filters, n_hidden)."""
        return (tuple(tuple(c) for c in self.conv_filters), len(self.hidden))

    def build(self, seed: int = 0, device: Union[str, torch.device, None] = None) -> "RLModule":
        """The module on ``device``: the card unless the caller names
        another (env runners ask for the CPU)."""
        return RLModule(self, seed, device)


def init_params(spec: RLModuleSpec, seed: int = 0, device="cpu") -> dict:
    """Fresh parameters with the JAX init's shapes and distributions
    (normal / sqrt(fan_in) weights, zero biases, heads x 0.01), drawn on
    the host from ``torch.Generator().manual_seed(seed)``."""
    gen = torch.Generator().manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32)

    params: dict[str, torch.Tensor] = {}
    convs = tuple(tuple(c) for c in spec.conv_filters)
    if convs:
        if spec.obs_shape is None:
            raise ValueError("conv_filters requires obs_shape (H, W, C)")
        h, w, c_in = spec.obs_shape
        for i, (c_out, k, s) in enumerate(convs):
            params[f"conv{i}"] = normal(k, k, c_in, c_out) / np.sqrt(k * k * c_in)
            params[f"cb{i}"] = torch.zeros(c_out)
            h, w, c_in = -(-h // s), -(-w // s), c_out
        flat = h * w * c_in
    else:
        flat = spec.observation_dim
    sizes = [flat, *spec.hidden]
    for i in range(len(sizes) - 1):
        params[f"w{i}"] = normal(sizes[i], sizes[i + 1]) / np.sqrt(sizes[i])
        params[f"b{i}"] = torch.zeros(sizes[i + 1])
    params["w_pi"] = normal(sizes[-1], spec.action_dim) * 0.01
    params["b_pi"] = torch.zeros(spec.action_dim)
    params["w_v"] = normal(sizes[-1], 1) * 0.01
    params["b_v"] = torch.zeros(1)
    return {k: v.to(device) for k, v in params.items()}


def params_from_jax(np_params: dict, device="cpu") -> dict:
    """JAX parameters (numpy arrays, JAX's names and layouts) as the
    port's fp32 tensors on ``device``. The layouts are the same, so this
    is a copy."""
    return {k: torch.tensor(np.asarray(v), dtype=torch.float32, device=device)
            for k, v in np_params.items()}


def _same_pad(size: int, k: int, s: int) -> tuple[int, int]:
    """XLA's SAME padding: total max((ceil(size/s) - 1) s + k - size, 0),
    the low side total // 2."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def forward(params, obs: torch.Tensor, arch) -> tuple[torch.Tensor, torch.Tensor]:
    """(logits [B, A], value [B]): the JAX ``RLModule.forward``.

    ``arch``: an int n_hidden (MLP torso) or ``RLModuleSpec.arch()``
    (conv_filters, n_hidden); conv torsos take [B, H, W, C] observations."""
    convs, n_hidden = ((), arch) if isinstance(arch, int) else arch
    x = obs
    if convs:
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        for i, (_c_out, _k, s) in enumerate(convs):
            w = params[f"conv{i}"]  # HWIO
            ph = _same_pad(x.shape[2], w.shape[0], s)
            pw = _same_pad(x.shape[3], w.shape[1], s)
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
            x = torch.relu(F.conv2d(x, w.permute(3, 2, 0, 1), params[f"cb{i}"], stride=s))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flatten in NHWC order
    for i in range(n_hidden):
        x = torch.tanh(torch.addmm(params[f"b{i}"], x, params[f"w{i}"]))
    logits = torch.addmm(params["b_pi"], x, params["w_pi"])
    value = torch.addmm(params["b_v"], x, params["w_v"])[:, 0]
    return logits, value


class RLModule(torch.nn.Module):
    """Shared-torso network with policy-logit and value heads."""

    def __init__(self, spec: RLModuleSpec, seed: int = 0,
                 device: Union[str, torch.device, None] = None):
        super().__init__()
        self.spec = spec
        self.device = resolve_device(device)
        self.arch = spec.arch()
        self.params = torch.nn.ParameterDict(
            {k: torch.nn.Parameter(v) for k, v in init_params(spec, seed, self.device).items()})

    def forward(self, obs: torch.Tensor):
        return forward(self.params, obs, self.arch)

    # -- inference-side API (env runners): numpy in, numpy out ---------------

    @torch.no_grad()
    def _fwd(self, obs: np.ndarray):
        x = torch.from_numpy(np.asarray(obs, np.float32)).to(self.device)
        logits, value = self.forward(x)
        return logits.cpu().numpy(), value.cpu().numpy()

    def forward_inference(self, obs: np.ndarray):
        return self._fwd(obs)

    def forward_exploration(self, obs: np.ndarray):
        return self._fwd(obs)

    def get_state(self) -> dict:
        """Host copies, JAX's names and layouts."""
        return {k: p.detach().cpu().numpy().copy() for k, p in self.params.items()}

    @torch.no_grad()
    def set_state(self, state: dict):
        """Copy weights (numpy arrays or tensors) into the parameters in
        place, so an optimizer's references stay valid."""
        if set(state) != set(self.params):
            raise ValueError(f"weights {sorted(state)} != the module's {sorted(self.params)}")
        for k, v in state.items():
            p = self.params[k]
            src = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v, np.float32))
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"weight {k!r} is {tuple(src.shape)}, the module's {tuple(p.shape)}")
            p.copy_(src)
