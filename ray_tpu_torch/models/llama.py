"""Llama-family decoder in PyTorch: the training forward and the serving
half.

Counterpart of ``ray_tpu/models/llama.py``. Params are a plain dict keyed
as the JAX package keys them (``_param_shapes``), with the per-layer
weights stacked ``[L, ...]``; caches are head-major ``[L, B, KV, S, D]``.
Public functions keep the JAX package's layouts, so one set of numpy arrays
feeds both packages in the tests.

Ported: the config, parameter init, the training forward
(``forward_hidden``, ``forward``, ``loss_fn``; causal attention through the
CUDA flash-attention kernels for ``attention="flash"``/``"splash"`` on the
card; per-layer remat, "full" or "dots"), the routed MoE FFN
(``parallel/moe.py``) in training and, dropless, in serving, and the decode
path (``init_kv_cache``, ``prefill``, ``decode_step``) with stacked
multi-LoRA adapters (``init_lora_stack``), on one device or, for gang
serving (``llm/spmd.py``), on a serving mesh of tp, sp and dp.

On a mesh (``parallel/mesh.py``) each rank runs the same functions on its
shards, with explicit collectives where the JAX package has GSPMD insert
them (``_Plan``): tensor parallelism Megatron style (q/k/v/gate/up by
columns, wo/w_down by rows and an all-reduce, the embedding, unembedding
and cross-entropy vocab-parallel), fsdp params all-gathered before use
(their gradients reduce-scattered), ring or Ulysses attention over ``sp``
with global RoPE positions, the MoE FFN expert-parallel over ``ep``
(``moe.moe_layer``) or globally routed over a sharded batch at ep = 1, and
the layer stack as a GPipe pipeline over ``pp``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ray_tpu_torch import resolve_device
from ray_tpu_torch.ops.cross_entropy import fused_cross_entropy, fused_nll_sum, matmul_fp32_out
from ray_tpu_torch.ops.flash_attention import flash_attention
from ray_tpu_torch.ops.rmsnorm import add_rmsnorm
from ray_tpu_torch.parallel import mesh as pmesh
from ray_tpu_torch.parallel import moe
from ray_tpu_torch.parallel.pipeline import pipeline_apply
from ray_tpu_torch.parallel.ring_attention import dense_attention, ring_attention
from ray_tpu_torch.parallel.ulysses import ulysses_attention


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    d_ff: int = 11008
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # route rmsnorm through the CUDA kernel (ray_tpu_torch.ops.rmsnorm)
    fused_rmsnorm: bool = False
    tie_embeddings: bool = False
    # >0: every layer's FFN is a top-k routed expert bank (parallel/moe.py)
    moe_experts: int = 0
    # 'full' | 'flash' | 'splash' | 'ring' | 'ulysses': all but 'full' run
    # the CUDA flash-attention kernels on the card (ring and ulysses per
    # rank over an sp mesh axis); 'full', and all on the CPU, run
    # dense_attention, as the JAX package does off the TPU
    attention: str = "full"
    # fused blockwise cross-entropy in the train loss (ops.cross_entropy)
    fused_ce: bool = True
    # per-layer torch.utils.checkpoint in forward_hidden
    remat: bool = True
    # 'full' = recompute everything in backward; 'dots' = save matmul
    # outputs, recompute the rest (jax.checkpoint_policies.dots_saveable)
    remat_policy: str = "full"
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    # microbatches of the GPipe schedule when the mesh has pp > 1; 0 = 2 * pp
    pp_microbatches: int = 0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def num_params(self) -> int:
        e, f, v = self.d_model, self.d_ff, self.vocab_size
        h, kv, hd = self.n_heads, self.n_kv_heads, self.head_dim
        if self.moe_experts:
            ffn = e * self.moe_experts + self.moe_experts * 3 * e * f
        else:
            ffn = 3 * e * f  # w_gate, w_up + w_down
        per_layer = (
            e * h * hd  # wq
            + 2 * e * kv * hd  # wk, wv
            + h * hd * e  # wo
            + ffn
            + 2 * e  # norms
        )
        out_head = 0 if self.tie_embeddings else v * e
        return v * e + self.n_layers * per_layer + e + out_head

    # ---- presets (the JAX package's, value for value) ----
    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        d = dict(
            vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=128, dtype=torch.float32, remat=False,
        )
        d.update(kw)
        return LlamaConfig(**d)

    @staticmethod
    def llama2_7b(**kw) -> "LlamaConfig":
        d = dict(
            vocab_size=32000, d_model=4096, n_layers=32, n_heads=32,
            n_kv_heads=32, d_ff=11008, max_seq_len=4096,
        )
        d.update(kw)
        return LlamaConfig(**d)

    @staticmethod
    def llama3_8b(**kw) -> "LlamaConfig":
        d = dict(
            vocab_size=128256, d_model=4096, n_layers=32, n_heads=32,
            n_kv_heads=8, d_ff=14336, max_seq_len=8192, rope_theta=500000.0,
        )
        d.update(kw)
        return LlamaConfig(**d)

    @staticmethod
    def llama32_3b(**kw) -> "LlamaConfig":
        d = dict(
            vocab_size=128256, d_model=3072, n_layers=28, n_heads=24,
            n_kv_heads=8, d_ff=8192, max_seq_len=8192, rope_theta=500000.0,
            tie_embeddings=True,
        )
        d.update(kw)
        return LlamaConfig(**d)

    @staticmethod
    def llama3_70b(**kw) -> "LlamaConfig":
        d = dict(
            vocab_size=128256, d_model=8192, n_layers=80, n_heads=64,
            n_kv_heads=8, d_ff=28672, max_seq_len=8192, rope_theta=500000.0,
        )
        d.update(kw)
        return LlamaConfig(**d)


def _param_shapes(cfg: LlamaConfig) -> dict[str, tuple]:
    e, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    h, kv, hd, L = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    shapes = {
        "embed": (v, e),
        "final_norm": (e,),
        "wq": (L, e, h, hd),
        "wk": (L, e, kv, hd),
        "wv": (L, e, kv, hd),
        "wo": (L, h, hd, e),
        "attn_norm": (L, e),
        "mlp_norm": (L, e),
    }
    if cfg.moe_experts:
        E = cfg.moe_experts
        shapes.update(
            {
                "moe_router": (L, e, E),
                "moe_w_gate": (L, E, e, f),
                "moe_w_up": (L, E, e, f),
                "moe_w_down": (L, E, f, e),
            }
        )
    else:
        shapes.update({"w_gate": (L, e, f), "w_up": (L, e, f), "w_down": (L, f, e)})
    if not cfg.tie_embeddings:
        shapes["unembed"] = (e, v)
    return shapes


def _layer_keys(cfg: LlamaConfig) -> tuple:
    base = ("wq", "wk", "wv", "wo", "attn_norm", "mlp_norm")
    if cfg.moe_experts:
        return base + ("moe_router", "moe_w_gate", "moe_w_up", "moe_w_down")
    return base + ("w_gate", "w_up", "w_down")


# Logical dims of each param (``ray_tpu/models/llama.py:_PARAM_DIMS``,
# :199-212), except that the layer stacks' leading dim is named "stage"
# (rule: pp) where the JAX table has None: the JAX pipeline constrains that
# dim to pp at its entry (``gpipe_spmd``'s ``cst``), and here each pp rank
# holds only its stage's layers.
_PARAM_DIMS = {
    "embed": ("vocab", "embed"),
    "unembed": ("embed", "vocab"),
    "final_norm": ("norm",),
    "wq": ("stage", "embed", "heads", "head_dim"),
    "wk": ("stage", "embed", "kv_heads", "head_dim"),
    "wv": ("stage", "embed", "kv_heads", "head_dim"),
    "wo": ("stage", "heads", "head_dim", "embed"),
    "w_gate": ("stage", "embed", "mlp"),
    "w_up": ("stage", "embed", "mlp"),
    "w_down": ("stage", "mlp", "embed"),
    "attn_norm": ("stage", "norm"),
    "mlp_norm": ("stage", "norm"),
    "moe_router": ("stage", "embed", None),
    "moe_w_gate": ("stage", "expert", "embed", "mlp"),
    "moe_w_up": ("stage", "expert", "embed", "mlp"),
    "moe_w_down": ("stage", "expert", "mlp", "embed"),
}


def param_specs(cfg: LlamaConfig, mesh) -> dict[str, tuple]:
    """Each param's PartitionSpec on ``mesh`` (mesh axes per dim; an axis
    that does not divide a dim leaves it whole)."""
    return {k: pmesh.logical_pspec(mesh, *_PARAM_DIMS[k], shape=s)
            for k, s in _param_shapes(cfg).items()}


def gather_params(cfg: LlamaConfig, mesh, params: dict) -> dict[str, torch.Tensor]:
    """The whole params from every rank's shards (a collective: every rank
    calls it)."""
    specs = param_specs(cfg, mesh)
    return {k: pmesh.gather_leaf(mesh, params[k], specs[k]) for k in sorted(params)}


def param_template(cfg: LlamaConfig) -> dict[str, torch.Tensor]:
    """``init_params``' names, shapes and dtype as meta tensors: a template
    for ``train.restore_state_dict`` that allocates nothing."""
    return {name: torch.empty(shape, dtype=cfg.dtype, device="meta")
            for name, shape in sorted(_param_shapes(cfg).items())}


def init_params(
    cfg: LlamaConfig, seed: int = 0, device: Union[str, torch.device, None] = None,
    mesh=None,
) -> dict[str, torch.Tensor]:
    """Norms are ones; every other weight is N(0, 1) * fan_in^-1/2 in
    ``cfg.dtype``, as in the JAX package (the random bits differ), drawn
    from a ``torch.Generator`` on ``device`` seeded with ``seed``. Each
    tensor is drawn on ``device`` directly in ``cfg.dtype``: a 3B model
    takes no fp32 detour through host memory. ``device`` is CUDA unless
    the caller names another (``resolve_device``).

    With a ``mesh`` each rank gets its shard (``param_specs``) holding
    exactly the numbers of the unsharded init with the same seed: each
    whole leaf is drawn on the device, cut, and freed, one at a time."""
    device = resolve_device(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    specs = None if mesh is None else param_specs(cfg, mesh)
    params = {}
    for name, shape in sorted(_param_shapes(cfg).items()):
        if "norm" in name:
            t = torch.ones(shape, dtype=cfg.dtype, device=device)
        else:
            fan_in = shape[-2] if len(shape) > 1 else shape[0]
            t = torch.empty(shape, dtype=cfg.dtype, device=device)
            t.normal_(0.0, fan_in**-0.5, generator=generator)
        if specs is not None:
            t = t[pmesh.local_slice(mesh, specs[name], shape)].clone()
        params[name] = t
    return params


def _rmsnorm(x, w, eps, fused: bool = False):
    if fused:
        from ray_tpu_torch.ops import rmsnorm

        # output dtype = x's dtype (model weights share cfg.dtype)
        return rmsnorm(x, w, eps)
    x32 = x.float()
    scale = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * scale).to(x.dtype) * w


def _rope_tables(positions: torch.Tensor, d: int, theta: float):
    """cos/sin [B, T, 1, D/2] (fp32) for absolute positions [B, T]."""
    exps = torch.arange(0, d, 2, dtype=torch.float32, device=positions.device) / d
    freqs = 1.0 / (theta**exps)
    angles = positions[..., None].float() * freqs
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def _rope(x, positions, theta, tables=None):
    """x: [B, T, H, D], positions: [B, T]. Rotates split halves (not
    interleaved pairs), as the JAX package does. ``tables`` reuses the
    cos/sin of ``_rope_tables`` across layers."""
    cos, sin = tables if tables is not None else _rope_tables(positions, x.shape[-1], theta)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Training forward: full-sequence causal forward and the next-token loss.
# ---------------------------------------------------------------------------

def _attention(q, k, v, cfg: LlamaConfig):
    """q: [B, T, H, D]; k/v: [B, T, KV, D]. Returns [B, T, H, D].

    The JAX package's dispatch without a mesh: "flash" and "splash" run the
    flash-attention kernels on the card (JAX: its Pallas kernels on the
    TPU), and so do "ring" and "ulysses" on one sequence shard (JAX: dense
    attention there, the same function); "full", and every choice on the
    CPU, runs the GQA-native dense_attention. The kernels read kv head
    h // G directly, so K/V are never repeated."""
    if cfg.attention != "full" and q.device.type == "cuda":
        return flash_attention(q, k, v, causal=True)
    return dense_attention(q, k, v, causal=True)


class _Plan:
    """How this rank runs the model on ``mesh``: each param's PartitionSpec
    and the collectives that follow from it.

    - fsdp: a leaf sharded along "embed" is all-gathered over fsdp where it
      is used (``full``), inside the layer (and again when remat re-runs it);
      the gather's backward reduce-scatters its gradient.
    - tp: wq/wk/wv/w_gate/w_up hold this rank's columns (heads, kv heads,
      mlp), wo/w_down its rows, and their partial outputs are all-reduced
      (``tp_sum``); a dim that tp does not divide stays whole and its
      product is computed on every tp rank. The embedding, unembedding and
      cross-entropy are vocab-parallel.
    - sp: this rank's sequence shard, RoPE at global positions, ring (or
      Ulysses) attention.
    - ep / pp: ``moe.moe_layer`` over ep; a GPipe pipeline over pp.
    Every collective's backward is its transpose, so each rank's share of
    the loss (``loss_fn``) back-propagates to its share of each gradient."""

    def __init__(self, cfg: LlamaConfig, mesh):
        self.mesh = mesh
        self.sizes = pmesh.mesh_sizes(mesh)
        self.specs = param_specs(cfg, mesh)
        self.tp = pmesh.axis_group(mesh, "tp")
        self.tp_rank = mesh.get_local_rank("tp")
        self.sp_rank = mesh.get_local_rank("sp")
        # a layer leaf's spec without its leading stage dim
        self._layer_spec = {k: (v[1:] if _PARAM_DIMS[k][0] == "stage" else v)
                            for k, v in self.specs.items()}

    def full(self, name: str, w: torch.Tensor, axes=("fsdp",)) -> torch.Tensor:
        """``w`` (a leaf, or one layer of a stack) all-gathered along each
        dim sharded over one of ``axes``."""
        for dim, entry in enumerate(self._layer_spec[name] if w.dim() < len(self.specs[name])
                                    else self.specs[name]):
            for axis in pmesh.spec_axes(entry):
                if axis in axes:
                    w = pmesh.all_gather(w, pmesh.axis_group(self.mesh, axis), dim)
        return w

    def sharded(self, name: str, logical: str) -> bool:
        """Whether ``name``'s ``logical`` dim is split over tp."""
        return "tp" in pmesh.spec_axes(self.specs[name][_PARAM_DIMS[name].index(logical)])

    def tp_sum(self, y: torch.Tensor, name: str, logical: str) -> torch.Tensor:
        return pmesh.all_reduce(y, self.tp) if self.sharded(name, logical) else y

    def local_kv(self, k, v, n_heads: int, cfg: LlamaConfig, dim: int = 2):
        """The kv heads this rank's q heads read (``dim`` is the head dim:
        2 for [B, T, KV, D], 1 for the cache's [B, KV, S, D]): all of k/v
        when the kv heads are split over tp with the heads (or nothing is
        split), else the slice (or, when a q head group straddles ranks, the
        per-head selection) of the whole k/v."""
        if k.shape[dim] * (cfg.n_heads // cfg.n_kv_heads) == n_heads:
            return k, v
        G = cfg.n_heads // cfg.n_kv_heads
        first = self.tp_rank * n_heads
        if n_heads % G == 0:
            return (k.narrow(dim, first // G, n_heads // G),
                    v.narrow(dim, first // G, n_heads // G))
        idx = (torch.arange(first, first + n_heads, device=k.device) // G)
        return k.index_select(dim, idx), v.index_select(dim, idx)

    def cut(self, x: torch.Tensor, name: str, logical: str, dim: int) -> torch.Tensor:
        """This rank's part of ``x`` along ``dim``, which is whole and runs
        along ``name``'s ``logical`` dim (a view: LoRA's B matrices cut to
        the rank's heads)."""
        if not self.sharded(name, logical):
            return x
        n = x.shape[dim] // self.sizes["tp"]
        return x.narrow(dim, self.tp_rank * n, n)

    def attention(self, q, k, v, cfg: LlamaConfig):
        sp = self.sizes["sp"]
        if sp > 1 and cfg.attention == "ulysses":
            if k.shape[2] % sp:  # the JAX package repeats kv heads here (:316)
                G = q.shape[2] // k.shape[2]
                k, v = k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)
            return ulysses_attention(q, k, v, self.mesh)
        if sp > 1:
            # ring for "ring"; for any other choice too: the JAX package
            # computes the same function as dense attention over the sharded
            # sequence
            return ring_attention(q, k, v, self.mesh)
        return _attention(q, k, v, cfg)


def _layer(layer_params, x, positions, cfg: LlamaConfig, tables=None, plan=None):
    """One transformer block. Returns (x, aux): aux is the MoE
    load-balancing loss, 0.0 for dense layers. With a ``plan`` the weights
    are this rank's shards (``_Plan``)."""
    p = layer_params
    B, T, e = x.shape
    D = cfg.head_dim
    w = (lambda n: p[n]) if plan is None else (lambda n: plan.full(n, p[n]))
    h = _rmsnorm(x, p["attn_norm"], cfg.rms_eps, cfg.fused_rmsnorm)
    wq, wk, wv = w("wq"), w("wk"), w("wv")
    H, KV = wq.shape[1], wk.shape[1]  # this rank's heads
    q = (h @ wq.reshape(e, H * D)).view(B, T, H, D)
    k = (h @ wk.reshape(e, KV * D)).view(B, T, KV, D)
    v = (h @ wv.reshape(e, KV * D)).view(B, T, KV, D)
    q = _rope(q, positions, cfg.rope_theta, tables)
    k = _rope(k, positions, cfg.rope_theta, tables)
    if plan is None:
        attn = _attention(q, k, v, cfg)
    else:
        attn = plan.attention(q, *plan.local_kv(k, v, H, cfg), cfg)
    o = attn.reshape(B, T, H * D) @ w("wo").reshape(H * D, e)
    x = x + (o if plan is None else plan.tp_sum(o, "wo", "heads"))

    h = _rmsnorm(x, p["mlp_norm"], cfg.rms_eps, cfg.fused_rmsnorm)
    if cfg.moe_experts:
        y, aux = _moe_ffn(p, h, cfg, plan)
        return x + y, aux
    ff = F.silu(h @ w("w_gate")) * (h @ w("w_up"))
    y = ff @ w("w_down")
    x = x + (y if plan is None else plan.tp_sum(y, "w_down", "mlp"))
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def _moe_ffn(p, h, cfg: LlamaConfig, plan=None):
    """Routed expert FFN of one layer, with capacity. h: [B, T, e] ->
    ([B, T, e], aux). On a mesh: ``moe.moe_layer`` when ep > 1 (routing
    local to the token shard, the JAX package's ``moe_layer``; with sp > 1
    the shard is a chunk of the (dp, fsdp) group's flattened rows, as JAX
    shards them, laid out and back by ``moe.token_chunks``), else
    ``moe.moe_dense`` routed over the global batch (the JAX package's
    ``moe_dense`` under GSPMD); the expert weights whole along embed and
    mlp (gathered over fsdp and tp, as the JAX shard_map's in_specs have
    them)."""
    B, T, e = h.shape
    keys = {"router": "moe_router", "w_gate": "moe_w_gate", "w_up": "moe_w_up",
            "w_down": "moe_w_down"}
    if plan is None:
        bank = {k: p[n] for k, n in keys.items()}
    else:
        bank = {k: plan.full(n, p[n], axes=("fsdp", "tp")) for k, n in keys.items()}
    kw = dict(num_experts=cfg.moe_experts, top_k=cfg.moe_top_k,
              capacity_factor=cfg.moe_capacity_factor)
    tokens = h.reshape(B * T, e)
    if plan is not None and plan.sizes["ep"] > 1:
        chunked = plan.sizes["sp"] > 1
        if chunked:
            tokens = moe.token_chunks(tokens, plan.mesh, B)
        y, aux = moe.moe_layer(bank, tokens, plan.mesh, tokens_axis_names=("dp", "fsdp", "sp"),
                               **kw)
        if chunked:
            y = moe.token_chunks(y, plan.mesh, B, inverse=True)
    else:
        y, aux = moe.moe_dense(bank, tokens, mesh=None if plan is None else plan.mesh,
                               row_len=T, **kw)
    return y.view(B, T, e).to(h.dtype), aux


# The matmul ops that "dots" saves: what ``@``, ``einsum`` and F.linear
# reach at the dispatcher.
_DOTS = frozenset(
    op.default for op in (torch.ops.aten.mm, torch.ops.aten.bmm, torch.ops.aten.addmm,
                          torch.ops.aten.baddbmm)
)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat_context():
    """Selective checkpointing for "dots": matmul outputs are kept, every
    other op (norms, RoPE, softmax, SwiGLU, the attention kernels, which
    are no matmul ops at the dispatcher, and the buffers they fill) runs
    again in the backward pass."""
    return create_selective_checkpoint_contexts(_save_dots)


def _embed_lookup(table, tokens, cfg: LlamaConfig, plan=None):
    """Token embedding: the row gather (the JAX package's one-hot matmul on
    a sharded mesh is the same function). With a plan whose embed is split
    over tp by vocab, each rank gathers the rows it holds (zero for the
    rest) and the partial embeddings are all-reduced over tp."""
    if plan is None:
        return F.embedding(tokens.long(), table).to(cfg.dtype)
    table = plan.full("embed", table)
    if not plan.sharded("embed", "vocab"):
        return F.embedding(tokens.long(), table).to(cfg.dtype)
    n = table.shape[0]
    local = tokens.long() - plan.tp_rank * n
    inside = (local >= 0) & (local < n)
    x = F.embedding(local.clamp(0, n - 1), table) * inside[..., None].to(table.dtype)
    return pmesh.all_reduce(x, plan.tp).to(cfg.dtype)


def _layer_params(params, cfg: LlamaConfig) -> list[dict]:
    """Per-layer views of the stacked [L, ...] weights. ``unbind`` gives all
    L views at once, so the backward stacks each weight's L gradients into
    one [L, ...] tensor (indexing layer by layer would instead build a
    zero-filled [L, ...] gradient per layer and sum L of them)."""
    keys = _layer_keys(cfg)
    return [dict(zip(keys, vals)) for vals in zip(*(params[k].unbind(0) for k in keys))]


def _run_layers(params, x, positions, cfg: LlamaConfig, tables, plan=None):
    """The layer stack in ``params`` (all L, or one pipeline stage's):
    (x, summed aux)."""
    remat_kw = {"use_reentrant": False}
    if cfg.remat_policy == "dots":
        remat_kw["context_fn"] = _remat_context
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in _layer_params(params, cfg):
        if cfg.remat:
            x, a = checkpoint(_layer, lp, x, positions, cfg, tables, plan, **remat_kw)
        else:
            x, a = _layer(lp, x, positions, cfg, tables, plan)
        aux = aux + a
    return x, aux


def forward_hidden(params, tokens, cfg: LlamaConfig, positions=None, with_aux: bool = False,
                   mesh=None):
    """tokens: [B, T] int -> final hidden states [B, T, d_model].

    ``with_aux=True`` returns (hidden, aux), aux the summed MoE
    load-balancing loss (0 for dense configs). ``positions`` [B, T] gives
    absolute RoPE positions (default 0..T-1). ``cfg.remat`` runs each layer
    under ``torch.utils.checkpoint`` (non-reentrant): its activations are
    recomputed in the backward pass, the counterpart of the JAX package's
    per-layer ``jax.checkpoint``. ``remat_policy="dots"`` keeps the matmul
    outputs and recomputes the rest (``_remat_context``); any other policy
    recomputes everything, as in the JAX package.

    With a ``mesh`` (``parallel/mesh.py``) every rank of it calls this on
    its shards: ``params`` from ``init_params(mesh=)`` or
    ``parallel.mesh.shard_params``, ``tokens`` its [B / (dp fsdp), T / sp]
    shard; positions default to the shard's global ones. With pp > 1 the
    layers run as a GPipe pipeline of ``cfg.pp_microbatches`` (default
    2 pp) microbatches of the rank's rows (the JAX package's
    ``_pipeline_hidden``), the aux is the mean over them, and the hidden
    states come back on every pp rank."""
    plan = None if mesh is None else _Plan(cfg, mesh)
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens, device=dev)
    if positions is None:
        T = tokens.shape[1]
        first = 0 if plan is None else plan.sp_rank * T
        positions = torch.arange(first, first + T, device=dev).expand(tokens.shape)
    elif plan is not None and plan.sizes["pp"] > 1:
        # the pipeline's microbatches take the default positions
        raise NotImplementedError("pp > 1 with custom positions is not supported")
    else:
        positions = torch.as_tensor(positions, device=dev)
    x = _embed_lookup(params["embed"], tokens, cfg, plan)
    stack = {k: params[k] for k in _layer_keys(cfg)}
    if plan is not None and plan.sizes["pp"] > 1:
        x, aux = _pipeline_hidden(stack, x, positions, cfg, plan)
    else:
        tables = _rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        x, aux = _run_layers(stack, x, positions, cfg, tables, plan)
    x = _rmsnorm(x, params["final_norm"], cfg.rms_eps, cfg.fused_rmsnorm)
    return (x, aux) if with_aux else x


def _pipeline_hidden(stack, x, positions, cfg: LlamaConfig, plan):
    """This rank's pipeline stage (its L / pp layers) over M microbatches
    of its rows: (hidden [B, T, e] on every pp rank, aux / M), the JAX
    package's ``_pipeline_hidden`` (:519-562)."""
    pp = plan.sizes["pp"]
    if cfg.n_layers % pp:
        raise ValueError(f"n_layers {cfg.n_layers} not divisible by pp={pp}")
    B, T, e = x.shape
    M = cfg.pp_microbatches or 2 * pp
    if B % M:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    pos = positions[: B // M]
    tables = _rope_tables(pos, cfg.head_dim, cfg.rope_theta)

    def stage_fn(stage_params, y):
        return _run_layers(stage_params, y, pos, cfg, tables, plan)

    out, aux = pipeline_apply(stack, x.reshape(M, B // M, T, e), stage_fn, plan.mesh,
                              with_aux=True)
    # per-microbatch aux values are token means: their mean over the M
    # microbatches is the full batch's scale (as in the JAX package)
    return out.reshape(B, T, e), aux / M


def _unembed(params, cfg: LlamaConfig):
    return params["embed"].t() if cfg.tie_embeddings else params["unembed"]


def _project_logits(x, params, cfg: LlamaConfig):
    """Vocab projection shared by forward() and the training loss: operands
    in x's dtype, fp32 accumulation and fp32 logits (the JAX package's
    preferred_element_type=float32)."""
    return matmul_fp32_out(x, _unembed(params, cfg).to(x.dtype))


def forward(params, tokens, cfg: LlamaConfig, positions=None, mesh=None):
    """tokens: [B, T] int -> logits [B, T, vocab] (fp32). With a ``mesh``,
    this rank's tokens' logits over the whole vocabulary (the vocab-parallel
    projection all-gathered over tp)."""
    x = forward_hidden(params, tokens, cfg, positions, mesh=mesh)
    if mesh is None:
        return _project_logits(x, params, cfg)
    plan = _Plan(cfg, mesh)
    name = "embed" if cfg.tie_embeddings else "unembed"
    w = plan.full(name, params[name])
    logits = matmul_fp32_out(x, (w.t() if cfg.tie_embeddings else w).to(x.dtype))
    return pmesh.all_gather(logits, plan.tp, -1) if plan.sharded(name, "vocab") else logits


def loss_fn(params, batch, cfg: LlamaConfig, mesh=None):
    """Next-token cross-entropy. batch: {'tokens': [B, T+1]} (labels are
    the tokens shifted by one, a 'mask' [B, T+1] likewise) or {'tokens',
    'labels', 'mask'}. The mean is over the mask sum, clamped at 1.

    With a ``mesh`` every rank calls it on its batch shard ({'tokens',
    'labels'[, 'mask']} of [B / (dp fsdp), T / sp]; {'tokens': [.., T+1]}
    when sp = 1) and gets its SHARE of the global loss: the shares of all
    ranks sum to the loss (the denominator is the global mask sum; ranks
    that hold the same tokens, over ep, pp and tp, split their term
    equally; the aux term is split over every rank), so back-propagating
    each share and summing each gradient over the ranks that hold a copy
    of its leaf gives the loss's gradient (``training.make_train_step``)."""
    dev = params["embed"].device
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    tokens = batch["tokens"]
    if "labels" in batch:
        labels, mask = batch["labels"], batch.get("mask")
    else:
        if mesh is not None and pmesh.mesh_sizes(mesh)["sp"] > 1:
            raise ValueError("a sequence-sharded batch needs 'labels' (shift before sharding)")
        labels = tokens[:, 1:]
        tokens = tokens[:, :-1]
        mask = batch.get("mask")
        if mask is not None:
            mask = mask[:, 1:]
    x, aux = forward_hidden(params, tokens, cfg, with_aux=True, mesh=mesh)
    if mesh is not None:
        return _loss_share(x, aux, params, cfg, labels, mask, mesh)
    if cfg.fused_ce:
        base = fused_cross_entropy(x, _unembed(params, cfg), labels, mask=mask)
    else:
        logits = _project_logits(x, params, cfg)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, labels[..., None].long())[..., 0]
        if mask is not None:
            mask = mask.to(nll.dtype)
            base = (nll * mask).sum() / mask.sum().clamp(min=1)
        else:
            base = nll.mean()
    if cfg.moe_experts:
        return base + cfg.moe_aux_weight * aux
    return base


def _loss_share(x, aux, params, cfg: LlamaConfig, labels, mask, mesh):
    plan = _Plan(cfg, mesh)
    sizes = plan.sizes
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32, device=x.device)
    tokens_group = pmesh.axis_group(mesh, ("dp", "fsdp", "sp"))
    count = pmesh.all_reduce(mask.float().sum().detach(), tokens_group)
    replicas = sizes["ep"] * sizes["pp"] * sizes["tp"]
    # the vocab split over tp where the unembedding is; cfg.fused_ce picks
    # the chunked, checkpointed loss or one step with the logits kept
    name = "embed" if cfg.tie_embeddings else "unembed"
    w = plan.full(name, params[name])
    w = w.t() if cfg.tie_embeddings else w
    split = plan.sharded(name, "vocab")
    nll = fused_nll_sum(x, w, labels, mask, chunk_size=1024 if cfg.fused_ce else None,
                        group=plan.tp if split else None,
                        first=plan.tp_rank * w.shape[1] if split else 0)
    share = nll / (count.clamp(min=1) * replicas)
    if cfg.moe_experts:
        world = replicas * sizes["dp"] * sizes["fsdp"] * sizes["sp"]
        share = share + cfg.moe_aux_weight * aux / world
    return share


# ---------------------------------------------------------------------------
# Decode path (serving): KV cache prefill + single-token step.
# ---------------------------------------------------------------------------

def _moe_decode_ffn(p, h, cfg: LlamaConfig):
    """Dropless routed expert FFN for serving. h: [B, T, e].

    Serving never drops a token: every expert runs on the batch and the
    outputs mix with the renormalised top-k gates (``moe.topk_gates``, the
    training path's gate math), as the JAX package's ``_moe_decode_ffn``
    does. Equal to ``moe_dense`` wherever its capacity does not overflow.
    Up to 64 tokens (decode steps): one batched product over all experts,
    every expert's weights read once, static shapes (the step is one CUDA
    graph). More (prefill chunks): expert by expert, so the transient is
    [G, d_ff], not [E, G, d_ff]."""
    B, T, e = h.shape
    E = cfg.moe_experts
    g = h.reshape(B * T, e)
    _, gate_vals, gate_idx = moe.topk_gates({"router": p["moe_router"]}, g, cfg.moe_top_k)
    # wge[g, e] = sum_k gate_vals[g, k] * [gate_idx[g, k] == e]
    wge = (F.one_hot(gate_idx, E).float() * gate_vals[..., None]).sum(1).to(g.dtype)
    if g.shape[0] <= 64:
        # [G, e] @ [E, e, f] -> [E, G, f]: batched over the experts' own
        # weights (an einsum here would copy the bank to one [e, E*f] matrix)
        ff = F.silu(torch.matmul(g, p["moe_w_gate"])) * torch.matmul(g, p["moe_w_up"])
        out = torch.bmm(ff, p["moe_w_down"])  # [E, G, e]
        y = torch.einsum("egd,ge->gd", out, wge)
    else:
        y = torch.zeros_like(g)
        for ei in range(E):
            ff = F.silu(g @ p["moe_w_gate"][ei]) * (g @ p["moe_w_up"][ei])
            y = y + (ff @ p["moe_w_down"][ei]) * wge[:, ei, None]
    return y.view(B, T, e)


def init_kv_cache(
    cfg: LlamaConfig,
    batch_size: int,
    max_len: Optional[int] = None,
    device: Union[str, torch.device, None] = None,
    mesh=None,
) -> dict[str, torch.Tensor]:
    """KV cache [L, B, KV_HEADS, S, D], head-major: each (batch, head)
    attention read is one contiguous S x D block. ``device`` is CUDA unless
    the caller names another (``resolve_device``). On a serving ``mesh``
    this rank's part: the kv heads split over tp as wk/wv's are (when tp
    divides them), else all of them (``ray_tpu/llm/spmd.py:128-137``)."""
    device = resolve_device(device)
    max_len = max_len or cfg.max_seq_len
    kv = cfg.n_kv_heads
    if mesh is not None:
        (entry,) = pmesh.logical_pspec(mesh, "kv_heads", shape=(kv,))
        kv //= math.prod(pmesh.mesh_sizes(mesh)[a] for a in pmesh.spec_axes(entry))
    shape = (cfg.n_layers, batch_size, kv, max_len, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "length": torch.zeros((batch_size,), dtype=torch.int32, device=device),
    }


def init_lora_stack(
    cfg: LlamaConfig, n_adapters: int, rank: int, device: Union[str, torch.device, None] = None,
) -> dict[str, torch.Tensor]:
    """Zeroed stacked LoRA adapters on q and v for the decode path:
    ``[L, n_adapters + 1, ...]``, slot 0 all zero (the base model). Each
    sequence gathers its own slot, so one decode step serves any mix of
    adapters. ``device`` is CUDA unless the caller names another."""
    device = resolve_device(device)
    L, e, h, kv, hd = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n = n_adapters + 1
    shapes = {"wq_a": (L, n, e, rank), "wq_b": (L, n, rank, h, hd),
              "wv_a": (L, n, e, rank), "wv_b": (L, n, rank, kv, hd)}
    return {k: torch.zeros(s, dtype=cfg.dtype, device=device) for k, s in shapes.items()}


def _lora_delta(h, a, b, ids):
    """(h . A[id]) . B[id] per row: h [B, T, e], a [n, e, r], b [n, r, H, D],
    ids [B] -> [B, T, H, D]. No alpha/rank scaling, as in the JAX package."""
    return torch.einsum("btr,brhd->bthd", torch.einsum("bte,ber->btr", h, a[ids]), b[ids])


def _write_plan(positions: torch.Tensor, valid: Optional[torch.Tensor], S: int):
    """Where each new token's K/V goes, with dropped writes made harmless.

    JAX drops a write whose index is out of range (padding is sent to index
    S, ``mode="drop"``); ``index_put_`` would raise instead, and writing only
    the kept tokens needs their count on the host (a sync). So every token
    writes somewhere in range: a dropped token rewrites the slot of its
    row's last kept token with that token's own value, and a row with no
    kept token rewrites its last slot with the value already there.
    Duplicate writes then carry equal values, so their order cannot matter.

    Returns (write_pos [B, T], src_t [B, T], has_kept [B])."""
    B, T = positions.shape
    keep = positions < S
    if valid is not None:
        keep = keep & valid
    t_idx = torch.arange(T, device=positions.device).expand(B, T)
    last = torch.where(keep, t_idx, -1).amax(dim=1)  # [B]
    has_kept = last >= 0
    fb_t = last.clamp(min=0)
    fb_pos = torch.where(
        has_kept, positions.gather(1, fb_t[:, None])[:, 0], S - 1
    )
    write_pos = torch.where(keep, positions, fb_pos[:, None].to(positions.dtype))
    src_t = torch.where(keep, t_idx, fb_t[:, None])
    return write_pos.long(), src_t, has_kept


def _cache_write(cache_l, new, plan, bi, ki):
    """cache_l [B, KV, S, D] <- new [B, T, KV, D] in place, per ``plan``."""
    write_pos, src_t, has_kept = plan
    B = new.shape[0]
    vals = new[torch.arange(B, device=new.device)[:, None], src_t]  # [B, T, KV, D]
    vals = vals.transpose(1, 2)  # [B, KV, T, D]
    S = cache_l.shape[2]
    old = cache_l[:, :, S - 1 : S, :]  # [B, KV, 1, D]
    vals = torch.where(has_kept[:, None, None, None], vals, old)
    cache_l.index_put_((bi, ki, write_pos[:, None, :]), vals)


_MOE_KEYS = ("moe_router", "moe_w_gate", "moe_w_up", "moe_w_down")


def _serving_plan(cfg: LlamaConfig, mesh) -> Optional[_Plan]:
    """The decode path's plan on a serving mesh: tp splits the weights and
    the cache; sp and dp hold copies (no serving param or cache dim maps to
    them, and the JAX ``_decode_forward`` constrains no activation: each sp
    or dp rank computes what its tp group computes)."""
    if mesh is None:
        return None
    sizes = pmesh.mesh_sizes(mesh)
    if any(sizes[a] > 1 for a in ("fsdp", "ep", "pp")):
        raise ValueError(f"a serving mesh has tp, sp and dp axes only, got {sizes}")
    return _Plan(cfg, mesh)


def _decode_forward(
    params, cache, tokens, positions, cfg: LlamaConfig, valid=None,
    loras=None, adapter_ids=None, with_logits: bool = True, logits_at=None, mesh=None,
):
    """Shared prefill/decode body. tokens, positions, valid: [B, T].

    New K/V are written into the cache before attention, so new tokens see
    themselves and every earlier slot (causal over absolute positions).
    Padding (``valid`` false) and positions past the stripe are never
    written. The cache is updated IN PLACE and returned (the JAX package
    gets the same effect from ``fori_loop`` with donated buffers); its
    ``length`` grows by T. ``logits_at`` [B] projects the LM head at only
    that position per sequence ([B, 1, V]); ``with_logits=False`` skips the
    head (mid-chunk prefill). ``loras`` (``init_lora_stack``) and
    ``adapter_ids`` [B] (0 = the base model) add each row's adapter delta to
    q and v before RoPE.

    With a serving ``mesh`` (tp, sp, dp) every rank calls it on its shards
    (``_Plan``, the train step's plan): params from ``init_params(mesh=)``,
    the cache from ``init_kv_cache(mesh=)``, the LoRA stacks whole (their B
    matrices are cut to the rank's heads here). wq/wk/wv give the rank's
    heads, wo its rows and a tp all-reduce follows; w_gate/w_up (and the
    MoE experts' gate/up) its mlp columns, w_down its rows, an all-reduce;
    the embedding is vocab-parallel, and the logits are all-gathered over
    tp, so every rank returns the same [B, V] fp32 logits (the JAX
    program's replicated out-sharding)."""
    plan = _serving_plan(cfg, mesh)
    B, T = tokens.shape
    S = cache["k"].shape[3]
    dev = cache["k"].device
    if loras is not None:
        adapter_ids = torch.as_tensor(adapter_ids, device=dev).long()
    H, KV, D = params["wq"].shape[2], cache["k"].shape[2], cfg.head_dim  # this rank's heads
    e = cfg.d_model
    eps, fused = cfg.rms_eps, cfg.fused_rmsnorm
    scale = D**-0.5

    def tp_sum(y, name, logical):
        return y if plan is None else plan.tp_sum(y, name, logical)

    x = _embed_lookup(params["embed"], tokens, cfg, plan)
    slot = torch.arange(S, device=dev)
    seq_mask = slot[None, None, :] <= positions[:, :, None]  # [B, T, S]
    wplan = _write_plan(positions, valid, S)
    bi = torch.arange(B, device=dev)[:, None, None]
    ki = torch.arange(KV, device=dev)[None, :, None]
    tables = _rope_tables(positions, D, cfg.rope_theta)

    # Each norm after the first follows a residual add. With the fused norm
    # the two are one add_rmsnorm (s = x + delta, h = rmsnorm(s)): the
    # layer's MLP norm after its attention residual, the next layer's
    # attention norm after this layer's MLP residual, and the final norm
    # unless logits_at gathers between the add and the norm.
    def add_norm(x, delta, w):
        if fused:
            return add_rmsnorm(x, delta, w, eps)
        x = x + delta
        return x, _rmsnorm(x, w, eps, fused)

    h = _rmsnorm(x, params["attn_norm"][0], eps, fused)
    for l in range(cfg.n_layers):
        q = (h @ params["wq"][l].reshape(e, -1)).view(B, T, H, D)
        k = (h @ params["wk"][l].reshape(e, -1)).view(B, T, KV, D)
        v = (h @ params["wv"][l].reshape(e, -1)).view(B, T, KV, D)
        if loras is not None:
            qb, vb = loras["wq_b"][l], loras["wv_b"][l]
            if plan is not None:
                qb, vb = plan.cut(qb, "wq", "heads", 2), plan.cut(vb, "wv", "kv_heads", 2)
            q = q + _lora_delta(h, loras["wq_a"][l], qb, adapter_ids)
            v = v + _lora_delta(h, loras["wv_a"][l], vb, adapter_ids)
        q = _rope(q, positions, cfg.rope_theta, tables)
        k = _rope(k, positions, cfg.rope_theta, tables)
        ck, cv = cache["k"][l], cache["v"][l]  # views: writes land in the cache
        _cache_write(ck, k, wplan, bi, ki)
        _cache_write(cv, v, wplan, bi, ki)
        if plan is not None:  # the kv heads this rank's q heads read
            ck, cv = plan.local_kv(ck, cv, H, cfg, dim=1)

        # GQA without repeating K/V: the group axis folds into the query
        n_kv = ck.shape[1]
        qg = q.view(B, T, n_kv, H // n_kv, D)
        s = torch.einsum("btkgd,bksd->bktgs", qg, ck) * scale
        s = s.masked_fill(~seq_mask[:, None, :, None, :], -1e30)
        w = torch.softmax(s.float(), dim=-1).to(x.dtype)
        attn = torch.einsum("bktgs,bksd->btkgd", w, cv).reshape(B, T, H * D)
        o = tp_sum(attn @ params["wo"][l].reshape(-1, e), "wo", "heads")
        x, h = add_norm(x, o, params["mlp_norm"][l])

        if cfg.moe_experts:
            delta = _moe_decode_ffn({k: params[k][l] for k in _MOE_KEYS}, h, cfg)
            delta = tp_sum(delta, "moe_w_down", "mlp")
        else:
            ff = F.silu(h @ params["w_gate"][l]) * (h @ params["w_up"][l])
            delta = tp_sum(ff @ params["w_down"][l], "w_down", "mlp")
        if l + 1 < cfg.n_layers:
            x, h = add_norm(x, delta, params["attn_norm"][l + 1])

    cache["length"] += T
    if not with_logits:
        return None, cache
    if logits_at is not None:
        # gather the one requested hidden state per sequence BEFORE the norm
        # and the vocab projection: [B, T, e] -> [B, 1, e]
        x = (x + delta)[torch.arange(B, device=dev), logits_at.long()][:, None]
        x = _rmsnorm(x, params["final_norm"], eps, fused)
    else:
        _, x = add_norm(x, delta, params["final_norm"])
    name = "embed" if cfg.tie_embeddings else "unembed"
    unembed = params["embed"].t() if cfg.tie_embeddings else params["unembed"]
    # The JAX package asks XLA for fp32 logits from bf16 operands
    # (preferred_element_type). A bf16 matmul here accumulates in fp32 too,
    # but rounds its output to bf16 before the upcast: ~2^-9 relative on
    # each logit, which can only reorder near-ties. Upcasting the operands
    # instead would copy the [e, V] unembed (0.8 GB at 128k vocab) to fp32
    # on every step. In fp32 configs the two are the same.
    logits = (x @ unembed.to(x.dtype)).float()
    if plan is not None and plan.sharded(name, "vocab"):
        logits = pmesh.all_gather(logits, plan.tp, -1)
    return logits, cache


def prefill(
    params, cache, tokens, cfg: LlamaConfig, lengths=None,
    loras=None, adapter_ids=None, start_pos=None, with_logits: bool = True, mesh=None,
):
    """Process a prompt batch. tokens: [B, T] (right-padded); lengths: [B].
    Returns (last-token logits [B, vocab] or None, cache), the cache updated
    in place.

    ``start_pos`` [B]: absolute position of tokens[:, 0] — the SUFFIX
    prefill of prefix caching and chunked admission (the cache already
    holds positions 0..start_pos-1). ``with_logits=False`` skips the LM head
    for mid-chunk prefills. Afterwards ``cache["length"] = start_pos +
    lengths``. ``mesh``: this rank's shards on a serving mesh
    (``_decode_forward``)."""
    dev = cache["k"].device
    tokens = torch.as_tensor(tokens, device=dev)
    B, T = tokens.shape
    lengths = (
        torch.full((B,), T, dtype=torch.int32, device=dev)
        if lengths is None else torch.as_tensor(lengths, device=dev)
    )
    start_pos = (
        torch.zeros((B,), dtype=torch.int32, device=dev)
        if start_pos is None else torch.as_tensor(start_pos, device=dev)
    )
    rel = torch.arange(T, dtype=torch.int32, device=dev)[None, :].expand(B, T)
    positions = rel + start_pos[:, None]
    valid = rel < lengths[:, None]
    logits, cache = _decode_forward(
        params, cache, tokens, positions, cfg, valid,
        loras=loras, adapter_ids=adapter_ids, with_logits=with_logits,
        logits_at=(lengths - 1) if with_logits else None, mesh=mesh,
    )
    cache["length"].copy_(start_pos + lengths)
    if not with_logits:
        return None, cache
    return logits[:, 0], cache


def decode_step(params, cache, tokens, cfg: LlamaConfig, loras=None, adapter_ids=None,
                mesh=None):
    """One decode step. tokens: [B] or [B, 1] -> (logits [B, vocab], cache),
    the cache updated in place. ``mesh``: this rank's shards on a serving
    mesh (``_decode_forward``)."""
    tokens = torch.as_tensor(tokens, device=cache["k"].device)
    if tokens.dim() == 1:
        tokens = tokens[:, None]
    positions = cache["length"][:, None].clone()
    logits, cache = _decode_forward(
        params, cache, tokens, positions, cfg, loras=loras, adapter_ids=adapter_ids, mesh=mesh,
    )
    return logits[:, -1], cache
