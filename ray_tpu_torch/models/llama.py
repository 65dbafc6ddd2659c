"""Llama-family decoder in PyTorch: the serving half.

Counterpart of ``ray_tpu/models/llama.py``. Params are a plain dict keyed
as the JAX package keys them (``_param_shapes``), with the per-layer
weights stacked ``[L, ...]``; caches are head-major ``[L, B, KV, S, D]``.
Public functions keep the JAX package's layouts, so one set of numpy arrays
feeds both packages in the tests.

This slice ports the config, parameter init and the decode path
(``init_kv_cache``, ``prefill``, ``decode_step``). The training forward,
the loss, LoRA deltas and the MoE decode FFN come in later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
import torch.nn.functional as F

from ray_tpu_torch import resolve_device


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
    moe_experts: int = 0  # >0: MoE FFN (decode raises until its slice)
    # The fields below are the JAX config's, read by later slices (the
    # training forward, MoE, pipelining); they are here so the JAX
    # package's presets and ModelConfig.model_kwargs resolve unchanged.
    attention: str = "full"
    fused_ce: bool = True
    remat: bool = True
    remat_policy: str = "full"
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
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


def init_params(
    cfg: LlamaConfig, seed: int = 0, device: Union[str, torch.device, None] = None
) -> dict[str, torch.Tensor]:
    """Norms are ones; every other weight is N(0, 1) * fan_in^-1/2 in
    ``cfg.dtype``, as in the JAX package (the random bits differ), drawn
    from a ``torch.Generator`` on ``device`` seeded with ``seed``. Each
    tensor is drawn on ``device`` directly in ``cfg.dtype``: a 3B model
    takes no fp32 detour through host memory. ``device`` is CUDA unless
    the caller names another (``resolve_device``)."""
    device = resolve_device(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    params = {}
    for name, shape in sorted(_param_shapes(cfg).items()):
        if "norm" in name:
            params[name] = torch.ones(shape, dtype=cfg.dtype, device=device)
        else:
            fan_in = shape[-2] if len(shape) > 1 else shape[0]
            t = torch.empty(shape, dtype=cfg.dtype, device=device)
            params[name] = t.normal_(0.0, fan_in**-0.5, generator=generator)
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
# Decode path (serving): KV cache prefill + single-token step.
# ---------------------------------------------------------------------------

_LATER = "not ported yet: LoRA and MoE decode come with the port's LoRA/MoE slice"


def init_kv_cache(
    cfg: LlamaConfig,
    batch_size: int,
    max_len: Optional[int] = None,
    device: Union[str, torch.device, None] = None,
) -> dict[str, torch.Tensor]:
    """KV cache [L, B, KV_HEADS, S, D], head-major: each (batch, head)
    attention read is one contiguous S x D block. ``device`` is CUDA unless
    the caller names another (``resolve_device``)."""
    device = resolve_device(device)
    max_len = max_len or cfg.max_seq_len
    shape = (cfg.n_layers, batch_size, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "length": torch.zeros((batch_size,), dtype=torch.int32, device=device),
    }


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


def _decode_forward(
    params, cache, tokens, positions, cfg: LlamaConfig, valid=None,
    loras=None, adapter_ids=None, with_logits: bool = True, logits_at=None,
):
    """Shared prefill/decode body. tokens, positions, valid: [B, T].

    New K/V are written into the cache before attention, so new tokens see
    themselves and every earlier slot (causal over absolute positions).
    Padding (``valid`` false) and positions past the stripe are never
    written. The cache is updated IN PLACE and returned (the JAX package
    gets the same effect from ``fori_loop`` with donated buffers); its
    ``length`` grows by T. ``logits_at`` [B] projects the LM head at only
    that position per sequence ([B, 1, V]); ``with_logits=False`` skips the
    head (mid-chunk prefill)."""
    if loras is not None:
        raise NotImplementedError(f"LoRA decode is {_LATER}")
    if cfg.moe_experts:
        raise NotImplementedError(f"MoE decode is {_LATER}")
    B, T = tokens.shape
    S = cache["k"].shape[3]
    dev = cache["k"].device
    KV, G, D = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    e = cfg.d_model
    eps, fused = cfg.rms_eps, cfg.fused_rmsnorm
    scale = D**-0.5

    x = F.embedding(tokens.long(), params["embed"]).to(cfg.dtype)
    slot = torch.arange(S, device=dev)
    seq_mask = slot[None, None, :] <= positions[:, :, None]  # [B, T, S]
    plan = _write_plan(positions, valid, S)
    bi = torch.arange(B, device=dev)[:, None, None]
    ki = torch.arange(KV, device=dev)[None, :, None]
    tables = _rope_tables(positions, D, cfg.rope_theta)

    for l in range(cfg.n_layers):
        h = _rmsnorm(x, params["attn_norm"][l], eps, fused)
        q = (h @ params["wq"][l].reshape(e, -1)).view(B, T, cfg.n_heads, D)
        k = (h @ params["wk"][l].reshape(e, -1)).view(B, T, KV, D)
        v = (h @ params["wv"][l].reshape(e, -1)).view(B, T, KV, D)
        q = _rope(q, positions, cfg.rope_theta, tables)
        k = _rope(k, positions, cfg.rope_theta, tables)
        ck, cv = cache["k"][l], cache["v"][l]  # views: writes land in the cache
        _cache_write(ck, k, plan, bi, ki)
        _cache_write(cv, v, plan, bi, ki)

        # GQA without repeating K/V: the group axis folds into the query
        qg = q.view(B, T, KV, G, D)
        s = torch.einsum("btkgd,bksd->bktgs", qg, ck) * scale
        s = s.masked_fill(~seq_mask[:, None, :, None, :], -1e30)
        w = torch.softmax(s.float(), dim=-1).to(x.dtype)
        attn = torch.einsum("bktgs,bksd->btkgd", w, cv).reshape(B, T, cfg.n_heads * D)
        x = x + attn @ params["wo"][l].reshape(-1, e)

        h = _rmsnorm(x, params["mlp_norm"][l], eps, fused)
        ff = F.silu(h @ params["w_gate"][l]) * (h @ params["w_up"][l])
        x = x + ff @ params["w_down"][l]

    cache["length"] += T
    if not with_logits:
        return None, cache
    if logits_at is not None:
        # gather the one requested hidden state per sequence BEFORE the norm
        # and the vocab projection: [B, T, e] -> [B, 1, e]
        x = x[torch.arange(B, device=dev), logits_at.long()][:, None]
    x = _rmsnorm(x, params["final_norm"], eps, fused)
    unembed = params["embed"].t() if cfg.tie_embeddings else params["unembed"]
    # The JAX package asks XLA for fp32 logits from bf16 operands
    # (preferred_element_type). A bf16 matmul here accumulates in fp32 too,
    # but rounds its output to bf16 before the upcast: ~2^-9 relative on
    # each logit, which can only reorder near-ties. Upcasting the operands
    # instead would copy the [e, V] unembed (0.8 GB at 128k vocab) to fp32
    # on every step. In fp32 configs the two are the same.
    logits = (x @ unembed.to(x.dtype)).float()
    return logits, cache


def prefill(
    params, cache, tokens, cfg: LlamaConfig, lengths=None,
    loras=None, adapter_ids=None, start_pos=None, with_logits: bool = True,
):
    """Process a prompt batch. tokens: [B, T] (right-padded); lengths: [B].
    Returns (last-token logits [B, vocab] or None, cache), the cache updated
    in place.

    ``start_pos`` [B]: absolute position of tokens[:, 0] — the SUFFIX
    prefill of prefix caching and chunked admission (the cache already
    holds positions 0..start_pos-1). ``with_logits=False`` skips the LM head
    for mid-chunk prefills. Afterwards ``cache["length"] = start_pos +
    lengths``."""
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
        logits_at=(lengths - 1) if with_logits else None,
    )
    cache["length"].copy_(start_pos + lengths)
    if not with_logits:
        return None, cache
    return logits[:, 0], cache


def decode_step(params, cache, tokens, cfg: LlamaConfig, loras=None, adapter_ids=None):
    """One decode step. tokens: [B] or [B, 1] -> (logits [B, vocab], cache),
    the cache updated in place."""
    tokens = torch.as_tensor(tokens, device=cache["k"].device)
    if tokens.dim() == 1:
        tokens = tokens[:, None]
    positions = cache["length"][:, None].clone()
    logits, cache = _decode_forward(
        params, cache, tokens, positions, cfg, loras=loras, adapter_ids=adapter_ids,
    )
    return logits[:, -1], cache
