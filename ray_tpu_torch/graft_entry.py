"""The port's twins of ``__graft_entry__.py``: ``entry()``, the forward of
the flagship model's small check configuration, and ``dryrun_multichip``,
one full train step on every mesh of the JAX file's sweep.

    fn, (params, tokens) = entry()          # on the card
    logits = fn(params, tokens)             # [2, 128, 4096] fp32
    dryrun_multichip(torch.cuda.device_count())   # one NCCL rank a card
    dryrun_multichip(8, device="cpu")             # 8 gloo ranks

``entry``: a 4-layer Llama (d_model 512, 8 heads / 4 kv heads, d_ff 1408,
vocab 4096, bf16, no remat) on 2 x 128 tokens drawn by numpy from seed 0,
as the JAX entry draws them. The weights are the port's own, seeded; to
hold the two entries against each other, give ``fn`` the JAX entry's
weights through ``models.convert.params_from_jax``.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Optional, Union

import numpy as np
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models.llama import LlamaConfig, forward, gather_params, init_params
from ray_tpu_torch.parallel.mesh import AXIS_ORDER, MeshSpec


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


# ---------------------------------------------------------------------------
# The multi-chip dry run
# ---------------------------------------------------------------------------

# (label, axis sizes at 8 devices, model kwargs): __graft_entry__._mesh_sweep
_SWEEP = (
    ("pure-dp", {"dp": 8}, {}),
    ("pure-fsdp", {"fsdp": 8}, {}),
    ("dp2-sp2-tp2", {"dp": 2, "sp": 2, "tp": 2}, {"attention": "ring"}),
    ("pp2-dp2-tp2", {"dp": 2, "pp": 2, "tp": 2}, {"n_layers": 4}),
    ("ep2-moe", {"dp": 4, "ep": 2}, {"moe_experts": 4, "moe_top_k": 2}),
    ("pp2-ep2-moe", {"dp": 2, "pp": 2, "ep": 2},
     {"n_layers": 4, "moe_experts": 4, "moe_top_k": 2}),
    ("pp2-sp2", {"dp": 2, "pp": 2, "sp": 2}, {"n_layers": 4, "attention": "ring"}),
)


def mesh_sweep(n: int) -> list[tuple[str, MeshSpec, dict]]:
    """The JAX dry run's meshes (``__graft_entry__._mesh_sweep`` :36) for
    ``n`` ranks: [(label, MeshSpec, model kwargs)].

    At n = 8k the sweep is JAX's, config for config (the dp factor times
    k). Under 8 ranks (n = 4, 2 or 1), where no 8-device mesh can form,
    each mesh is halved until it fits, the dp factor first, then fsdp, sp,
    tp, ep and pp: at n = 4 dp2-sp2-tp2 becomes sp2-tp2, ep2-moe dp2-ep2,
    pp2-ep2-moe pp2-ep2; at n = 1 every axis is 1. The labels and model
    kwargs stay the JAX sweep's. This is the only place where the twin
    differs from the reference."""
    return [(label, fit_mesh(label, sizes, n), dict(kw)) for label, sizes, kw in _SWEEP]


def fit_mesh(label: str, sizes: dict, n: int) -> MeshSpec:
    """An 8-device mesh's axis ``sizes`` fitted to ``n`` ranks as
    ``mesh_sweep`` fits the sweep's (pure-fsdp scales fsdp, the rest dp)."""
    if n % 8 and n not in (1, 2, 4):
        raise ValueError(f"the sweep takes 1, 2, 4 or a multiple of 8 ranks, not {n}")
    sizes = {a: sizes.get(a, 1) for a in AXIS_ORDER}
    if n % 8 == 0:
        lead = "fsdp" if label == "pure-fsdp" else "dp"
        sizes[lead] *= n // 8
    else:
        shrink = 8 // n
        for a in ("dp", "fsdp", "sp", "tp", "ep", "pp"):
            while shrink > 1 and sizes[a] > 1:
                sizes[a] //= 2
                shrink //= 2
    return MeshSpec(**sizes)


def sweep_config(model_kw: dict, widths: str = "tiny") -> LlamaConfig:
    """The dry run's model: the JAX sweep's (``LlamaConfig.tiny(n_heads=4,
    n_kv_heads=2, max_seq_len=64)`` plus the mesh's kwargs), or at
    ``widths="bench"`` the bench train configuration (``bench.py:31-47``,
    16 layers; the pp and MoE meshes take 4 layers, the MoE meshes the
    sweep's 4 experts)."""
    if widths == "bench":
        from ray_tpu_torch.tools.train_bench import bench_config

        if model_kw.get("moe_experts"):
            model_kw = {"n_layers": 4, **model_kw}
        return bench_config(**model_kw)
    return LlamaConfig.tiny(n_heads=4, n_kv_heads=2, max_seq_len=64, **model_kw)


def sweep_batch(spec: MeshSpec, cfg: LlamaConfig, widths: str = "tiny", seed: int = 0) -> dict:
    """The dry run's global batch {'tokens': [B, T + 1]} int32, drawn by
    numpy from ``seed`` as the JAX dry run draws it. The JAX rule (tiny):
    B = 2 max(dp fsdp, 2 pp), divisible by the batch shards and by the
    pp microbatches, and T = 32 sp. At the bench widths each data shard
    gets the bench's 4 x 2048: B = 4 dp fsdp, T = 2048 sp."""
    if widths == "bench":
        B, T = 4 * spec.dp * spec.fsdp, 2048 * spec.sp
    else:
        B, T = max(spec.dp * spec.fsdp, 2 * spec.pp) * 2, 32 * max(1, spec.sp)
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, T + 1))
    return {"tokens": toks.astype(np.int32)}


def sweep_loop(config: dict) -> None:
    """A rank's body of the dry run: for each mesh of ``mesh_sweep(n)``
    (``config["meshes"]`` to choose labels), build the mesh, one full train
    step on the rank's shard of the global batch, and report {label, mesh,
    loss, grad_norm, step_ms, the flash launches in the rank}; with
    ``timed_steps`` that many more steps are timed (their median
    ``step_ms``). Config keys: ``n``, ``widths``, ``meshes``, ``params``
    ({label: numpy params}), ``init`` ("seed": ``init_params`` from seed 0,
    the default; "conditioned": ``conditioned_params`` from seed 0),
    ``optimizer`` (``default_optimizer`` kwargs), ``model_kwargs`` (set on
    every mesh's config after its own), ``gather`` (rank 0 reports
    the params after the step), ``timed_steps``, ``reference`` (rank 0 also
    runs the unsharded step on the global batch, whole model on its card),
    ``extra_meshes`` (more [(label, axis sizes, model kwargs)] after the
    sweep's, already fitted to ``n``),
    ``control_leaf`` (on the first mesh, one more step from the same
    initial state whose backward counts that leaf's gradient twice, as a
    gradient all-reduce issued twice would: its loss is the true one, its
    grad norm is not; reported under ``control``)."""
    import torch.distributed as dist

    import ray_tpu_torch.train as train
    from ray_tpu_torch.models.training import default_optimizer, make_train_step, shard_batch
    from ray_tpu_torch.ops.flash_attention import flash_attention, reset_launches
    from ray_tpu_torch.parallel.mesh import build_mesh

    device = train.get_device()
    rank = dist.get_rank()
    widths = config.get("widths", "tiny")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    first = True
    extra = [(label, MeshSpec(**sizes), kw) for label, sizes, kw in config.get("extra_meshes", ())]
    for label, spec, kw in mesh_sweep(config["n"]) + extra:
        if config.get("meshes") and label not in config["meshes"]:
            continue
        mesh = build_mesh(spec, device.type)
        cfg = dataclasses.replace(sweep_config(kw, widths), **config.get("model_kwargs", {}))
        opt = default_optimizer(**config.get("optimizer", {}))
        init_fn, step_fn = make_train_step(cfg, opt, device=device, mesh=mesh)
        given = (config.get("params") or {}).get(label)
        init = config.get("init", "seed")
        state = _initial_state(cfg, opt, device, mesh, given, init, init_fn)
        glob = sweep_batch(spec, cfg, widths)
        batch = {k: v.to(device) for k, v in shard_batch(glob, mesh, cfg).items()}
        reset_launches()
        sync()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        loss = m["loss"].item()
        first_ms = (time.perf_counter() - t0) * 1e3
        rec = {"label": label, "mesh": spec.sizes(), "loss": loss,
               # MoE routes per token shard under ep and per microbatch under
               # pp (the JAX package's function): not the unsharded one there
               "unsharded_function": not cfg.moe_experts or (spec.ep == 1 and spec.pp == 1),
               "grad_norm": m["grad_norm"].item(), "first_step_ms": first_ms,
               "tokens": int(glob["tokens"].shape[0] * (glob["tokens"].shape[1] - 1)),
               "launches": {"fwd": flash_attention.launches_fwd,
                            "bwd_dq": flash_attention.launches_bwd_dq,
                            "bwd_dkdv": flash_attention.launches_bwd_dkdv}}
        times = []
        for _ in range(config.get("timed_steps", 0)):
            sync()
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            m["loss"].item()
            times.append((time.perf_counter() - t0) * 1e3)
        if times:
            rec["step_ms"], rec["step_ms_all"] = statistics.median(times), times
        if config.get("gather"):
            full = gather_params(cfg, mesh, state.params)
            if rank == 0:
                rec["params"] = {k: v.float().cpu().numpy() for k, v in full.items()}
            del full
        del state, init_fn, step_fn
        if device.type == "cuda":
            torch.cuda.empty_cache()
        if config.get("control_leaf") and first:
            rec["control"] = _control_step(cfg, opt, device, mesh, given, init, batch,
                                           config["control_leaf"])
        first = False
        if config.get("reference"):
            if rank == 0:
                rec.update(_unsharded_step(cfg, opt, device, glob, given, init))
            dist.barrier()
        train.report(rec)


class _TwiceGrad(torch.autograd.Function):
    """The identity whose backward doubles the gradient."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return 2 * g


def _control_step(cfg: LlamaConfig, opt, device, mesh, given, init: str, batch: dict,
                  leaf: str) -> dict:
    """One step from the sweep's initial state with ``leaf``'s gradient
    counted twice in the backward: {leaf, loss, grad_norm}."""
    from ray_tpu_torch.models.llama import loss_fn
    from ray_tpu_torch.models.training import make_train_step

    def twice(params, batch, cfg, mesh=None):
        return loss_fn({**params, leaf: _TwiceGrad.apply(params[leaf])}, batch, cfg, mesh=mesh)

    init_fn, step_fn = make_train_step(cfg, opt, loss=twice, device=device, mesh=mesh)
    state = _initial_state(cfg, opt, device, mesh, given, init, init_fn)
    state, m = step_fn(state, batch)
    out = {"leaf": leaf, "loss": m["loss"].item(), "grad_norm": m["grad_norm"].item()}
    del state
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def conditioned_params(cfg: LlamaConfig, seed: int, device, mesh=None) -> dict:
    """Well-conditioned weights drawn on ``device`` from ``seed``: norms
    ones, every other weight N(0, 1) / sqrt(d_model) in ``cfg.dtype`` (the
    JAX init's fan_in of the head count makes wq/wk ill-conditioned, so its
    bf16 gradients read ~1e-2 from one summation order to another). With a
    ``mesh``, this rank's shard of the same numbers, each whole leaf drawn,
    cut and freed in turn."""
    from ray_tpu_torch.models.llama import _param_shapes, param_specs
    from ray_tpu_torch.parallel.mesh import local_slice

    gen = torch.Generator(device=device).manual_seed(seed)
    specs = None if mesh is None else param_specs(cfg, mesh)
    out = {}
    for name, shape in sorted(_param_shapes(cfg).items()):
        if "norm" in name:
            t = torch.ones(shape, dtype=cfg.dtype, device=device)
        else:
            t = torch.empty(shape, dtype=cfg.dtype, device=device)
            t.normal_(0.0, cfg.d_model**-0.5, generator=gen)
        out[name] = t if specs is None else t[local_slice(mesh, specs[name], shape)].clone()
    return out


def _initial_state(cfg: LlamaConfig, opt, device, mesh, given, init: str, init_fn):
    """The train state from ``given`` numpy params, ``conditioned_params``
    (seed 0) or ``init_fn(0)``, this rank's shard of it with a mesh."""
    from ray_tpu_torch.models.training import TrainState
    from ray_tpu_torch.parallel.mesh import shard_params

    if given is not None:
        params = {k: torch.from_numpy(v).to(device) for k, v in given.items()}
        params = params if mesh is None else shard_params(mesh, params)
    elif init == "conditioned":
        params = conditioned_params(cfg, 0, device, mesh)
    else:
        return init_fn(0)
    return TrainState(params, opt.init(params), 0)


def _unsharded_step(cfg: LlamaConfig, opt, device, glob: dict, given, init: str) -> dict:
    """One unsharded ``make_train_step`` step on the whole batch, the same
    initial params (``given``, or ``init``)."""
    from ray_tpu_torch.models.training import make_train_step

    init_fn, step_fn = make_train_step(cfg, opt, device=device)
    state = _initial_state(cfg, opt, device, None, given, init, init_fn)
    state, m = step_fn(state, {k: torch.from_numpy(v).to(device) for k, v in glob.items()})
    out = {"ref_loss": m["loss"].item(), "ref_grad_norm": m["grad_norm"].item()}
    del state
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def dryrun_multichip(n_devices: int, device: Optional[str] = None, *, widths: str = "tiny",
                     timeout_s: float = 900.0, **options) -> list[dict]:
    """One full train step on every mesh of ``mesh_sweep(n_devices)``, on
    ``n_devices`` ranks spawned through the Train layer's worker group:
    one NCCL rank a card by default, gloo ranks with ``device="cpu"``.
    Prints one line per mesh (loss, grad norm, step ms) and returns rank
    0's records; a non-finite loss raises. ``options`` go to
    ``sweep_loop`` (``meshes``, ``extra_meshes``, ``params``, ``init``, ``optimizer``,
    ``model_kwargs``, ``gather``, ``timed_steps``, ``reference``)."""
    from ray_tpu_torch.train._internal.worker_group import run_ranks

    use_gpu = resolve_device(device).type == "cuda"
    ranks = run_ranks(sweep_loop, {"n": n_devices, "widths": widths, **options}, n_devices,
                      use_gpu, timeout_s)
    for rec in ranks[0]:
        if not np.isfinite(rec["loss"]):
            raise AssertionError(f"{rec['label']}: loss {rec['loss']}")
        ms = rec.get("step_ms", rec["first_step_ms"])
        print(f"dryrun_multichip(n={n_devices}) mesh={rec['label']} "
              f"{ {a: v for a, v in rec['mesh'].items() if v > 1} } loss={rec['loss']:.4f} "
              f"grad_norm={rec['grad_norm']:.4f} step_ms={ms:.1f}", flush=True)
    return ranks[0]
