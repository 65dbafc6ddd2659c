"""Named device meshes, logical sharding rules, and collectives that carry
autograd: the counterpart of ``ray_tpu/parallel/mesh.py``.

The JAX package names its mesh axes and lets XLA insert the collectives;
here each rank is one process with one device, the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the default process
group, and the model code issues the collectives itself. Axis vocabulary,
in canonical order (the JAX package's):

- ``dp``   data parallel (batch split, gradients summed)
- ``fsdp`` fully-sharded data parallel (batch split, params sharded along embed)
- ``ep``   expert parallel (MoE experts)
- ``pp``   pipeline parallel (layer stages)
- ``sp``   sequence parallel (ring attention / Ulysses)
- ``tp``   tensor parallel (Megatron-style within-layer sharding)

Logical dimension names ('batch', 'seq', 'embed', ...) map to mesh axes by
rules (``DEFAULT_RULES``, ``logical_pspec``), as in the JAX package. A
PartitionSpec here is a tuple with one entry per dimension: None, a mesh
axis name, or a tuple of axis names.

The collectives below (``all_reduce``, ``all_gather``) run their exact
transposes in the backward pass (all-reduce for all-reduce, reduce-scatter
for all-gather), so a program whose ranks each compute a share of one loss
gets that loss's gradient when every leaf's gradient is then summed over
the ranks that hold a copy of it (``models/training.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

AXIS_ORDER = ("dp", "fsdp", "ep", "pp", "sp", "tp")

# logical dim -> mesh axis (or tuple of axes, tried in order; None = replicate)
DEFAULT_RULES: dict[str, Any] = {
    "batch": ("dp", "fsdp"),
    "seq": "sp",
    "embed": "fsdp",  # fsdp shards params along embed
    "mlp": "tp",
    "heads": "tp",
    "kv_heads": "tp",
    "head_dim": None,
    "vocab": "tp",
    "expert": "ep",
    "stage": "pp",
    "norm": None,
}

# axis sets that collectives run over besides the single axes (the batch
# and token axes); build_mesh builds their groups once per mesh, on every
# rank in the same order, and keeps them on the mesh
_AXIS_SETS = (("dp", "fsdp"), ("dp", "sp"), ("dp", "fsdp", "sp"))


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh: axis sizes (use -1 for one inferred axis)."""

    dp: int = 1
    fsdp: int = 1
    ep: int = 1
    pp: int = 1
    sp: int = 1
    tp: int = 1

    def sizes(self) -> dict[str, int]:
        return {a: getattr(self, a) for a in AXIS_ORDER}

    def total(self) -> int:
        t = 1
        for v in self.sizes().values():
            t *= v
        return t

    def resolve(self, n_devices: int) -> "MeshSpec":
        sizes = self.sizes()
        negs = [a for a, v in sizes.items() if v == -1]
        if len(negs) > 1:
            raise ValueError("at most one mesh axis may be -1")
        if negs:
            known = 1
            for a, v in sizes.items():
                if v != -1:
                    known *= v
            if n_devices % known:
                raise ValueError(
                    f"cannot infer axis {negs[0]}: {n_devices} devices not divisible by {known}"
                )
            sizes[negs[0]] = n_devices // known
            return MeshSpec(**sizes)
        if self.total() != n_devices:
            raise ValueError(f"mesh {sizes} needs {self.total()} devices, have {n_devices}")
        return self


def build_mesh(spec: Optional[MeshSpec] = None, device_type: Optional[str] = None,
               **axis_sizes: int):
    """A DeviceMesh over the default process group with ``mesh_dim_names ==
    AXIS_ORDER`` (size-1 axes kept). Ranks are laid out row-major over
    AXIS_ORDER, as the JAX package lays out devices, so ``tp`` is innermost.
    ``device_type`` is "cuda" (NCCL) unless the caller asks for "cpu"
    (gloo). Every rank must call it, in the same order: it creates the
    mesh's process groups, each axis's and those of ``_AXIS_SETS``."""
    from torch.distributed.device_mesh import init_device_mesh

    if spec is None:
        spec = MeshSpec(**{a: axis_sizes.get(a, 1) for a in AXIS_ORDER})
    spec = spec.resolve(dist.get_world_size())
    sizes = spec.sizes()
    mesh = init_device_mesh(device_type or "cuda", tuple(sizes[a] for a in AXIS_ORDER),
                            mesh_dim_names=AXIS_ORDER)
    groups = {}
    ranks = mesh.mesh.reshape([sizes[a] for a in AXIS_ORDER])
    for axes in _AXIS_SETS:
        axes = tuple(a for a in axes if sizes[a] > 1)
        if len(axes) < 2 or axes in groups:
            continue
        keep = [AXIS_ORDER.index(a) for a in axes]
        rest = [i for i in range(len(AXIS_ORDER)) if i not in keep]
        blocks = ranks.permute(rest + keep).reshape(-1, _product(sizes, axes))
        for block in blocks.tolist():  # every rank creates every group
            g = dist.new_group(block)
            if dist.get_rank() in block:
                groups[axes] = g
    mesh.axis_set_groups = groups
    return mesh


def _product(sizes: dict, axes: Sequence[str]) -> int:
    return math.prod(sizes[a] for a in axes)


def mesh_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axis_group(mesh, axes):
    """The process group over ``axes`` (one axis name or a tuple) that
    holds this rank, or None when the axes hold one rank between them."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    sizes = mesh_sizes(mesh)
    axes = tuple(a for a in axes if sizes[a] > 1)
    if not axes:
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    groups = mesh.axis_set_groups
    if axes not in groups:
        raise ValueError(f"no process group over {axes}: build_mesh makes those of {_AXIS_SETS}")
    return groups[axes]


def axis_index(mesh, axes) -> int:
    """This rank's index along ``axes`` (row-major over them)."""
    axes = (axes,) if isinstance(axes, str) else axes
    sizes = mesh_sizes(mesh)
    i = 0
    for a in axes:
        i = i * sizes[a] + mesh.get_local_rank(a)
    return i


def peer_rank(mesh, axis: str, index: int) -> int:
    """The global rank at ``index`` along ``axis``, this rank's coordinates
    on every other axis."""
    coords = [mesh.get_local_rank(a) for a in AXIS_ORDER]
    coords[AXIS_ORDER.index(axis)] = index
    return int(mesh.mesh[tuple(coords)])


def _axes_for(logical: str, rules: dict, sizes: dict, taken: set,
              dim_size: Optional[int]) -> Any:
    rule = rules.get(logical, None)
    if rule is None:
        return None
    candidates = rule if isinstance(rule, tuple) else (rule,)
    chosen = []
    shard_factor = 1
    for axis in candidates:
        if axis in sizes and sizes[axis] > 1 and axis not in taken:
            # a dim can only shard over axes whose product divides its size
            if dim_size is not None and dim_size % (shard_factor * sizes[axis]):
                continue
            shard_factor *= sizes[axis]
            chosen.append(axis)
    if not chosen:
        return None
    for a in chosen:
        taken.add(a)
    return tuple(chosen) if len(chosen) > 1 else chosen[0]


def logical_pspec(mesh, *logical_dims: Optional[str], rules: Optional[dict] = None,
                  shape: Optional[Sequence[int]] = None) -> tuple:
    """The PartitionSpec (mesh axes per dim) for dims with these logical
    names; no mesh axis is used twice. When ``shape`` is given, axes that
    do not divide a dim are skipped for it (2 kv heads over tp = 4 stay
    whole), as the JAX package's ``logical_sharding`` does."""
    rules = rules or DEFAULT_RULES
    sizes = mesh_sizes(mesh) if not isinstance(mesh, dict) else mesh
    taken: set = set()
    return tuple(
        _axes_for(d, rules, sizes, taken, shape[i] if shape is not None else None) if d else None
        for i, d in enumerate(logical_dims)
    )


def spec_axes(entry) -> tuple:
    """The mesh axes of one PartitionSpec entry, as a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_slice(mesh, pspec: Sequence, shape: Sequence[int]) -> tuple:
    """This rank's slice of a global array of ``shape`` under ``pspec``."""
    sizes = mesh_sizes(mesh)
    out = []
    for i, n in enumerate(shape):
        axes = spec_axes(pspec[i]) if i < len(pspec) else ()
        parts = _product(sizes, axes)
        if n % parts:
            raise ValueError(f"dim {i} of size {n} does not split over {axes} ({parts} shards)")
        step = n // parts
        j = axis_index(mesh, axes) if axes else 0
        out.append(slice(j * step, (j + 1) * step))
    return tuple(out)


def shard_params(mesh, params: dict, param_dims: Optional[dict] = None,
                 rules: Optional[dict] = None) -> dict:
    """Each full leaf cut to this rank's shard by its logical dims
    (``models/llama.py:_PARAM_DIMS`` unless ``param_dims`` is given), as a
    contiguous copy."""
    if param_dims is None:
        from ray_tpu_torch.models.llama import _PARAM_DIMS as param_dims
    out = {}
    for name, leaf in params.items():
        spec = logical_pspec(mesh, *param_dims[name], rules=rules, shape=leaf.shape)
        out[name] = leaf[local_slice(mesh, spec, leaf.shape)].contiguous()
    return out


def gather_leaf(mesh, local: torch.Tensor, pspec: Sequence) -> torch.Tensor:
    """The full array from every rank's shard (no autograd): all-gathers
    each sharded dim over its axes."""
    out = local.detach()
    for i, entry in enumerate(pspec):
        axes = spec_axes(entry)
        if axes:
            out = _gather(out.contiguous(), axis_group(mesh, axes), i)
    return out


# ---------------------------------------------------------------------------
# Collectives with their transposes as backward
# ---------------------------------------------------------------------------


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _reduce_scatter(g: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum over the group of ``g``, this rank's chunk of ``dim``."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if dist.get_backend(group) == "nccl":
        full = g.movedim(dim, 0).contiguous()
        out = torch.empty((full.shape[0] // n,) + full.shape[1:], dtype=g.dtype, device=g.device)
        dist.reduce_scatter_tensor(out, full, group=group)
        return out.movedim(0, dim)
    g = g.contiguous()
    dist.all_reduce(g, group=group)  # gloo has no reduce-scatter
    return g.chunk(n, dim=dim)[r].contiguous()


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x.contiguous(), group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group`` (identity when None); backward: the same sum."""
    return x if group is None else _AllReduce.apply(x, group)


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Concatenate the group's tensors along ``dim`` in group-rank order
    (identity when None); backward: reduce-scatter."""
    return x if group is None else _AllGather.apply(x, group, dim)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise max over ``group``, no gradient."""
    x = x.detach().clone(memory_format=torch.contiguous_format)
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x

