"""The port's parallel layer on 8 gloo ranks against the JAX package's on
its virtual 8-device mesh: the counterparts of ``tests/test_parallel.py``.

One spawn of 8 CPU ranks (the port's worker group, with a deadline) runs
every case on seeded numpy inputs; each rank's output shards are gathered
to rank 0 and compared here with the JAX function on the same mesh:

- mesh: ``MeshSpec.resolve``, ``build_mesh`` sizes, ``logical_pspec``;
- ring attention (dp=2, sp=4) causal and not, against JAX's
  ``ring_attention`` and the dense reference; its gradient (sp=4, tp=2);
- Ulysses (sp=4, tp=2) causal and not;
- the GPipe pipeline (pp=8) against JAX's ``pipeline_apply`` and the
  sequential loop, and its gradient;
- expert-parallel MoE (ep=8) against JAX's ep=8 and ep=1 ``moe_layer``,
  values and gradients; big capacity routes every token (ep=4, tp=2);
- the ep = 1 MoE over a batch sharded on (dp=4, sp=2), routed over the
  global token order, against JAX's ``moe_dense`` on the whole batch with
  a capacity that drops tokens.

fp32 throughout; tolerances are stated per test. The rank loop is a
module-level function and this module imports neither JAX nor ray_tpu at
its top: the ranks import it by name.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.timeout(300)

RING = dict(B=2, T=32, H=4, D=16)


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _moe_params(seed, E, d, f):
    return {"router": _normal(seed, (d, E), d**-0.5),
            "w_gate": _normal(seed + 1, (E, d, f), d**-0.5),
            "w_up": _normal(seed + 2, (E, d, f), d**-0.5),
            "w_down": _normal(seed + 3, (E, f, d), f**-0.5)}


def _inputs():
    qkv = [_normal(s, (RING["B"], RING["T"], RING["H"], RING["D"])) for s in (0, 1, 2)]
    return {
        "ring_qkv": qkv,
        "ulysses_qkv": [_normal(s, (2, 32, 8, 16)) for s in (3, 4, 5)],
        "ring_grad_q": _normal(6, (1, 16, 2, 8)),
        "pipe_w": _normal(7, (8, 16, 16), 16**-0.5), "pipe_x": _normal(8, (4, 2, 16)),
        "pipe_gw": _normal(9, (8, 8, 8), 0.3), "pipe_gx": _normal(10, (2, 2, 8)),
        "moe8": _moe_params(11, 8, 16, 32), "moe8_x": _normal(15, (64, 16)),
        "moe4": _moe_params(16, 4, 8, 16), "moe4_x": _normal(20, (32, 8)),
        "moe_global_x": _normal(21, (4, 8, 8)),
    }


# ---- the rank loop (module level: the ranks import it by name) ---------------


def _loop(config):
    import torch.distributed as dist

    import ray_tpu_torch.train as train
    from ray_tpu_torch.parallel import moe
    from ray_tpu_torch.parallel.mesh import (
        MeshSpec, all_reduce, axis_group, build_mesh, gather_leaf, local_slice, mesh_sizes)
    from ray_tpu_torch.parallel.pipeline import pipeline_apply
    from ray_tpu_torch.parallel.ring_attention import ring_attention
    from ray_tpu_torch.parallel.ulysses import ulysses_attention

    x = config["inputs"]
    meshes = {}

    def mesh_of(**sizes):
        key = tuple(sorted(sizes.items()))
        if key not in meshes:
            meshes[key] = build_mesh(MeshSpec(**sizes), "cpu")
        return meshes[key]

    def local(mesh, arr, spec):
        return torch.from_numpy(arr[local_slice(mesh, spec, arr.shape)].copy())

    def whole(mesh, t, spec):
        return gather_leaf(mesh, t.detach(), spec).numpy()

    out = {}
    mesh = mesh_of(dp=2, sp=2, tp=2)
    out["mesh_sizes"] = {k: int(v) for k, v in mesh_sizes(mesh).items()}
    out["mesh_names"] = list(mesh.mesh_dim_names)

    mesh = mesh_of(dp=2, sp=4)
    spec = ("dp", "sp", None, None)
    q, k, v = (local(mesh, a, spec) for a in x["ring_qkv"])
    for causal in (True, False):
        out[f"ring_{causal}"] = whole(mesh, ring_attention(q, k, v, mesh, causal=causal), spec)

    mesh = mesh_of(sp=4, tp=2)
    spec = (None, "sp", None, None)
    q, k, v = (local(mesh, a, spec) for a in x["ulysses_qkv"])
    for causal in (True, False):
        out[f"ulysses_{causal}"] = whole(mesh, ulysses_attention(q, k, v, mesh, causal=causal),
                                         spec)
    qg = local(mesh, x["ring_grad_q"], spec).requires_grad_(True)
    ring_attention(qg, qg, qg, mesh, causal=True).sum().backward()
    out["ring_grad"] = whole(mesh, qg.grad, spec)

    mesh = mesh_of(pp=8)
    stage = mesh.get_local_rank("pp")

    def stage_fn(p, act):
        return torch.tanh(act @ p["w"])

    w = torch.from_numpy(x["pipe_w"][stage].copy())
    out["pipe"] = pipeline_apply({"w": w}, torch.from_numpy(x["pipe_x"]), stage_fn, mesh).numpy()
    wg = torch.from_numpy(x["pipe_gw"][stage].copy()).requires_grad_(True)
    y = pipeline_apply({"w": wg}, torch.from_numpy(x["pipe_gx"]), stage_fn, mesh)
    (y.sum() / 8).backward()  # every pp rank holds the output: each backs its share
    out["pipe_grad"] = whole(mesh, wg.grad[None], ("pp", None, None))

    mesh = mesh_of(ep=8)
    ex = ("ep", None, None)
    p8 = {k: (torch.from_numpy(v.copy()) if k == "router" else local(mesh, v, ex))
          for k, v in x["moe8"].items()}
    for p in p8.values():
        p.requires_grad_(True)
    xm = torch.from_numpy(x["moe8_x"])
    y, aux = moe.moe_layer(p8, xm, mesh, num_experts=8, top_k=2, capacity_factor=8.0,
                           tokens_axis_names=())
    out["moe8_y"], out["moe8_aux"] = y.detach().numpy(), aux.item()
    # tokens are copied over ep: each rank back-propagates its 1/ep share
    (((y**2).sum() + aux) / 8).backward()
    dist.all_reduce(p8["router"].grad, group=axis_group(mesh, "ep"))
    out["moe8_grads"] = {k: (p.grad.numpy() if k == "router" else whole(mesh, p.grad, ex))
                         for k, p in p8.items()}

    mesh = mesh_of(ep=4, tp=2)
    p4 = {k: (torch.from_numpy(v.copy()) if k == "router" else local(mesh, v, ex))
          for k, v in x["moe4"].items()}
    y, aux = moe.moe_layer(p4, torch.from_numpy(x["moe4_x"]), mesh, num_experts=4, top_k=1,
                           capacity_factor=8.0, tokens_axis_names=())
    out["moe4_y"], out["moe4_aux"] = y.numpy(), aux.item()

    mesh = mesh_of(dp=4, sp=2)
    spec = ("dp", "sp", None)
    xg = local(mesh, x["moe_global_x"], spec)  # [1 row, 4 tokens, d]
    pg = {k: torch.from_numpy(v.copy()) for k, v in x["moe4"].items()}
    y, aux = moe.moe_dense(pg, xg.reshape(-1, 8), num_experts=4, top_k=2, capacity_factor=0.5,
                           mesh=mesh, row_len=xg.shape[1])
    out["moe_global_y"] = whole(mesh, y.reshape(xg.shape), spec)
    out["moe_global_aux"] = aux.item()
    out["moe_global_aux_sum"] = all_reduce(aux.detach(), axis_group(mesh, ("dp", "sp"))).item()
    train.report(out if dist.get_rank() == 0 else {})


@pytest.fixture(scope="module")
def port():
    from ray_tpu_torch.train._internal.worker_group import run_ranks

    inputs = _inputs()
    return inputs, run_ranks(_loop, {"inputs": inputs}, 8, use_gpu=False, timeout_s=240)[0][0]


# ---- the JAX side --------------------------------------------------------------


def _jax_mesh(**sizes):
    import jax

    from ray_tpu.parallel import MeshSpec, build_mesh

    spec = MeshSpec(**sizes)
    return build_mesh(spec, devices=jax.devices()[: spec.total()])


def test_mesh_build_and_resolve(port):
    from ray_tpu_torch.parallel.mesh import AXIS_ORDER, MeshSpec

    _, got = port
    assert got["mesh_names"] == list(AXIS_ORDER)
    assert got["mesh_sizes"] == {"dp": 2, "fsdp": 1, "ep": 1, "pp": 1, "sp": 2, "tp": 2}
    assert MeshSpec(dp=-1, tp=2).resolve(8).dp == 4
    with pytest.raises(ValueError, match="at most one"):
        MeshSpec(dp=-1, tp=-1).resolve(8)
    with pytest.raises(ValueError, match="needs 4 devices"):
        MeshSpec(dp=4).resolve(8)


def test_logical_pspec_matches_jax_no_axis_reuse():
    from ray_tpu.parallel import logical_sharding
    from ray_tpu_torch.parallel.mesh import logical_pspec

    sizes = {"dp": 4, "fsdp": 1, "ep": 1, "pp": 1, "sp": 1, "tp": 2}
    mesh = _jax_mesh(dp=4, tp=2)
    for dims, shape in ((("batch", "seq", "embed"), None), (("embed", "vocab"), (64, 256)),
                        (("stage", "embed", "kv_heads", "head_dim"), (2, 64, 3, 16)),
                        (("vocab", "heads"), (256, 4))):
        want = tuple(logical_sharding(mesh, *dims, shape=shape).spec)
        want += (None,) * (len(dims) - len(want))
        assert logical_pspec(sizes, *dims, shape=shape) == want, dims
    assert logical_pspec(sizes, "batch", "seq", "embed")[0] == "dp"


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_jax(port, causal):
    import jax.numpy as jnp

    from ray_tpu.parallel import ring_attention
    from ray_tpu.parallel.ring_attention import full_attention_reference

    inputs, got = port
    q, k, v = (jnp.asarray(a) for a in inputs["ring_qkv"])
    want = ring_attention(q, k, v, _jax_mesh(dp=2, sp=4), causal=causal)
    np.testing.assert_allclose(got[f"ring_{causal}"], np.asarray(want), rtol=1e-5, atol=1e-5)
    dense = full_attention_reference(q, k, v, causal=causal)
    np.testing.assert_allclose(got[f"ring_{causal}"], np.asarray(dense), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_ulysses_matches_jax(port, causal):
    import jax.numpy as jnp

    from ray_tpu.parallel import ulysses_attention

    inputs, got = port
    q, k, v = (jnp.asarray(a) for a in inputs["ulysses_qkv"])
    want = ulysses_attention(q, k, v, _jax_mesh(sp=4, tp=2), causal=causal)
    np.testing.assert_allclose(got[f"ulysses_{causal}"], np.asarray(want), rtol=1e-5, atol=1e-5)


def test_ulysses_refuses_indivisible_heads():
    from ray_tpu_torch.parallel.ulysses import ulysses_attention

    class _Mesh:  # only the axis sizes are read before the check
        mesh_dim_names = ("sp",)
        mesh = torch.zeros(4)

    q = torch.zeros(1, 4, 6, 8)
    with pytest.raises(ValueError, match="heads \\(6\\) divisible by sp=4"):
        ulysses_attention(q, q, q, _Mesh())
    with pytest.raises(ValueError, match="kv heads \\(2\\)"):
        ulysses_attention(torch.zeros(1, 4, 8, 8), torch.zeros(1, 4, 2, 8),
                          torch.zeros(1, 4, 2, 8), _Mesh())


def test_ring_attention_grad_matches_jax(port):
    import jax
    import jax.numpy as jnp

    from ray_tpu.parallel import ring_attention

    inputs, got = port
    mesh = _jax_mesh(sp=4, tp=2)
    q = jnp.asarray(inputs["ring_grad_q"])
    want = jax.jit(jax.grad(lambda q: ring_attention(q, q, q, mesh, causal=True).sum()))(q)
    np.testing.assert_allclose(got["ring_grad"], np.asarray(want), rtol=1e-4, atol=1e-5)


def test_pipeline_matches_jax_and_sequential(port):
    import jax.numpy as jnp

    from ray_tpu.parallel import pipeline_apply

    inputs, got = port
    w, x = jnp.asarray(inputs["pipe_w"]), jnp.asarray(inputs["pipe_x"])
    want = pipeline_apply({"w": w}, x, lambda p, a: jnp.tanh(a @ p["w"]), _jax_mesh(pp=8))
    np.testing.assert_allclose(got["pipe"], np.asarray(want), rtol=1e-5, atol=1e-6)
    seq = inputs["pipe_x"]
    for s in range(8):
        seq = np.tanh(seq @ inputs["pipe_w"][s])
    np.testing.assert_allclose(got["pipe"], seq, rtol=1e-4, atol=1e-5)


def test_pipeline_grad_matches_jax(port):
    import jax
    import jax.numpy as jnp

    from ray_tpu.parallel import pipeline_apply

    inputs, got = port
    mesh = _jax_mesh(pp=8)
    x = jnp.asarray(inputs["pipe_gx"])
    want = jax.jit(jax.grad(lambda w: pipeline_apply(
        {"w": w}, x, lambda p, a: jnp.tanh(a @ p["w"]), mesh).sum()))(
        jnp.asarray(inputs["pipe_gw"]))
    np.testing.assert_allclose(got["pipe_grad"], np.asarray(want), rtol=1e-4, atol=1e-5)


def test_moe_expert_parallel_matches_jax_and_single_device(port):
    import jax.numpy as jnp

    from ray_tpu.parallel import moe_layer

    inputs, got = port
    p = {k: jnp.asarray(v) for k, v in inputs["moe8"].items()}
    x = jnp.asarray(inputs["moe8_x"])
    for mesh in (_jax_mesh(ep=8), _jax_mesh(ep=1)):
        y, aux = moe_layer(p, x, mesh, num_experts=8, top_k=2, capacity_factor=8.0,
                           tokens_axis_names=())
        np.testing.assert_allclose(got["moe8_y"], np.asarray(y), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got["moe8_aux"], float(aux), rtol=1e-5)


def test_moe_expert_parallel_grads_match_jax(port):
    """Tokens copied over ep (tokens_axis_names=()): JAX's gradients define
    the function; the port's ranks each back-propagate a 1/ep share."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.parallel import moe_layer

    inputs, got = port
    mesh = _jax_mesh(ep=8)
    x = jnp.asarray(inputs["moe8_x"])

    def loss(p):
        y, aux = moe_layer(p, x, mesh, num_experts=8, top_k=2, capacity_factor=8.0,
                           tokens_axis_names=())
        return (y**2).sum() + aux

    want = jax.jit(jax.grad(loss))({k: jnp.asarray(v) for k, v in inputs["moe8"].items()})
    for k, g in want.items():
        np.testing.assert_allclose(got["moe8_grads"][k], np.asarray(g), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_moe_routes_all_tokens_with_big_capacity(port):
    import jax.numpy as jnp

    from ray_tpu.parallel import moe_layer

    inputs, got = port
    y = got["moe4_y"]
    assert np.abs(y).sum(axis=-1).min() > 0.0
    assert np.isfinite(got["moe4_aux"])
    want, aux = moe_layer({k: jnp.asarray(v) for k, v in inputs["moe4"].items()},
                          jnp.asarray(inputs["moe4_x"]), _jax_mesh(ep=4, tp=2), num_experts=4,
                          top_k=1, capacity_factor=8.0, tokens_axis_names=())
    np.testing.assert_allclose(y, np.asarray(want), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["moe4_aux"], float(aux), rtol=1e-5)


def test_moe_global_routing_matches_jax_moe_dense(port):
    """ep = 1 on a batch sharded over (dp, sp): capacity from the global
    token count and positions in the global (row, position) order, as XLA
    computes JAX's moe_dense on the whole batch (capacity 0.5: tokens drop)."""
    import jax.numpy as jnp

    from ray_tpu.parallel.moe import moe_dense

    inputs, got = port
    x = inputs["moe_global_x"]
    y, aux = moe_dense({k: jnp.asarray(v) for k, v in inputs["moe4"].items()},
                       jnp.asarray(x.reshape(-1, 8)), num_experts=4, top_k=2,
                       capacity_factor=0.5)
    y = np.asarray(y).reshape(x.shape)
    assert (np.abs(y).sum(-1) == 0).any()  # the capacity dropped some tokens
    np.testing.assert_allclose(got["moe_global_y"], y, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["moe_global_aux"], float(aux), rtol=1e-5)
    np.testing.assert_allclose(got["moe_global_aux_sum"], 8 * float(aux), rtol=1e-5)
