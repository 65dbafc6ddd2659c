"""How far bf16 train steps at two data-parallel world sizes part, in the
port and in the JAX package, on the CPU.

On four cards the port's bf16 step on 2 and 4 ranks parts by 2.08e-3 in
loss at step 4 on one global batch (``tools/elastic_bench.py grow``). Here
the same question at the tiny width: the port's step on 2 and on 4 gloo
ranks (``make_train_step(dp_group=WORLD)``, the gradient all-reduced in
bf16) against JAX's step on dp2 and dp4 meshes of its virtual devices, both
over 4 steps of ``examples/train_llama_dp.py:global_batch``'s batches
(8 rows, each rank or data shard taking its rows), from the same bf16
weights: JAX's seeded ``init_params`` and well-conditioned ones. Each
package's parting is the largest relative difference of its two world
sizes' losses over the 4 steps.

The answer at this width (CPU, deterministic): both packages part, by the
same order. Seeded weights: the port 3.52e-4, JAX 2.12e-4 (the port 1.66x
further); conditioned: the port 4.50e-5, JAX 2.83e-4 (the port 0.16x as
far). The test holds the port to within ``PARTING_FACTOR`` of JAX's
parting. It does not settle the four-card 2.08e-3 at the bench widths,
which is six times the largest parting here.

Ranks import this module by name (the loop lives here), so it imports
neither JAX nor ray_tpu at its top.
"""

import numpy as np
import pytest

from ray_tpu_torch.train._internal.worker_group import run_ranks
from tests.test_torch_elastic import _conditioned

pytestmark = pytest.mark.timeout(300)

STEPS = 4
LLAMA = {"model": "tiny", "global_batch": 8, "seq_len": 16, "seed": 5}
OPT = dict(learning_rate=1e-3, warmup_steps=1, total_steps=20)
DEADLINE_S = 180.0
# the port may part up to 2x as far as JAX's step does on the same weights:
# the larger of the two readings below (1.66x, seeded) with a margin. JAX
# itself must part (by more than 1e-5), or the parting would be the port's
# alone
PARTING_FACTOR = 2.0


def bf16_rank_loop(config):
    """Each weight set in turn: STEPS bf16 steps on this rank's rows of the
    global batch, its loss reported a step."""
    import torch
    import torch.distributed as dist

    import ray_tpu_torch.train as train
    from ray_tpu_torch.examples import train_llama_dp as ex
    from ray_tpu_torch.models import training as tt
    from ray_tpu_torch.models.llama import LlamaConfig

    torch.set_num_threads(1)
    cfg = LlamaConfig.tiny(max_seq_len=LLAMA["seq_len"], dtype=torch.bfloat16)
    rank, world = dist.get_rank(), dist.get_world_size()
    B = LLAMA["global_batch"]
    for name, weights in config["weights"].items():
        params = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in weights.items()}
        opt = tt.default_optimizer(**OPT)
        _, step_fn = tt.make_train_step(cfg, opt, device=torch.device("cpu"),
                                        dp_group=dist.group.WORLD)
        state = tt.TrainState(params, opt.init(params), 0)
        for step in range(STEPS):
            rows = ex.global_batch(cfg, LLAMA, LLAMA["seed"], step)
            rows = rows[rank * B // world:(rank + 1) * B // world]
            state, m = step_fn(state, {"tokens": torch.from_numpy(rows)})
            train.report({"weights": name, "step": step, "loss": m["loss"].item()})


def _parting(a: list, b: list) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


@pytest.fixture(scope="module")
def weights():
    import jax

    from ray_tpu.models import llama as jl
    from ray_tpu_torch.examples import train_llama_dp as ex
    from ray_tpu_torch.models import llama as tl

    jcfg = jl.LlamaConfig.tiny(max_seq_len=LLAMA["seq_len"])
    seeded = {k: np.asarray(v, np.float32)
              for k, v in jl.init_params(jax.random.PRNGKey(0), jcfg).items()}
    conditioned = _conditioned(tl._param_shapes(ex.model_config(LLAMA)), seed=11)
    assert seeded.keys() == conditioned.keys()
    return {"seeded": seeded, "conditioned": conditioned}


@pytest.fixture(scope="module")
def port_losses(weights):
    out = {}
    for world in (2, 4):
        reports = run_ranks(bf16_rank_loop, {"weights": weights}, world, use_gpu=False,
                            timeout_s=DEADLINE_S)
        out[world] = {name: [m["loss"] for m in reports[0] if m["weights"] == name]
                      for name in weights}
    return out


@pytest.fixture(scope="module")
def jax_losses(weights):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import llama as jl
    from ray_tpu.models import training as jt
    from ray_tpu.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.examples import train_llama_dp as ex

    jcfg = jl.LlamaConfig.tiny(max_seq_len=LLAMA["seq_len"], dtype=jnp.bfloat16)
    cfg = ex.model_config(LLAMA)
    out = {}
    for dp in (2, 4):
        mesh = build_mesh(MeshSpec(dp=dp), devices=jax.devices()[:dp])
        jopt = jt.default_optimizer(**OPT)
        _, jstep = jt.make_train_step(jcfg, mesh, optimizer=jopt)
        out[dp] = {}
        for name, w in weights.items():
            jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in w.items()}
            state = jt.TrainState(jp, jopt.init(jp), jnp.zeros((), jnp.int32))
            losses = []
            for step in range(STEPS):
                tokens = ex.global_batch(cfg, LLAMA, LLAMA["seed"], step)
                jbatch = jax.device_put({"tokens": jnp.asarray(tokens)}, jt.batch_sharding(mesh))
                state, m = jstep(state, jbatch)
                losses.append(float(m["loss"]))
            out[dp][name] = losses
    return out


@pytest.mark.parametrize("name", ["seeded", "conditioned"])
def test_bf16_world_sizes_part_no_further_than_jax(name, port_losses, jax_losses):
    port = _parting(port_losses[2][name], port_losses[4][name])
    ref = _parting(jax_losses[2][name], jax_losses[4][name])
    print(f"{name}: port 2 vs 4 ranks {port:.3e}, JAX dp2 vs dp4 {ref:.3e}")
    assert all(np.isfinite(port_losses[w][name]).all() for w in (2, 4))
    assert ref > 1e-5
    assert port <= PARTING_FACTOR * ref
