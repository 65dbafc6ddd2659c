"""The port's Train layer on CPU ranks, against the JAX package's.

Counterparts of ``tests/test_train.py`` (trainer contract, report and
checkpoint round trip, failure retries, stop criteria, dataset shards,
top-k retention), the raises that differ (a closure train function, a GPU
run without a card, elastic bounds), and data parallelism: a 2-rank gloo
step (fp32, masks that differ between the ranks) against JAX's
``make_train_step`` on a dp=2 mesh over the same global batch, within 1e-5
relative on the loss, the grad norm and each param tensor (its norm) after
2 steps (the weights are drawn well-conditioned: JAX's init draws wq/wk
with fan_in = the head count, which amplifies summation-order differences
to 2e-4, see ``test_torch_train.py``), and equal to the port's 1-rank step
on the whole batch within the same limits.

Ranks are spawned processes that import the train loop by name, so the
loops are module-level functions and this module imports neither JAX nor
ray_tpu at its top: a rank that unpickles a loop imports this module.
"""

import multiprocessing
import os

import numpy as np
import pytest
import torch

import ray_tpu_torch.train as train
from ray_tpu_torch.train import (
    Checkpoint,
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
    TorchTrainer,
)
from ray_tpu_torch.train._internal.checkpoint_manager import CheckpointManager

CPU = dict(use_gpu=False)


@pytest.fixture
def storage(tmp_path):
    return str(tmp_path / "results")


def _no_rank_left():
    left = [p for p in multiprocessing.active_children() if "-rank-" in p.name]
    assert not left, left


# ---- loops (module level: the ranks import them by name) --------------------


def _loop_steps(config):
    for i in range(config["steps"]):
        train.report({"loss": 1.0 / (i + 1), "step": i})


def _loop_context():
    ctx = train.get_context()
    train.report({"rank": ctx.get_world_rank(), "ws": ctx.get_world_size(),
                  "env": (os.environ["RAY_TPU_RANK"], os.environ["RAY_TPU_WORLD_SIZE"]),
                  "seed": train.broadcast_from_rank_zero(41 + ctx.get_world_rank())})
    train.barrier()


def _loop_checkpoint(config):
    chk = train.get_checkpoint()
    start = chk.to_dict()["step"] + 1 if chk else 0
    for i in range(start, start + 2):
        train.report({"step": i}, checkpoint=Checkpoint.from_dict({"step": i}))


def _loop_explodes():
    raise RuntimeError("worker exploded")


def _loop_dies():
    os._exit(3)


def _loop_transient(config):
    if not os.path.exists(config["marker"]):
        with open(config["marker"], "w") as f:
            f.write("x")
        raise RuntimeError("transient")
    train.report({"ok": 1})


def _loop_forever():
    for i in range(1000):
        train.report({"step": i})


def _loop_dataset():
    train.report({"total": sum(train.get_dataset_shard("train"))})


class _Split:
    def __init__(self, items):
        self.items = items

    def split(self, n):
        return [self.items[i::n] for i in range(n)]


def _loop_sharded():
    train.report({"shard": list(train.get_dataset_shard("train")),
                  "rank": train.get_context().get_world_rank()})


# ---- trainer semantics (mirrors tests/test_train.py) --------------------------


def test_single_worker_fit(storage):
    trainer = TorchTrainer(
        _loop_steps,
        train_loop_config={"steps": 3},
        scaling_config=ScalingConfig(num_workers=1, **CPU),
        run_config=RunConfig(name="t1", storage_path=storage),
    )
    result = trainer.fit()
    assert result.error is None
    assert result.metrics["loss"] == pytest.approx(1.0 / 3)
    assert len(result.metrics_history) == 3
    assert len(trainer._controller.rank_startup_s) == 1
    _no_rank_left()


def test_multi_worker_context(storage):
    """Two gloo ranks: rank 0's reports drive the run; the collectives
    carry rank 0's value to every rank."""
    trainer = TorchTrainer(
        _loop_context,
        scaling_config=ScalingConfig(num_workers=2, **CPU),
        run_config=RunConfig(name="t2", storage_path=storage),
    )
    result = trainer.fit()
    assert result.error is None, result.error
    assert result.metrics["rank"] == 0
    assert result.metrics["ws"] == 2
    assert result.metrics["seed"] == 41
    assert result.metrics["env"] == ("0", "2")  # the rank's environment, set at spawn
    _no_rank_left()


def test_checkpoint_report_and_restore(storage):
    trainer = TorchTrainer(
        _loop_checkpoint,
        train_loop_config={},
        scaling_config=ScalingConfig(num_workers=1, **CPU),
        run_config=RunConfig(name="t3", storage_path=storage),
    )
    r1 = trainer.fit()
    assert r1.checkpoint is not None
    assert r1.checkpoint.to_dict()["step"] == 1

    trainer2 = TorchTrainer(
        _loop_checkpoint,
        train_loop_config={},
        scaling_config=ScalingConfig(num_workers=1, **CPU),
        run_config=RunConfig(name="t3b", storage_path=storage),
        resume_from_checkpoint=r1.checkpoint,
    )
    r2 = trainer2.fit()
    assert r2.checkpoint.to_dict()["step"] == 3
    assert os.path.isdir(r1.checkpoint.path)  # protected: never deleted


def test_failure_no_retry(storage):
    trainer = TorchTrainer(
        _loop_explodes,
        scaling_config=ScalingConfig(num_workers=1, **CPU),
        run_config=RunConfig(name="t4", storage_path=storage),
    )
    result = trainer.fit()
    assert result.error is not None
    assert "worker exploded" in result.error
    _no_rank_left()


def test_rank_death_is_a_failure(storage):
    """A rank that exits without a word (os._exit) fails the run."""
    result = TorchTrainer(
        _loop_dies,
        scaling_config=ScalingConfig(num_workers=2, **CPU),
        run_config=RunConfig(name="t4b", storage_path=storage),
    ).fit()
    assert result.error is not None and "exited with code 3" in result.error, result.error
    _no_rank_left()


def test_failure_retry_then_succeed(storage, tmp_path):
    marker = str(tmp_path / "attempted")
    trainer = TorchTrainer(
        _loop_transient,
        train_loop_config={"marker": marker},
        scaling_config=ScalingConfig(num_workers=1, **CPU),
        run_config=RunConfig(
            name="t5",
            storage_path=storage,
            failure_config=FailureConfig(max_failures=2),
        ),
    )
    result = trainer.fit()
    assert result.error is None
    assert result.metrics["ok"] == 1
    assert trainer._controller.failure_policy.failures == 1


def test_stop_criteria(storage):
    trainer = TorchTrainer(
        _loop_forever,
        scaling_config=ScalingConfig(num_workers=1, **CPU),
        run_config=RunConfig(name="t6", storage_path=storage, stop={"step": 5}),
    )
    result = trainer.fit()
    assert result.error is None
    assert result.metrics["step"] >= 5
    _no_rank_left()  # the still-running rank was terminated


def test_dataset_shard_plain_iterable(storage):
    trainer = TorchTrainer(
        _loop_dataset,
        scaling_config=ScalingConfig(num_workers=1, **CPU),
        run_config=RunConfig(name="t7", storage_path=storage),
        datasets={"train": [1, 2, 3, 4]},
    )
    result = trainer.fit()
    assert result.metrics["total"] == 10


def test_dataset_with_split_is_split_per_rank(storage):
    """``split(n)`` where the dataset has one (controller.py:253-273)."""
    result = TorchTrainer(
        _loop_sharded,
        scaling_config=ScalingConfig(num_workers=2, **CPU),
        run_config=RunConfig(name="t7b", storage_path=storage),
        datasets={"train": _Split([0, 1, 2, 3, 4, 5])},
    ).fit()
    assert result.error is None, result.error
    assert result.metrics == {"shard": [0, 2, 4], "rank": 0}


def test_checkpoint_manager_topk(tmp_path):
    mgr = CheckpointManager(
        CheckpointConfig(
            num_to_keep=2,
            checkpoint_score_attribute="acc",
            checkpoint_score_order="max",
        )
    )
    paths = []
    for i, acc in enumerate([0.1, 0.9, 0.5, 0.3]):
        d = str(tmp_path / f"chk{i}")
        os.makedirs(d)
        paths.append(d)
        mgr.register(Checkpoint(d), {"acc": acc})
    kept = {tc.checkpoint.path for tc in mgr.tracked}
    # top-2 by acc are chk1 (0.9) and chk2 (0.5); latest (chk3) is protected
    assert os.path.abspath(paths[1]) in kept
    assert mgr.best_checkpoint().path == os.path.abspath(paths[1])
    assert not os.path.exists(paths[0])


# ---- what raises ------------------------------------------------------------


def test_closure_train_fn_raises_type_error(storage):
    def loop():
        train.report({"x": 1})

    for fn in (loop, lambda: None):
        with pytest.raises(TypeError, match="picklable by reference"):
            TorchTrainer(fn, scaling_config=ScalingConfig(num_workers=1, **CPU),
                         run_config=RunConfig(storage_path=storage)).fit()


def test_use_gpu_without_a_card_raises(storage, monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert ScalingConfig().use_gpu  # the default: ranks on the card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchTrainer(_loop_steps, train_loop_config={"steps": 1},
                     run_config=RunConfig(storage_path=storage)).fit()
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    with pytest.raises(RuntimeError, match="need 2 cards, but 1 are visible"):
        TorchTrainer(_loop_steps, train_loop_config={"steps": 1},
                     scaling_config=ScalingConfig(num_workers=2),
                     run_config=RunConfig(storage_path=storage)).fit()


@pytest.mark.parametrize("kw", [{"min_workers": 1}, {"max_workers": 4}])
def test_elastic_bounds_raise(kw):
    with pytest.raises(NotImplementedError, match="elastic"):
        ScalingConfig(num_workers=2, **kw)


def test_worker_resources_name_one_gpu_per_rank():
    assert ScalingConfig(num_workers=2).worker_resources() == {"CPU": 1.0, "GPU": 1.0}
    assert ScalingConfig(use_gpu=False).worker_resources() == {"CPU": 1.0}


# ---- data parallelism against JAX's dp=2 mesh ---------------------------------

DP_STEPS = 2
DP_OPT = dict(learning_rate=1e-2, warmup_steps=1, total_steps=10)


def _rel(a, b) -> float:
    """||a - b|| / ||b|| over a tensor. Elementwise, AdamW's m / (sqrt(v) +
    eps) turns a grad's summation-order difference into up to 2e-4 of an
    element's update where |g| is near eps (the port's 1-rank step against
    JAX's reads 8.6e-5 on one w_down element at lr 1e-2); over the tensor
    the params agree to 5.5e-6."""
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _conditioned(shapes: dict, seed: int) -> dict:
    """Norms ones, every other weight N(0, 1) / sqrt(d_model) in fp32."""
    rng = np.random.default_rng(seed)
    d = shapes["final_norm"][0]
    return {k: (np.ones(s, np.float32) if "norm" in k
                else (rng.standard_normal(s) / np.sqrt(d)).astype(np.float32))
            for k, s in sorted(shapes.items())}


def _dp_batch(vocab: int):
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, vocab, (4, 17)).astype(np.int32)
    mask = np.ones((4, 17), np.int32)
    mask[:2, 5:] = 0  # rank 0's half predicts far fewer positions
    mask[3, ::3] = 0
    return {"tokens": tokens, "mask": mask}


def _run_dp_steps(params_np: dict, batch: dict, group, rank: int, n: int):
    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.models import training as tt

    cfg = tl.LlamaConfig.tiny()
    params = {k: torch.from_numpy(v.copy()) for k, v in params_np.items()}
    opt = tt.default_optimizer(**DP_OPT)
    state = tt.TrainState(params, opt.init(params), 0)
    _, step = tt.make_train_step(cfg, opt, device="cpu", dp_group=group)
    rows = batch["tokens"].shape[0] // n
    local = {k: torch.from_numpy(v[rank * rows:(rank + 1) * rows]) for k, v in batch.items()}
    out = []
    for _ in range(DP_STEPS):
        state, m = step(state, local)
        out.append((m["loss"].item(), m["grad_norm"].item()))
    return state, out


def _loop_dp(config):
    import torch.distributed as dist

    from ray_tpu_torch.examples.train_llama_dp import bit_checksums, equal_across_ranks

    ctx = train.get_context()
    rank, n = ctx.get_world_rank(), ctx.get_world_size()
    state, out = _run_dp_steps(config["params"], config["batch"], dist.group.WORLD, rank, n)
    train.report({"losses": [x for x, _ in out], "grad_norms": [g for _, g in out],
                  "ranks_equal": equal_across_ranks(bit_checksums(state.params), "cpu"),
                  "params": {k: v.detach().numpy() for k, v in state.params.items()}})


def test_dp_step_matches_jax_dp2_mesh_and_one_rank(storage):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import llama as jl
    from ray_tpu.models import training as jt
    from ray_tpu.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.models import llama as tl

    jcfg = jl.LlamaConfig.tiny()
    params = _conditioned(tl._param_shapes(tl.LlamaConfig.tiny()), seed=3)
    batch = _dp_batch(jcfg.vocab_size)

    mesh = build_mesh(MeshSpec(dp=2), devices=jax.devices()[:2])
    jopt = jt.default_optimizer(**DP_OPT)
    _, jstep = jt.make_train_step(jcfg, mesh, optimizer=jopt)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jt.TrainState(jp, jopt.init(jp), jnp.zeros((), jnp.int32))
    jbatch = jax.device_put({k: jnp.asarray(v) for k, v in batch.items()}, jt.batch_sharding(mesh))
    jout = []
    for _ in range(DP_STEPS):
        jstate, jm = jstep(jstate, jbatch)
        jout.append((float(jm["loss"]), float(jm["grad_norm"])))

    result = TorchTrainer(
        _loop_dp,
        train_loop_config={"params": params, "batch": batch},
        scaling_config=ScalingConfig(num_workers=2, **CPU),
        run_config=RunConfig(name="dp", storage_path=storage),
    ).fit()
    assert result.error is None, result.error
    got = result.metrics
    assert got["ranks_equal"]
    np.testing.assert_allclose(got["losses"], [x for x, _ in jout], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norms"], [g for _, g in jout], rtol=1e-5)
    for k, v in got["params"].items():
        assert _rel(v, np.asarray(jstate.params[k])) <= 1e-5, k

    # the port's 1-rank step on the whole batch: the same function
    one, one_out = _run_dp_steps(params, batch, None, 0, 1)
    np.testing.assert_allclose(got["losses"], [x for x, _ in one_out], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norms"], [g for _, g in one_out], rtol=1e-5)
    for k, v in got["params"].items():
        assert _rel(v, one.params[k].detach().numpy()) <= 1e-5, k


def test_moe_under_data_parallelism_raises(monkeypatch):
    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.models import training as tt

    cfg = tl.LlamaConfig.tiny(moe_experts=4)
    # a stand-in group of two ranks: the check runs before any collective
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: 2)
    with pytest.raises(NotImplementedError, match="MoE under data parallelism"):
        tt.make_train_step(cfg, device="cpu", dp_group=object())
    tt.make_train_step(cfg, device="cpu", dp_group=None)  # one device: fine
