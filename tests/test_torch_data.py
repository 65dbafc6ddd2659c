"""``ray_tpu_torch.data.iter_device_batches`` against the JAX package's
``iter_jax_batches``: the counterparts of ``tests/test_data.py:59, 299,
411``, and the Train layer's dataset shards read through it.

- ragged token columns padded to a bucket with a ``<col>_length`` column,
  and a bare-tensor batch cast by ``dtypes``: the same ray_tpu Dataset
  through both iterators, equal values (the port's iterator is duck typed
  over ``iter_batches``);
- with a mesh, each of 4 gloo ranks keeps exactly the shard that JAX's
  ``NamedSharding`` places on the device of the same index, for the
  iterator's default spec (dp=4) and for the train step's batch spec
  (batch over dp, sequence over sp, dp=2 x sp=2); with the model's
  ``cfg`` each rank gets the train step's shard (labels shifted before the
  sequence is cut, pp microbatches each sharded over dp);
- the prefetch window: ``prefetch`` batches are in flight ahead of the one
  yielded, as in JAX's deque;
- ``examples/train_llama_dp.py`` on 2 CPU ranks reads its ``"train"``
  shard (``split(2)``) through the iterator, and its loss equals one
  device's step on the two shards' rows together (1e-5 relative).

Rank loops are module level and this module imports neither JAX nor
ray_tpu at its top: the ranks import it by name.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.data import iter_device_batches

pytestmark = pytest.mark.timeout(300)


class _Batches:
    """A source of fixed numpy batches, ``split`` by rows for the trainer."""

    def __init__(self, batches):
        self.batches = batches

    def iter_batches(self, batch_size, batch_format, drop_last):
        assert batch_format == "numpy"
        for b in self.batches:
            yield {k: v[:batch_size] for k, v in b.items()} if isinstance(b, dict) else b

    def split(self, n):
        return [_Batches([{k: v[i::n] for k, v in b.items()} for b in self.batches])
                for i in range(n)]


def test_iter_device_batches_pads_and_buckets_ragged_like_jax(ray_start_thread):
    import ray_tpu.data as rd

    rows = [{"tokens": list(range(3 + (i % 5)))} for i in range(16)]
    ds = rd.from_items(rows)
    kw = dict(batch_size=8, ragged_buckets=(4, 16), drop_last=False)
    got = list(iter_device_batches(ds, device="cpu", **kw))
    want = list(ds.iter_jax_batches(**kw))
    assert got and len(got) == len(want)
    for b, w in zip(got, want):
        toks, lens = b["tokens"].numpy(), b["tokens_length"].numpy()
        assert toks.shape[1] == 16  # smallest bucket covering max len 7
        assert b["tokens_length"].dtype == torch.int32
        np.testing.assert_array_equal(toks, np.asarray(w["tokens"]))
        np.testing.assert_array_equal(lens, np.asarray(w["tokens_length"]))
        for row, n in zip(toks, lens):
            np.testing.assert_array_equal(row[:n], np.arange(n))
            assert (row[n:] == 0).all()


def test_iter_device_batches_tensor_dtype_like_jax(ray_start_thread):
    import ray_tpu.data as rd

    ds = rd.range_tensor(8, shape=(2,))
    b = next(iter(iter_device_batches(ds, batch_size=4, dtypes={"data": np.float32},
                                      device="cpu")))
    w = next(iter(ds.iter_jax_batches(batch_size=4, dtypes={"data": np.float32})))
    assert b.dtype == torch.float32
    np.testing.assert_array_equal(b.numpy(), np.asarray(w))


def test_prefetch_window():
    pulled = []

    class Counting:
        def iter_batches(self, batch_size, batch_format, drop_last):
            for i in range(5):
                pulled.append(i)
                yield {"x": np.full((batch_size,), i)}

    for prefetch in (0, 1, 3):
        pulled.clear()
        it = iter_device_batches(Counting(), batch_size=2, prefetch=prefetch, device="cpu")
        assert int(next(it)["x"][0]) == 0
        assert len(pulled) == prefetch + 1
        assert [int(b["x"][0]) for b in it] == [1, 2, 3, 4]


def test_iter_device_batches_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(iter(iter_device_batches(_Batches([{"x": np.zeros(2)}]), batch_size=2)))


# ---- sharded over a mesh of gloo ranks ----------------------------------------


def _loop_sharded(config):
    import ray_tpu_torch.train as train
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.models.training import batch_spec
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh

    def numpy(batches):
        return [{k: v.numpy() for k, v in b.items()} for b in batches]

    out = {}
    mesh = build_mesh(MeshSpec(dp=4), "cpu")
    out["default"] = [b.numpy() for b in iter_device_batches(
        _Batches(config["tensor"]), batch_size=16, mesh=mesh, device="cpu")]
    mesh = build_mesh(MeshSpec(dp=2, sp=2), "cpu")
    out["train"] = numpy(iter_device_batches(
        _Batches(config["tokens"]), batch_size=4, mesh=mesh, spec=batch_spec(mesh), device="cpu"))
    cfg = LlamaConfig.tiny()
    out["step_sp"] = numpy(iter_device_batches(
        _Batches(config["step_tokens"]), batch_size=4, mesh=mesh, cfg=cfg, device="cpu"))
    mesh = build_mesh(MeshSpec(dp=2, pp=2), "cpu")
    out["step_pp"] = numpy(iter_device_batches(
        _Batches(config["pp_tokens"]), batch_size=8, mesh=mesh, cfg=cfg, device="cpu"))
    train.report(out)


def _tokens(i, b, t):
    return {"tokens": np.arange(i * b * t, (i + 1) * b * t, dtype=np.int32).reshape(b, t)}


@pytest.fixture(scope="module")
def sharded_ranks():
    """Each of 4 gloo ranks' batches from ``_loop_sharded``, and the inputs."""
    import ray_tpu
    import ray_tpu.data as rd
    from ray_tpu_torch.train._internal.worker_group import run_ranks

    ray_tpu.init(num_cpus=8, mode="thread")
    try:
        tensor = list(rd.range_tensor(32, shape=(8,)).iter_batches(
            batch_size=16, batch_format="numpy", drop_last=True))
    finally:
        ray_tpu.shutdown()
    config = {
        "tensor": tensor,
        "tokens": [_tokens(i, 4, 16) for i in range(2)],
        "step_tokens": [_tokens(i, 4, 17) for i in range(2)],
        "pp_tokens": [_tokens(i, 8, 17) for i in range(2)],
    }
    ranks = run_ranks(_loop_sharded, config, 4, use_gpu=False, timeout_s=200)
    return config, [r[0] for r in ranks]


def test_sharded_batches_are_the_jax_named_sharding_shards(ray_start_thread, sharded_ranks):
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    import ray_tpu.data as rd
    from ray_tpu.models.training import batch_sharding
    from ray_tpu.parallel.mesh import MeshSpec, build_mesh

    config, got = sharded_ranks
    tokens = config["tokens"]
    ds = rd.range_tensor(32, shape=(8,))
    devices = jax.devices()[:4]
    want = list(ds.iter_jax_batches(batch_size=16, mesh=Mesh(np.array(devices), ("dp",)),
                                    sharding_spec=PartitionSpec("dp")))
    assert len(want) == len(got[0]["default"]) == 2
    for i, w in enumerate(want):
        assert w.shape == (16, 8) and len(w.sharding.device_set) == 4
        shards = {s.device: np.asarray(s.data) for s in w.addressable_shards}
        for r in range(4):
            np.testing.assert_array_equal(got[r]["default"][i], shards[devices[r]])

    mesh = build_mesh(MeshSpec(dp=2, sp=2), devices=devices)
    for i, b in enumerate(tokens):
        w = jax.device_put(b["tokens"], NamedSharding(mesh, batch_sharding(mesh).spec))
        shards = {s.device: np.asarray(s.data) for s in w.addressable_shards}
        for r in range(4):
            np.testing.assert_array_equal(got[r]["train"][i]["tokens"], shards[devices[r]])


def _shards(x, mesh, spec) -> dict:
    import jax
    from jax.sharding import NamedSharding

    w = jax.device_put(x, NamedSharding(mesh, spec))
    return {s.device: np.asarray(s.data) for s in w.addressable_shards}


def test_train_batches_are_the_steps_shards(sharded_ranks):
    """With ``cfg`` each rank gets the train step's shard: labels shifted
    before the sequence is cut over sp (the JAX batch sharding of the
    shifted arrays), and under pp each of the step's M = 2 pp = 4 microbatches
    (global rows [m B / M, (m + 1) B / M)) sharded over dp, as the JAX
    pipeline holds them."""
    import jax
    from jax.sharding import PartitionSpec as P

    from ray_tpu.models.training import batch_sharding
    from ray_tpu.parallel.mesh import MeshSpec, build_mesh

    config, got = sharded_ranks
    devices = jax.devices()[:4]
    mesh = build_mesh(MeshSpec(dp=2, sp=2), devices=devices)
    spec = batch_sharding(mesh).spec
    for i, b in enumerate(config["step_tokens"]):
        want = {"tokens": _shards(b["tokens"][:, :-1], mesh, spec),
                "labels": _shards(b["tokens"][:, 1:], mesh, spec)}
        for r in range(4):
            assert sorted(got[r]["step_sp"][i]) == ["labels", "tokens"]
            for k in want:
                np.testing.assert_array_equal(got[r]["step_sp"][i][k], want[k][devices[r]])
    mesh = build_mesh(MeshSpec(dp=2, pp=2), devices=devices)
    M = 4
    for i, b in enumerate(config["pp_tokens"]):
        tok = b["tokens"]
        B, T = tok.shape[0], tok.shape[1] - 1
        for k, x in (("tokens", tok[:, :-1]), ("labels", tok[:, 1:])):
            want = _shards(x.reshape(M, B // M, T), mesh, P(None, "dp", None))
            for r in range(4):
                np.testing.assert_array_equal(got[r]["step_pp"][i][k],
                                              want[devices[r]].reshape(-1, T))


def test_train_batches_need_a_mesh_and_no_spec():
    from ray_tpu_torch.models.llama import LlamaConfig

    with pytest.raises(ValueError, match="cfg cuts"):
        next(iter_device_batches(_Batches([_tokens(0, 4, 17)]), batch_size=4,
                                 cfg=LlamaConfig.tiny(), device="cpu"))


# ---- the Train layer's dataset shard ----------------------------------------------


def test_example_reads_its_dataset_shard(tmp_path):
    from ray_tpu_torch.examples import train_llama_dp as ex
    from ray_tpu_torch.models import training as tt
    from ray_tpu_torch.models.llama import init_params
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    config = {"model": "tiny", "steps": 1, "batch": 2, "seq_len": 16, "seed": 5}
    rng = np.random.default_rng(0)
    data = _Batches([{"tokens": rng.integers(0, 256, (4, 17)).astype(np.int32)}])
    result = TorchTrainer(
        ex.train_loop, train_loop_config=config,
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
        run_config=RunConfig(name="data", storage_path=str(tmp_path)),
        datasets={"train": data},
    ).fit()
    assert result.error is None, result.error
    # rank r's rows are r::2; one device's step on the same four rows
    cfg = ex.model_config(config)
    _, step = tt.make_train_step(cfg, device="cpu")
    params = init_params(cfg, config["seed"], "cpu")
    state = tt.TrainState(params, tt.default_optimizer().init(params), 0)
    rows = np.concatenate([p.batches[0]["tokens"] for p in data.split(2)])
    _, m = step(state, {"tokens": torch.from_numpy(rows)})
    np.testing.assert_allclose(result.metrics["loss"], m["loss"].item(), rtol=1e-5)
