"""``ray_tpu_torch.data`` (the port's Dataset, its logical plan and streaming
executor, on driver threads) against ``ray_tpu.data`` under the thread-mode
runtime, in one process:

- pipelines, as the cases of one parametrised test: the same seeded items
  and explicit ``parallelism`` give both packages the same blocks, and
  every transformation, all-to-all stage, split and batch iteration must
  give the reference's rows in the reference's order (values equal: the
  same numpy code runs on the same blocks);
- datasources: the port writes csv, json, parquet and numpy and reads them
  back; text, binary, image and sqlite files are written here; both
  packages' readers give equal rows;
- the plan's optimizer rules rewrite a plan as the reference's do;
- BC's ``offline_data`` over a port Dataset: the port's BC reads the rows
  that JAX's BC reads from a ``ray_tpu.data`` Dataset of the same items,
  and one update gives the same loss within 1e-5.
"""

import os

import numpy as np
import pandas  # noqa: F401 — on the main thread first: pyarrow (which pandas
import pyarrow  # noqa: F401 — imports) first imported on another thread crashes later
import pytest

pytestmark = pytest.mark.timeout(300)


def _items(n=40, seed=0):
    rng = np.random.default_rng(seed)
    return [{"id": i, "x": float(rng.normal()), "k": int(rng.integers(0, 5)), "s": f"r{i}"}
            for i in range(n)]


ITEMS = _items()
KEYS = [{"k": k, "name": f"n{k}"} for k in range(4)]


def _py(v):
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v.item() if isinstance(v, np.generic) else v


def _plain(rows) -> list:
    return [{k: _py(v) for k, v in r.items()} for r in rows]


def _arrow_add(table):
    import pyarrow.compute as pc

    return table.append_column("y", pc.add(table["id"], table["k"]))


def _tagged(parts) -> list:
    """Rows of several shards, each tagged with its shard's index."""
    return [{"shard": i, **r} for i, rows in enumerate(parts) for r in rows]


def _batches(d, **kw):
    ds = d.from_items(ITEMS, parallelism=4)
    return _tagged([[dict(zip(b, vals)) for vals in zip(*b.values())]
                    for b in ds.iter_batches(**kw)])


def _src(d, parallelism=4):
    return d.from_items(ITEMS, parallelism=parallelism)


PIPELINES = {
    "map_batches_numpy": lambda d: _src(d).map_batches(
        lambda b: {"id": b["id"], "y": b["x"] * 2 + b["k"]}, batch_size=7).take_all(),
    "map_batches_pandas": lambda d: _src(d).map_batches(
        lambda df: df.assign(y=df["x"] * df["k"]), batch_size=6,
        batch_format="pandas").take_all(),
    "map_batches_pyarrow": lambda d: _src(d).map_batches(
        _arrow_add, batch_size=9, batch_format="pyarrow").take_all(),
    "map": lambda d: _src(d).map(lambda r: {**r, "y": r["id"] * 3}).take_all(),
    "filter": lambda d: _src(d).filter(lambda r: r["k"] % 2 == 0).take_all(),
    "flat_map": lambda d: _src(d).flat_map(
        lambda r: [{"id": r["id"], "j": j} for j in range(r["k"])]).take_all(),
    "limit": lambda d: _src(d).map(lambda r: {**r, "y": 1}).limit(13).take_all(),
    "repartition": lambda d: _tagged(
        [list(d.MaterializedDataset([b]).iter_rows())
         for b in _src(d).repartition(3).materialize().get_internal_block_refs()]),
    "random_shuffle": lambda d: _src(d).random_shuffle(seed=7).take_all(),
    "sort": lambda d: _src(d).sort("x").take_all(),
    "sort_descending": lambda d: _src(d).sort("k", descending=True).take_all(),
    "groupby_aggregate": lambda d: _src(d).groupby("k").aggregate(
        ("sum", "x"), ("count", None), ("max", "id"), ("std", "x")).take_all(),
    "map_groups": lambda d: _src(d).groupby("k").map_groups(
        lambda g: {"k": g["k"][:1], "n": np.asarray([len(g["id"])]),
                   "top": np.asarray([g["x"].max()])}).take_all(),
    "union": lambda d: _src(d).union(d.from_items(ITEMS[:5], parallelism=1)).take_all(),
    "zip": lambda d: d.from_items([{"a": i} for i in range(40)], parallelism=3).zip(
        _src(d)).take_all(),
    "join_inner": lambda d: _src(d).join(d.from_items(KEYS, parallelism=2), on="k").take_all(),
    "join_left": lambda d: _src(d).join(d.from_items(KEYS[:2], parallelism=2), on="k",
                                        how="left").take_all(),
    "split": lambda d: _tagged([s.take_all() for s in _src(d).split(3)]),
    "streaming_split": lambda d: _tagged(
        [list(it.iter_rows()) for it in _src(d).streaming_split(2, equal=True)]),
    "train_test_split": lambda d: _tagged(
        [p.take_all() for p in _src(d).train_test_split(0.25, shuffle=True, seed=3)]),
    "iter_batches_drop_last": lambda d: _batches(d, batch_size=6, drop_last=True),
    "iter_batches_local_shuffle": lambda d: _batches(
        d, batch_size=8, local_shuffle_buffer_size=16, local_shuffle_seed=5),
}


@pytest.mark.parametrize("case", list(PIPELINES))
def test_pipeline_rows_equal_the_reference_in_order(ray_start_thread, case):
    import ray_tpu.data as rd
    import ray_tpu_torch.data as td

    got, want = _plain(PIPELINES[case](td)), _plain(PIPELINES[case](rd))
    assert want, case
    assert got == want


def test_data_exports_the_reference_names():
    import ray_tpu.data as rd
    import ray_tpu_torch.data as td

    assert set(td.__all__) == set(rd.__all__) | {"iter_device_batches"}
    for name in td.__all__:
        assert getattr(td, name) is not None
    assert hasattr(td.Dataset, "iter_torch_batches") and not hasattr(td.Dataset, "iter_jax_batches")


def test_optimizer_rules_rewrite_plans_as_the_reference():
    import ray_tpu.data as rd
    import ray_tpu.data.logical as rl
    import ray_tpu_torch.data as td
    import ray_tpu_torch.data.logical as tl

    def plan(d):
        return (d.range(10, parallelism=2).map(lambda r: r).limit(5).limit(3)
                .repartition(4).repartition(2).random_shuffle(seed=1).sort("id"))._plan

    got, want = tl.optimize(plan(td)), rl.optimize(plan(rd))
    assert [op.name for op in got.ops] == [op.name for op in want.ops] == [
        "Read", "Limit", "Map", "Repartition", "Sort"]
    assert got.ops[1].n == want.ops[1].n == 3 and got.ops[3].num_blocks == 2


def _write(kind, d, path):
    """Files of ``kind`` under ``path``, made by the port's ``write_*`` where
    the Dataset has one, else here."""
    if kind in ("csv", "json", "parquet"):
        getattr(d.from_items(ITEMS[:12], parallelism=3), f"write_{kind}")(path)
        return path
    if kind == "numpy":
        d.range_tensor(10, shape=(3,), parallelism=2).write_numpy(path)
        return path
    os.makedirs(path)
    if kind == "text":
        for i in range(2):
            with open(os.path.join(path, f"{i}.txt"), "w") as f:
                f.write("".join(f"line {i}.{j}\n" for j in range(3)))
    elif kind == "binary":
        rng = np.random.default_rng(2)
        for i in range(3):
            with open(os.path.join(path, f"{i}.bin"), "wb") as f:
                f.write(rng.integers(0, 256, 16 + i, dtype=np.uint8).tobytes())
    elif kind == "images":
        from PIL import Image

        for i in range(3):
            Image.new("RGB", (10 + i, 8), color=(i * 10, 5, 0)).save(
                os.path.join(path, f"{i}.png"))
    elif kind == "sql":
        import sqlite3

        db = os.path.join(path, "t.db")
        conn = sqlite3.connect(db)
        conn.execute("CREATE TABLE m (name TEXT, value REAL)")
        conn.executemany("INSERT INTO m VALUES (?, ?)", [(f"m{i}", i * 0.5) for i in range(20)])
        conn.commit()
        conn.close()
        return db
    return path


def _read(kind, d, path):
    if kind == "images":
        return d.read_images(path, size=(12, 12))
    if kind == "sql":
        return d.read_sql("SELECT name, value FROM m WHERE value >= 2", database=path)
    if kind == "binary":
        return d.read_binary_files(path)
    return getattr(d, f"read_{kind}")(path)


@pytest.mark.parametrize("kind", ["csv", "json", "parquet", "numpy", "text", "binary",
                                  "images", "sql"])
def test_datasource_round_trip_equals_the_reference(ray_start_thread, tmp_path, kind):
    import ray_tpu.data as rd
    import ray_tpu_torch.data as td

    path = _write(kind, td, str(tmp_path / kind))
    got, want = _plain(_read(kind, td, path).take_all()), _plain(_read(kind, rd, path).take_all())
    assert got and got == want
    if kind in ("csv", "json", "parquet"):  # the port's write, read back
        # pandas writes csv's floats to 1 ulp and json's to 10 decimal places
        tol = {"csv": dict(rel=1e-15, abs=0), "json": dict(rel=0, abs=5e-11),
               "parquet": dict(rel=0, abs=0)}[kind]
        back = {r["id"]: r for r in got}
        assert sorted(back) == list(range(12))
        for item in ITEMS[:12]:
            r = back[item["id"]]
            assert (r["k"], r["s"]) == (item["k"], item["s"])
            assert r["x"] == pytest.approx(item["x"], **tol)
    if kind == "numpy":
        assert [r["data"] for r in got] == [[i] * 3 for i in range(10)]


def test_bc_offline_data_over_a_port_dataset_equals_jax(ray_start_thread):
    """BC's ``offline_data`` reads ``iter_rows()``: a port Dataset gives the
    port's BC the rows a ``ray_tpu.data`` Dataset of the same items gives
    JAX's BC, and one update from the same weights the same loss."""
    import jax
    import jax.numpy as jnp
    import torch

    import ray_tpu.data as rd
    import ray_tpu_torch.data as td
    from ray_tpu.rllib import BCConfig as JBCConfig
    from ray_tpu_torch.rllib import BCConfig, params_from_jax

    rng = np.random.default_rng(6)
    items = [{"obs": rng.normal(size=4).astype(np.float32), "actions": int(rng.integers(0, 2)),
              "advantages": float(rng.normal() * 3), "logp_old": -0.7} for _ in range(48)]
    def config(cls, data):
        return (cls().environment("CartPole-v1").offline_data(data.from_items(items, parallelism=3))
                .env_runners(num_env_runners=0, num_envs_per_env_runner=2,
                             rollout_fragment_length=8).debugging(seed=0))

    talgo, jalgo = config(BCConfig, td).build(device="cpu"), config(JBCConfig, rd).build()
    for k in ("obs", "actions", "advantages"):
        np.testing.assert_array_equal(talgo._rows[k], jalgo._rows[k])
    w = jax.tree.map(np.asarray, jax.device_get(jalgo.learner_group.get_weights()))
    batch = {k: v[:32] for k, v in talgo._rows.items()}
    jp = jax.tree.map(jnp.asarray, w)
    _, _, jloss = jalgo._update_fn(jp, jalgo.optimizer.init(jp),
                                   jax.tree.map(jnp.asarray, batch))
    tp = params_from_jax(w)
    _, _, tloss = talgo._update_fn(tp, talgo.optimizer.init(tp),
                                   {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5, atol=1e-6)
