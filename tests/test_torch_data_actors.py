"""The port's Data layer on its own processes, on the CPU:

- actor pools (``ActorPoolStrategy`` stages, ``data/execution.py``) under a
  card ledger of the test's own (``use_ledger``), their actors on CPU
  leases: outputs in input order, a callable class built once an actor,
  the pool grown from ``min_size`` 1 to ``max_size`` 2 while input waits,
  and not past what the ledger has room for; a lambda refused with
  ``TypeError`` at the call; a GPU share without a card or a free lease
  raises, never running on the CPU in its place; no lease and no child
  process left after each test;
- the batch processor: ``build_llm_processor(concurrency=2,
  device="cpu")(ds)`` over a port Dataset, two actor processes each
  building one engine, gives the texts of JAX's processor over
  ``ray_tpu.data`` with ``ActorPoolStrategy(size=2)``, row for row;
- Train ingest: a 2-rank gloo ``TorchTrainer`` fed a port ``Dataset``
  reads, in each rank, the rows of JAX's ``streaming_split(2,
  equal=True)`` shard of the same items, and its losses equal one
  device's steps on the two shards' rows together (1e-5 relative).

The UDF class and the rank loop are module level and this module imports
neither JAX nor ray_tpu at its top: actors and ranks import it by name.
"""

import json
import multiprocessing
import os

import numpy as np
import pytest

from ray_tpu_torch._private.cards import CardLedger, LedgerError, use_ledger
from ray_tpu_torch._private.process_actor import get
from ray_tpu_torch.data import ActorPoolStrategy
from ray_tpu_torch.data.execution import StreamingExecutor, _resolve
from tests.test_torch_llm_batch import SAMPLING, _config, _jax_config, checkpoint  # noqa: F401

pytestmark = pytest.mark.timeout(300)

_BUILT = []  # in an actor's process: one entry per _AddOffset built there


class _AddOffset:
    """A stateful UDF: built once per actor ("the model loaded once")."""

    def __init__(self):
        _BUILT.append(os.getpid())
        self.offset = 100

    def __call__(self, batch):
        return {"id": batch["id"], "x": batch["id"] + self.offset,
                "pid": np.full(len(batch["id"]), os.getpid()),
                "built": np.full(len(batch["id"]), len(_BUILT))}


def _actors_alive() -> list:
    """This process's live children that are data actors."""
    return [p for p in multiprocessing.active_children() if p.name.startswith("data-actor")]


@pytest.fixture
def ledger(tmp_path):
    with use_ledger(CardLedger(str(tmp_path / "ledger"), cards=[], cpus=8)) as led:
        yield led
        assert led.holders() == []
        assert _actors_alive() == []


def _run(ds):
    """The dataset's blocks through an executor, and the holders of the
    ledger seen after each block while the stage runs."""
    from ray_tpu_torch._private.cards import default_ledger

    blocks, seen = [], []
    for item in StreamingExecutor().execute(ds._plan):
        blocks.append(_resolve(item))
        seen.append(default_ledger().holders())
    rows = [r for b in blocks for r in zip(*(b[k].tolist() for k in ("id", "x", "pid", "built")))]
    return rows, seen


def test_actor_pool_keeps_order_builds_once_and_grows(ledger):
    import ray_tpu_torch.data as td

    ds = td.range(48, parallelism=6).map_batches(
        _AddOffset, batch_size=4,
        compute=ActorPoolStrategy(min_size=1, max_size=2, resources={"CPU": 1}))
    rows, seen = _run(ds)
    assert [r[:2] for r in rows] == [(i, i + 100) for i in range(48)]  # input order
    pids = {r[2] for r in rows}
    assert len(pids) == 2  # grown from 1 to 2 while input waited
    assert {r[3] for r in rows} == {1}  # the class built once in each actor
    held = max(seen, key=len)
    assert len(held) == 2 and all(h.cpu == 1 and not h.gpu for h in held)
    assert {h.pid for h in held} == pids


def test_actor_pool_grows_no_further_than_the_ledger(tmp_path):
    import ray_tpu_torch.data as td

    with use_ledger(CardLedger(str(tmp_path / "ledger"), cards=[], cpus=1)) as led:
        ds = td.range(24, parallelism=6).map_batches(
            _AddOffset, batch_size=4,
            compute=ActorPoolStrategy(min_size=1, max_size=3, resources={"CPU": 1}))
        rows, _ = _run(ds)
        assert [r[:2] for r in rows] == [(i, i + 100) for i in range(24)]
        assert len({r[2] for r in rows}) == 1  # no room for a second actor
        with pytest.raises(LedgerError):  # no room for the first two at all
            _run(td.range(8, parallelism=2).map_batches(
                _AddOffset, compute=ActorPoolStrategy(size=2, resources={"CPU": 1})))
        assert led.holders() == [] and _actors_alive() == []


def test_actor_stage_refuses_a_lambda_or_a_closure():
    import ray_tpu_torch.data as td

    def closure(batch):
        return batch

    for fn in (lambda b: b, closure):
        with pytest.raises(TypeError, match="by reference"):
            td.range(4).map_batches(fn, compute=ActorPoolStrategy(size=1))
    td.range(4).map_batches(lambda b: b)  # a task stage takes it


def test_gpu_share_without_a_card_or_a_lease_raises(tmp_path):
    import ray_tpu_torch.data as td

    def stage():
        return td.range(8, parallelism=2).map_batches(
            _AddOffset, compute=ActorPoolStrategy(size=2, resources={"GPU": 0.5}))

    with use_ledger(CardLedger(str(tmp_path / "none"), cards=[], cpus=8)):
        with pytest.raises(RuntimeError, match="need a CUDA device"):
            stage().take_all()
    with use_ledger(CardLedger(str(tmp_path / "one"), cards=["0"], cpus=8)) as led:
        lease, = led.acquire([{"GPU": 1}], "holder")
        try:
            with pytest.raises(LedgerError):
                stage().take_all()
        finally:
            lease.release()
    assert _actors_alive() == []


def _engines_here() -> int:
    """In an actor's process: the engines its processor cache holds."""
    from ray_tpu_torch.llm import batch

    return len(batch._ENGINE_CACHE)


def test_processor_on_two_actors_equals_jax_processor(ray_start_thread, checkpoint):  # noqa: F811
    import ray_tpu.data as rd
    import ray_tpu_torch.data as td
    from ray_tpu.llm import ProcessorConfig as JProcessorConfig
    from ray_tpu.llm import build_llm_processor as jbuild
    from ray_tpu_torch.llm import ProcessorConfig, build_llm_processor

    cfg = _config(checkpoint)
    items = [{"prompt": f"row {i}", "id": i} for i in range(8)]
    proc = build_llm_processor(ProcessorConfig(llm_config=cfg, batch_size=4, concurrency=2,
                                               sampling_params=SAMPLING, device="cpu"))
    out = proc(td.from_items(items, parallelism=2))
    ex = StreamingExecutor()
    blocks, engines = [], None
    for item in ex.execute(out._plan):
        blocks.append(_resolve(item))
        if len(blocks) == 2:  # both actors still alive: one engine built in each
            pool, = ex.actor_pools
            engines = get([a.call(_engines_here) for a in pool.actors])
    assert engines == [1, 1]
    rows = [{k: b[k][i] for k in b} for b in blocks for i in range(len(b["id"]))]
    want = jbuild(JProcessorConfig(llm_config=_jax_config(cfg), batch_size=4, concurrency=2,
                                   sampling_params=SAMPLING))(
        rd.from_items(items, parallelism=2)).take_all()
    assert [r["id"] for r in rows] == [r["id"] for r in want] == list(range(8))
    assert [r["generated_text"] for r in rows] == [r["generated_text"] for r in want]
    assert all(len(r["generated_text"]) > 0 for r in rows)
    assert _actors_alive() == []


def ingest_loop(config: dict) -> None:
    """The example loop, after writing the rows of this rank's ``"train"``
    shard to ``config["out"]``."""
    import ray_tpu_torch.train as train
    from ray_tpu_torch.examples import train_llama_dp as ex

    rank = train.get_context().get_world_rank()
    rows = [r["tokens"].tolist() for r in train.get_dataset_shard("train").iter_rows()]
    with open(os.path.join(config["out"], f"rows-{rank}.json"), "w") as f:
        json.dump(rows, f)
    ex.train_loop(config)


def test_trainer_ingests_a_port_dataset_as_jax_streaming_split(ray_start_thread, tmp_path):
    import torch

    import ray_tpu.data as rd
    import ray_tpu_torch.data as td
    from ray_tpu_torch.examples import train_llama_dp as ex
    from ray_tpu_torch.models import training as tt
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    rng = np.random.default_rng(3)
    items = [{"tokens": rng.integers(0, 256, 17).astype(np.int32)} for _ in range(8)]
    config = {"model": "tiny", "steps": 2, "batch": 2, "seq_len": 16, "seed": 5,
              "out": str(tmp_path)}
    result = TorchTrainer(
        ingest_loop, train_loop_config=config,
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
        run_config=RunConfig(name="ingest", storage_path=str(tmp_path)),
        datasets={"train": td.from_items(items, parallelism=3)},
    ).fit()
    assert result.error is None, result.error
    got = [json.load(open(tmp_path / f"rows-{r}.json")) for r in range(2)]
    want = [[r["tokens"].tolist() for r in it.iter_rows()]
            for it in rd.from_items(items, parallelism=3).streaming_split(2, equal=True)]
    assert got == want and [len(g) for g in got] == [4, 4]
    # each step: rank r's rows [2 s, 2 s + 2) of its shard, one device's
    # step on the two ranks' rows together
    cfg = ex.model_config(config)
    init_fn, step = tt.make_train_step(cfg, device="cpu")
    state, losses = init_fn(config["seed"]), []
    for s in range(config["steps"]):
        rows = np.asarray([row for shard in got for row in shard[2 * s:2 * s + 2]], np.int32)
        state, m = step(state, {"tokens": torch.from_numpy(rows)})
        losses.append(m["loss"].item())
    np.testing.assert_allclose([m["loss"] for m in result.metrics_history], losses, rtol=1e-5)
