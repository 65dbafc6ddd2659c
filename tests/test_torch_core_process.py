"""The port's core API in process mode (``ray_tpu_torch.init(mode="process")``,
its default): tasks in worker processes, objects over shared memory, card
shares over the card ledger, on the CPU.

The mirrors of ``tests/test_core_process.py:17-95``'s task tests run
through ``ray_tpu``'s process mode and the port's, with the same
module-level functions and inputs, and the results are equal: the round
trip, a large object through shared memory, put-and-pass, nested
submission, and a retry on the worker's death. Then the port's own: two
``num_gpus=0.5`` tasks on a ledger of one fake card run at once while a
third waits; a card-share task never overlaps a ``WorkerGroup``'s lease,
and never runs without a card; a task placed in a placement group's
bundle; nothing (lease, process, segment) left after ``shutdown()``;
``import ray_tpu_torch`` importing no torch.

The slice as a whole: a ``@remote`` task builds the port's engine on the
CPU (a tiny Llama, ``graft_entry.conditioned_params`` weights through a
JAX checkpoint) in a worker process, and its greedy tokens equal those of
``ray_tpu``'s ``JaxEngine`` run in a ``ray_tpu`` task (its process mode)
on the same weights, exactly.

Every port test runs on a card ledger of its own. The functions stay at
module level (the workers import this module by name); JAX and ray_tpu are
imported inside the tests only.
"""

import gc
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest

import ray_tpu_torch as rt

pytestmark = pytest.mark.timeout(180)

SAMPLING = {"max_tokens": 4, "temperature": 0.0, "ignore_eos": True}


def whoami(x):
    return os.getpid(), x * 2


def make(n):
    return np.ones(n, dtype=np.float32)


def total(arr):
    return float(arr.sum())


def inner(x):
    return x + 1


def outer(x, pkg):
    import importlib

    api = importlib.import_module(pkg)
    return api.get(api.remote(inner).remote(x)) * 10


def flaky(marker_dir):
    marker = os.path.join(marker_dir, "attempt")
    if not os.path.exists(marker):
        open(marker, "w").close()
        os._exit(1)  # hard-kill the worker process
    return "recovered"


def hold(d, name, release_after=30.0):
    """Mark this task started, then wait for the release file."""
    open(os.path.join(d, f"{name}.started"), "w").close()
    deadline = time.monotonic() + release_after
    while not os.path.exists(os.path.join(d, "release")) and time.monotonic() < deadline:
        time.sleep(0.01)
    return name, os.environ.get("CUDA_VISIBLE_DEVICES"), os.getpid()


def visible():
    return os.environ.get("CUDA_VISIBLE_DEVICES")


def in_group():
    from ray_tpu_torch.util import get_current_placement_group

    pg = get_current_placement_group()
    return None if pg is None else pg.id, os.getpid()


def put_and_return(n):
    return [rt.put(np.arange(n))]


def context():
    ctx = rt.get_runtime_context()
    try:
        rt.init()
    except rt.RayTpuError as e:
        refused = str(e)
    return ctx.get_job_id(), ctx.get_task_name(), refused


def generate_tokens(llm_config, prompts, sampling):
    """The port's engine in this worker (the batch layer's per-process
    cache), greedy over ``prompts``: each prompt's tokens."""
    from ray_tpu_torch.llm import SamplingParams
    from ray_tpu_torch.llm import batch

    eng = batch._get_engine(llm_config, "cpu")
    reqs = [eng.submit(p, sampling_params=SamplingParams(**sampling)) for p in prompts]
    for r in reqs:
        eng._await_done(r)
    return [list(r.out_tokens) for r in reqs]


@pytest.fixture
def ledger(tmp_path):
    from ray_tpu_torch._private.cards import CardLedger, use_ledger

    with use_ledger(CardLedger(str(tmp_path / "ledger"), cards=["0"], cpus=8)) as led:
        yield led


@pytest.fixture
def port(ledger):
    rt.init(num_cpus=4, mode="process")
    try:
        yield rt
    finally:
        rt.shutdown()


@pytest.fixture(scope="module")
def jax_process():
    """ray_tpu's process mode, for the mirrored tests."""
    import ray_tpu

    ray_tpu.init(num_cpus=4, mode="process")
    yield ray_tpu
    ray_tpu.shutdown()


def _both(jax_api, scenario):
    return scenario(jax_api), scenario(rt)


# ---- tests/test_core_process.py -----------------------------------------------------


def test_process_task_roundtrip(jax_process, port):
    def run(api):
        pid, val = api.get(api.remote(whoami).remote(21), timeout=60)
        return pid != os.getpid(), val

    assert _both(jax_process, run) == ((True, 42),) * 2


def test_process_large_object_shm(jax_process, port):
    from ray_tpu_torch._private import object_store, worker

    def run(api):
        out = api.get(api.remote(make).remote(1_000_000), timeout=60)
        return out.shape, out.dtype, float(out.sum())

    assert _both(jax_process, run) == (((1_000_000,), np.float32, 1_000_000.0),) * 2
    ref = rt.remote(make).remote(1_000_000)
    rt.wait([ref], timeout=60)
    ok, wire = worker.driver().store.read(ref.hex())
    assert ok and wire[0] == "shm" and wire[2] in object_store.driver_segments()
    del ref
    gc.collect()
    worker.driver().store.collect()
    assert object_store.driver_segments() == []


def test_process_put_and_pass(jax_process, port):
    big = np.arange(500_000, dtype=np.float64)

    def run(api):
        return api.get(api.remote(total).remote(api.put(big)), timeout=60)

    assert _both(jax_process, run) == (float(big.sum()),) * 2


def test_process_nested_submission(jax_process, port):
    def run(api):
        return api.get(api.remote(outer).remote(4, api.__name__), timeout=90)

    assert _both(jax_process, run) == (50, 50)


def test_task_retry_on_worker_death(jax_process, port):
    def run(api):
        with tempfile.TemporaryDirectory() as d:
            return api.get(api.remote(max_retries=2)(flaky).remote(d), timeout=120)

    assert _both(jax_process, run) == ("recovered",) * 2
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(rt.WorkerCrashedError, match="0 retries"):
            rt.get(rt.remote(flaky).remote(d), timeout=120)


# ---- the port's own -------------------------------------------------------------------


def test_two_half_card_tasks_run_at_once_and_a_third_waits(port, ledger, tmp_path):
    from ray_tpu_torch.util import state

    h = rt.remote(num_gpus=0.5)(hold)
    refs = [h.remote(str(tmp_path), n) for n in ("a", "b", "c")]
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and not all(
            (tmp_path / f"{n}.started").exists() for n in "ab"):
        time.sleep(0.02)
    assert (tmp_path / "a.started").exists() and (tmp_path / "b.started").exists()
    time.sleep(0.5)
    assert not (tmp_path / "c.started").exists()
    held = sorted((h.name, h.gpu) for h in ledger.holders())
    assert held == [("1 core API task workers", {"0": 0.5})] * 2
    listed = [(t["name"], t["state"]) for t in state.list_tasks()]
    assert sorted(listed) == [("hold", "PENDING_SCHEDULING"), ("hold", "RUNNING"),
                              ("hold", "RUNNING")]
    assert rt.available_resources().get("GPU", 0.0) == 0.0
    (tmp_path / "release").touch()
    out = rt.get(refs, timeout=60)
    assert [o[0] for o in out] == ["a", "b", "c"] and all(o[1] == "0" for o in out)
    assert out[2][2] not in {out[0][2], out[1][2]}  # a card worker ends with its task
    assert not ledger.holders()


def test_a_card_task_frees_its_card_when_it_ends(port, ledger):
    """A whole-card task, then a Train group's lease on the same one-card
    ledger: granted at once, as the reference frees a task's GPU at its end."""
    from ray_tpu_torch.train import ScalingConfig
    from ray_tpu_torch.train._internal.worker_group import lease_ranks

    assert rt.get(rt.remote(num_gpus=1)(visible).remote(), timeout=60) == "0"
    (lease,) = lease_ranks(ScalingConfig(num_workers=1, use_gpu=True), 1)
    try:
        assert [h.gpu for h in ledger.holders()] == [{"0": 1.0}]
    finally:
        lease.release()


def test_a_card_share_task_never_overlaps_a_worker_groups_lease(port, ledger):
    from ray_tpu_torch.train import ScalingConfig
    from ray_tpu_torch.train._internal.worker_group import lease_ranks

    (lease,) = lease_ranks(ScalingConfig(num_workers=1, use_gpu=True), 1)
    try:
        ref = rt.remote(num_gpus=0.5)(visible).remote()
        ready, _ = rt.wait([ref], timeout=1.0)
        assert not ready
        assert [h.gpu for h in ledger.holders()] == [{"0": 1.0}]
    finally:
        lease.release()
    assert rt.get(ref, timeout=60) == "0"


def test_a_card_share_task_without_a_card_stays_pending(tmp_path):
    from ray_tpu_torch._private.cards import CardLedger, use_ledger

    with use_ledger(CardLedger(str(tmp_path / "none"), cards=[], cpus=8)):
        rt.init(num_cpus=4)
        try:
            ref = rt.remote(num_gpus=0.5)(visible).remote()
            cpu = rt.remote(visible).remote()
            assert rt.get(cpu, timeout=60) == ""  # a CPU worker sees no card
            ready, _ = rt.wait([ref], timeout=1.0)
            assert not ready
            assert "GPU" not in rt.cluster_resources()
        finally:
            rt.shutdown()


def test_a_task_is_placed_in_a_placement_groups_bundle(port, ledger):
    from ray_tpu_torch.util import placement_group, remove_placement_group
    from ray_tpu_torch.util.scheduling_strategies import PlacementGroupSchedulingStrategy

    pg = placement_group([{"CPU": 1}, {"GPU": 0.5}], strategy="PACK")
    assert pg.ready(timeout=10)
    gid, pid = rt.get(rt.remote(in_group).options(
        scheduling_strategy=PlacementGroupSchedulingStrategy(pg, 0)).remote(), timeout=60)
    assert gid == pg.id
    assert rt.get(rt.remote(visible).options(placement_group=pg,
                                             placement_group_bundle_index=1).remote(),
                  timeout=60) == "0"
    table = pg.table()
    assert [len(a) for a in table["bundle_actors"]] == [1, 1]
    remove_placement_group(pg)
    assert not os.path.exists(f"/proc/{pid}") or _dead(pid)
    with pytest.raises(rt.PlacementGroupSchedulingError, match="removed"):
        rt.get(rt.remote(in_group).options(placement_group=pg).remote(), timeout=30)


def _dead(pid: int) -> bool:
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        try:
            with open(f"/proc/{pid}/stat") as f:
                if f.read().rsplit(")", 1)[1].split()[0] in "ZX":
                    return True
        except OSError:
            return True
        time.sleep(0.02)
    return False


def test_a_worker_talks_to_the_driver(port):
    (ref,) = rt.get(rt.remote(put_and_return).remote(200_000), timeout=60)
    np.testing.assert_array_equal(rt.get(ref), np.arange(200_000))
    job, name, refused = rt.get(rt.remote(name="ctx")(context).remote(), timeout=60)
    assert job == rt.get_runtime_context().get_job_id() and name == "ctx"
    assert "inside a worker" in refused


def test_nothing_is_left_after_shutdown(ledger, tmp_path):
    from ray_tpu_torch._private import object_store, worker

    rt.init(num_cpus=4)
    try:
        kept = rt.put(np.ones(300_000))
        refs = [rt.remote(num_gpus=0.5)(hold).remote(str(tmp_path), n) for n in "ab"]
        refs.append(rt.remote(make).remote(100_000))
        rt.get(refs[2], timeout=60)
        deadline = time.monotonic() + 60  # shutdown ends the card tasks while they run
        while time.monotonic() < deadline and not all(
                (tmp_path / f"{n}.started").exists() for n in "ab"):
            time.sleep(0.02)
        pids = worker.driver().pool.pids()
        assert len(pids) == 3 and len(ledger.holders()) == 2
        assert len(object_store.driver_segments()) == 2
    finally:
        rt.shutdown()
    assert all(_dead(p) for p in pids)
    assert ledger.holders() == []
    assert object_store.driver_segments() == []
    assert not rt.is_initialized()
    del kept


def test_import_leaves_torch_out():
    code = ("import sys, ray_tpu_torch as rt\n"
            "rt.init, rt.remote, rt.get, rt.put, rt.ObjectRef, rt.TaskError, rt.nodes\n"
            "rt.cluster_resources, rt.placement_group\n"
            "assert 'torch' not in sys.modules, 'torch imported'\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       timeout=60)
    assert r.returncode == 0, r.stderr


# ---- the slice as a whole ---------------------------------------------------------------


@pytest.fixture(scope="module")
def conditioned_checkpoint(tmp_path_factory):
    """``graft_entry.conditioned_params`` of the tiny Llama, saved as the
    JAX package's checkpoint, which both engines read."""
    import torch

    from ray_tpu.train.checkpoint import save_pytree
    from ray_tpu_torch.graft_entry import conditioned_params
    from ray_tpu_torch.llm.config import resolve_llama_config
    from tests.test_torch_llm_batch import _config

    cfg = _config()
    mcfg = resolve_llama_config(cfg.model, cfg.engine, min_vocab=258)
    params = conditioned_params(mcfg, seed=5, device=torch.device("cpu"))
    d = tmp_path_factory.mktemp("core_ckpt")
    save_pytree({k: v.numpy() for k, v in params.items()}, str(d))
    return str(d)


def jax_tokens(config, prompts, sampling):
    """``generate_tokens`` through the JAX package's engine."""
    from ray_tpu.llm import SamplingParams
    from ray_tpu.llm.engine import JaxEngine

    eng = JaxEngine(config)
    try:
        reqs = [eng.submit(p, sampling_params=SamplingParams(**sampling)) for p in prompts]
        for r in reqs:
            eng._await_done(r)
        return [list(r.out_tokens) for r in reqs]
    finally:
        eng.shutdown()


def test_a_remote_task_runs_the_ports_engine_with_jax_engines_tokens(
        conditioned_checkpoint, jax_process, port):
    from tests.test_torch_llm_batch import _config, _jax_config

    cfg = _config(conditioned_checkpoint)
    prompts = [f"core row {i}" for i in range(4)]
    want = jax_process.get(jax_process.remote(jax_tokens).remote(
        _jax_config(cfg), prompts, SAMPLING), timeout=150)
    got = rt.get(rt.remote(generate_tokens).remote(cfg, prompts, SAMPLING), timeout=120)
    assert got == want  # exact: greedy tokens, tolerance 0
    assert all(len(t) == SAMPLING["max_tokens"] for t in got)
