"""``ray_tpu_torch.util``'s placement groups, scheduling strategies,
``ActorPool`` and ``Queue`` against the JAX package's ``ray_tpu.util`` (the
thread-mode runtime), on the CPU: the mirrors of
``tests/test_rllib.py:175-211`` (a pool and a queue, the queue passed to
another process) and ``tests/test_core_api.py:280`` (a pending group placed
once capacity frees), STRICT_SPREAD on one host, the validation errors; and
the port's own: a reservation never overlaps a ``WorkerGroup``'s leases,
a killed actor's bundle stays reserved, removal ends the group's actors
and leaves no lease.

The port's side runs on a card ledger of its own (8 CPU slots, no card;
one fake card where a GPU share is leased and nothing spawned). Its
actors are module level; this module imports neither JAX nor ray_tpu at
its top.
"""

import multiprocessing
import threading
import time

import pytest

from ray_tpu_torch._private.cards import CardLedger, LedgerError, use_ledger
from ray_tpu_torch._private.process_actor import ProcessActor, get, start_all

pytestmark = pytest.mark.timeout(300)


class Sq:
    def sq(self, x):
        return x * x

    def fail(self, x):
        raise ValueError(f"bad {x}")


def producer(queue):
    queue.put(42)
    return True


def current_group():
    from ray_tpu_torch.util import get_current_placement_group

    pg = get_current_placement_group()
    return None if pg is None else (pg.id, pg.bundle_specs, pg.strategy)


def _pool_and_queue(ActorPool, Queue, Empty, sq, actors, run_producer):
    """The scenario of ``tests/test_rllib.py:175-211``, for either package."""
    out = {}
    pool = ActorPool(actors)
    out["map"] = list(pool.map(sq, range(6)))
    out["unordered"] = sorted(pool.map_unordered(sq, range(4)))
    q = Queue(maxsize=2)
    q.put("a")
    q.put("b")
    try:
        q.put("c", block=False)
        out["full_raised"] = False
    except Exception:  # noqa: BLE001 — the reference's pytest.raises(Exception)
        out["full_raised"] = True
    out["gets"] = [q.get(), q.qsize(), q.get()]
    try:
        q.get_nowait()
        out["empty_raised"] = False
    except Empty:
        out["empty_raised"] = True
    out["producer"] = run_producer(q)
    out["after_producer"] = q.get(timeout=10)
    q.put_nowait_batch([1, 2])
    out["batch"] = [q.get_nowait_batch(5), q.empty()]
    q.shutdown()
    return out


@pytest.fixture(scope="module")
def ledger(tmp_path_factory):
    led = CardLedger(str(tmp_path_factory.mktemp("ledger")), cards=[], cpus=8)
    with use_ledger(led):
        yield led
    assert led.holders() == []


@pytest.fixture(scope="module")
def placed(ledger):
    """A group of two CPU bundles and a ``Sq`` actor placed in each."""
    from ray_tpu_torch.util import placement_group, remove_placement_group
    from ray_tpu_torch.util.scheduling_strategies import PlacementGroupSchedulingStrategy

    pg = placement_group([{"CPU": 1}, {"CPU": 1}], strategy="STRICT_PACK", name="pool")
    assert pg.ready(timeout=10)
    actors = start_all([ProcessActor(Sq, scheduling_strategy=PlacementGroupSchedulingStrategy(
        pg, i)) for i in range(2)])
    yield pg, actors
    remove_placement_group(pg)


def test_actor_pool_and_queue_equal_jax(ray_start_thread, placed):
    import ray_tpu
    from ray_tpu.util.actor_pool import ActorPool as JPool
    from ray_tpu.util.queue import Empty as JEmpty, Queue as JQueue

    from ray_tpu_torch.util.actor_pool import ActorPool
    from ray_tpu_torch.util.queue import Empty, Queue

    @ray_tpu.remote
    class JSq:
        def sq(self, x):
            return x * x

    @ray_tpu.remote
    def jproducer(queue):
        queue.put(42)
        return True

    jax_out = _pool_and_queue(JPool, JQueue, JEmpty, lambda a, v: a.sq.remote(v),
                              [JSq.remote(), JSq.remote()],
                              lambda q: ray_tpu.get(jproducer.remote(q), timeout=60))
    _, actors = placed
    # the producer runs in another port process, the queue passed as its argument
    port_out = _pool_and_queue(ActorPool, Queue, Empty, lambda a, v: a.call("sq", v), actors,
                               lambda q: get(actors[1].call(producer, q), timeout=60))
    assert port_out == jax_out
    assert port_out["map"] == [0, 1, 4, 9, 16, 25] and port_out["after_producer"] == 42


def test_actor_pool_timeout_keeps_the_call_and_a_failure_frees_the_actor(placed):
    from ray_tpu_torch.util.actor_pool import ActorPool

    _, actors = placed
    pool = ActorPool(actors)
    pool.submit(lambda a, v: a.call(time.sleep, v), 0.5)
    with pytest.raises(TimeoutError):
        pool.get_next(timeout=0.01)
    assert pool.has_next()  # retained: the call is retryable
    assert pool.get_next(timeout=30) is None
    pool.submit(lambda a, v: a.call("fail", v), 1)
    with pytest.raises(Exception, match="bad 1"):
        pool.get_next(timeout=30)
    assert not pool.has_next() and pool.has_free()  # consumed; the actor is back
    assert list(pool.map(lambda a, v: a.call("sq", v), [3, 4])) == [9, 16]


def test_current_group_inside_a_placed_actor(placed):
    from ray_tpu_torch.util import get_current_placement_group

    pg, actors = placed
    assert get_current_placement_group() is None  # the driver is placed in no group
    assert get(actors[0].call(current_group)) == (pg.id, [{"CPU": 1}, {"CPU": 1}], "STRICT_PACK")
    table = pg.table()
    assert (table["bundles"], table["strategy"], table["ready"]) == (
        [{"CPU": 1}, {"CPU": 1}], "STRICT_PACK", True)
    assert [len(a) for a in table["bundle_actors"]] == [1, 1]


def test_pending_group_placed_when_capacity_frees_equal_jax(ray_start_thread, tmp_path):
    """``tests/test_core_api.py:280``: a group asked for while a holder
    takes the whole host is placed once it lets go."""
    import ray_tpu

    from ray_tpu_torch.util import placement_group as port_pg

    @ray_tpu.remote(num_cpus=8)
    def hog():
        time.sleep(1.0)
        return True

    h = hog.remote()
    time.sleep(0.2)  # let it occupy the node first
    pg = ray_tpu.placement_group([{"CPU": 4}], strategy="PACK")
    jax_out = [pg.ready(timeout=0.2), pg.ready(timeout=30), ray_tpu.get(h, timeout=30)]

    led = CardLedger(str(tmp_path / "ledger"), cards=[], cpus=8)
    with use_ledger(led):
        held, = led.acquire([{"CPU": 8}], "hog")
        timer = threading.Timer(1.0, held.release)
        timer.start()
        pg = port_pg([{"CPU": 4}], strategy="PACK")
        port_out = [pg.ready(timeout=0.2), pg.ready(timeout=30), True]
        timer.join()
        assert [h.cpu for h in led.holders()] == [4.0]
        from ray_tpu_torch.util import remove_placement_group

        remove_placement_group(pg)
        assert led.holders() == []
    assert port_out == jax_out == [False, True, True]


def test_strict_spread_on_one_host_never_ready_equal_jax(ray_start_thread, tmp_path):
    import ray_tpu

    from ray_tpu_torch.util import placement_group, remove_placement_group

    jax_out = [ray_tpu.placement_group([{"CPU": 1}] * n, strategy="STRICT_SPREAD").ready(
        timeout=0.5) for n in (2, 1)]
    led = CardLedger(str(tmp_path / "ledger"), cards=[], cpus=8)
    with use_ledger(led):
        groups = [placement_group([{"CPU": 1}] * n, strategy="STRICT_SPREAD") for n in (2, 1)]
        port_out = [g.ready(timeout=0.5) for g in groups]
        assert [g.table()["state"] for g in groups] == ["PENDING", "CREATED"]
        for g in groups:
            remove_placement_group(g)
        assert led.holders() == []
    assert port_out == jax_out == [False, True]


@pytest.mark.parametrize("bundles,strategy", [
    ([{"CPU": 1}], "X"), ([], "PACK"), ([{}], "PACK"), ([{"CPU": -1}], "PACK")])
def test_placement_group_validation_equal_jax(ray_start_thread, bundles, strategy):
    import ray_tpu

    from ray_tpu_torch.util import placement_group

    with pytest.raises(ValueError) as jax_err:
        ray_tpu.placement_group(bundles, strategy=strategy)
    with pytest.raises(ValueError) as port_err:
        placement_group(bundles, strategy=strategy)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("bundle", [{"TPU": 1}, {"memory": 1}, {"GPU": 1.5}])
def test_bundles_name_cpu_and_gpu_only(bundle):
    from ray_tpu_torch.util import placement_group

    with pytest.raises(ValueError):
        placement_group([bundle])


def test_reservation_and_worker_group_leases_never_overlap(tmp_path):
    """A group's bundles and a ``WorkerGroup``'s rank leases come from one
    ledger: whichever holds the card first, the other waits or raises."""
    from ray_tpu_torch.train.config import ScalingConfig
    from ray_tpu_torch.train._internal.worker_group import lease_ranks
    from ray_tpu_torch.util import placement_group, remove_placement_group

    led = CardLedger(str(tmp_path / "ledger"), cards=["0"], cpus=8)
    scaling = ScalingConfig(num_workers=1, use_gpu=True)
    with use_ledger(led):
        # the group first: a rank cannot lease the card it reserves
        pg = placement_group([{"GPU": 0.5}, {"GPU": 0.5}], strategy="STRICT_PACK")
        assert pg.ready(timeout=5)
        assert sorted(h.gpu["0"] for h in led.holders()) == [0.5, 0.5]
        with pytest.raises(LedgerError):
            lease_ranks(scaling, 1)
        remove_placement_group(pg)
        assert led.holders() == []
        # the rank first: the group stays pending until the rank's lease ends
        lease, = lease_ranks(scaling, 1)
        pg = placement_group([{"GPU": 0.5}], strategy="PACK")
        assert not pg.ready(timeout=0.3)
        assert [h.gpu for h in led.holders()] == [{"0": 1.0}]
        lease.release()
        assert pg.ready(timeout=5)
        assert [h.gpu for h in led.holders()] == [{"0": 0.5}]
        remove_placement_group(pg)
        assert led.holders() == []


def test_killed_actor_keeps_its_bundle_and_removal_ends_the_rest(ledger):
    from ray_tpu_torch.util import placement_group, remove_placement_group
    from ray_tpu_torch.util.scheduling_strategies import PlacementGroupSchedulingStrategy

    pg = placement_group([{"CPU": 2}, {"CPU": 1}], strategy="PACK", name="ends")
    assert pg.ready(timeout=10)
    name = "placement group ends"
    # -1 takes the bundle with the fewest live actors: 0, then 1
    actors = start_all([ProcessActor(Sq, scheduling_strategy=PlacementGroupSchedulingStrategy(pg))
                        for _ in range(2)])
    assert [len(a) for a in pg.table()["bundle_actors"]] == [1, 1]
    pids = [a.pid for a in actors]
    actors[0].kill()
    assert sorted(h.cpu for h in ledger.holders() if h.name == name) == [1.0, 2.0]
    assert get(actors[1].call("sq", 3)) == 9
    remove_placement_group(pg)
    assert not actors[1].is_alive()
    assert [h for h in ledger.holders() if h.name == name] == []
    assert not {p.pid for p in multiprocessing.active_children()} & set(pids)
    assert pg.table()["state"] == "REMOVED" and not pg.ready(timeout=0.1)
    with pytest.raises(RuntimeError, match="removed"):
        ProcessActor(Sq, scheduling_strategy=PlacementGroupSchedulingStrategy(pg, 0))


def test_strategies_on_one_host(ledger):
    from ray_tpu_torch._private.registry import registry
    from ray_tpu_torch.util import placement_group, remove_placement_group
    from ray_tpu_torch.util.scheduling_strategies import (NodeAffinitySchedulingStrategy,
                                                          PlacementGroupSchedulingStrategy,
                                                          SpreadSchedulingStrategy, resolve)

    node = registry().node_id
    assert resolve(NodeAffinitySchedulingStrategy(node), None) is None
    assert resolve(NodeAffinitySchedulingStrategy("ab" * 14, soft=True), None) is None
    assert resolve(SpreadSchedulingStrategy(), None) is None
    with pytest.raises(ValueError, match="not this host's node"):
        resolve(NodeAffinitySchedulingStrategy("ab" * 14), None)
    pending = placement_group([{"CPU": 100}])
    try:
        with pytest.raises(RuntimeError, match="pending"):
            resolve(PlacementGroupSchedulingStrategy(pending, 0), None)
        held, = ledger.acquire([{"CPU": 1}], "a lease of its own")
        try:
            with pytest.raises(ValueError, match="no lease of its own"):
                resolve(PlacementGroupSchedulingStrategy(pending, 0), held)
        finally:
            held.release()
    finally:
        # a group left PENDING is demand the autoscaler's tests would read
        remove_placement_group(pending)


def test_a_queue_reaches_its_host_only_through_its_creator(ledger):
    """A copy of a ``Queue`` in a process its creator did not spawn has no
    way to the host: it raises instead of carrying the items."""
    import pickle

    from ray_tpu_torch.util.queue import Queue

    q = Queue(maxsize=4, actor_options={"name": "copy-test"})
    try:
        q.put_nowait_batch([1, 2])
        copy = pickle.loads(pickle.dumps(q))  # in the creator: its own server, in place
        assert copy.actor is None and copy.qsize() == 2 and copy.get() == 1
        copy._address = "\0elsewhere"
        with pytest.raises(RuntimeError, match="not spawned by it"):
            copy.qsize()
        assert q.get() == 2 and q.empty()
    finally:
        q.shutdown()
