"""The process handle that Serve's replicas run on
(``ray_tpu_torch/_private/process_actor.py``), extended for them, on the CPU:

- ``max_concurrency=n`` runs n calls at once in the child, so calls sent
  together reach one ``@serve.batch`` batch (with 1 they cannot);
- ``max_concurrency=1`` (the default, which RLlib's and Data's actors
  use) keeps the order the calls were sent in, streams included;
- ``call_stream``: chunks arrive while the method still runs; a consumer
  that drops its stream stops the producer within the stream's window; a
  stream whose process is killed ends with ``ActorDiedError`` instead of
  hanging; a generator that raises ends its stream with ``RemoteError``
  after the chunks it gave;
- any number of threads may call, ``get`` and ``wait`` on one actor;
- a driver that is SIGKILLed leaves no replica and no lease: the replicas'
  call pipes close and they exit.

The hosted classes are module level (the children import this module by
name); no child process is left after the module.
"""

import gc
import multiprocessing
import os
import signal
import threading
import time

import pytest

from ray_tpu_torch._private.process_actor import (STREAM_WINDOW, ActorDiedError, ProcessActor,
                                                  RemoteError, get, wait)
from ray_tpu_torch.serve import batch

pytestmark = pytest.mark.timeout(300)


class Host:
    """A hosted object with a batched method, generators and a log."""

    def __init__(self):
        self.log = []
        self.produced = 0

    @batch(max_batch_size=4, batch_wait_timeout_s=5.0)
    def add_batched(self, xs):
        return [(x + 1, len(xs)) for x in xs]

    def add_single(self, x):
        return self.add_batched_fast(x)

    @batch(max_batch_size=4, batch_wait_timeout_s=0.2)
    def add_batched_fast(self, xs):
        return [(x + 1, len(xs)) for x in xs]

    def append(self, x):
        self.log.append(x)
        return len(self.log)

    def snapshot(self):
        return list(self.log)

    def log_stream(self, n):
        """Yields the log as it stands, n times."""
        for _ in range(n):
            yield list(self.log)

    def slow_stream(self, gap_s):
        yield 0
        time.sleep(gap_s)
        yield 1

    def endless(self):
        i = 0
        while True:
            self.produced += 1
            yield i
            i += 1

    def produced_count(self):
        return self.produced

    def raising_stream(self):
        yield "a"
        yield "b"
        raise ValueError("mid-stream")

    def pid(self):
        return os.getpid()


@pytest.fixture(scope="module")
def actors():
    """One actor running 6 calls at once, one running them in order."""
    pool = ProcessActor(Host, name="host-pool", max_concurrency=6)
    ordered = ProcessActor(Host, name="host-ordered")
    get([pool.ready, ordered.ready], timeout=120)
    yield pool, ordered
    pool.kill()
    ordered.kill()
    deadline = time.monotonic() + 10
    while multiprocessing.active_children() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert [p for p in multiprocessing.active_children()
            if p.name.startswith("host-")] == []


def test_concurrent_calls_reach_a_batch(actors):
    pool, ordered = actors
    outs = get([pool.call("add_batched", i) for i in range(4)], timeout=60)
    assert outs == [(i + 1, 4) for i in range(4)]  # one batch of 4
    # one call at a time: each waits out the batch timeout alone
    outs = get([ordered.call("add_single", i) for i in range(3)], timeout=60)
    assert outs == [(i + 1, 1) for i in range(3)]


def test_max_concurrency_one_keeps_call_order_streams_included(actors):
    _, ordered = actors
    first = [ordered.call("append", i) for i in range(50)]
    stream = ordered.call_stream("log_stream", 2)
    rest = [ordered.call("append", i) for i in range(50, 100)]
    assert get(first + rest, timeout=60)[-1] == len(get(ordered.call("snapshot")))
    seen = list(stream)
    # the stream ran between the 50th and the 51st append, as sent
    assert [len(s) for s in seen] == [len(get(ordered.call("snapshot"))) - 50] * 2
    assert get(ordered.call("snapshot"))[-100:] == list(range(100))


def test_stream_chunks_arrive_before_the_method_ends(actors):
    pool, _ = actors
    t0 = time.monotonic()
    stream = pool.call_stream("slow_stream", 3.0)
    assert stream.next(timeout=60) == 0
    assert time.monotonic() - t0 < 2.5, "the first chunk waited for the method's end"
    assert not stream.done
    assert list(stream) == [1]
    assert stream.done and stream.finished


def test_abandoned_stream_stops_its_producer(actors):
    pool, _ = actors
    base = get(pool.call("produced_count"))
    stream = pool.call_stream("endless")
    assert [stream.next(timeout=60) for _ in range(3)] == [0, 1, 2]
    del stream
    gc.collect()
    deadline = time.monotonic() + 30
    counts = []
    while time.monotonic() < deadline:
        counts.append(get(pool.call("produced_count")) - base)
        if len(counts) >= 3 and counts[-1] == counts[-3]:
            break
        time.sleep(0.2)
    # the producer ran at most its window ahead of what was taken, then stopped
    assert counts[-1] == counts[-3] and counts[-1] <= 3 + STREAM_WINDOW + 1, counts


def test_stream_error_ends_the_stream_after_its_chunks(actors):
    pool, _ = actors
    stream = pool.call_stream("raising_stream")
    assert [stream.next(timeout=60), stream.next(timeout=60)] == ["a", "b"]
    with pytest.raises(RemoteError, match="ValueError: mid-stream"):
        stream.next(timeout=60)


def test_many_threads_call_get_and_wait_on_one_actor(actors):
    pool, _ = actors
    errors, results = [], {}

    def worker(k):
        try:
            hs = [pool.call("add_batched_fast", 100 * k + i) for i in range(8)]
            done, rest = wait(hs, num_returns=8, timeout=60)
            assert rest == []
            results[k] = [v for v, _ in get(hs)]
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert errors == []
    assert results == {k: [100 * k + i + 1 for i in range(8)] for k in range(6)}


def test_stream_of_a_killed_actor_raises_actor_died():
    a = ProcessActor(Host, name="host-doomed", max_concurrency=2)
    try:
        stream = a.call_stream("slow_stream", 60.0)
        assert stream.next(timeout=120) == 0
        os.kill(a.pid, signal.SIGKILL)
        t0 = time.monotonic()
        with pytest.raises(ActorDiedError, match="exited with code -9 before slow_stream"):
            stream.next(timeout=60)
        assert time.monotonic() - t0 < 10.0
        with pytest.raises(ActorDiedError):
            next(a.call_stream("slow_stream", 0.0))
    finally:
        a.kill()
    assert a._proc.exitcode is not None


_DRIVER = """
import sys, time
from ray_tpu_torch import serve
from ray_tpu_torch._private.cards import CardLedger, use_ledger
from tests.test_torch_serve_actor import Host

with use_ledger(CardLedger(sys.argv[1], cards=[], cpus=4)):
    h = serve.run(serve.deployment(Host, num_replicas=2,
                                   ray_actor_options={"resources": {"CPU": 1}}).bind())
    h.pid.remote().result(timeout_s=120)
    from ray_tpu_torch.serve import api
    while len(api._controller.get_replicas_versioned("Host")[1]) < 2:
        time.sleep(0.05)
    print(" ".join(str(a.pid) for a in api._controller.replicas("Host").values()), flush=True)
    time.sleep(600)
"""


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def test_a_killed_driver_leaves_no_replica_and_no_lease(tmp_path):
    """The driver SIGKILLed: its replicas' call pipes close, they exit, and
    their leases end with them."""
    import subprocess
    import sys

    from ray_tpu_torch._private.cards import CardLedger

    root = str(tmp_path / "ledger")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    driver = subprocess.Popen([sys.executable, "-c", _DRIVER, root], cwd=repo,
                              stdout=subprocess.PIPE, text=True,
                              env={**os.environ, "PYTHONPATH": repo})
    try:
        pids = [int(p) for p in driver.stdout.readline().split()]
        assert len(pids) == 2 and all(_alive(p) for p in pids)
        assert len(CardLedger(root, cards=[], cpus=4).holders()) == 2
    finally:
        driver.kill()
        driver.wait(30)
    deadline = time.monotonic() + 30
    while any(_alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not any(_alive(p) for p in pids)
    assert CardLedger(root, cards=[], cpus=4).holders() == []
