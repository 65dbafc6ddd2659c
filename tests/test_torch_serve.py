"""The port's Serve runtime (``ray_tpu_torch/serve/``) against the JAX
package's (``ray_tpu.serve`` in its thread-mode runtime), on the CPU: the
mirrors of ``tests/test_serve.py``.

Each test runs the same deployments and the same requests behind both and
compares what comes back: replies, stream chunks in order, the batch sizes
the handler saw, the autoscaler's decisions. The port's replicas are
processes of their own (``ProcessActor``s) leasing from a card ledger of the
module's own (``use_ledger``; no card, 8 CPU slots); one serve instance
serves the module, its apps deployed together at the start so that their
replicas start at once. After each test every child process is a replica
the controller holds, and every lease is one of theirs; after the module,
none is left.

The deployment classes and functions are module level (replicas import
this module by name), and this module imports neither JAX nor ray_tpu at
its top. The port's rules have tests of their own: a lambda, a closure or
a class defined in a function raises ``TypeError`` at ``serve.run``; a
replica leases what its deployment names, and one that cannot lease leaves
the deployment short, never on the CPU in its place.
"""

import asyncio
import gc
import multiprocessing
import os
import signal
import threading
import time
import types

import pytest

from ray_tpu_torch._private.cards import CardLedger, use_ledger
from ray_tpu_torch.serve import batch as port_batch
from ray_tpu_torch.serve import multiplexed as port_multiplexed

pytestmark = pytest.mark.timeout(300)


# ---- deployments (module level: the port's replicas import them by name) ----


def double(x):
    return x * 2


class Counter:
    def __init__(self, start):
        self.n = start

    def incr(self, k):
        self.n += k
        return self.n

    def __call__(self, req):
        return self.n


class WhoAmI:
    def __init__(self):
        self.ident = f"{os.getpid()}-{id(self)}"

    def __call__(self, req):
        return self.ident


class Adder:
    def __init__(self, offset):
        self.offset = offset

    def __call__(self, x):
        return x + self.offset


class Combiner:
    def __init__(self, a, b):
        self.a = a
        self.b = b

    def __call__(self, x):
        ra = self.a.remote(x)
        rb = self.b.remote(x)
        return ra.result() + rb.result()

    def chained(self, x):
        """A response passed on as another call's argument."""
        return self.b.remote(self.a.remote(x)).result()

    def streamed(self, n):
        """A streaming handle's chunks, relayed from another replica."""
        return list(self.a.options(stream=True).tokens.remote(n))


class TokenAdder(Adder):
    def tokens(self, n):
        for i in range(n):
            yield i + self.offset


class PortBatched:
    @port_batch(max_batch_size=4, batch_wait_timeout_s=5.0)
    def handle_batch(self, xs):
        return [(x, len(xs)) for x in xs]

    def __call__(self, x):
        return self.handle_batch(x)


class PortMultiModel:
    @port_multiplexed(max_num_models_per_replica=2)
    def get_model(self, model_id):
        return {"id": model_id, "loaded_at": time.time()}

    def __call__(self, model_id):
        from ray_tpu_torch.serve import get_multiplexed_model_id

        m = self.get_model(model_id)
        return (m["id"], get_multiplexed_model_id())


class Tokens:
    def __call__(self, n):
        for i in range(n):
            yield {"tok": i}
            if i == 0:
                time.sleep(3.0)  # long gap AFTER the first chunk


class Infinite:
    def __init__(self):
        self.produced = 0

    def __call__(self):
        i = 0
        while True:  # unbounded: only the consumer's going can stop it
            self.produced += 1
            yield {"i": i}
            i += 1

    def count(self):
        return self.produced


class Chunks:
    def __call__(self, n):
        for i in range(n):
            yield i


class Async:
    async def __call__(self, x):
        await asyncio.sleep(0.01)
        return {"doubled": x * 2}

    async def ticks(self, n):
        for i in range(n):
            await asyncio.sleep(0.01)
            yield i


class Plain:
    def __call__(self, req):
        return "ok"


class SlowStart:
    def __init__(self):
        time.sleep(2.0)  # >> health_check_timeout_s

    def __call__(self, req):
        return "ready"


class Stuck:
    def __init__(self):
        time.sleep(120)  # far past the declared budget

    def __call__(self, req):
        return None


class Versioned:
    def __init__(self, version):
        self.version = version

    def __call__(self):
        return self.version


class Sleepy:
    def __call__(self, seconds):
        time.sleep(seconds)
        return "slept"


# ---- the two runtimes -------------------------------------------------------


@pytest.fixture
def jserve():
    """The JAX package's Serve on a thread-mode runtime of the test's own
    (as ``tests/test_serve.py`` runs it: its state does not carry over)."""
    import ray_tpu
    from ray_tpu import serve

    ray_tpu.init(num_cpus=8, mode="thread")
    yield serve
    serve.shutdown()
    ray_tpu.shutdown()


def _port_apps(ts):
    """The module's port apps, deployed together."""
    dep = ts.deployment
    return {
        "fn": dep(double).bind(),
        "counter": dep(Counter).bind(10),
        "who": dep(WhoAmI, num_replicas=2).bind(),
        "comp": dep(Combiner).bind(dep(Adder, name="add1").bind(1),
                                   dep(Adder, name="add100").bind(100)),
        "comp_stream": dep(Combiner, name="CombinerS").bind(
            dep(TokenAdder, name="tok10").bind(10), dep(Adder, name="add1000").bind(1000)),
        "batched": dep(PortBatched, max_ongoing_requests=16).bind(),
        "mm": dep(PortMultiModel).bind(),
        "tok": dep(Tokens).bind(),
        "inf": dep(Infinite).bind(),
        "chk": dep(Chunks).bind(),
        "async": dep(Async).bind(),
        "fragile": dep(Plain, name="Fragile",
                       ray_actor_options={"resources": {"CPU": 1}}).bind(),
    }


def _serve_children() -> list:
    return [p for p in multiprocessing.active_children() if p.name.startswith("serve:")]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    from ray_tpu_torch import serve as ts

    ledger = CardLedger(str(tmp_path_factory.mktemp("ledger")), cards=[], cpus=8)
    with use_ledger(ledger):
        handles = {name: ts.run(app, name=name) for name, app in _port_apps(ts).items()}
        try:
            yield types.SimpleNamespace(serve=ts, ledger=ledger, handles=handles)
        finally:
            ts.shutdown()
        deadline = time.monotonic() + 10
        while _serve_children() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert _serve_children() == []
        assert ledger.holders() == []


def _controller():
    from ray_tpu_torch.serve import api

    return api._controller


@pytest.fixture(autouse=True)
def _only_the_instances_replicas_left(request):
    """After each test: every serve child process is a replica the
    controller holds, and every lease of the module's ledger is one of
    theirs (killed and replaced replicas are gone, with their leases)."""
    yield
    if "port" not in request.fixturenames:
        return
    ctrl = _controller()
    deadline = time.monotonic() + 15
    while True:
        live = {a.pid for d in list(ctrl._deployments) for a in ctrl.replicas(d).values()}
        children = {p.pid for p in _serve_children()}
        holders = {h.pid for h in request.getfixturevalue("port").ledger.holders()}
        if (children <= live and holders <= live) or time.monotonic() > deadline:
            break
        time.sleep(0.1)
    assert children <= live, f"serve processes left that no deployment holds: {children - live}"
    assert holders <= live, f"leases left that no replica holds: {holders - live}"


def _ready(deployment: str, n: int = 1, timeout_s: float = 120.0) -> None:
    """Wait until ``n`` of the port deployment's replicas have constructed."""
    deadline = time.monotonic() + timeout_s
    while len(_controller().get_replicas_versioned(deployment)[1]) < n:
        assert time.monotonic() < deadline, f"{deployment}: not {n} replicas ready"
        time.sleep(0.05)


# ---- mirrors of tests/test_serve.py -------------------------------------------


def test_function_and_class_deployments(jserve, port):
    jd = jserve.run(jserve.deployment(double).bind(), name="fn")
    jc = jserve.run(jserve.deployment(Counter).bind(10), name="counter")
    pd, pc = port.handles["fn"], port.handles["counter"]
    got = {}
    for side, (d, c) in (("jax", (jd, jc)), ("port", (pd, pc))):
        got[side] = [d.remote(21).result(timeout_s=120), c.incr.remote(5).result(timeout_s=120),
                     c.incr.remote(5).result(timeout_s=60), c.remote(None).result(timeout_s=60)]
    assert got["port"] == got["jax"] == [42, 15, 20, 20]


def test_multiple_replicas_roundrobin(jserve, port):
    jh = jserve.run(jserve.deployment(WhoAmI, num_replicas=2).bind(), name="who")
    ph = port.handles["who"]
    _ready("WhoAmI", 2)
    jids = {jh.remote(None).result(timeout_s=60) for _ in range(20)}
    pids = {ph.remote(None).result(timeout_s=60) for _ in range(20)}
    assert len(jids) == len(pids) == 2  # both replicas served
    # the port's replicas are processes of their own
    assert len({i.split("-")[0] for i in pids}) == 2


def test_composition(jserve, port):
    jdep = jserve.deployment
    japp = jdep(Combiner).bind(jdep(Adder, name="add1").bind(1),
                               jdep(Adder, name="add100").bind(100))
    jh = jserve.run(japp, name="comp")
    ph = port.handles["comp"]
    assert ph.remote(0).result(timeout_s=120) == jh.remote(0).result(timeout_s=60) == 101
    # a response passed on as an argument: resolved first in the port
    assert ph.chained.remote(5).result(timeout_s=60) == jh.chained.remote(5).result(
        timeout_s=60) == 106
    # a streaming handle inside a replica, its chunks relayed through the
    # driver: the chunks JAX's handle streams from the same deployment
    jtok = jserve.run(jdep(TokenAdder, name="tok10").bind(10), name="tok10")
    want = list(jtok.options(stream=True).tokens.remote(4))
    assert port.handles["comp_stream"].streamed.remote(4).result(timeout_s=120) == want
    assert want == [10, 11, 12, 13]
    # binding the same name twice with different args is an explicit error
    for s in (jserve, port.serve):
        with pytest.raises(ValueError, match="bound more than once"):
            s.deployment(Combiner).bind(s.deployment(Adder).bind(1),
                                        s.deployment(Adder).bind(2)).walk()


def test_deployment_options_override(jserve, port):
    for s in (jserve, port.serve):
        d = s.deployment(double).options(num_replicas=2, name="renamed")
        assert (d.name, d.config.num_replicas) == ("renamed", 2)
        auto = s.deployment(double).options(num_replicas="auto")
        assert auto.config.autoscaling_config == s.AutoscalingConfig()
        with pytest.raises(ValueError, match="unknown deployment option"):
            s.deployment(double).options(not_an_option=1)


def test_status_and_delete(jserve, port):
    seen = {}
    for side, s in (("jax", jserve), ("port", port.serve)):
        s.run(s.deployment(double, name="g").bind(), name="app1")
        st = s.status()
        seen[side] = {k: st["applications"]["app1"]["deployments"]["g"][k]
                      for k in ("replicas", "target")}
        s.delete("app1")
        assert "app1" not in s.status()["applications"]
    assert seen["port"] == seen["jax"] == {"replicas": 1, "target": 1}
    assert _controller().get_replica_names("g") == []


def test_batching(jserve, port):
    from ray_tpu import serve

    @serve.deployment(max_ongoing_requests=16)
    class Batched:
        @serve.batch(max_batch_size=4, batch_wait_timeout_s=5.0)
        def handle_batch(self, xs):
            return [(x, len(xs)) for x in xs]

        def __call__(self, x):
            return self.handle_batch(x)

    jh = jserve.run(Batched.bind(), name="batched")
    ph = port.handles["batched"]
    _ready("PortBatched")
    out = {}
    for side, h in (("jax", jh), ("port", ph)):
        out[side] = []
        for start in (0, 4):  # two bursts of 4: one batch of 4 each
            responses = [h.remote(i) for i in range(start, start + 4)]
            out[side] += [tuple(r.result(timeout_s=120)) for r in responses]
    assert out["port"] == out["jax"] == [(i, 4) for i in range(8)]


def test_multiplex(jserve, port):
    from ray_tpu import serve

    @serve.deployment
    class MultiModel:
        @serve.multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id):
            return {"id": model_id, "loaded_at": time.time()}

        def __call__(self, model_id):
            m = self.get_model(model_id)
            return (m["id"], serve.get_multiplexed_model_id())

    jh = jserve.run(MultiModel.bind(), name="mm")
    ph = port.handles["mm"]
    ids = ["a", "b", "a", "c", "b"]
    want = [tuple(jh.remote(i).result(timeout_s=60)) for i in ids]
    got = [tuple(ph.remote(i).result(timeout_s=120)) for i in ids]
    assert got == want == [(i, i) for i in ids]


def test_starting_verdict_state_machine():
    from ray_tpu.serve.controller import ServeControllerActor
    from ray_tpu_torch.serve.controller import ServeController

    jv, pv = ServeControllerActor._starting_verdict, ServeController._starting_verdict
    now = 1000.0
    grid = [(state, started, alive, grace)
            for state in ("DEAD", "ALIVE", "PENDING", "RESTARTING", None)
            for started in (now - 10_000, now - 61, now - 10, now - 5)
            for alive in (None, now - 31, now - 5)
            for grace in (None, 60.0)]
    for args in grid:
        assert pv(*args, 30.0, now) == jv(*args, 30.0, now), args
    assert pv("PENDING", now - 10_000, None, None, 30.0, now) == "wait"
    assert pv("PENDING", now - 61, None, 60.0, 30.0, now) == "replace"
    assert pv("ALIVE", now - 10_000, now - 31, None, 30.0, now) == "replace"


def test_slow_start_not_killed_while_constructing(jserve, port):
    for s in (jserve, port.serve):
        d = s.deployment(SlowStart, health_check_period_s=0.1, health_check_timeout_s=0.2)
        h = s.run(d.bind(), name="slowstart")
        assert h.remote(None).result(timeout_s=120) == "ready"
    import ray_tpu

    jnames = ray_tpu.get(ray_tpu.get_actor("serve-controller").get_replica_names.remote(
        "SlowStart"), timeout=10)
    assert jnames == _controller().get_replica_names("SlowStart") == ["serve:SlowStart#0"]
    port.serve.delete("slowstart")
    jserve.delete("slowstart")


def test_slow_start_grace_bounds_stuck_init(jserve, port):
    import ray_tpu

    for side, s in (("jax", jserve), ("port", port.serve)):
        d = s.deployment(Stuck, initial_health_grace_s=0.5, health_check_period_s=0.1,
                         health_check_timeout_s=0.2)
        s.run(d.bind(), name="stuck", _wait_for_ready_s=30)
        jctl = ray_tpu.get_actor("serve-controller")
        deadline = time.time() + 60
        while True:
            names = (ray_tpu.get(jctl.get_replica_names.remote("Stuck"), timeout=10)
                     if side == "jax" else _controller().get_replica_names("Stuck"))
            if names and "serve:Stuck#0" not in names:
                break  # the original replica was reaped and replaced
            assert time.time() < deadline, f"{side}: stuck replica outlived its grace: {names}"
            time.sleep(0.2)
        s.delete("stuck")
    assert any(e[1] == "Stuck" and e[2] == "replaced" for e in _controller().events)


def _recovered(handle, timeout_s=60.0):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        try:
            return handle.remote("x").result(timeout_s=30)
        except Exception:  # noqa: BLE001 — the old replica's calls fail until replaced
            time.sleep(0.2)
    raise AssertionError("traffic did not recover")


def test_replica_failure_recovery(jserve, port):
    import ray_tpu

    jh = jserve.run(jserve.deployment(Plain, name="Fragile").bind(), name="fragile")
    assert jh.remote("x").result(timeout_s=60) == "ok"
    jctl = ray_tpu.get_actor("serve-controller")
    jnames = ray_tpu.get(jctl.get_replica_names.remote("Fragile"))
    ray_tpu.kill(ray_tpu.get_actor(jnames[0]))

    ph = port.handles["fragile"]
    assert ph.remote("x").result(timeout_s=120) == "ok"
    ctrl = _controller()
    (name, actor), = ctrl.replicas("Fragile").items()
    holder, = port.ledger.holders()
    assert holder.pid == actor.pid and holder.cpu == 1 and not holder.gpu
    os.kill(actor.pid, signal.SIGKILL)
    deadline = time.time() + 60
    while ctrl.get_replica_names("Fragile") in ([], [name]):
        assert time.time() < deadline, "controller did not replace the killed replica"
        time.sleep(0.2)
    assert _recovered(ph) == _recovered(jh) == "ok"
    (new_name, new_actor), = ctrl.replicas("Fragile").items()
    assert new_name != name and new_actor.pid != actor.pid
    # the lease came back with the replacement: one CPU slot, its pid
    assert [(h.pid, h.cpu) for h in port.ledger.holders()] == [(new_actor.pid, 1)]


def test_handle_streaming_response(jserve, port):
    from ray_tpu.serve.streaming import StreamStart as JStreamStart
    from ray_tpu_torch.serve.streaming import StreamStart

    jh = jserve.run(jserve.deployment(Tokens).bind(), name="tok")
    ph = port.handles["tok"]
    list(ph.options(stream=True).remote(1))  # the replica constructed
    out = {}
    for side, h, cls in (("jax", jh, JStreamStart), ("port", ph, StreamStart)):
        gen = h.options(stream=True).remote(4)
        t0 = time.monotonic()
        first = next(gen)
        assert time.monotonic() - t0 < 2.5, f"{side}: the first chunk was not streamed"
        assert isinstance(gen.stream_start, cls)  # absorbed, not yielded
        out[side] = [first] + list(gen)
    assert out["port"] == out["jax"] == [{"tok": i} for i in range(4)]


def test_abandoned_stream_releases_producer(jserve, port):
    ph = port.handles["inf"]
    gen = ph.options(stream=True).remote()
    assert [next(gen)["i"], next(gen)["i"]] == [0, 1]
    del gen
    gc.collect()
    deadline = time.monotonic() + 30
    counts = []
    while time.monotonic() < deadline:
        counts.append(ph.count.remote().result(timeout_s=30))
        if len(counts) >= 3 and counts[-1] == counts[-3]:
            break
        time.sleep(0.2)
    assert counts[-1] == counts[-3], f"the producer never stopped: {counts}"
    deadline = time.monotonic() + 15
    while any(ph._inflight.values()) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert all(v == 0 for v in ph._inflight.values())  # P2C sees an idle replica

    jh = jserve.run(jserve.deployment(Infinite).bind(), name="inf")
    jgen = jh.options(stream=True).remote()
    assert [next(jgen)["i"], next(jgen)["i"]] == [0, 1]
    del jgen
    gc.collect()
    deadline = time.monotonic() + 15
    while any(jh._inflight.values()) and time.monotonic() < deadline:
        time.sleep(0.2)
    assert all(v == 0 for v in jh._inflight.values())


def test_streaming_handle_survives_pickle(jserve, port):
    import pickle

    jh = jserve.run(jserve.deployment(Chunks).bind(), name="chk")
    for h in (jh, port.handles["chk"]):
        sh2 = pickle.loads(pickle.dumps(h.options(stream=True)))
        assert list(sh2.remote(3)) == [0, 1, 2]


def test_async_deployment_handlers(jserve, port):
    jh = jserve.run(jserve.deployment(Async).bind(), name="async")
    for h in (jh, port.handles["async"]):
        assert h.remote(21).result(timeout_s=120) == {"doubled": 42}
        assert list(h.options(stream=True).ticks.remote(3)) == [0, 1, 2]


def test_autoscaling_config_math(jserve, port):
    for s in (jserve, port.serve):
        ac = s.AutoscalingConfig(min_replicas=1, max_replicas=8, target_ongoing_requests=2)
        assert ac.desired_replicas(total_ongoing=8, current=2) == 4
        assert ac.desired_replicas(total_ongoing=0, current=4) == 1
        assert ac.desired_replicas(total_ongoing=100, current=4) == 8
    kw = dict(min_replicas=2, max_replicas=9, target_ongoing_requests=3,
              upscaling_factor=0.5, downscaling_factor=0.3)
    ja, pa = jserve.AutoscalingConfig(**kw), port.serve.AutoscalingConfig(**kw)
    for total in (0, 1, 5, 9, 17, 40, 200):
        for current in (0, 1, 2, 5, 9):
            assert pa.desired_replicas(total, current) == ja.desired_replicas(total, current)


class _Clock:
    def __init__(self):
        self.now = 1000.0

    def time(self):
        return self.now

    def sleep(self, s):
        self.now += s


def test_autoscaler_decisions_equal_jax(monkeypatch):
    """The same load, tick by tick, through both controllers' ``_autoscale``
    (the JAX one on stub replicas): the same target at every tick."""
    import ray_tpu
    from ray_tpu.serve import controller as jctl
    from ray_tpu_torch.serve import controller as pctl

    clock = _Clock()
    monkeypatch.setattr(jctl, "time", clock)
    monkeypatch.setattr(pctl, "time", clock)
    monkeypatch.setattr(ray_tpu, "get", lambda v, timeout=None: v)
    ac = dict(min_replicas=1, max_replicas=4, target_ongoing_requests=2.0,
              upscale_delay_s=1.0, downscale_delay_s=3.0, metrics_interval_s=0.5,
              upscaling_factor=1.0, downscaling_factor=1.0)
    spec = {"initial_replicas": 1, "autoscaling_config": ac}
    load = [0.0] * 4 + [10.0] * 8 + [3.0] * 6 + [0.0] * 16 + [7.0] * 3 + [0.0] * 12
    replicas_box = [1]

    def jreplica():
        return types.SimpleNamespace(get_metrics=types.SimpleNamespace(
            remote=lambda: {"ongoing": load_now[0] / replicas_box[0]}))

    j = jctl.ServeControllerActor.__new__(jctl.ServeControllerActor)
    j._lock = threading.RLock()
    j._deployments = {"d": jctl._DeploymentState("d", dict(spec))}
    p = pctl.ServeController.__new__(pctl.ServeController)
    p._lock = threading.RLock()
    p.events = []
    p._deployments = {"d": pctl._DeploymentState("d", dict(spec))}
    p._replica_metrics = lambda actors: [{"ongoing": load_now[0] / replicas_box[0]}
                                         for _ in actors]
    load_now, targets = [0.0], {"jax": [], "port": []}
    for ongoing in load:
        load_now[0] = ongoing
        for side, c in (("jax", j), ("port", p)):
            st = c._deployments["d"]
            st.replicas = {f"r{i}": jreplica() for i in range(replicas_box[0])}
            c._autoscale()
            targets[side].append(st.target)
        # the reconciler brings the replica count to the target a tick later
        replicas_box[0] = targets["jax"][-1]
        clock.sleep(0.5)
    assert targets["port"] == targets["jax"]
    assert max(targets["port"]) == 4 and targets["port"][-1] == 1
    assert [e[3]["to"] for e in p.events if e[2] == "target"] == [
        t for a, t in zip([1] + targets["port"], targets["port"]) if a != t]


def _target_trace(get_target, until: list, timeout_s: float) -> list:
    """The distinct targets seen, in order, until they read ``until``."""
    seen = [get_target()]
    deadline = time.monotonic() + timeout_s
    while seen[-len(until):] != until and time.monotonic() < deadline:
        t = get_target()
        if t != seen[-1]:
            seen.append(t)
        time.sleep(0.05)
    return seen


def test_autoscaling_live_scales_up_and_back(jserve, port):
    """Queue-depth autoscaling end to end: 4 concurrent 2 s requests drive
    1 -> 2 replicas, idleness brings them back to 1, in both runtimes."""
    ac = dict(min_replicas=1, max_replicas=2, target_ongoing_requests=1.0,
              upscale_delay_s=0.2, downscale_delay_s=2.0, metrics_interval_s=0.1)
    traces = {}
    for side, s in (("jax", jserve), ("port", port.serve)):
        h = s.run(s.deployment(Sleepy, autoscaling_config=ac, max_ongoing_requests=8).bind(),
                  name="auto")
        assert h.remote(0.0).result(timeout_s=120) == "slept"

        def target():
            return s.status()["applications"]["auto"]["deployments"]["Sleepy"]["target"]

        responses = [h.remote(2.0) for _ in range(4)]
        traces[side] = _target_trace(target, [1, 2, 1], 60)
        assert [r.result(timeout_s=60) for r in responses] == ["slept"] * 4
        deadline = time.monotonic() + 30  # the reconciler stops the second replica
        while (s.status()["applications"]["auto"]["deployments"]["Sleepy"]["replicas"] != 1
               and time.monotonic() < deadline):
            time.sleep(0.05)
        s.delete("auto")
    assert traces["port"] == traces["jax"] == [1, 2, 1]
    events = [(e[2], e[3]) for e in _controller().events if e[1] == "Sleepy"]
    assert [d["to"] for w, d in events if w == "target"] == [2, 1]
    assert sum(w == "start" for w, _ in events) == 2 and sum(w == "stop" for w, _ in events) == 1


def test_rolling_update_with_drain(jserve, port):
    """Re-deploying changed init args rolls the replicas: the new version
    serves, the old ones drain, and the deployment converges to RUNNING.
    The version travels in the init args (the port pickles by reference)."""
    for side, s in (("jax", jserve), ("port", port.serve)):
        d = s.deployment(Versioned, num_replicas=2).options(graceful_shutdown_timeout_s=2.0)
        h = s.run(d.bind("v1"), name="roll")
        assert h.remote().result(timeout_s=120) == "v1"
        s.run(d.bind("v2"), name="roll")

        def st():
            return s.status()["applications"]["roll"]["deployments"]["Versioned"]

        # the rollout has ended once v2 answers and the deployment reads
        # RUNNING (every replica on the new version) with 2 replicas: a v1
        # replica still in the set (not yet retired) could answer otherwise
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            if h.remote().result(timeout_s=60) == "v2" and all(
                    h.remote().result(timeout_s=60) == "v2" for _ in range(6)) and (
                    st()["status"], st()["replicas"]) == ("RUNNING", 2):
                break
            time.sleep(0.5)
        assert all(h.remote().result(timeout_s=60) == "v2" for _ in range(4)), side
        deadline = time.monotonic() + 60
        while (st()["status"], st()["replicas"]) != ("RUNNING", 2) and time.monotonic() < deadline:
            time.sleep(0.2)
        assert (st()["status"], st()["replicas"]) == ("RUNNING", 2), side
        s.delete("roll")
    stops = [e for e in _controller().events if e[1] == "Versioned" and e[2] == "stop"]
    assert len(stops) == 2  # both v1 replicas drained and stopped


# ---- the port's own rules ----------------------------------------------------


def test_lambda_closure_or_local_class_raise_type_error(port):
    ts = port.serve
    factor = 3

    def closure(x):
        return x * factor

    class Local:
        def __call__(self, x):
            return x

    names = set(_controller()._deployments)
    for target in (lambda x: x, closure, Local):
        with pytest.raises(TypeError, match="by reference"):
            ts.run(ts.deployment(target, name="refused").bind(), name="refused")
    with pytest.raises(TypeError, match="not a lambda or a closure"):
        ts.run(ts.deployment(Adder, name="refused").bind(lambda: 1), name="refused")
    assert set(_controller()._deployments) == names  # nothing started


def test_replica_leases_what_its_deployment_names(port, tmp_path):
    """A CPU lease per replica; a GPU share with no card, or with the card
    held, leaves the deployment short (status says why), with no replica
    running on the CPU in its place."""
    ts = port.serve
    h = ts.run(ts.deployment(WhoAmI, name="cpu2", num_replicas=2,
                             ray_actor_options={"resources": {"CPU": 2}}).bind(), name="cpu2")
    h.remote(None).result(timeout_s=120)
    pids = {a.pid for a in _controller().replicas("cpu2").values()}
    assert {(x.pid, x.cpu) for x in port.ledger.holders() if x.pid in pids} == {
        (pid, 2) for pid in pids}
    ts.delete("cpu2")

    share = ts.deployment(WhoAmI, name="half", ray_actor_options={"resources": {"GPU": 0.5}})
    with pytest.raises(RuntimeError, match="no replicas.*need a CUDA device"):
        ts.run(share.bind(), name="half", _wait_for_ready_s=1.0)
    st = ts.status()["applications"]["half"]["deployments"]["half"]
    assert (st["replicas"], st["target"]) == (0, 1) and "need a CUDA device" in st["message"]
    ts.delete("half")
    with use_ledger(CardLedger(str(tmp_path / "one"), cards=["0"], cpus=8)) as led:
        lease, = led.acquire([{"GPU": 1}], "holder")
        try:
            with pytest.raises(RuntimeError, match="no replicas"):
                ts.run(share.bind(), name="half", _wait_for_ready_s=1.0)
            st = ts.status()["applications"]["half"]["deployments"]["half"]
            assert st["replicas"] == 0 and f"pid {os.getpid()} (holder" in st["message"]
            ts.delete("half")
        finally:
            lease.release()
    assert _controller().get_replica_names("half") == []
