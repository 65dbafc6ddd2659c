"""The port's HTTP proxy and ingress (``ray_tpu_torch/serve/proxy.py``)
against the JAX package's (``ray_tpu.serve``, thread-mode runtime), on the
CPU: the mirrors of ``tests/test_serve.py``'s proxy tests and of
``tests/test_serve_ingress.py``.

The same deployments and the same HTTP requests go to both proxies, and the
statuses, bodies, stream chunks, ``Retry-After`` headers and admission
counters are compared: unary JSON (``None`` as null), SSE streaming (the
first chunk before the handler ends), a mid-stream error truncating the
chunked body, 429 shedding at the global budget, the per-deployment
queue bound, per-tenant caps and the shared bucket of unregistered
tenants, the shed table's bound, latency-feedback routing away from a slow
replica, shutdown draining in-flight requests and counting dropped streams,
the shared wait on an empty replica set, and a handle's stream yielding the
handler's bytes (``test_serve_ingress.py:481``).

Not mirrored (each in ``ROADMAP.md`` Queue C): ``test_serve_ingress.py:336``
(one proxy per node, ``start_proxies``), ``:396`` (the zero-copy large
body), ``:430`` (zero-copy streamed chunks), ``:452`` (a typed memoryview
on the zero-copy path) and ``:511`` (proxy incarnations at the
controller): the port serves one host and has no object store.

Deployments are module level; this module imports neither JAX nor ray_tpu
at its top.
"""

import collections
import http.client
import json
import multiprocessing
import os
import tempfile
import threading
import time
import types
import urllib.error
import urllib.request

import pytest

from ray_tpu_torch._private.cards import CardLedger, use_ledger

pytestmark = pytest.mark.timeout(300)


# ---- deployments ----------------------------------------------------------------


class Echo:
    def __call__(self, request):
        return {"path": request.path, "echo": request.json()}


def fire_and_forget(request):
    return None


class SSE:
    def __call__(self, request):
        for i in range(3):
            yield f"data: chunk{i}\n\n"
            time.sleep(0.8)


class Bad:
    def __call__(self, request):
        yield "data: ok\n\n"
        raise RuntimeError("mid-stream boom")


class Sleeper:
    def __init__(self, seconds, reply):
        self.seconds, self.reply = seconds, reply

    def __call__(self, request):
        time.sleep(self.seconds)
        return self.reply


class Gated:
    """Holds each request while the file ``gate`` exists (at most
    ``GATE_HOLD_S``), then sleeps ``seconds``: a test closes the gate to
    keep every admitted request in flight until all of its requests have
    reached the proxy."""

    def __init__(self, gate, seconds, reply):
        self.gate, self.seconds, self.reply = gate, seconds, reply

    def __call__(self, request):
        deadline = time.monotonic() + GATE_HOLD_S
        while os.path.exists(self.gate) and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(self.seconds)
        return self.reply


class MaybeSlow:
    def __init__(self, flag):
        try:
            fd = os.open(flag, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            os.close(fd)
            self.slow = True
        except FileExistsError:
            self.slow = False

    def __call__(self, request):
        if self.slow:
            time.sleep(0.6)
        return "slow" if self.slow else "fast"


class BigStream:
    def __call__(self, request):
        for i in range(2):
            yield bytes([65 + i]) * (512 * 1024)


def noop(request):
    return None


BUDGET = 8
GATE_HOLD_S = 30.0


def _apps(s, flag):
    """(app name, route prefix) -> bound app, for either package."""
    dep = s.deployment
    return {
        ("echo", "/echo"): dep(Echo).bind(),
        ("null", "/null"): dep(fire_and_forget).bind(),
        ("sse", "/sse"): dep(SSE).bind(),
        ("bad", "/bad"): dep(Bad).bind(),
        ("slow", "/slow"): dep(Gated, name="Slow", max_ongoing_requests=BUDGET).bind(
            flag + ".gate", 0.2, {"ok": True}),
        ("bounded", "/bounded"): dep(Sleeper, name="Bounded", max_ongoing_requests=16,
                                     max_queued_requests=3).bind(0.5, "ok"),
        ("work", "/work"): dep(Sleeper, name="Work", max_ongoing_requests=16).bind(1.0, "done"),
        ("ms", "/ms"): dep(MaybeSlow, num_replicas=2, max_ongoing_requests=4).bind(flag),
        ("long", "/long"): dep(Sleeper, name="Long").bind(1.5, "finished"),
        ("vlong", "/vlong"): dep(Sleeper, name="VeryLong").bind(30.0, "too late"),
        ("bigs", "/bigs"): dep(BigStream).bind(),
        ("noop", "/noop"): dep(noop).bind(),
    }


def _serve_children() -> list:
    return [p for p in multiprocessing.active_children() if p.name.startswith("serve:")]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """One port serve instance for the module, every app deployed at once."""
    from ray_tpu_torch import serve as ts

    ledger = CardLedger(str(tmp_path_factory.mktemp("ledger")), cards=[], cpus=8)
    flag = str(tmp_path_factory.mktemp("flag") / "slow_flag")
    with use_ledger(ledger):
        handles = {name: ts.run(app, name=name, route_prefix=prefix)
                   for (name, prefix), app in _apps(ts, flag).items()}
        try:
            from ray_tpu_torch.serve import api

            yield types.SimpleNamespace(serve=ts, handles=handles, ledger=ledger,
                                        controller=api._controller, flag=flag)
        finally:
            ts.shutdown()
        deadline = time.monotonic() + 10
        while _serve_children() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert _serve_children() == []
        assert ledger.holders() == []


@pytest.fixture(autouse=True)
def _only_the_instances_replicas_left(request):
    yield
    if "port" not in request.fixturenames:
        return
    ctrl = request.getfixturevalue("port").controller
    live = {a.pid for d in list(ctrl._deployments) for a in ctrl.replicas(d).values()}
    assert {p.pid for p in _serve_children()} <= live
    assert {h.pid for h in request.getfixturevalue("port").ledger.holders()} <= live


def _ready(port, deployment, n=1, timeout_s=120.0):
    deadline = time.monotonic() + timeout_s
    while len(port.controller.get_replicas_versioned(deployment)[1]) < n:
        assert time.monotonic() < deadline, f"{deployment}: not {n} replicas ready"
        time.sleep(0.05)


@pytest.fixture
def proxies(port):
    """A port ProxyServer of the test's own: ``make(config_kwargs)``."""
    from ray_tpu_torch.serve import ProxyConfig, ProxyServer

    made = []

    def make(**config):
        p = ProxyServer(port.controller, port=0, config=ProxyConfig(**config))
        made.append(p)
        return p

    yield make
    for p in made:
        p.shutdown(drain_s=0)


def _jax(config=None, flag=None, only=()):
    """The JAX package's runtime (thread mode) with the apps of ``only``
    deployed and its proxy started; returns (serve module, proxy, port)."""
    import ray_tpu
    from ray_tpu import serve

    ray_tpu.init(num_cpus=8, mode="thread", config=config or {})
    for (name, prefix), app in _apps(serve, flag or tempfile.mktemp()).items():
        if name in only:
            serve.run(app, name=name, route_prefix=prefix)
    proxy, jport = serve.start_proxy(port=0)
    for (name, prefix) in [k for k in _apps(serve, "x") if k[0] in only]:
        _wait_route(jport, prefix)
    return serve, proxy, jport


@pytest.fixture
def jax_teardown():
    yield
    import ray_tpu
    from ray_tpu import serve

    serve.shutdown()
    ray_tpu.shutdown()


def _wait_route(port: int, prefix: str, timeout_s: float = 20.0):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/-/routes", timeout=5) as r:
                if prefix in json.loads(r.read()):
                    return
        except Exception:  # noqa: BLE001 — not up yet
            pass
        time.sleep(0.2)
    raise TimeoutError(f"route {prefix} never appeared on proxy :{port}")


def _get(port: int, path: str, timeout: float = 60.0, tenant: str = "", data=None):
    """(status, body, retry_after_header, elapsed_s)."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"} if data else {})
    if tenant:
        req.add_header("x-ray-tpu-tenant", tenant)
    t0 = time.monotonic()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read(), None, time.monotonic() - t0
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("Retry-After"), time.monotonic() - t0


def _stats(port: int) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/-/stats", timeout=10) as r:
        return json.loads(r.read())


def _gated_round(port: int, gate: str, path: str, n: int, timeout: float = 60.0) -> list:
    """``n`` concurrent requests to ``path`` with the gate closed, opened
    once all ``n`` have reached the proxy (admitted or shed), so that every
    admitted one is still in flight when the last arrives; then the
    proxy's in-flight count is waited back to 0 (a handler releases its
    admission after writing its reply). An admitted request's elapsed time
    counts from the later of its start and the gate's opening: the hold is
    the test's, not the proxy's."""
    before = _stats(port)
    open(gate, "w").close()
    out, lock = [], threading.Lock()
    opened = []

    def run():
        t0 = time.monotonic()
        code, body, retry_after, elapsed = _get(port, path, timeout=timeout)
        if code == 200:
            elapsed = time.monotonic() - max(t0, opened[0])
        with lock:
            out.append((code, body, retry_after, elapsed))

    threads = [threading.Thread(target=run) for _ in range(n)]
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + GATE_HOLD_S
        while time.monotonic() < deadline:
            now = _stats(port)
            if (now["accepted"] + now["shed"]) - (before["accepted"] + before["shed"]) >= n:
                break
            time.sleep(0.01)
    finally:
        opened.append(time.monotonic())
        os.unlink(gate)
    for t in threads:
        t.join()
    deadline = time.monotonic() + 10.0
    while _stats(port)["inflight"] and time.monotonic() < deadline:
        time.sleep(0.01)
    return out


def _concurrent(fn, n: int) -> list:
    out, lock = [], threading.Lock()

    def run(i):
        r = fn(i)
        with lock:
            out.append(r)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def _port_proxy(port):
    _, p = port.serve.start_proxy(port=0)
    return p


# ---- mirrors of tests/test_serve.py: the proxy --------------------------------


def test_http_proxy_end_to_end_and_null_json(port, jax_teardown):
    _, _, jport = _jax(only=("echo", "null"))
    pport = _port_proxy(port)
    _ready(port, "Echo")
    _ready(port, "fire_and_forget")
    out = {}
    for side, p in (("jax", jport), ("port", pport)):
        _wait_route(p, "/echo")
        status, body, _, _ = _get(p, "/echo/predict", data=json.dumps({"x": 1}).encode())
        null = _get(p, "/null/")
        missing = _get(p, "/nowhere")
        out[side] = (status, json.loads(body), null[:2], missing[0])
    assert out["port"] == out["jax"] == (
        200, {"path": "/predict", "echo": {"x": 1}}, (200, b"null"), 404)


def test_http_streaming_sse(port, jax_teardown):
    _, _, jport = _jax(only=("sse",))
    pport = _port_proxy(port)
    _ready(port, "SSE")
    out = {}
    for side, p in (("jax", jport), ("port", pport)):
        with urllib.request.urlopen(f"http://127.0.0.1:{p}/sse/", timeout=60) as r:
            ctype = r.headers.get("Content-Type")
            t0 = time.monotonic()
            first = r.read(len(b"data: chunk0\n\n"))
            first_latency = time.monotonic() - t0
            rest = r.read()
        # the handler sleeps 0.8 s after each chunk: a buffering proxy could
        # not deliver chunk0 before ~2.4 s
        assert first_latency < 2.0, f"{side}: first SSE chunk took {first_latency:.1f}s"
        out[side] = (ctype, first, rest)
    assert out["port"] == out["jax"] == (
        "text/event-stream", b"data: chunk0\n\n", b"data: chunk1\n\ndata: chunk2\n\n")


def test_http_stream_error_truncates(port, jax_teardown):
    _, _, jport = _jax(only=("bad",))
    pport = _port_proxy(port)
    _ready(port, "Bad")
    for p in (jport, pport):
        conn = http.client.HTTPConnection("127.0.0.1", p, timeout=60)
        conn.request("GET", "/bad/")
        resp = conn.getresponse()
        assert resp.status == 200
        with pytest.raises(http.client.IncompleteRead):
            data = resp.read()
            raise AssertionError(f"read returned {data!r} without error")
        conn.close()


# ---- mirrors of tests/test_serve_ingress.py ---------------------------------------


def test_admission_caps_math():
    from ray_tpu._private.tenants import admission_caps as jcaps
    from ray_tpu_torch.serve.proxy import admission_caps

    cases = [
        ([{"tenant": "a", "weight": 3.0}, {"tenant": "b", "weight": 1.0}], 100),
        ([{"tenant": "a", "weight": 100.0}, {"tenant": "b", "weight": 0.01}], 10),
        ([{"tenant": "a", "weight": 1.0}], 100),
        ([], 100),
        ([{"tenant": t, "weight": w} for t, w in zip("abcde", (0.0, 1, 2.5, 7, 0.3))], 37),
        ([{"tenant": "a"}, {"tenant": "b", "weight": 2}], 0),
    ]
    for policies, budget in cases:
        assert admission_caps(policies, budget) == jcaps(policies, budget)
    assert admission_caps(*cases[0]) == {"a": 75, "b": 25}
    assert admission_caps(*cases[1])["b"] == 1


def test_shed_at_overload_returns_429_with_retry_after(port, proxies, jax_teardown):
    _, _, jport = _jax(config={"serve_max_inflight_per_proxy": BUDGET}, flag=port.flag,
                       only=("slow",))
    pport = proxies(serve_max_inflight_per_proxy=BUDGET).port
    _ready(port, "Slow")
    gate = port.flag + ".gate"
    out = {}
    for side, p in (("jax", jport), ("port", pport)):
        base = _gated_round(p, gate, "/slow/", BUDGET)
        assert all(c == 200 for c, *_ in base)
        base_p99 = sorted(e for *_, e in base)[-1]
        results = _gated_round(p, gate, "/slow/", 2 * BUDGET, timeout=30)
        codes = collections.Counter(c for c, *_ in results)
        sheds = [r for r in results if r[0] == 429]
        assert all(ra is not None and float(ra) > 0 for _, _, ra, _ in sheds)
        assert all(e < 5.0 for *_, e in sheds), "shed responses must be cheap"
        admitted_p99 = sorted(e for c, _, _, e in results if c == 200)[-1]
        assert admitted_p99 < 3.0 * max(base_p99, 0.3), (side, admitted_p99, base_p99)
        stats = _stats(p)
        out[side] = (codes[200], codes[429], {r for _, _, r, _ in sheds},
                     stats["accepted"], stats["shed"], stats["shed_global"], stats["inflight"])
    assert out["port"] == out["jax"] == (BUDGET, BUDGET, {"1"}, 2 * BUDGET, BUDGET, BUDGET, 0)


def test_per_deployment_queue_bound(port, proxies, jax_teardown):
    _, _, jport = _jax(config={"serve_max_inflight_per_proxy": 64}, only=("bounded",))
    pport = proxies(serve_max_inflight_per_proxy=64).port
    _ready(port, "Bounded")
    out = {}
    for side, p in (("jax", jport), ("port", pport)):
        results = _concurrent(lambda i: _get(p, "/bounded/", timeout=30), 8)
        codes = collections.Counter(c for c, *_ in results)
        stats = _stats(p)
        out[side] = (codes[200], codes[429], stats["shed_deployment"], stats["shed_global"])
    assert out["port"] == out["jax"] == (3, 5, 5, 0)


def test_per_tenant_cap_isolates_bursty_tenant(port, proxies, jax_teardown):
    import ray_tpu

    serve, jproxy, jport = _jax(config={"serve_max_inflight_per_proxy": 8}, only=("work",))
    from ray_tpu.util.state import api as state_api

    state_api.set_tenant_quota("burst", weight=1.0)
    state_api.set_tenant_quota("quiet", weight=1.0)
    deadline = time.time() + 15
    jcaps = {}
    while time.time() < deadline:
        jcaps = ray_tpu.get(jproxy.get_stats.remote(), timeout=10)["tenant_caps"]
        if "burst" in jcaps and "quiet" in jcaps:
            break
        time.sleep(0.2)
    from ray_tpu._private.worker import global_worker

    # the same tenant records the JAX proxy read from its scheduler (the
    # driver's own tenant among them)
    policies = global_worker().controller_call("tenant_stats")
    pproxy = proxies(serve_max_inflight_per_proxy=8)
    pproxy.set_tenant_policies(policies)
    assert pproxy.get_stats()["tenant_caps"] == jcaps
    _ready(port, "Work")
    out = {}
    for side, p in (("jax", jport), ("port", pproxy.port)):
        burst_results = []
        lock = threading.Lock()

        def burst(i):
            r = _get(p, "/work/", timeout=30, tenant="burst")
            with lock:
                burst_results.append(r)

        threads = [threading.Thread(target=burst, args=(i,)) for i in range(12)]
        for t in threads:
            t.start()
        time.sleep(0.4)  # the burst in flight (the handler holds 1.0 s)
        status, _, _, elapsed = _get(p, "/work/", timeout=30, tenant="quiet")
        for t in threads:
            t.join()
        assert status == 200 and elapsed < 5.0, side  # admitted mid-burst, served promptly
        codes = collections.Counter(c for c, *_ in burst_results)
        stats = _stats(p)
        out[side] = (codes[200], codes[429], stats["shed_tenant"] > 0,
                     stats["shed_by_tenant"].get("burst", 0) > 0,
                     stats["shed_by_tenant"].get("quiet", 0))
    assert out["port"] == out["jax"] == (jcaps["burst"], 12 - jcaps["burst"], True, True, 0)


def _admission(pkg):
    if pkg == "jax":
        from ray_tpu.serve import proxy as mod
    else:
        from ray_tpu_torch.serve import proxy as mod
    return mod


def test_unregistered_tenant_shares_one_capped_bucket(jax_teardown):
    import ray_tpu

    ray_tpu.init(num_cpus=2, mode="thread")  # the JAX controller reads its config
    out = {}
    for pkg in ("jax", "port"):
        mod = _admission(pkg)
        ac = mod.AdmissionController()
        ac.budget = 8
        ac.tenant_enabled = True
        ac.set_tenant_policies([{"tenant": "a", "weight": 3.0}, {"tenant": "b", "weight": 1.0}])
        floor = min(ac.snapshot()["tenant_caps"].values())
        tickets, shed = [], 0
        for i in range(8):
            t = ac.try_admit("dep", f"rotating-{i}")
            if t is None:
                shed += 1
            else:
                assert t[1] == mod._UNREGISTERED_TENANT
                tickets.append(t)
        t = ac.try_admit("dep", "a")  # a configured tenant still admits
        assert t is not None and t[1] == "a"
        for tk in tickets + [t]:
            ac.release(tk)
        out[pkg] = (floor, len(tickets), shed, ac.inflight())
    assert out["port"] == out["jax"] and out["port"][1] == out["port"][0] < 8


def test_shed_by_tenant_table_bounded(jax_teardown):
    import ray_tpu

    ray_tpu.init(num_cpus=2, mode="thread")
    out = {}
    for pkg in ("jax", "port"):
        mod = _admission(pkg)
        ac = mod.AdmissionController()
        ac.budget = 0  # every admit sheds on the global check
        n = mod._SHED_TENANT_TABLE_MAX * 4
        for i in range(n):
            assert ac.try_admit("dep", f"uniq-{i}") is None
        table = ac.snapshot()["shed_by_tenant"]
        out[pkg] = (len(table), table[mod._OVERFLOW_TENANT], sum(table.values()))
    assert out["port"] == out["jax"] == (65, 192, 256)


def test_latency_feedback_routing_drains_slow_replica(port, jax_teardown):
    import ray_tpu
    from ray_tpu import serve

    ray_tpu.init(num_cpus=8, mode="thread")
    jh = serve.run(serve.deployment(MaybeSlow, num_replicas=2, max_ongoing_requests=4).bind(
        os.path.join(tempfile.mkdtemp(), "slow_flag")), name="ms")
    ph = port.handles["ms"]
    _ready(port, "MaybeSlow", 2)
    out = {}
    for side, h in (("jax", jh), ("port", ph)):
        warm = collections.Counter(h.remote(None).result(timeout_s=60) for _ in range(8))
        assert warm["slow"] >= 1 and warm["fast"] >= 1, (side, warm)
        slow_name = max(h._latency, key=h._latency.get)
        assert h._latency[slow_name] > 0.3  # the 0.6 s sleep dominates its estimate
        counts = collections.Counter(h.remote(None).result(timeout_s=120) for _ in range(30))
        out[side] = counts["fast"] >= 27
    assert out == {"jax": True, "port": True}


def test_proxy_shutdown_drains_inflight(port, proxies, jax_teardown):
    import ray_tpu

    _, jproxy, jport = _jax(only=("long",))
    pproxy = proxies()
    _ready(port, "Long")
    out = {}
    for side, p in (("jax", jport), ("port", pproxy.port)):
        result = {}

        def long_req():
            result["r"] = _get(p, "/long/", timeout=30)

        t = threading.Thread(target=long_req)
        t.start()
        time.sleep(0.4)  # the request is in flight
        if side == "jax":
            shutdown = jproxy.shutdown.remote(drain_s=10.0)
        else:
            done = {}
            shutdown = threading.Thread(
                target=lambda: done.setdefault("ok", pproxy.shutdown(drain_s=10.0)))
            shutdown.start()
        time.sleep(0.3)
        status, *_ = _get(p, "/long/", timeout=10)  # new requests shed while draining
        if side == "jax":
            ok = ray_tpu.get(shutdown, timeout=30)
            stats = ray_tpu.get(jproxy.get_stats.remote(), timeout=10)
        else:
            shutdown.join(30)
            ok, stats = done["ok"], pproxy.get_stats()
        t.join(timeout=30)
        out[side] = (status, ok, result["r"][0], json.loads(result["r"][1]),
                     stats["dropped_streams"], stats["draining"])
    assert out["port"] == out["jax"] == (429, True, 200, "finished", 0, True)


def test_proxy_shutdown_counts_dropped_streams(port, proxies, jax_teardown):
    import ray_tpu

    _, jproxy, jport = _jax(only=("vlong",))
    pproxy = proxies()
    _ready(port, "VeryLong")
    out = {}
    for side, p in (("jax", jport), ("port", pproxy.port)):
        def doomed():
            try:
                _get(p, "/vlong/", timeout=5)
            except Exception:  # noqa: BLE001 — the connection is cut
                pass

        t = threading.Thread(target=doomed, daemon=True)
        t.start()
        time.sleep(0.4)
        if side == "jax":
            ok = ray_tpu.get(jproxy.shutdown.remote(drain_s=0.5), timeout=30)
            stats = ray_tpu.get(jproxy.get_stats.remote(), timeout=10)
        else:
            ok, stats = pproxy.shutdown(drain_s=0.5), pproxy.get_stats()
        out[side] = (ok, stats["dropped_streams"])
    assert out["port"] == out["jax"] == (True, 1)


def test_empty_replica_wait_shares_refresh(port, jax_teardown):
    import ray_tpu
    from ray_tpu import serve
    from ray_tpu.serve import handle as jhandle_mod
    from ray_tpu_torch.serve import handle as phandle_mod

    ray_tpu.init(num_cpus=8, mode="thread")
    serve.run(serve.deployment(noop).bind(), name="noop")
    out = {}
    for side, mod in (("jax", jhandle_mod), ("port", phandle_mod)):
        h = mod.DeploymentHandle("definitely-not-deployed")
        old = mod._EMPTY_WAIT_DEADLINE_S
        mod._EMPTY_WAIT_DEADLINE_S = 2.0
        try:
            errors, lock = [], threading.Lock()

            def caller():
                try:
                    h._pick_replica()
                except RuntimeError as e:
                    with lock:
                        errors.append(e)

            threads = [threading.Thread(target=caller) for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            # every waiter timed out cleanly; one shared forced-refresh
            # stream with backoff, not ~8 threads x 2 s x 10/s
            out[side] = (len(errors), h._refresh_stats["calls"] <= 30)
        finally:
            mod._EMPTY_WAIT_DEADLINE_S = old
    assert out["port"] == out["jax"] == (8, True)


def test_streaming_handle_yields_bytes_not_raw_body(port, jax_teardown):
    import ray_tpu
    from ray_tpu import serve

    ray_tpu.init(num_cpus=8, mode="thread")
    jh = serve.run(serve.deployment(BigStream).bind(), name="hbs")
    got = {}
    for side, h in (("jax", jh), ("port", port.handles["bigs"])):
        got[side] = list(h.options(stream=True).remote(None))
    assert [type(c) for c in got["port"]] == [type(c) for c in got["jax"]] == [bytes, bytes]
    assert got["port"] == got["jax"] == [b"A" * (512 * 1024), b"B" * (512 * 1024)]
    # the same body through the port's proxy, by value
    status, body, _, _ = _get(_port_proxy(port), "/bigs/", timeout=60)
    assert status == 200 and body == b"A" * (512 * 1024) + b"B" * (512 * 1024)
