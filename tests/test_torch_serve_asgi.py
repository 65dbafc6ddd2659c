"""The port's ASGI ingress (``ray_tpu_torch.serve.ingress``) and declarative
deploy (``ray_tpu_torch.serve.schema``) on replica processes: the mirrors of
``tests/test_serve.py::test_asgi_ingress_e2e`` and
``::test_declarative_deploy_and_status``, with the port's own rules.

The ASGI app is ``tools/serve_bench.py:make_asgi_app`` (a plain ASGI
callable, as FastAPI is not installed), route for route the JAX test's
``_make_asgi_app``, with an ``/endless`` route added here that streams
until its client goes. Replicas import this module by name to build their
app, so the decorated classes are module level and this module imports
neither JAX nor ray_tpu. Beyond the mirrors: a failed lifespan startup
leaves the deployment short, with the failure in ``status()``; a stream
dropped mid-way ends the app's request; a decorated class defined in a
function raises ``TypeError`` at ``serve.run``; an unknown override raises
``ValueError`` and an ``import_path`` that is no Application ``TypeError``;
a redeploy with changed builder arguments rolls the replicas;
``ray_tpu_torch.serve`` imports without ``grpc`` and ``yaml``.
"""

import asyncio
import http.client
import json
import multiprocessing
import os
import subprocess
import sys
import time
import types

import pytest

from ray_tpu_torch import serve as ts
from ray_tpu_torch._private.cards import CardLedger, use_ledger
from ray_tpu_torch.tools.serve_bench import make_asgi_app

pytestmark = pytest.mark.timeout(300)

# in a replica: the /endless requests that began and that ended
_ENDLESS = {"began": 0, "ended": 0}


def _with_endless(inner):
    """``inner`` with an ``/endless`` route: chunks every 20 ms until the
    client disconnects, counting its begin and its end."""

    async def app(scope, receive, send):
        if scope["type"] != "http" or scope["path"] != "/endless":
            await inner(scope, receive, send)
            return
        _ENDLESS["began"] += 1
        await receive()  # the request's body
        gone = asyncio.ensure_future(receive())  # returns at the disconnect
        try:
            await send({"type": "http.response.start", "status": 200,
                        "headers": [(b"content-type", b"text/plain")]})
            i = 0
            while not gone.done():
                await send({"type": "http.response.body", "body": f"e{i};".encode(),
                            "more_body": True})
                i += 1
                await asyncio.sleep(0.02)
        finally:
            gone.cancel()
            _ENDLESS["ended"] += 1

    return app


@ts.ingress(_with_endless(make_asgi_app()))
class Api:
    def endless_counts(self):
        return dict(_ENDLESS)


async def _failing_lifespan(scope, receive, send):
    if scope["type"] == "lifespan":
        await receive()
        await send({"type": "lifespan.startup.failed", "message": "no database"})
        return
    raise AssertionError("served after a failed startup")


@ts.ingress(_failing_lifespan)
class Broken:
    pass


def _serve_children() -> list:
    return [p for p in multiprocessing.active_children() if p.name.startswith("serve:")]


def _controller():
    from ray_tpu_torch.serve import api

    return api._controller


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    ledger = CardLedger(str(tmp_path_factory.mktemp("ledger")), cards=[], cpus=8)
    with use_ledger(ledger):
        ts.run(ts.deployment(Api).bind(), name="asgi", route_prefix="/api")
        _, http_port = ts.start_proxy(port=0)
        try:
            yield types.SimpleNamespace(ledger=ledger, port=http_port)
        finally:
            ts.shutdown()
        deadline = time.monotonic() + 10
        while _serve_children() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert _serve_children() == [] and ledger.holders() == []


def _ready(deployment: str, n: int = 1, timeout_s: float = 120.0) -> None:
    deadline = time.monotonic() + timeout_s
    while len(_controller().get_replicas_versioned(deployment)[1]) < n:
        assert time.monotonic() < deadline, f"{deployment}: not {n} replicas ready"
        time.sleep(0.05)


def test_asgi_ingress_e2e(port):
    _ready("Api")
    conn = http.client.HTTPConnection("127.0.0.1", port.port, timeout=30)
    conn.request("GET", "/api/items/7?q=x")
    resp = conn.getresponse()
    data = resp.read()
    # path params + query string survived, middleware header present
    assert resp.status == 200
    assert json.loads(data) == {"item_id": 7, "q": "q=x"}
    assert resp.getheader("x-middleware") == "on"

    # the app's error status comes through as it is
    conn.request("GET", "/api/items/notanint")
    resp = conn.getresponse()
    body = resp.read()
    assert resp.status == 422, (resp.status, body)

    # request body round trip
    conn.request("POST", "/api/echo", body=b"x" * 1234)
    resp = conn.getresponse()
    assert json.loads(resp.read()) == {"len": 1234}

    # a streaming route arrives chunked with all frames
    conn.request("GET", "/api/stream")
    resp = conn.getresponse()
    assert resp.status == 200
    assert resp.read() == b"part0;part1;part2;part3;end"

    # a disconnect-guarded stream is not cancelled by an early http.disconnect
    conn.request("GET", "/api/guarded-stream")
    resp = conn.getresponse()
    assert resp.status == 200
    assert resp.read() == b"g0;g1;g2;g3;gend"

    # the lifespan startup's state is visible to request scopes
    conn.request("GET", "/api/state")
    resp = conn.getresponse()
    assert json.loads(resp.read()) == {"state": "db-pool"}

    # 204: no chunk framing; the same kept-alive connection serves the next request
    conn.request("DELETE", "/api/nobody")
    resp = conn.getresponse()
    assert resp.status == 204
    assert resp.getheader("x-deleted") == "yes"
    assert resp.getheader("transfer-encoding") is None
    assert resp.read() == b""
    conn.request("GET", "/api/items/9?q=y")
    resp = conn.getresponse()
    assert resp.status == 200
    assert json.loads(resp.read())["item_id"] == 9

    # CRLF in an app-supplied header value cannot split the response
    conn.request("GET", "/api/redirect?/evil%0d%0aX-Injected:%20owned")
    resp = conn.getresponse()
    resp.read()
    assert resp.status == 302
    assert resp.getheader("x-injected") is None
    loc = resp.getheader("location") or ""
    assert "\r" not in loc and "\n" not in loc
    conn.close()


def test_dropped_stream_ends_the_apps_request(port):
    _ready("Api")
    handle = ts.get_deployment_handle("Api")
    before = handle.endless_counts.remote().result(timeout_s=60)
    conn = http.client.HTTPConnection("127.0.0.1", port.port, timeout=30)
    conn.request("GET", "/api/endless")
    resp = conn.getresponse()
    assert resp.status == 200
    data = b""
    while len(data) < 6:
        chunk = resp.read1(64)
        assert chunk, data  # the stream must not end
        data += chunk
    assert data.startswith(b"e0;e1;")
    conn.close()  # the client goes mid-stream
    deadline = time.monotonic() + 30
    while True:
        now = handle.endless_counts.remote().result(timeout_s=60)
        if now["ended"] > before["ended"] or time.monotonic() > deadline:
            break
        time.sleep(0.1)
    assert now == {"began": before["began"] + 1, "ended": before["ended"] + 1}


def test_failed_lifespan_startup_leaves_the_deployment_short(port):
    d = ts.deployment(Broken, health_check_period_s=0.5)
    try:
        ts.run(d.bind(), name="broken", route_prefix="/broken")
        deadline = time.monotonic() + 60
        while True:
            # the message stands until the next replica starts
            st = ts.status()["applications"]["broken"]["deployments"]["Broken"]
            if "failed to start" in st["message"]:
                break
            assert time.monotonic() < deadline, st
            time.sleep(0.05)
        assert "ASGI lifespan startup failed: no database" in st["message"]
        assert _controller().get_replicas_versioned("Broken")[1] == []
    finally:
        ts.delete("broken")


def test_decorated_class_in_a_function_raises_type_error(port):
    @ts.deployment
    @ts.ingress(make_asgi_app())
    class Local:
        pass

    names = set(_controller()._deployments)
    with pytest.raises(TypeError, match="by reference"):
        ts.run(Local.bind(), name="local", route_prefix="/local")
    assert set(_controller()._deployments) == names  # nothing started


_GREETER = (
    "from ray_tpu_torch import serve\n"
    "import os\n"
    "@serve.deployment\n"
    "class Greeter:\n"
    "    def __init__(self, greeting='hello'):\n"
    "        self.greeting = greeting\n"
    "    def __call__(self, name='world'):\n"
    "        return f'{self.greeting} {name}'\n"
    "    def pid(self):\n"
    "        return os.getpid()\n"
    "app = Greeter.bind()\n"
    "def build(args):\n"
    "    return Greeter.bind(args.get('greeting', 'hello'))\n"
    "def not_an_app():\n"
    "    return 'nope'\n"
)


@pytest.fixture
def greeter_module(tmp_path):
    (tmp_path / "torch_serve_app.py").write_text(_GREETER)
    sys.path.insert(0, str(tmp_path))  # replicas are spawned with this sys.path
    try:
        yield tmp_path
    finally:
        sys.path.remove(str(tmp_path))
        sys.modules.pop("torch_serve_app", None)


def test_declarative_deploy_status_and_a_rolling_redeploy(port, greeter_module):
    """YAML config -> a running app (the mirror); then a redeploy whose
    builder arguments changed rolls the replicas."""
    from ray_tpu_torch.serve import schema

    cfg = greeter_module / "serve.yaml"
    cfg.write_text(
        "applications:\n"
        "  - name: greeter\n"
        "    route_prefix: /greet\n"
        "    import_path: torch_serve_app:app\n"
        "    deployments:\n"
        "      - name: Greeter\n"
        "        num_replicas: 2\n"
    )
    try:
        names = schema.deploy(str(cfg))
        assert names == ["greeter"]
        h = ts.get_app_handle("greeter")
        assert h.remote("ray").result(timeout_s=120) == "hello ray"
        st = schema.status()
        assert "Greeter" in str(st)
        assert st["applications"]["greeter"]["deployments"]["Greeter"]["target"] == 2
        _ready("Greeter", 2)
        old = {a.pid for a in _controller().replicas("Greeter").values()}
        assert len(old) == 2

        schema.deploy({"applications": [{
            "name": "greeter", "route_prefix": "/greet", "import_path": "torch_serve_app:build",
            "args": {"greeting": "hi"}, "deployments": [{"name": "Greeter", "num_replicas": 2}]}]})
        deadline = time.monotonic() + 120
        while True:
            pids = {a.pid for a in _controller().replicas("Greeter").values()}
            st = schema.status()["applications"]["greeter"]["deployments"]["Greeter"]
            if (not pids & old and len(pids) == 2 and st["status"] == "RUNNING") or (
                    time.monotonic() > deadline):
                break
            time.sleep(0.1)
        assert not pids & old and len(pids) == 2, (pids, old)
        _ready("Greeter", 2)
        assert {h.remote("ray").result(timeout_s=60) for _ in range(4)} == {"hi ray"}
        rolled = [e[3]["replica"] for e in _controller().events
                  if e[1] == "Greeter" and e[2] == "stop"]
        assert len(rolled) == 2  # each old replica drained and stopped
    finally:
        ts.delete("greeter")


def test_bad_configs_raise_before_anything_starts(port, greeter_module):
    from ray_tpu_torch.serve import schema

    names = set(_controller()._deployments)
    with pytest.raises(ValueError, match="unknown deployments: \\['Nope'\\]"):
        schema.deploy({"applications": [{
            "name": "bad", "import_path": "torch_serve_app:app",
            "deployments": [{"name": "Nope", "num_replicas": 2}]}]})
    with pytest.raises(TypeError, match="did not resolve to an Application"):
        schema.deploy({"applications": [{"name": "bad",
                                         "import_path": "torch_serve_app:not_an_app"}]})
    with pytest.raises(ValueError, match="module:attribute"):
        schema.deploy({"applications": [{"name": "bad", "import_path": "torch_serve_app"}]})
    with pytest.raises(ValueError, match="no 'applications'"):
        schema.deploy({})
    assert set(_controller()._deployments) == names


def test_serve_imports_without_grpc_and_yaml():
    """The card's machine has no grpcio and may have no PyYAML: the port's
    Serve and LLM layers import without either (a dict deploys without
    yaml; grpc loads only when a gRPC proxy starts)."""
    code = ("import sys\n"
            "sys.modules['grpc'] = None\n"
            "sys.modules['yaml'] = None\n"
            "import ray_tpu_torch.serve, ray_tpu_torch.llm\n"
            "from ray_tpu_torch.serve import schema\n"
            "assert schema._load_config({'applications': []}) == {'applications': []}\n"
            "print('ok')\n")
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=env, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
