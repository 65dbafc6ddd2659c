"""The port's gRPC proxy (``ray_tpu_torch.serve.start_grpc_proxy``, a server
in the driver over the controller's route table) against a replica
process: the mirror of ``tests/test_grpc_proxy.py`` (unary, streamed,
unknown route), and admission's shed as ``RESOURCE_EXHAUSTED``. The CPU
only: the card's machine has no ``grpcio``. ``Echo`` is module level
(its replica imports this module by name), and this module imports neither
JAX nor ray_tpu.
"""

import json
import multiprocessing
import time

import pytest

from ray_tpu_torch._private.cards import CardLedger, use_ledger

grpc = pytest.importorskip("grpc")

pytestmark = pytest.mark.timeout(180)


class Echo:
    def __call__(self, request):
        body = request.json() or {}
        if body.get("stream"):
            def gen():
                for i in range(int(body.get("n", 3))):
                    yield {"i": i, "path": request.path}
            return gen()
        return {"echo": body.get("msg"), "path": request.path}


def _unary(channel):
    return channel.unary_unary("/ray_tpu.serve.ServeAPI/Predict",
                               request_serializer=lambda b: b,
                               response_deserializer=lambda b: b)


@pytest.fixture(scope="module")
def grpc_app(tmp_path_factory):
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve import start_grpc_proxy

    ledger = CardLedger(str(tmp_path_factory.mktemp("ledger")), cards=[], cpus=8)
    with use_ledger(ledger):
        serve.run(serve.deployment(Echo, name="grpc-echo").bind(), name="grpc-app",
                  route_prefix="/echo")
        proxy, port = start_grpc_proxy(port=0)
        channel = grpc.insecure_channel(f"127.0.0.1:{port}")
        try:
            deadline = time.time() + 60
            while time.time() < deadline:
                try:
                    _unary(channel)(b"{}", metadata=(("route", "/echo/ping"),), timeout=30)
                    break
                except grpc.RpcError as e:
                    if e.code() != grpc.StatusCode.NOT_FOUND:
                        break  # the route resolved
                    time.sleep(0.3)
            yield channel, proxy
        finally:
            channel.close()
            serve.shutdown()
        children = [p for p in multiprocessing.active_children() if p.name.startswith("serve:")]
        assert children == [] and ledger.holders() == []


def test_grpc_unary_predict(grpc_app):
    channel, _ = grpc_app
    out = _unary(channel)(json.dumps({"msg": "hi"}).encode(),
                          metadata=(("route", "/echo/predict"),), timeout=60)
    assert json.loads(out) == {"echo": "hi", "path": "/predict"}


def test_grpc_streamed_predict(grpc_app):
    channel, _ = grpc_app
    stream = channel.unary_stream("/ray_tpu.serve.ServeAPI/PredictStreamed",
                                  request_serializer=lambda b: b,
                                  response_deserializer=lambda b: b)
    msgs = [json.loads(m) for m in stream(json.dumps({"stream": True, "n": 4}).encode(),
                                          metadata=(("route", "/echo/gen"),), timeout=60)]
    assert [m["i"] for m in msgs] == [0, 1, 2, 3]
    assert msgs[0]["path"] == "/gen"


def test_grpc_unknown_route(grpc_app):
    channel, _ = grpc_app
    with pytest.raises(grpc.RpcError) as ei:
        _unary(channel)(b"{}", metadata=(("route", "/nope"),), timeout=30)
    assert ei.value.code() == grpc.StatusCode.NOT_FOUND


def test_grpc_shed_is_resource_exhausted(grpc_app):
    """Past the per-deployment bound, or a tenant's share, the proxy sheds
    with a retry-after trailer, as the HTTP proxy answers 429."""
    channel, proxy = grpc_app
    adm = proxy._admission
    predict = _unary(channel)
    tickets = [adm.try_admit("grpc-echo", "default") for _ in range(adm.dep_default_cap)]
    try:
        with pytest.raises(grpc.RpcError) as ei:
            predict(b"{}", metadata=(("route", "/echo/x"),), timeout=30)
        assert ei.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
        assert dict(ei.value.trailing_metadata())["retry-after"] == "1"
    finally:
        for t in tickets:
            adm.release(t)
    assert proxy.get_stats()["shed_deployment"] == 1

    # tenant a's share of the budget of 256 at weights 1 : 3 is 64
    proxy.set_tenant_policies([{"tenant": "a", "weight": 1}, {"tenant": "b", "weight": 3}])
    tickets = [adm.try_admit("grpc-echo", "a") for _ in range(64)]
    try:
        with pytest.raises(grpc.RpcError) as ei:
            predict(b"{}", metadata=(("route", "/echo/x"), ("x-ray-tpu-tenant", "a")),
                    timeout=30)
        assert ei.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
        out = predict(json.dumps({"msg": "b"}).encode(),
                      metadata=(("route", "/echo/x"), ("x-ray-tpu-tenant", "b")), timeout=60)
        assert json.loads(out) == {"echo": "b", "path": "/x"}
    finally:
        for t in tickets:
            adm.release(t)
        proxy.set_tenant_policies([])
    stats = proxy.get_stats()
    assert stats["shed_tenant"] == 1 and stats["shed_by_tenant"] == {"default": 1, "a": 1}
