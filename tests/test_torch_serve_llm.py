"""The slice as a whole on the CPU: the port's ``LLMServer`` served by the
port's Serve (``ray_tpu_torch.serve``: replica processes, handles, the
router for a handle inside a replica, the HTTP proxy) against the JAX
package's ``LLMServer`` behind ray_tpu's Serve (thread mode).

Both read one set of well-conditioned fp32 weights from a JAX
``save_pytree`` checkpoint (``ModelConfig.checkpoint_path``, the one-way
carry-over; the config's seed draws different numbers in the two
packages). The application is ``tools/serve_bench.py``'s: an ingress
deployment forwarding each request's JSON body through a handle to the
LLM deployment's ``completions``, or, for ``"stream": true``, its
``completions_stream`` as SSE. Greedy completions must be token-equal
(the byte tokenizer's texts equal): through the LLM deployment's handle,
through the ingress's handle (its call to the LLM relayed by the driver),
over HTTP, and streamed over HTTP chunk for chunk.

A replica that leases a card runs ``LLMServer`` on that card, and on a
machine without one its constructor fails; it never runs on the CPU in its
place (the CPU needs ``device="cpu"``).
"""

import json
import multiprocessing
import time
import urllib.request

import pytest

from ray_tpu_torch._private.cards import CardLedger, use_ledger
from tests.test_torch_llm_batch import _config, _jax_config, checkpoint  # noqa: F401

pytestmark = pytest.mark.timeout(300)

PROMPTS = ["abc", "serve this prompt", "the third one"]


def _body(prompt, **kw):
    return {"prompt": prompt, "max_tokens": 6, "temperature": 0.0, **kw}


def _serve_children() -> list:
    return [p for p in multiprocessing.active_children() if p.name.startswith("serve:")]


@pytest.fixture(scope="module")
def jax_app(checkpoint):  # noqa: F811
    import ray_tpu
    from ray_tpu import serve
    from ray_tpu.llm.server import LLMServer
    from ray_tpu_torch.tools.serve_bench import Ingress

    ray_tpu.init(num_cpus=8, mode="thread")
    llm = serve.deployment(LLMServer, name="llm", max_ongoing_requests=8).bind(
        _jax_config(_config(checkpoint)))
    serve.run(serve.deployment(Ingress, name="ingress").bind(llm), name="llm-app",
              route_prefix="/")
    _, port = serve.start_proxy(port=0)
    deadline = time.time() + 30
    while time.time() < deadline:
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/-/routes", timeout=5) as r:
                if "/" in json.loads(r.read()):
                    break
        except OSError:
            pass
        time.sleep(0.2)
    yield serve, port
    serve.shutdown()
    ray_tpu.shutdown()


@pytest.fixture(scope="module")
def port_app(checkpoint, tmp_path_factory):  # noqa: F811
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import LLMServer
    from ray_tpu_torch.tools.serve_bench import Ingress

    ledger = CardLedger(str(tmp_path_factory.mktemp("ledger")), cards=[], cpus=8)
    with use_ledger(ledger):
        llm = serve.deployment(LLMServer, name="llm", max_ongoing_requests=8).bind(
            _config(checkpoint), device="cpu")
        serve.run(serve.deployment(Ingress, name="ingress").bind(llm), name="llm-app",
                  route_prefix="/")
        _, port = serve.start_proxy(port=0)
        try:
            yield serve, port, ledger
        finally:
            serve.shutdown()
        deadline = time.monotonic() + 10
        while _serve_children() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert _serve_children() == [] and ledger.holders() == []


def _post(port: int, body: dict):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _events(raw: bytes) -> list:
    return [e[len("data: "):] for e in raw.decode().split("\n\n") if e.startswith("data: ")]


def test_greedy_completions_by_handle_equal_jax(jax_app, port_app):
    jserve, _ = jax_app
    pserve, _, _ = port_app
    out = {}
    for side, s in (("jax", jserve), ("port", pserve)):
        llm, ingress = s.get_deployment_handle("llm"), s.get_app_handle("llm-app")
        direct = [llm.completions.remote(_body(p)).result(timeout_s=240) for p in PROMPTS]
        # through the ingress: its handle's call to the LLM deployment goes
        # (in the port) from the ingress process through the driver's router
        from ray_tpu_torch.serve import Request

        via = [ingress.remote(Request("POST", "/", {}, {}, json.dumps(_body(p)).encode()))
               .result(timeout_s=240) for p in PROMPTS]
        out[side] = ([r["choices"][0]["text"] for r in direct],
                     [r["choices"][0]["text"] for r in via],
                     [r["usage"]["completion_tokens"] for r in direct])
    assert out["port"] == out["jax"]
    texts, via, n = out["port"]
    assert via == texts and all(len(t) > 0 for t in texts) and all(k > 0 for k in n)


def test_http_unary_and_sse_equal_jax(jax_app, port_app):
    _, jport = jax_app
    _, pport, _ = port_app
    out = {}
    for side, p in (("jax", jport), ("port", pport)):
        unary, streams = [], []
        for prompt in PROMPTS:
            status, ctype, raw = _post(p, _body(prompt))
            assert (status, ctype) == (200, "application/json"), side
            unary.append(json.loads(raw)["choices"][0]["text"])
            status, ctype, raw = _post(p, _body(prompt, stream=True))
            assert (status, ctype) == (200, "text/event-stream"), side
            events = _events(raw)
            assert events[-1] == "[DONE]", side
            chunks = [json.loads(e) for e in events[:-1]]
            assert all(c["object"] == "text_completion" for c in chunks)
            assert chunks[-1]["choices"][0]["finish_reason"] in ("stop", "length")
            streams.append([c["choices"][0]["text"] for c in chunks])
        out[side] = (unary, streams)
    assert out["port"] == out["jax"]
    unary, streams = out["port"]
    assert ["".join(s) for s in streams] == unary  # the byte tokenizer: one byte a chunk


def test_a_card_lease_runs_llm_server_on_the_card_never_the_cpu(port_app, checkpoint,  # noqa: F811
                                                                 tmp_path):
    """On a machine without a CUDA device, a replica holding a lease of
    half a card cannot build its engine: its constructor raises and the
    deployment stays short, saying why; no replica serves from the CPU."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import LLMServer
    from ray_tpu_torch.serve import api

    with use_ledger(CardLedger(str(tmp_path / "ledger"), cards=["0"], cpus=8)) as ledger:
        d = serve.deployment(LLMServer, name="llm-card", health_check_period_s=0.5,
                             ray_actor_options={"resources": {"GPU": 0.5}})
        try:
            serve.run(d.bind(_config(checkpoint)), name="card-app")
            deadline = time.monotonic() + 120
            while "failed to start" not in serve.status()["applications"]["card-app"][
                    "deployments"]["llm-card"]["message"]:
                assert time.monotonic() < deadline, serve.status()
                time.sleep(0.1)
            st = serve.status()["applications"]["card-app"]["deployments"]["llm-card"]
            assert "no CUDA device" in st["message"]
            assert api._controller.get_replicas_versioned("llm-card")[1] == []
            starts = [e for e in api._controller.events if e[1] == "llm-card" and e[2] == "start"]
            assert starts and all(e[3]["lease"] == ["0"] for e in starts)
        finally:
            serve.delete("card-app")
        deadline = time.monotonic() + 10
        while ledger.holders() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert ledger.holders() == []
    live = {a.pid for d in list(api._controller._deployments)
            for a in api._controller.replicas(d).values()}
    assert {p.pid for p in _serve_children()} <= live
