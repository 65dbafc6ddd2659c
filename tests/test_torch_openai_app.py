"""The port's OpenAI app (``ray_tpu_torch.llm.build_openai_app``: the
``OpenAIRouter`` ingress over an ``LLMServer`` deployment, each a replica
process of the port's Serve) against the JAX package's
(``ray_tpu.llm.build_openai_app`` on ray_tpu's thread-mode Serve), both
over HTTP through their own proxies.

Both read one set of well-conditioned fp32 weights from a JAX
``save_pytree`` checkpoint (``ModelConfig.checkpoint_path``) and hold the
same LoRA adapter in ``LLMConfig.lora_adapters``. Tolerance 0 on token
ids: with the byte tokenizer, greedy texts equal. Held equal, reply for
reply (ids and timestamps aside): ``/v1/models``; unary completions and
chat; their SSE streams, chunk for chunk; a ``"<base>:<adapter>"`` model
id and an unknown adapter; the replies for an unknown model, an unknown
route and an invalid JSON body. The router alone is held to the mirror of
``tests/test_llm.py::test_openai_router_routing`` with fake handles. An
LLM deployment built without ``device`` whose config names no card fails
to start (its replica sees none) and never runs on the CPU.
"""

import json
import multiprocessing
import time
import urllib.request

import numpy as np
import pytest

from ray_tpu_torch._private.cards import CardLedger, use_ledger
from tests.test_torch_llm_batch import _config, _jax_config, checkpoint  # noqa: F401

pytestmark = pytest.mark.timeout(300)

PROMPTS = ["abc", "serve this prompt"]
ADAPTER = "a1"


def _serve_children() -> list:
    return [p for p in multiprocessing.active_children() if p.name.startswith("serve:")]


def _adapter(cfg) -> dict:
    """One rank-4 LoRA adapter of the tiny model, seeded."""
    from ray_tpu_torch.llm.config import resolve_llama_config

    m = resolve_llama_config(cfg.model, cfg.engine, min_vocab=258)
    rng = np.random.default_rng(11)
    r, L, e = cfg.engine.lora_rank, m.n_layers, m.d_model
    shapes = {"wq_a": (L, e, r), "wq_b": (L, r, m.n_heads, m.head_dim),
              "wv_a": (L, e, r), "wv_b": (L, r, m.n_kv_heads, m.head_dim)}
    return {k: (rng.standard_normal(s) * 0.5).astype(np.float32) for k, s in shapes.items()}


@pytest.fixture(scope="module")
def configs(checkpoint):  # noqa: F811
    cfg = _config(checkpoint, max_loras=1, lora_rank=4)
    cfg.lora_adapters = {ADAPTER: _adapter(cfg)}
    jcfg = _jax_config(cfg)
    jcfg.lora_adapters = dict(cfg.lora_adapters)
    return cfg, jcfg


def _wait_routes(port: int) -> None:
    deadline = time.time() + 60
    while time.time() < deadline:
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/-/routes", timeout=5) as r:
                if "/" in json.loads(r.read()):
                    return
        except OSError:
            pass
        time.sleep(0.2)
    raise TimeoutError("the proxy has no route '/'")


@pytest.fixture(scope="module")
def jax_port(configs):
    import ray_tpu
    from ray_tpu import serve
    from ray_tpu.llm import build_openai_app

    ray_tpu.init(num_cpus=8, mode="thread")
    serve.run(build_openai_app(configs[1]), name="llm-app", route_prefix="/")
    _, port = serve.start_proxy(port=0)
    _wait_routes(port)
    yield port
    serve.shutdown()
    ray_tpu.shutdown()


@pytest.fixture(scope="module")
def port_port(configs, tmp_path_factory):
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import build_openai_app

    ledger = CardLedger(str(tmp_path_factory.mktemp("ledger")), cards=[], cpus=8)
    with use_ledger(ledger):
        serve.run(build_openai_app(configs[0], device="cpu"), name="llm-app", route_prefix="/",
                  _wait_for_ready_s=120)
        try:
            _, port = serve.start_proxy(port=0)
            _wait_routes(port)
            yield port
        finally:
            serve.shutdown()
        deadline = time.monotonic() + 10
        while _serve_children() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert _serve_children() == [] and ledger.holders() == []


def _request(port: int, path: str, body=None, raw: bytes = None):
    """(status, content type, body bytes)."""
    data = raw if raw is not None else (json.dumps(body).encode() if body is not None else None)
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _strip(reply: dict) -> dict:
    """A reply without what differs by run: its id and its timestamp."""
    return {k: v for k, v in reply.items() if k not in ("id", "created")}


def _events(raw: bytes) -> list:
    return [e[len("data: "):] for e in raw.decode().split("\n\n") if e.startswith("data: ")]


def _both(jax_port, port_port, fn):
    return {side: fn(p) for side, p in (("jax", jax_port), ("port", port_port))}


def test_models_and_unary_completions_and_chat_equal_jax(configs, jax_port, port_port):
    name = configs[0].served_name

    def run(p):
        out = [json.loads(_request(p, "/v1/models")[2])]
        for prompt in PROMPTS:
            status, ctype, raw = _request(p, "/v1/completions", {
                "model": name, "prompt": prompt, "max_tokens": 6, "temperature": 0.0})
            assert (status, ctype) == (200, "application/json")
            out.append(_strip(json.loads(raw)))
        status, _, raw = _request(p, "/v1/chat/completions", {
            "model": name, "messages": [{"role": "user", "content": "hi"}], "max_tokens": 5})
        out.append(_strip(json.loads(raw)))
        return out

    got = _both(jax_port, port_port, run)
    assert got["port"] == got["jax"]
    models, *completions, chat = got["port"]
    assert [m["id"] for m in models["data"]] == [name]
    assert all(c["usage"]["completion_tokens"] > 0 for c in completions)
    assert chat["object"] == "chat.completion"


def test_sse_streams_equal_jax_chunk_for_chunk(configs, jax_port, port_port):
    name = configs[0].served_name

    def run(p):
        out = []
        for path, body in (("/v1/completions", {"prompt": PROMPTS[1], "max_tokens": 6}),
                           ("/v1/chat/completions",
                            {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 5})):
            status, ctype, raw = _request(p, path, {"model": name, "stream": True, **body})
            assert (status, ctype) == (200, "text/event-stream")
            events = _events(raw)
            assert events[-1] == "[DONE]"
            out.append([_strip(json.loads(e)) for e in events[:-1]])
        return out

    got = _both(jax_port, port_port, run)
    assert got["port"] == got["jax"]
    completion, chat = got["port"]
    assert len(completion) > 1 and completion[-1]["choices"][0]["finish_reason"] in (
        "stop", "length")
    assert chat[0]["choices"][0]["delta"]["role"] == "assistant"


def test_lora_model_id_and_error_replies_equal_jax(configs, jax_port, port_port):
    name = configs[0].served_name

    def run(p):
        body = {"prompt": PROMPTS[0], "max_tokens": 6, "temperature": 0.0}
        out = [_strip(json.loads(_request(p, "/v1/completions", {"model": m, **body})[2]))
               for m in (name, f"{name}:{ADAPTER}", f"{name}:nope", "no-such-model")]
        out.append(json.loads(_request(p, "/v1/embeddings", {"model": name, "input": "x"})[2]))
        out.append(json.loads(_request(p, "/v1/completions", raw=b"{not json")[2]))
        return out

    got = _both(jax_port, port_port, run)
    assert got["port"] == got["jax"]
    base, adapted, unknown_adapter, unknown_model, route, invalid = got["port"]
    assert adapted["choices"][0]["text"] != base["choices"][0]["text"]
    assert unknown_adapter["error"]["code"] == 404 and "'nope'" in unknown_adapter["error"][
        "message"]
    assert unknown_model == {"error": {"message": "model 'no-such-model' not found",
                                       "code": 404}}
    assert route["error"]["code"] == 404 and invalid["error"]["code"] == 400


def test_a_config_naming_no_card_fails_to_start_never_on_the_cpu(configs, port_port):
    """``build_llm_deployment(cfg)`` without ``device`` and with no card in
    ``ray_actor_options``: its replica sees no card, ``LLMServer`` fails to
    build there, and the deployment stays short with the reason in
    ``status()``; nothing serves from the CPU in the card's place."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import build_llm_deployment
    from ray_tpu_torch.serve import api

    app = build_llm_deployment(configs[0])
    app.deployment = app.deployment.options(name="llm:nocard", health_check_period_s=0.5)
    try:
        serve.run(app, name="nocard", route_prefix="/nocard")
        deadline = time.monotonic() + 60
        while True:
            st = serve.status()["applications"]["nocard"]["deployments"]["llm:nocard"]
            if "failed to start" in st["message"]:
                break
            assert time.monotonic() < deadline, st
            time.sleep(0.05)
        assert "no CUDA device is available" in st["message"]
        assert api._controller.get_replicas_versioned("llm:nocard")[1] == []
    finally:
        serve.delete("nocard")


class _Reply:
    def __init__(self, value):
        self.value = value

    def result(self, timeout_s=None):
        return self.value


class _FakeHandle:
    class chat:
        @staticmethod
        def remote(body):
            return _Reply({"ok": True, "got": body["model"], "lora": body.get("_lora")})


def test_openai_router_routing():
    """The mirror of ``tests/test_llm.py::test_openai_router_routing``."""
    from ray_tpu_torch.llm import OpenAIRouter
    from ray_tpu_torch.serve import Request

    router = OpenAIRouter(m1=_FakeHandle())
    assert router(Request("GET", "/v1/models", {}, {}, b""))["data"][0]["id"] == "m1"
    req = Request("POST", "/v1/chat/completions", {}, {}, b'{"model": "m1", "messages": []}')
    assert router(req)["ok"] is True
    req = Request("POST", "/v1/chat/completions", {}, {}, b'{"model": "m1:ad", "messages": []}')
    assert router(req) == {"ok": True, "got": "m1:ad", "lora": "ad"}
    req = Request("POST", "/v1/chat/completions", {}, {}, b'{"model": "nope"}')
    assert router(req)["error"]["code"] == 404
