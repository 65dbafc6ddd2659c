"""The port's ``LLMServer`` behind ray_tpu's OpenAI router and HTTP proxy: the
mirror of ``tests/test_llm.py::test_openai_sse_end_to_end`` (what
``examples/serve_openai_llm.py`` serves, with the port's server as the model
deployment; the example itself imports ray_tpu, so its port is this test).

The model deployment is ``ray_tpu_torch.llm.LLMServer`` on the CPU, bound
under its served name beside ray_tpu's ``OpenAIRouter``; a unary chat
completion, a unary completion, a streamed (SSE) chat completion and
``/v1/models`` go through the proxy's socket. The unary completion's text
equals the port's ``TorchEngine`` greedy text for the same prompt.
"""

import json
import time
import urllib.request

import pytest

pytestmark = pytest.mark.timeout(300)


def _config():
    from ray_tpu_torch.llm import EngineConfig, LLMConfig, ModelConfig

    return LLMConfig(model=ModelConfig(model_id="tiny", tokenizer="byte", seed=0),
                     engine=EngineConfig(max_num_seqs=2, max_seq_len=64,
                                         prefill_buckets=(16, 32, 64)))


def _post(port: int, path: str, body: dict):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=300)


def test_port_llm_server_behind_openai_router_unary_and_sse(ray_start_thread):
    from ray_tpu import serve
    from ray_tpu.llm.openai_api import OpenAIRouter
    from ray_tpu_torch.llm import LLMServer, SamplingParams, TorchEngine

    cfg = _config()
    model = serve.deployment(LLMServer, name=f"llm:{cfg.served_name}",
                             max_ongoing_requests=4).bind(cfg, device="cpu")
    app = serve.deployment(OpenAIRouter, name="openai-router").bind(**{cfg.served_name: model})
    serve.run(app, name="llm-app", route_prefix="/")
    try:
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
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/models", timeout=60) as r:
            assert [m["id"] for m in json.loads(r.read())["data"]] == [cfg.served_name]
        chat = {"model": cfg.served_name, "messages": [{"role": "user", "content": "hi"}],
                "max_tokens": 4}
        with _post(port, "/v1/chat/completions", chat) as r:
            unary = json.loads(r.read())
        assert unary["object"] == "chat.completion"
        assert unary["choices"][0]["message"]["role"] == "assistant"
        with _post(port, "/v1/completions", {"model": cfg.served_name, "prompt": "abc",
                                             "max_tokens": 5, "ignore_eos": True}) as r:
            completion = json.loads(r.read())
        assert completion["usage"]["completion_tokens"] == 5
        with _post(port, "/v1/chat/completions", {**chat, "stream": True}) as r:
            assert r.headers.get("Content-Type") == "text/event-stream"
            raw = r.read().decode()
    finally:
        serve.shutdown()
    events = [e for e in raw.split("\n\n") if e.startswith("data: ")]
    assert events[-1] == "data: [DONE]"
    chunks = [json.loads(e[len("data: "):]) for e in events[:-1]]
    assert all(c["object"] == "chat.completion.chunk" for c in chunks)
    assert chunks[0]["choices"][0]["delta"].get("role") == "assistant"
    assert chunks[-1]["choices"][0]["finish_reason"] in ("stop", "length")
    assert sum(len(c["choices"][0]["delta"].get("content", "")) for c in chunks) > 0
    eng = TorchEngine(cfg, device="cpu")
    try:
        want = eng.generate("abc", sampling_params=SamplingParams(
            max_tokens=5, temperature=0.0, ignore_eos=True))
    finally:
        eng.shutdown()
    assert completion["choices"][0]["text"] == want.text
