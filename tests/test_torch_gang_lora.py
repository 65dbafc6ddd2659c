"""Multi-LoRA on a tensor- or sequence-parallel gang (``llm/gang.py``,
``llm/spmd.py``), and the gang's direct entries, against the JAX package.

The JAX engine serves adapters on a tp (or sp) mesh in one process
(``JaxEngine(tensor_parallel_degree=2, max_loras=2)``,
``ray_tpu/llm/engine.py:435-480``); the port's gang serves them on gloo
ranks. Both read one set of well-conditioned fp32 weights (norms one,
N(0, 1) / sqrt(d) elsewhere) from a JAX ``save_pytree`` checkpoint and the
same two numpy adapters, so greedy tokens are compared for equality:

- tp2 (and sp2): base and adapter tokens, alone and in one mixed batch,
  equal ``JaxEngine``'s on a 2-device virtual mesh of the same tp/sp;
- ``remove_lora`` gives back the base tokens and frees the slot;
- a ``"model": "tiny:a"`` body through ray_tpu's ``OpenAIRouter`` to the
  port's ``LLMServer`` over the gang;
- adapter requests neither hit nor store the gang's prefix cache;
- a rank killed mid adapter request: the rebuilt gang loads its adapters
  again and the replay equals the uninterrupted tokens;
- ``GangLLMServer.__call__``'s routes and its 400 and 404 replies;
- ``EngineWorker.generate_batch`` on 2 tp ranks equals JAX's
  ``SPMDGenerator.generate_batch`` (rank 0 the tokens, rank 1 ``True``).

This module imports neither JAX nor ray_tpu at its top: the ranks import
it by name.
"""

import dataclasses

import numpy as np
import pytest

pytestmark = pytest.mark.timeout(300)

PROMPTS = ["hello", "worlds!", "a third prompt"]
ADAPTERS = ("a", "b")
LONG = "a long shared preamble that spans several prefill chunks of sixteen"


def _conditioned(shapes: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    d = shapes["final_norm"][0]
    return {k: (np.ones(s, np.float32) if "norm" in k
                else (rng.standard_normal(s) / np.sqrt(d)).astype(np.float32))
            for k, s in sorted(shapes.items())}


def _adapter(seed: int) -> dict:
    """One rank-4 adapter on tiny (2 layers, d 64, 4 heads, 2 kv heads of 16)."""
    rng = np.random.default_rng(seed)
    L, e, h, kv, hd, r = 2, 64, 4, 2, 16, 4
    shapes = {"wq_a": (L, e, r), "wq_b": (L, r, h, hd), "wv_a": (L, e, r), "wv_b": (L, r, kv, hd)}
    return {k: (0.5 * rng.standard_normal(s) / np.sqrt(e if k.endswith("a") else r))
            .astype(np.float32) for k, s in shapes.items()}


WEIGHTS = {"a": _adapter(21), "b": _adapter(22)}


def _config(checkpoint=None, **engine_kw):
    from ray_tpu_torch.llm import EngineConfig, LLMConfig, ModelConfig

    kw = dict(max_num_seqs=4, max_seq_len=128, prefill_buckets=(16, 32, 64, 128),
              dtype="float32", max_loras=2, lora_rank=4)
    kw.update(engine_kw)
    return LLMConfig(model=ModelConfig(model_id="tiny", tokenizer="byte", seed=0,
                                       checkpoint_path=checkpoint),
                     engine=EngineConfig(**kw))


def _jax_config(port_config):
    from ray_tpu.llm import EngineConfig, LLMConfig, ModelConfig

    return LLMConfig(model=ModelConfig(**dataclasses.asdict(port_config.model)),
                     engine=EngineConfig(**dataclasses.asdict(port_config.engine)))


def _greedy(n=8):
    from ray_tpu_torch.llm import SamplingParams

    return SamplingParams(max_tokens=n, temperature=0.0, ignore_eos=True)


# ---- the rank loop (module level: the ranks import it by name) ---------------


def _batch_loop(config):
    import torch

    import ray_tpu_torch.train as train
    from ray_tpu_torch.llm.gang import EngineWorker

    worker = EngineWorker(config["llm_config"], torch.device("cpu"))
    ids = [worker.gen.tokenizer.encode(p) for p in PROMPTS]
    out = worker.generate_batch(ids, {"max_tokens": 6, "temperature": 0.0, "ignore_eos": True})
    train.report({"out": out, "mesh": worker.info()["mesh"]})


# ---- fixtures ----------------------------------------------------------------


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    from ray_tpu.train.checkpoint import save_pytree
    from ray_tpu_torch.llm.config import resolve_llama_config
    from ray_tpu_torch.models import llama as tl

    cfg = _config()
    mcfg = resolve_llama_config(cfg.model, cfg.engine, min_vocab=258)
    d = tmp_path_factory.mktemp("gang_lora_ckpt")
    save_pytree(_conditioned(tl._param_shapes(mcfg), seed=8), str(d))
    return str(d)


@pytest.fixture(scope="module")
def jax_tokens(checkpoint):
    """JaxEngine's greedy tokens of PROMPTS on tp2 and sp2 meshes, with no
    adapter and with each: {mesh: {adapter or None: [token ids]}}."""
    import jax

    from ray_tpu.llm import SamplingParams as JSamplingParams
    from ray_tpu.llm.engine import JaxEngine
    from ray_tpu.parallel.mesh import MeshSpec, build_mesh

    out = {}
    for name, kw in (("tp2", dict(tensor_parallel_degree=2)),
                     ("sp2", dict(sequence_parallel_degree=2))):
        eng = JaxEngine(_jax_config(_config(checkpoint, **kw)),
                        mesh=build_mesh(MeshSpec(tp=kw.get("tensor_parallel_degree", 1),
                                                 sp=kw.get("sequence_parallel_degree", 1)),
                                        devices=jax.devices()[:2]))
        try:
            for a in ADAPTERS:
                eng.add_lora(a, WEIGHTS[a])
            sp = JSamplingParams(max_tokens=8, temperature=0.0, ignore_eos=True)
            out[name] = {a: [eng.generate(p, sampling_params=sp, lora=a).token_ids
                             for p in PROMPTS] for a in (None,) + ADAPTERS}
        finally:
            eng.shutdown()
    return out


def _gang(checkpoint, **kw):
    from ray_tpu_torch.llm.gang import GangLLMServer

    gang = GangLLMServer(_config(checkpoint, **kw), device="cpu")
    for a in ADAPTERS:
        gang.engine.add_lora(a, WEIGHTS[a])
    return gang


@pytest.fixture(scope="module")
def gang_tp2(checkpoint):
    gang = _gang(checkpoint, tensor_parallel_degree=2)
    yield gang
    gang.shutdown()


def _tokens(gang, prompts, adapters) -> list:
    """Greedy tokens of (prompt, adapter) pairs, submitted at once."""
    reqs = [gang.engine.submit(p, sampling_params=_greedy(), lora=a)
            for p, a in zip(prompts, adapters)]
    for r in reqs:
        assert r.done.wait(timeout=120) and r.error is None, r.error
    return [list(r.out_tokens) for r in reqs]


# ---- tokens against JaxEngine ----------------------------------------------------


def test_tp2_adapter_tokens_equal_jax_engine(gang_tp2, jax_tokens):
    want = jax_tokens["tp2"]
    assert gang_tp2.engine.list_loras() == ["a", "b"]
    for a in (None,) + ADAPTERS:
        assert _tokens(gang_tp2, PROMPTS, [a] * len(PROMPTS)) == want[a], a
    # the adapters change the tokens (else the comparison proves nothing)
    assert want["a"] != want[None] and want["b"] != want[None] and want["a"] != want["b"]
    # one mixed batch: each slot reads its own adapter
    pairs = [(p, a) for a in (None,) + ADAPTERS for p in PROMPTS]
    got = _tokens(gang_tp2, [p for p, _ in pairs], [a for _, a in pairs])
    assert got == [want[a][PROMPTS.index(p)] for p, a in pairs]


def test_sp2_adapter_tokens_equal_jax_engine(checkpoint, jax_tokens):
    gang = _gang(checkpoint, sequence_parallel_degree=2)
    try:
        assert gang.gang_info["mesh"]["sp"] == 2
        for a in (None,) + ADAPTERS:
            assert _tokens(gang, PROMPTS, [a] * len(PROMPTS)) == jax_tokens["sp2"][a], a
    finally:
        gang.shutdown()


def test_remove_lora_gives_back_the_base_tokens(gang_tp2, jax_tokens):
    from ray_tpu_torch.llm.server import LLMServer

    want = jax_tokens["tp2"]
    server = LLMServer(gang_tp2.llm_config, engine=gang_tp2.engine)
    try:
        assert server.unload_lora("a")
        assert gang_tp2.engine.list_loras() == ["b"]
        with pytest.raises(KeyError, match="unknown LoRA"):
            gang_tp2.engine.submit(PROMPTS[0], lora="a")
        assert server.completions({"prompt": PROMPTS[0], "_lora": "a"})["error"]["code"] == 404
        assert _tokens(gang_tp2, PROMPTS, [None] * 3) == want[None]
        assert _tokens(gang_tp2, PROMPTS, ["b"] * 3) == want["b"]
        # the freed slot takes the next adapter
        assert server.load_lora("a2", WEIGHTS["a"])
        assert gang_tp2.engine.add_lora("a2", WEIGHTS["a"]) == 1  # loaded: its slot
        assert _tokens(gang_tp2, PROMPTS, ["a2"] * 3) == want["a"]
    finally:
        gang_tp2.engine.remove_lora("a2")
        assert gang_tp2.engine.add_lora("a", WEIGHTS["a"]) == 1


def test_model_base_colon_adapter_through_the_openai_router(gang_tp2, jax_tokens):
    """ray_tpu's ``OpenAIRouter`` maps ``"model": "tiny:b"`` to the base
    model's deployment with ``_lora: "b"``; here the deployment is the
    port's ``LLMServer`` over the gang (a handle that calls it in place)."""
    from ray_tpu.llm.openai_api import OpenAIRouter
    from ray_tpu.serve.proxy import Request
    from ray_tpu_torch.llm.server import LLMServer

    server = LLMServer(gang_tp2.llm_config, engine=gang_tp2.engine)

    class _Method:
        def __init__(self, fn):
            self.fn = fn

        def remote(self, body):
            out = self.fn(body)
            return type("R", (), {"result": staticmethod(lambda timeout_s=None: out)})

    class _Handle:
        completions = _Method(server.completions)
        chat = _Method(server.chat)

    router = OpenAIRouter(tiny=_Handle())
    tok = gang_tp2.tokenizer
    body = {"prompt": PROMPTS[1], "max_tokens": 8, "ignore_eos": True, "temperature": 0.0}
    out = router(Request("POST", "/v1/completions", {}, {},
                         _json({**body, "model": "tiny:b"})))
    assert out["choices"][0]["text"] == tok.decode(jax_tokens["tp2"]["b"][1])
    out = router(Request("POST", "/v1/completions", {}, {}, _json({**body, "model": "tiny"})))
    assert out["choices"][0]["text"] == tok.decode(jax_tokens["tp2"][None][1])
    out = router(Request("POST", "/v1/completions", {}, {}, _json({**body, "model": "tiny:zz"})))
    assert out["error"]["code"] == 404


def _json(d: dict) -> bytes:
    import json

    return json.dumps(d).encode()


def test_adapter_requests_bypass_the_prefix_cache(gang_tp2):
    before = gang_tp2.stats()
    r1, r2 = (gang_tp2.engine.submit(LONG, sampling_params=_greedy(4), lora="a")
              for _ in range(2))
    for r in (r1, r2):
        assert r.done.wait(timeout=120) and r.error is None
    assert r2.prefix_hit_tokens == 0 and r1.out_tokens == r2.out_tokens
    mid = gang_tp2.stats()
    assert (mid["prefix_hits"], mid["prefix_misses"]) == (before["prefix_hits"],
                                                          before["prefix_misses"])
    # the adapter requests stored nothing: the base request misses, then hits
    b1 = gang_tp2.engine.submit(LONG, sampling_params=_greedy(4))
    assert b1.done.wait(timeout=120) and b1.prefix_hit_tokens == 0
    b2 = gang_tp2.engine.submit(LONG, sampling_params=_greedy(4))
    assert b2.done.wait(timeout=120) and b2.prefix_hit_tokens > 0
    assert b1.out_tokens == b2.out_tokens != r1.out_tokens
    # and an adapter request after the base store still does not hit
    r3 = gang_tp2.engine.submit(LONG, sampling_params=_greedy(4), lora="a")
    assert r3.done.wait(timeout=120) and r3.prefix_hit_tokens == 0
    assert r3.out_tokens == r1.out_tokens


def test_rebuilt_gang_serves_its_adapters(gang_tp2, jax_tokens):
    from ray_tpu_torch.llm import SamplingParams

    gang_tp2.set_perf_knobs(decode_steps=4, decode_runahead=2)
    try:
        before = gang_tp2.stats()["rebuilds"]
        params = SamplingParams(max_tokens=40, ignore_eos=True, temperature=0.7, seed=5)
        req = gang_tp2.engine.submit("tell me a story", sampling_params=params, lora="b")
        assert isinstance(req.stream_queue.get(timeout=120), int)
        gang_tp2.workers[1].kill()
        gang_tp2.workers[1].join(timeout=30)
        assert req.done.wait(timeout=180) and req.finish_reason == "length", req.error
        assert gang_tp2.stats()["rebuilds"] == before + 1
        again = gang_tp2.engine.submit("tell me a story", sampling_params=params, lora="b")
        assert again.done.wait(timeout=180) and again.out_tokens == req.out_tokens
        assert gang_tp2.engine.list_loras() == ["a", "b"]
        assert _tokens(gang_tp2, PROMPTS, ["a"] * 3) == jax_tokens["tp2"]["a"]
    finally:
        gang_tp2.set_perf_knobs(decode_steps=1, decode_runahead=1)


# ---- the gang's direct entries -----------------------------------------------------


def test_gang_call_routes_as_the_reference(gang_tp2, jax_tokens):
    from ray_tpu.serve.proxy import Request

    tok = gang_tp2.tokenizer
    info = gang_tp2(Request("GET", "/v1/models", {}, {}, b""))
    assert info["object"] == "model" and info["gang"]["mesh"]["tp"] == 2
    assert gang_tp2(Request("GET", "/model_info", {}, {}, b""))["gang"]["world"] == 2
    body = {"prompt": PROMPTS[0], "max_tokens": 8, "ignore_eos": True}
    out = gang_tp2(Request("POST", "/v1/completions", {}, {}, _json(body)))
    assert out["object"] == "text_completion"
    assert out["choices"][0]["text"] == tok.decode(jax_tokens["tp2"][None][0])
    out = gang_tp2(Request("POST", "/v1/completions", {}, {}, _json({**body, "_lora": "a"})))
    assert out["choices"][0]["text"] == tok.decode(jax_tokens["tp2"]["a"][0])
    chat = {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 3, "ignore_eos": True}
    for path in ("/v1/chat/completions", "/chat"):
        out = gang_tp2(Request("POST", path, {}, {}, _json(chat)))
        assert out["object"] == "chat.completion" and out["usage"]["completion_tokens"] == 3
    bad = gang_tp2(Request("POST", "/v1/completions", {}, {}, b"{not json"))
    assert bad == {"error": {"message": "invalid JSON body", "code": 400}}
    lost = gang_tp2(Request("POST", "/v1/embeddings", {}, {}, _json(body)))
    assert lost["error"]["code"] == 404 and "/v1/embeddings" in lost["error"]["message"]


def test_engine_worker_generate_batch_equals_jax_spmd_generator(checkpoint):
    import jax

    from ray_tpu.llm import SamplingParams as JSamplingParams
    from ray_tpu.llm.spmd import SPMDGenerator as JSPMDGenerator
    from ray_tpu.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.train._internal.worker_group import run_ranks

    cfg = _config(checkpoint, tensor_parallel_degree=2, max_loras=0)
    ranks = run_ranks(_batch_loop, {"llm_config": cfg}, num_workers=2, use_gpu=False,
                      timeout_s=240)
    (r0,), (r1,) = ranks
    assert r0["mesh"]["tp"] == 2 and r1["out"] is True
    gen = JSPMDGenerator(_jax_config(cfg), mesh=build_mesh(MeshSpec(tp=2),
                                                           devices=jax.devices()[:2]))
    want = gen.generate_batch([gen.tokenizer.encode(p) for p in PROMPTS],
                              JSamplingParams(max_tokens=6, temperature=0.0, ignore_eos=True))
    assert r0["out"] == want and all(len(t) == 6 for t in want)
