"""The port's multi-LoRA serving against the JAX package's, on the CPU.

The stacked adapters of the decode path (``init_lora_stack``, the per-row
low-rank deltas on q and v), the engine's adapter registry and per-slot
adapter ids, and the server's LoRA methods. Stacks and inputs are numpy
arrays from a seed given to both packages; model weights come from the
JAX package through ``params_from_jax``. Widths are ``LlamaConfig.tiny``'s;
tolerance ``TOL`` (rtol = atol = 2e-4, the decode tests' fp32 limit).
Engine tests mirror tests/test_llm.py's multi-LoRA tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import JaxEngine
from ray_tpu.llm import config as jcfgmod
from ray_tpu.models import llama as jl
from ray_tpu_torch.llm import LLMServer, SamplingParams, TorchEngine
from ray_tpu_torch.llm import config as tcfgmod
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models.convert import params_from_jax

TOL = dict(rtol=2e-4, atol=2e-4)
P6 = SamplingParams(max_tokens=6, temperature=0.0, ignore_eos=True)


def _stack(cfg, n, rank, seed, scale=0.5):
    """A random [L, n + 1, ...] stack, slot 0 zero (the base model)."""
    rng = np.random.default_rng(seed)
    L, e, h, kv, hd = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    shapes = {"wq_a": (L, n + 1, e, rank), "wq_b": (L, n + 1, rank, h, hd),
              "wv_a": (L, n + 1, e, rank), "wv_b": (L, n + 1, rank, kv, hd)}
    out = {}
    for k, s in shapes.items():
        a = (rng.standard_normal(s) * scale).astype(np.float32)
        a[:, 0] = 0.0
        out[k] = a
    return out


def _adapter(stack, i):
    return {k: v[:, i] for k, v in stack.items()}


def test_init_lora_stack_matches_jax():
    for kw in ({}, {"n_kv_heads": 4}):
        jcfg, tcfg = jl.LlamaConfig.tiny(**kw), tl.LlamaConfig.tiny(**kw)
        want = jl.init_lora_stack(jcfg, 3, 4)
        got = tl.init_lora_stack(tcfg, 3, 4, "cpu")
        assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}
        assert all(v.dtype == torch.float32 and not v.any() for v in got.values())


@pytest.mark.parametrize("kv", [2, 4], ids=["gqa", "mha"])
def test_lora_prefill_and_decode_match_jax_with_mixed_adapters(kv):
    """4 rows on adapters [0, 1, 2, 1] (0 = base): prefill and 3 decode
    steps, logits and cache against the JAX package's."""
    jcfg, tcfg = jl.LlamaConfig.tiny(n_kv_heads=kv), tl.LlamaConfig.tiny(n_kv_heads=kv)
    jp = jl.init_params(jax.random.PRNGKey(kv), jcfg)
    tp = params_from_jax(jax.device_get(jp), "cpu")
    stack = _stack(jcfg, 2, 4, seed=kv)
    jlora = {k: jnp.asarray(v) for k, v in stack.items()}
    tlora = {k: torch.from_numpy(v) for k, v in stack.items()}
    ids = np.asarray([0, 1, 2, 1], np.int32)
    prompt = np.random.default_rng(kv).integers(0, 256, (4, 7)).astype(np.int32)
    lengths = np.asarray([7, 5, 7, 3], np.int32)
    jlog, jc = jl.prefill(jp, jl.init_kv_cache(jcfg, 4, 16), jnp.asarray(prompt), jcfg,
                          lengths=jnp.asarray(lengths), loras=jlora, adapter_ids=jnp.asarray(ids))
    tlog, tc = tl.prefill(tp, tl.init_kv_cache(tcfg, 4, 16, "cpu"), torch.from_numpy(prompt), tcfg,
                          lengths=torch.from_numpy(lengths), loras=tlora,
                          adapter_ids=torch.from_numpy(ids))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
        jlog, jc = jl.decode_step(jp, jc, jnp.asarray(nxt), jcfg, loras=jlora,
                                  adapter_ids=jnp.asarray(ids))
        tlog, tc = tl.decode_step(tp, tc, torch.from_numpy(nxt), tcfg, loras=tlora,
                                  adapter_ids=torch.from_numpy(ids))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        np.testing.assert_allclose(tc["v"].numpy(), np.asarray(jc["v"]), **TOL)
    # the adapters change the rows they are on
    base, _ = tl.prefill(tp, tl.init_kv_cache(tcfg, 4, 16, "cpu"), torch.from_numpy(prompt), tcfg,
                         lengths=torch.from_numpy(lengths))
    assert torch.equal(base[0], tl.prefill(
        tp, tl.init_kv_cache(tcfg, 4, 16, "cpu"), torch.from_numpy(prompt), tcfg,
        lengths=torch.from_numpy(lengths), loras=tlora, adapter_ids=torch.from_numpy(ids))[0][0])
    assert not np.allclose(base[1].numpy(), np.asarray(jl.prefill(
        jp, jl.init_kv_cache(jcfg, 4, 16), jnp.asarray(prompt), jcfg, lengths=jnp.asarray(lengths),
        loras=jlora, adapter_ids=jnp.asarray(ids))[0][1]), **TOL)


def test_base_slot_is_bit_equal_to_no_lora():
    """Adapter 0 adds an exact zero: its logits equal the no-LoRA path's
    bit for bit, whatever the other slots hold."""
    tcfg = tl.LlamaConfig.tiny()
    tp = tl.init_params(tcfg, seed=2, device="cpu")
    tlora = {k: torch.from_numpy(v) for k, v in _stack(tcfg, 2, 4, seed=2).items()}
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (2, 5)).astype(np.int32))
    want, _ = tl.prefill(tp, tl.init_kv_cache(tcfg, 2, 8, "cpu"), tokens, tcfg)
    got, _ = tl.prefill(tp, tl.init_kv_cache(tcfg, 2, 8, "cpu"), tokens, tcfg, loras=tlora,
                        adapter_ids=torch.zeros(2, dtype=torch.int32))
    assert torch.equal(got, want)


# ---- the engine --------------------------------------------------------------

def _llm_cfg(mod, **engine_kw):
    ek = dict(max_num_seqs=2, max_seq_len=64, prefill_buckets=(16, 32, 64), max_loras=2, lora_rank=4)
    ek.update(engine_kw)
    return mod.LLMConfig(model=mod.ModelConfig(model_id="tiny", tokenizer="byte", seed=0),
                         engine=mod.EngineConfig(**ek))


def _engine(jax_params=None, **engine_kw):
    eng = TorchEngine(_llm_cfg(tcfgmod, **engine_kw), device="cpu")
    if jax_params is not None:
        eng.params = params_from_jax(jax_params, "cpu")
    return eng


def _random_adapter(eng, rng):
    return {k: rng.normal(scale=0.5, size=v.shape[:1] + v.shape[2:]).astype(np.float32)
            for k, v in eng.loras.items()}


def test_multi_lora_engine():
    """Mirrors tests/test_llm.py:test_multi_lora_engine: a zero adapter
    changes nothing, a random one changes the continuation, base requests
    are unaffected, the errors and the reuse of a freed slot, and the base
    slot equal to a no-LoRA engine's."""
    eng = _engine()
    try:
        base_out = eng.generate("hello world", sampling_params=P6)
        zero = {k: np.zeros(v.shape[:1] + v.shape[2:], np.float32) for k, v in eng.loras.items()}
        assert eng.add_lora("zero", zero) == 1
        assert eng.generate("hello world", sampling_params=P6, lora="zero").token_ids == base_out.token_ids
        assert eng.add_lora("rand", _random_adapter(eng, np.random.default_rng(0))) == 2
        assert eng.generate("hello world", sampling_params=P6, lora="rand").token_ids != base_out.token_ids
        assert eng.generate("hello world", sampling_params=P6).token_ids == base_out.token_ids
        assert eng.list_loras() == ["rand", "zero"]
        assert eng.add_lora("zero", zero) == 1  # already loaded: its slot
        with pytest.raises(KeyError):
            eng.generate("x", sampling_params=P6, lora="nope")
        with pytest.raises(RuntimeError):  # both slots in use
            eng.add_lora("third", zero)
        eng.remove_lora("zero")
        eng.remove_lora("zero")  # unknown: nothing to do
        with pytest.raises(ValueError, match="shape"):
            eng.add_lora("bad", {k: v[:1] for k, v in zero.items()})
        assert not any(v[:, 1].any() for v in eng.loras.values())
        assert eng.add_lora("third", zero) == 1  # the freed slot is reused
        assert eng.list_loras() == ["rand", "third"]
    finally:
        eng.shutdown()
    eng0 = TorchEngine(_llm_cfg(tcfgmod, max_loras=0), device="cpu")
    try:
        assert eng0.loras is None
        with pytest.raises(ValueError, match="max_loras=0"):
            eng0.add_lora("a", zero)
        assert eng0.generate("hello world", sampling_params=P6).token_ids == base_out.token_ids
    finally:
        eng0.shutdown()


def test_multi_lora_batched_mixed_adapters():
    """Mirrors tests/test_llm.py:test_multi_lora_batched_mixed_adapters:
    concurrent requests on different adapters share decode steps and give
    their sequential tokens; a slot's adapter id is reset when it frees."""
    eng = _engine(max_num_seqs=4)
    try:
        rng = np.random.default_rng(1)
        for name in ("a", "b"):
            eng.add_lora(name, _random_adapter(eng, rng))
        p = SamplingParams(max_tokens=5, temperature=0.0, ignore_eos=True)
        ref_a = eng.generate("prompt one", sampling_params=p, lora="a").token_ids
        ref_b = eng.generate("prompt two", sampling_params=p, lora="b").token_ids
        ref_0 = eng.generate("prompt three", sampling_params=p).token_ids
        reqs = [eng.submit("prompt one", sampling_params=p, lora="a"),
                eng.submit("prompt two", sampling_params=p, lora="b"),
                eng.submit("prompt three", sampling_params=p)]
        for r in reqs:
            assert r.done.wait(timeout=120) and r.error is None
        assert [r.out_tokens for r in reqs] == [ref_a, ref_b, ref_0]
        assert ref_a != ref_b
        pool = eng._pools[0]
        assert not pool.adapter_ids.any() and not pool.adapter_host.any()
    finally:
        eng.shutdown()


def test_lora_engine_tokens_equal_jax_engine():
    """The same weights and adapters in both engines: equal greedy tokens
    for base and adapted requests (fp32)."""
    jeng = JaxEngine(_llm_cfg(jcfgmod, dtype="float32"))
    teng = _engine(jax.device_get(jeng.params), dtype="float32")
    try:
        rng = np.random.default_rng(3)
        for name in ("a", "b"):
            adapter = _random_adapter(teng, rng)
            jeng.add_lora(name, adapter)
            teng.add_lora(name, adapter)
        for prompt, lora in (("hello", None), ("hello", "a"), ("the quick fox", "b")):
            want = jeng.generate(prompt, sampling_params=P6, lora=lora).token_ids
            assert teng.generate(prompt, sampling_params=P6, lora=lora).token_ids == want
    finally:
        jeng.shutdown()
        teng.shutdown()


def test_adapted_requests_neither_read_nor_store_prefixes():
    eng = _engine(enable_prefix_caching=True)
    try:
        eng.add_lora("a", _random_adapter(eng, np.random.default_rng(4)))
        system = "You are helpful. " * 2  # 35 tokens: covers bucket 32
        a1 = eng.generate(system + "one", sampling_params=P6, lora="a")
        assert eng.get_stats()["prefix_cache_entries"] == 0  # not stored
        base = eng.generate(system + "one", sampling_params=P6)
        assert base.metrics["prefix_hit_tokens"] == 0 and eng.get_stats()["prefix_cache_entries"] > 0
        a2 = eng.generate(system + "one", sampling_params=P6, lora="a")
        assert a2.metrics["prefix_hit_tokens"] == 0  # base KV not reused
        assert a2.token_ids == a1.token_ids != base.token_ids
        assert eng.generate(system + "two", sampling_params=P6).metrics["prefix_hit_tokens"] == 32
    finally:
        eng.shutdown()


# ---- the server --------------------------------------------------------------

def test_server_loads_lists_unloads_and_routes():
    rng = np.random.default_rng(5)
    stack = _stack(tl.LlamaConfig.tiny(vocab_size=258), 1, 4, seed=5)
    cfg = _llm_cfg(tcfgmod)
    cfg.lora_adapters = {"pre": _adapter(stack, 1)}
    server = LLMServer(cfg, device="cpu")
    try:
        assert server.list_loras() == ["pre"]
        assert server.load_lora("rt", _random_adapter(server.engine, rng)) is True
        assert server.list_loras() == ["pre", "rt"]
        body = {"prompt": "route me", "max_tokens": 6, "ignore_eos": True}
        base = server.completions(body)["choices"][0]["text"]
        adapted = server.completions({**body, "_lora": "rt"})["choices"][0]["text"]
        assert adapted != base
        assert server.engine.generate("route me", sampling_params=P6, lora="rt").text == adapted
        chunks = list(server.completions_stream({**body, "_lora": "rt"}))
        assert "".join(c["choices"][0]["text"] for c in chunks) == adapted
        chat = {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 4, "_lora": "pre"}
        assert server.chat(chat)["object"] == "chat.completion"
        assert list(server.chat_stream(chat))[-1]["choices"][0]["finish_reason"] == "length"
        assert server.unload_lora("rt") is True
        assert server.list_loras() == ["pre"]
        err = server.completions({**body, "_lora": "rt"})["error"]
        assert err["code"] == 404 and "'rt'" in err["message"]
        assert next(iter(server.chat_stream({**chat, "_lora": "gone"})))["error"]["code"] == 404
    finally:
        server.engine.shutdown()


def test_server_lora_from_a_path_waits_for_checkpoints():
    server = LLMServer(_llm_cfg(tcfgmod), device="cpu")
    try:
        with pytest.raises(NotImplementedError, match="restore_pytree"):
            server.load_lora("a", "/some/checkpoint")
        assert server.list_loras() == []
    finally:
        server.engine.shutdown()
