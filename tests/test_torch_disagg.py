"""Prefill/decode disaggregation in the port (``ray_tpu_torch/llm/disagg.py``)
against the JAX package's (``ray_tpu/llm/disagg.py``) and against both
packages' unified engines.

Both packages read one set of well-conditioned fp32 weights (norms one,
N(0, 1) / sqrt(d) elsewhere) from a JAX ``save_pytree`` checkpoint, so the
greedy tokens of the two packages are compared for equality, and the KV
handoff for closeness:

- the port's ``PrefillWorker`` handoff against JAX's: ``k`` and ``v``
  within 1e-5 of the largest |entry| (fp32, the same function summed in
  another order), ``length``, ``first_token`` and ``prompt_token_ids``
  equal;
- JAX's handoff decoded by the port's ``DecodeWorker`` gives JAX's
  ``DecodeWorker`` tokens, and the port's own handoff too;
- the EOS stop (a token the run emits, made the tokenizer's EOS on both
  sides) and the max_seq_len stop as in the reference;
- ``DisaggRouter`` over the workers in one process and behind
  ``ray_tpu.serve`` (the mirror of ``tests/test_llm.py::
  test_prefill_decode_disagg``): the greedy text of ``TorchEngine`` and of
  ``JaxEngine``.
"""

import dataclasses
import types

import numpy as np
import pytest

pytestmark = pytest.mark.timeout(300)

PROMPTS = ["abc", "the quick brown fox jumps", "x" * 40]
KV_LIMIT = 1e-5


def _conditioned(shapes: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    d = shapes["final_norm"][0]
    return {k: (np.ones(s, np.float32) if "norm" in k
                else (rng.standard_normal(s) / np.sqrt(d)).astype(np.float32))
            for k, s in sorted(shapes.items())}


def _config(checkpoint=None, **engine_kw):
    from ray_tpu_torch.llm import EngineConfig, LLMConfig, ModelConfig

    kw = dict(max_num_seqs=2, max_seq_len=64, prefill_buckets=(16, 32, 64), dtype="float32")
    kw.update(engine_kw)
    return LLMConfig(model=ModelConfig(model_id="tiny", tokenizer="byte", seed=0,
                                       checkpoint_path=checkpoint),
                     engine=EngineConfig(**kw))


def _jax_config(port_config):
    from ray_tpu.llm import EngineConfig, LLMConfig, ModelConfig

    return LLMConfig(model=ModelConfig(**dataclasses.asdict(port_config.model)),
                     engine=EngineConfig(**dataclasses.asdict(port_config.engine)))


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    from ray_tpu.train.checkpoint import save_pytree
    from ray_tpu_torch.llm.config import resolve_llama_config
    from ray_tpu_torch.models import llama as tl

    cfg = _config()
    mcfg = resolve_llama_config(cfg.model, cfg.engine, min_vocab=258)
    d = tmp_path_factory.mktemp("disagg_ckpt")
    save_pytree(_conditioned(tl._param_shapes(mcfg), seed=3), str(d))
    return str(d)


@pytest.fixture(scope="module")
def workers(checkpoint):
    import jax.numpy as jnp

    from ray_tpu.llm.disagg import DecodeWorker as JDecode
    from ray_tpu.llm.disagg import PrefillWorker as JPrefill
    from ray_tpu_torch.llm import DecodeWorker, PrefillWorker

    cfg = _config(checkpoint)
    jax_workers = (JPrefill(_jax_config(cfg)), JDecode(_jax_config(cfg)))
    for w in jax_workers:
        # the JAX workers keep restore_pytree's numpy leaves, which their
        # traced layer loop cannot index: put them on the device, as
        # JaxEngine's programs do when they first run
        w.params = {k: jnp.asarray(v) for k, v in w.params.items()}
    return {"port": (PrefillWorker(cfg, device="cpu"), DecodeWorker(cfg, device="cpu")),
            "jax": jax_workers}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.mark.parametrize("prompt", PROMPTS)
def test_prefill_handoff_matches_jax(workers, prompt):
    port, jax_ = workers["port"][0].prefill(prompt), workers["jax"][0].prefill(prompt)
    assert set(port) == set(jax_) == {"k", "v", "length", "first_token", "prompt_token_ids"}
    for name in ("k", "v"):
        assert isinstance(port[name], np.ndarray)  # fp32 crosses as numpy
        assert port[name].shape == np.asarray(jax_[name]).shape == (2, 1, 2, 64, 16)
        assert _rel(port[name], jax_[name]) <= KV_LIMIT, _rel(port[name], jax_[name])
    for name in ("length", "first_token", "prompt_token_ids"):
        assert port[name] == jax_[name]


@pytest.mark.parametrize("prompt", PROMPTS)
def test_port_decodes_jax_handoff_to_jax_tokens(workers, prompt):
    (tp, td), (jp, jd) = workers["port"], workers["jax"]
    handoff = jp.prefill(prompt)
    want = jd.decode(handoff, max_tokens=16)
    got = td.decode(handoff, max_tokens=16)
    assert got["token_ids"] == want["token_ids"] and got["text"] == want["text"]
    assert len(got["token_ids"]) == 16
    assert td.decode(tp.prefill(prompt), max_tokens=16)["token_ids"] == want["token_ids"]
    assert td.counts["decode_graph_replays"] == 0  # the CPU steps eagerly


def test_eos_and_max_seq_len_stops_as_the_reference(workers):
    (tp, td), (jp, jd) = workers["port"], workers["jax"]
    handoff = jp.prefill(PROMPTS[1])
    ref = jd.decode(handoff, max_tokens=12)["token_ids"]
    # the first token a decode step emits that it had not emitted before
    # becomes EOS: the stream stops before it, EOS not kept
    i = next(j for j in range(2, 12) if ref[j] not in ref[1:j])
    eos = types.SimpleNamespace(eos_id=ref[i], decode=td.tokenizer.decode)
    saved = td.tokenizer, jd.tokenizer
    td.tokenizer = jd.tokenizer = eos
    try:
        got = td.decode(handoff, max_tokens=12)["token_ids"]
        assert got == jd.decode(handoff, max_tokens=12)["token_ids"] == ref[:i]
    finally:
        td.tokenizer, jd.tokenizer = saved
    # a 61-token prompt (BOS + 60 bytes) in 64 positions: 3 tokens fit
    long = jp.prefill("y" * 60)
    assert long["length"] == 61
    got = td.decode(long, max_tokens=16)["token_ids"]
    assert got == jd.decode(long, max_tokens=16)["token_ids"] and len(got) == 3
    # max_tokens below 1 still returns the first token, as the reference
    assert td.decode(handoff, max_tokens=1)["token_ids"] == ref[:1]


def test_decode_refuses_a_handoff_of_another_shape(workers):
    tp, td = workers["port"]
    handoff = tp.prefill("abc")
    bad = dict(handoff, k=handoff["k"][:, :, :, :32])
    with pytest.raises(ValueError, match="shape"):
        td.decode(bad)


def test_router_in_one_process_equals_both_engines(workers, checkpoint):
    from ray_tpu.llm import SamplingParams as JSamplingParams
    from ray_tpu.llm.engine import JaxEngine
    from ray_tpu_torch.llm import DisaggRouter, SamplingParams, TorchEngine

    tp, td = workers["port"]
    router = DisaggRouter(tp, td)
    teng = TorchEngine(_config(checkpoint), device="cpu")
    jeng = JaxEngine(_jax_config(_config(checkpoint)))
    try:
        for prompt in PROMPTS:
            out = router({"prompt": prompt, "max_tokens": 8})
            want = teng.generate(prompt, sampling_params=SamplingParams(
                max_tokens=8, temperature=0.0, ignore_eos=True))
            jwant = jeng.generate(prompt, sampling_params=JSamplingParams(
                max_tokens=8, temperature=0.0, ignore_eos=True))
            assert out == {"text": want.text, "num_tokens": 8}
            assert want.token_ids == jwant.token_ids
        assert tp.last["handoff_bytes"] == 2 * 2 * 2 * 64 * 16 * 4
    finally:
        teng.shutdown()
        jeng.shutdown()


def test_disagg_behind_ray_tpu_serve(ray_start_thread, checkpoint):
    """The mirror of ``tests/test_llm.py::test_prefill_decode_disagg``: the
    port's workers as separate serve deployments behind the port's router,
    the handoff forwarded replica to replica; the same greedy text as the
    unified engines (``TorchEngine`` and ``JaxEngine``)."""
    from ray_tpu import serve
    from ray_tpu.llm import SamplingParams as JSamplingParams
    from ray_tpu.llm.engine import JaxEngine
    from ray_tpu_torch.llm import (DecodeWorker, DisaggRouter, PrefillWorker, SamplingParams,
                                   TorchEngine)

    cfg = _config(checkpoint)
    prefill = serve.deployment(PrefillWorker, name="prefill:tiny", max_ongoing_requests=4
                               ).bind(cfg, device="cpu")
    decode = serve.deployment(DecodeWorker, name="decode:tiny", max_ongoing_requests=4
                              ).bind(cfg, device="cpu")
    app = serve.deployment(DisaggRouter, name="pd-router:tiny").bind(prefill, decode)
    handle = serve.run(app, name="pd")
    try:
        out = handle.remote({"prompt": "abc", "max_tokens": 5}).result(timeout_s=300)
    finally:
        serve.shutdown()
    assert out["num_tokens"] == 5
    eng = TorchEngine(cfg, device="cpu")
    jeng = JaxEngine(_jax_config(cfg))
    try:
        ref = eng.generate("abc", sampling_params=SamplingParams(
            max_tokens=5, temperature=0.0, ignore_eos=True))
        jref = jeng.generate("abc", sampling_params=JSamplingParams(
            max_tokens=5, temperature=0.0, ignore_eos=True))
    finally:
        eng.shutdown()
        jeng.shutdown()
    assert out["text"] == ref.text == jeng.tokenizer.decode(jref.token_ids)
