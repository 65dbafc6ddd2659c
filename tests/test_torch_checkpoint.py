"""Checkpoints that cross between the packages, serving from them, and the
runtime glue (the tensor serializer, the GPU accelerator manager).

- The JAX package's ``save_pytree`` of params (bf16 and fp32) restores in
  the port bit-equal (tolerance 0), through a meta template.
- The port's ``save_state_dict`` leaves rebuild the JAX tree with JAX's own
  treedef (JAX's ``restore_pytree`` cannot read a port checkpoint: its
  treedef is null), bit-equal.
- A wrong template raises, naming the leaf.
- ``JaxEngine`` and ``TorchEngine`` built from one fp32 checkpoint
  directory give equal greedy tokens; ``LLMServer.load_lora(name, path)``
  on a JAX-written adapter gives the JAX server's tokens.
- The example train loop through TorchTrainer on a CPU rank fails,
  resumes from its train-state checkpoint and reports the params, which
  LLMServer serves (chip_smoke.py's train_serve phase at tiny size).
- The serializer round-trips contiguous, strided, bf16 and 0-d tensors
  through a ray_tpu ``SerializationContext`` with the array out-of-band.
"""

import multiprocessing
import os

import jax
import numpy as np
import pytest
import torch

from ray_tpu.llm import JaxEngine, LLMServer as JaxServer
from ray_tpu.llm import config as jcfgmod
from ray_tpu.models import llama as jl
from ray_tpu.train import restore_pytree, save_pytree
from ray_tpu_torch.accelerator import GPUAcceleratorManager
from ray_tpu_torch.llm import LLMServer, SamplingParams, TorchEngine
from ray_tpu_torch.llm import config as tcfgmod
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.train import Checkpoint, restore_state_dict, save_state_dict
from ray_tpu_torch.train.checkpoint import _PYTREE_DATA

P6 = SamplingParams(max_tokens=6, temperature=0.0, ignore_eos=True)


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.contiguous()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _jax_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_jax_checkpoint_restores_bit_equal(tmp_path, dtype):
    jcfg = jl.LlamaConfig.tiny(dtype=getattr(jax.numpy, dtype))
    tcfg = tl.LlamaConfig.tiny(dtype=getattr(torch, dtype))
    jparams = jl.init_params(jax.random.PRNGKey(4), jcfg)
    save_pytree(jparams, str(tmp_path))
    got = restore_state_dict(str(tmp_path), like=tl.param_template(tcfg))
    assert sorted(got) == sorted(jparams)
    for k, t in got.items():
        assert t.dtype == tcfg.dtype and t.device.type == "cpu"
        np.testing.assert_array_equal(_bits(t), _jax_bits(jparams[k]), err_msg=k)
    # the same through Checkpoint, and a JAX checkpoint names no keys
    assert Checkpoint(str(tmp_path)).to_state_dict(like=tl.param_template(tcfg)).keys() == got.keys()
    with pytest.raises(ValueError, match="names no keys"):
        restore_state_dict(str(tmp_path))


def test_port_leaves_rebuild_the_jax_tree(tmp_path):
    """Nested dicts flatten in JAX's order: the port's leaf_i are JAX's
    leaves, so JAX's treedef rebuilds the tree from them."""
    jparams = jl.init_params(jax.random.PRNGKey(5), jl.LlamaConfig.tiny(dtype=jax.numpy.bfloat16))
    jtree = {"params": jparams, "aux": {"step": np.int32(7), "scale": np.float32(0.5)}}
    ttree = {"params": {k: torch.from_numpy(_jax_bits(v).copy()).view(torch.bfloat16)
                        for k, v in jparams.items()},
             "aux": {"step": 7, "scale": torch.tensor(0.5)}}
    save_state_dict(ttree, str(tmp_path))
    leaves, treedef = jax.tree_util.tree_flatten(jtree)
    with np.load(os.path.join(str(tmp_path), _PYTREE_DATA)) as data:
        stored = [data[f"leaf_{i}"] for i in range(len(leaves))]
    rebuilt = jax.tree_util.tree_unflatten(treedef, stored)
    for k, v in jparams.items():
        np.testing.assert_array_equal(rebuilt["params"][k].view(np.int16), _jax_bits(v), err_msg=k)
    assert int(rebuilt["aux"]["step"]) == 7 and float(rebuilt["aux"]["scale"]) == 0.5
    # the port reads its own checkpoint without a template, and into one
    back = restore_state_dict(str(tmp_path))
    assert back["aux"]["step"].item() == 7 and back["params"]["wq"].dtype == torch.bfloat16
    typed = restore_state_dict(str(tmp_path), like={"params": back["params"],
                                                    "aux": {"step": 0, "scale": back["aux"]["scale"]}})
    assert typed["aux"]["step"] == 7 and isinstance(typed["aux"]["step"], int)
    with pytest.raises(TypeError):  # the one-way crossing: JAX needs its treedef
        restore_pytree(str(tmp_path))


def test_wrong_template_raises_naming_the_leaf(tmp_path):
    jcfg = jl.LlamaConfig.tiny()
    save_pytree(jl.init_params(jax.random.PRNGKey(6), jcfg), str(tmp_path))
    wide = tl.param_template(tl.LlamaConfig.tiny(d_ff=256))
    with pytest.raises(ValueError, match="'w_down'"):
        restore_state_dict(str(tmp_path), like=wide)
    half = tl.param_template(tl.LlamaConfig.tiny(dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="'attn_norm' is float32.*bfloat16"):
        restore_state_dict(str(tmp_path), like=half)
    fewer = dict(tl.param_template(tl.LlamaConfig.tiny()))
    fewer.pop("wq")
    with pytest.raises(ValueError, match="12 leaves, the template 11"):
        restore_state_dict(str(tmp_path), like=fewer)
    port = tmp_path / "port"
    port.mkdir()
    save_state_dict({"a": torch.ones(2)}, str(port))
    with pytest.raises(ValueError, match="no leaf 'b'"):
        restore_state_dict(str(port), like={"b": torch.ones(2)})


def _serve_cfg(mod, path, **engine_kw):
    ek = dict(max_num_seqs=2, max_seq_len=64, prefill_buckets=(16, 32, 64), dtype="float32")
    ek.update(engine_kw)
    return mod.LLMConfig(model=mod.ModelConfig(model_id="tiny", tokenizer="byte", seed=0,
                                               checkpoint_path=path),
                         engine=mod.EngineConfig(**ek))


def test_engines_from_one_checkpoint_give_equal_greedy_tokens(tmp_path):
    jcfg = jl.LlamaConfig.tiny(vocab_size=258)
    save_pytree(jl.init_params(jax.random.PRNGKey(9), jcfg), str(tmp_path))
    jeng = JaxEngine(_serve_cfg(jcfgmod, str(tmp_path)))
    teng = TorchEngine(_serve_cfg(tcfgmod, str(tmp_path)), device="cpu")
    try:
        fresh = TorchEngine(_serve_cfg(tcfgmod, None), device="cpu")  # seeded init
        try:
            assert not torch.equal(fresh.params["wq"], teng.params["wq"])
        finally:
            fresh.shutdown()
        for prompt in ("hello", "the quick brown fox", "ab" * 20):
            want = jeng.generate(prompt, sampling_params=P6).token_ids
            assert teng.generate(prompt, sampling_params=P6).token_ids == want, prompt
    finally:
        jeng.shutdown()
        teng.shutdown()


def test_load_lora_from_a_jax_checkpoint_matches_the_jax_server(tmp_path):
    cfg = jl.LlamaConfig.tiny(vocab_size=258)
    rng = np.random.default_rng(2)
    L, e, h, kv, hd = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    adapter = {"wq_a": rng.normal(scale=0.5, size=(L, e, 4)).astype(np.float32),
               "wq_b": rng.normal(scale=0.5, size=(L, 4, h, hd)).astype(np.float32),
               "wv_a": rng.normal(scale=0.5, size=(L, e, 4)).astype(np.float32),
               "wv_b": rng.normal(scale=0.5, size=(L, 4, kv, hd)).astype(np.float32)}
    base = tmp_path / "base"
    lora = tmp_path / "lora"
    base.mkdir()
    lora.mkdir()
    save_pytree(jl.init_params(jax.random.PRNGKey(10), cfg), str(base))
    save_pytree(adapter, str(lora))
    kw = dict(max_loras=1, lora_rank=4)
    jserver = JaxServer(_serve_cfg(jcfgmod, str(base), **kw))
    tcfg = _serve_cfg(tcfgmod, str(base), **kw)
    tcfg.lora_adapters = {"pre": str(lora)}  # loaded at start, from the path
    tserver = LLMServer(tcfg, device="cpu")
    try:
        assert jserver.load_lora("tuned", str(lora)) is True
        assert tserver.list_loras() == ["pre"]
        body = {"prompt": "abc", "max_tokens": 6, "ignore_eos": True}
        want = jserver.completions({**body, "_lora": "tuned"})["choices"][0]["text"]
        assert tserver.completions({**body, "_lora": "pre"})["choices"][0]["text"] == want
        assert want != jserver.completions(body)["choices"][0]["text"]
    finally:
        jserver.engine.shutdown()
        tserver.engine.shutdown()


# ---- runtime glue -----------------------------------------------------------


@pytest.mark.parametrize("case", ["contiguous", "strided", "bf16", "scalar", "int64"])
def test_tensor_serializer_round_trips_out_of_band(case):
    from ray_tpu._private.serialization import SerializationContext
    from ray_tpu_torch._private.serialization import deserialize_tensor, serialize_tensor

    g = torch.Generator().manual_seed(0)
    t = {"contiguous": torch.randn(64, 32, generator=g),
         "strided": torch.randn(32, 64, generator=g).t()[::2],
         "bf16": torch.randn(16, 48, generator=g).to(torch.bfloat16),
         "scalar": torch.tensor(3.5),
         "int64": torch.arange(1000).reshape(10, 100)}[case]
    ctx = SerializationContext()
    ctx.register_custom_serializer(torch.Tensor, serialize_tensor, deserialize_tensor)
    obj = ctx.serialize({"x": t, "meta": 1})
    assert len(obj.oob) == 1 and len(memoryview(obj.oob[0]).cast("B")) == t.numel() * t.element_size()
    back = ctx.deserialize(type(obj).from_buffer(obj.to_bytes()))["x"]
    assert back.dtype == t.dtype and back.shape == t.shape and back.device.type == "cpu"
    assert torch.equal(back, t)


def test_visibility_env_and_quantities():
    m = GPUAcceleratorManager
    assert m.get_resource_name() == "GPU"
    assert m.get_visibility_env([3]) == {"CUDA_VISIBLE_DEVICES": "3"}
    assert m.get_visibility_env(["0", "2"]) == {"CUDA_VISIBLE_DEVICES": "0,2"}
    assert m.validate_resource_request_quantity(2) == (True, None)
    ok, why = m.validate_resource_request_quantity(0.5)
    assert not ok and "whole cards" in why


def test_visible_count_honours_cuda_visible_devices(monkeypatch):
    m = GPUAcceleratorManager
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "1,3")
    assert m.get_current_process_visible_accelerator_ids() == ["1", "3"]
    assert m.get_current_node_num_accelerators() == 2
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert m.get_current_node_num_accelerators() == 0
    assert m.get_current_node_accelerator_type() is None
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    assert m.get_current_node_num_accelerators() == torch.cuda.device_count()


# ---- train -> checkpoint -> serve (the smoke's train_serve, tiny, on CPU ranks) --


def test_example_trains_fails_resumes_and_serves(tmp_path):
    """The example loop through TorchTrainer on a CPU rank: attempt 0 runs
    2 steps, reports the whole train state, runs step 3 and raises;
    attempt 1 resumes from the step-2 checkpoint, re-runs step 3 to the
    same loss (bit-equal: same params, moments and batch), runs step 4 and
    reports the params. LLMServer then serves that checkpoint: the served
    weights' checksums equal the rank's, the prefill logits equal the
    rank's, and a copy with wq and wk swapped is refused by the same limit."""
    from ray_tpu_torch.examples import train_llama_dp as ex
    from ray_tpu_torch.llm import EngineConfig, LLMConfig, ModelConfig
    from ray_tpu_torch.train import (CheckpointConfig, FailureConfig, RunConfig, ScalingConfig,
                                     TorchTrainer)

    kw = dict(vocab_size=258, d_model=64, n_layers=2, n_heads=4, n_kv_heads=4, d_ff=128)
    probe = {"tokens": list(range(10, 30)), "model_kwargs": kw, "max_seq_len": 64}
    config = {"model": "tiny", "model_kwargs": {**kw, "dtype": torch.bfloat16},
              "steps": 4, "batch": 2, "seq_len": 16, "seed": 5,
              "optimizer": {"learning_rate": 1e-2, "warmup_steps": 1, "total_steps": 10},
              "state_checkpoint_at": 2, "fail_once_after": 3, "probe": probe}
    trainer = TorchTrainer(
        ex.train_loop, train_loop_config=config,
        scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
        run_config=RunConfig(name="ts", storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=1),
                             checkpoint_config=CheckpointConfig(num_to_keep=1)),
    )
    result = trainer.fit()
    assert result.error is None, result.error
    assert not [p for p in multiprocessing.active_children() if "-rank-" in p.name]
    h = result.metrics_history
    assert [m["step"] for m in h] == [1, 2, 3, 3, 4]
    assert h[3]["resumed_from_step"] == 2 and h[3]["resumed_from"].endswith("checkpoint_000001")
    assert h[3]["loss"] == h[2]["loss"]
    assert all(np.isfinite(m["loss"]) for m in h)
    assert result.checkpoint.path.endswith(os.path.join("attempt_001", "checkpoint_000001"))
    assert not os.path.exists(h[3]["resumed_from"])  # num_to_keep=1 pruned it

    cfg = LLMConfig(model=ModelConfig(model_id="tiny", model_kwargs=kw,
                                      checkpoint_path=result.checkpoint.path),
                    engine=EngineConfig(max_num_seqs=2, max_seq_len=64, prefill_buckets=(32, 64)))
    server = LLMServer(cfg, device="cpu")
    try:
        eng = server.engine
        assert ex.bit_checksums(eng.params) == h[-1]["checksums"]
        got = ex.probe_logits(eng.params, eng.model_cfg, probe["tokens"])
        want = h[-1]["probe_logits"]
        assert np.array_equal(got, want)
        reply = server.completions({"prompt": "hi", "max_tokens": 4, "ignore_eos": True})
        assert reply["usage"]["completion_tokens"] == 4
    finally:
        server.engine.shutdown()
    swapped = {**eng.params, "wq": eng.params["wk"], "wk": eng.params["wq"]}
    bad = ex.probe_logits(swapped, eng.model_cfg, probe["tokens"])
    rel = np.sqrt(np.mean((bad - want) ** 2) / np.mean(want ** 2))
    assert rel > 5e-2, rel
