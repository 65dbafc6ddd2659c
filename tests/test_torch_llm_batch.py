"""Offline batch inference in the port (``ray_tpu_torch/llm/batch.py``) against
the JAX package's (``ray_tpu/llm/batch.py``).

Both packages' engines read one set of well-conditioned fp32 weights from
a JAX ``save_pytree`` checkpoint (the config's seed draws different
numbers in the two packages), so the greedy texts must be equal:

- the mirror of ``tests/test_llm.py::test_batch_processor``: the port's
  block function mapped over a ``ray_tpu.data`` Dataset with
  ``map_batches``, the texts equal to JAX's ``build_llm_processor`` over
  the same rows;
- ``apply`` over a port Dataset (``ray_tpu_torch.data``) in task stages
  (``concurrency=0``), with ``preprocess`` and ``postprocess``;
- a tp2 config: ``apply`` runs on the gang of 2 gloo ranks that
  ``TorchEngine`` gives it (task stages: an actor cannot spawn the gang),
  the texts equal to JAX's ``build_llm_processor`` over a ``JaxEngine`` on
  a 2-device tp mesh;
- the per-process engine cache: one engine per key.
"""

import dataclasses
import functools

import numpy as np
import pytest

pytestmark = pytest.mark.timeout(300)

SAMPLING = {"max_tokens": 3, "temperature": 0.0, "ignore_eos": True}


def _conditioned(shapes: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    d = shapes["final_norm"][0]
    return {k: (np.ones(s, np.float32) if "norm" in k
                else (rng.standard_normal(s) / np.sqrt(d)).astype(np.float32))
            for k, s in sorted(shapes.items())}


def _config(checkpoint=None, **engine_kw):
    from ray_tpu_torch.llm import EngineConfig, LLMConfig, ModelConfig

    kw = dict(max_num_seqs=4, max_seq_len=64, prefill_buckets=(16, 32, 64), dtype="float32")
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
    d = tmp_path_factory.mktemp("batch_ckpt")
    save_pytree(_conditioned(tl._param_shapes(mcfg), seed=4), str(d))
    return str(d)


@pytest.fixture(scope="module", autouse=True)
def engines():
    """The port's per-process engine cache, emptied (and its engines shut
    down) after the module."""
    from ray_tpu_torch.llm import batch

    yield batch._ENGINE_CACHE
    for eng in batch._ENGINE_CACHE.values():
        eng.shutdown()
    batch._ENGINE_CACHE.clear()


def test_block_function_over_a_ray_tpu_dataset_equals_jax(ray_start_thread, checkpoint):
    from ray_tpu import data as rd
    from ray_tpu.llm import ProcessorConfig as JProcessorConfig
    from ray_tpu.llm import build_llm_processor as jbuild
    from ray_tpu_torch.llm import ProcessorConfig
    from ray_tpu_torch.llm.batch import infer_block

    cfg = _config(checkpoint)
    items = [{"prompt": f"p{i}"} for i in range(8)]
    pcfg = ProcessorConfig(llm_config=cfg, batch_size=4, sampling_params=SAMPLING, device="cpu")
    rows = rd.from_items(items, parallelism=2).map_batches(
        functools.partial(infer_block, pcfg), batch_size=4, batch_format="dict").take_all()
    jproc = jbuild(JProcessorConfig(llm_config=_jax_config(cfg), batch_size=4,
                                    sampling_params=SAMPLING))
    want = jproc(rd.from_items(items, parallelism=2)).take_all()
    assert len(rows) == len(want) == 8
    got = {r["prompt"]: r["generated_text"] for r in rows}
    assert got == {r["prompt"]: r["generated_text"] for r in want}
    assert all(isinstance(t, str) and len(t.encode("utf-8", "replace")) > 0 for t in got.values())


def test_apply_over_blocks_with_pre_and_postprocess(checkpoint):
    import ray_tpu_torch.data as td
    from ray_tpu_torch.llm import (ProcessorConfig, SamplingParams, TorchEngine,
                                   build_llm_processor)

    cfg = _config(checkpoint)
    proc = build_llm_processor(
        ProcessorConfig(llm_config=cfg, batch_size=3, sampling_params=SAMPLING, concurrency=0,
                        device="cpu"),
        preprocess=lambda row: {**row, "prompt": row["prompt"].upper()},
        postprocess=lambda row: {**row, "n": len(row["generated_text"])},
    )
    items = [{"prompt": p, "id": i} for i, p in enumerate(["a", "bb", "ccc", "dddd", "e"])]
    out = proc(td.from_items(items, parallelism=2)).materialize()
    # blocks of 3 and 2 rows, each one batch of at most batch_size
    assert [len(b["prompt"]) for b in out.get_internal_block_refs()] == [3, 2]
    rows = out.take_all()
    assert [r["id"] for r in rows] == [0, 1, 2, 3, 4]
    eng = TorchEngine(cfg, device="cpu")
    try:
        for r in rows:
            want = eng.generate(r["prompt"], sampling_params=SamplingParams(**SAMPLING)).text
            assert r["prompt"].isupper() and r["generated_text"] == want
            assert r["n"] == len(want)
    finally:
        eng.shutdown()


def test_tp2_processor_on_a_gang_equals_jax_on_a_2_device_mesh(ray_start_thread, checkpoint,
                                                               monkeypatch):
    import jax

    from ray_tpu import data as rd
    from ray_tpu.llm import ProcessorConfig as JProcessorConfig
    from ray_tpu.llm import batch as jbatch
    from ray_tpu.llm import build_llm_processor as jbuild
    from ray_tpu.llm.engine import JaxEngine
    from ray_tpu.parallel.mesh import MeshSpec, build_mesh
    import ray_tpu_torch.data as td
    from ray_tpu_torch.llm import ProcessorConfig, build_llm_processor
    from ray_tpu_torch.llm.batch import _get_engine
    from ray_tpu_torch.llm.gang import GangEngine

    cfg = _config(checkpoint, tensor_parallel_degree=2)
    prompts = [f"p{i}" for i in range(6)]
    with pytest.raises(ValueError, match="concurrency=0"):  # no gang inside an actor
        build_llm_processor(ProcessorConfig(llm_config=cfg, device="cpu"))
    proc = build_llm_processor(ProcessorConfig(llm_config=cfg, batch_size=4, concurrency=0,
                                               sampling_params=SAMPLING, device="cpu"))
    rows = proc(td.from_items([{"prompt": p} for p in prompts], parallelism=1)).take_all()
    assert isinstance(_get_engine(cfg, "cpu"), GangEngine)
    assert [r["prompt"] for r in rows] == prompts
    got = {r["prompt"]: r["generated_text"] for r in rows}
    # JAX's processor over one engine on a 2-device tp mesh (its own cache
    # would build the mesh over every virtual device)
    jeng = JaxEngine(_jax_config(cfg), mesh=build_mesh(MeshSpec(tp=2), devices=jax.devices()[:2]))
    monkeypatch.setattr(jbatch, "_get_engine", lambda config: jeng)
    try:
        want = jbuild(JProcessorConfig(llm_config=_jax_config(cfg), batch_size=4,
                                       sampling_params=SAMPLING))(
            rd.from_items([{"prompt": p} for p in prompts], parallelism=2)).take_all()
    finally:
        jeng.shutdown()
    assert got == {r["prompt"]: r["generated_text"] for r in want}
    assert len(got) == 6 and all(len(t) > 0 for t in got.values())


def test_engine_cache_builds_one_engine_per_key(engines, checkpoint):
    from ray_tpu_torch.llm.batch import _get_engine

    cfg = _config(checkpoint)
    a = _get_engine(cfg, "cpu")
    assert _get_engine(_config(checkpoint), "cpu") is a  # an equal config, another object
    b = _get_engine(_config(checkpoint, max_num_seqs=2), "cpu")
    assert b is not a and b.config.engine.max_num_seqs == 2
    assert sum(e is a for e in engines.values()) == 1
    assert len({id(e) for e in engines.values()}) == len(engines)
