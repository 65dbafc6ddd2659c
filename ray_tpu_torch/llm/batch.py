"""Offline batch inference over the port's Dataset: the port's counterpart of
``ray_tpu/llm/batch.py``.

``build_llm_processor(config)`` returns ``apply(ds) -> Dataset``: the rows
of ``ds`` with the generated text of each under ``output_column``
(reference: ``python/ray/llm/_internal/batch/processor/``). The inference
stage is ``ds.map_batches(infer_block, batch_size=, batch_format="dict")``
over blocks of ``ray_tpu_torch.data``, and every prompt of a batch is
submitted to the engine at once, so a batch is one continuously batched
run:

- ``concurrency > 0``: the stage runs on ``ActorPoolStrategy(size=
  concurrency)``; each actor process builds one engine, on the card
  leasing 1/concurrency of it from the host's card ledger (with
  ``device="cpu"`` the actors lease nothing and run on the CPU);
- ``concurrency == 0``: stateless task stages on the driver's threads with
  the per-process engine cache (``_get_engine``). Several threads then
  submit into one engine: its ``submit`` is a queue put and its scheduler
  batches what arrives, and the cache builds under a lock, so the threads
  share one engine.

The UDF is ``functools.partial(infer_block, config)``: it travels to the
actors by reference. A tensor- or sequence-parallel config is a gang of
rank processes (``TorchEngine`` gives a ``GangEngine``), which an actor
process cannot spawn: it runs with ``concurrency=0``.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import time
from typing import Callable, Optional

import numpy as np

from ray_tpu_torch.llm.config import LLMConfig, SamplingParams

_ENGINE_CACHE: dict = {}
# each cached engine's build: its seconds, and the kernel launch counts of
# this process when it was done (the capture's warm-up steps ran kernels)
_ENGINE_BUILT: dict = {}
_ENGINE_LOCK = threading.Lock()


def _engine_key(config: LLMConfig, device: Optional[str]) -> tuple:
    return (
        config.model.model_id,
        config.model.checkpoint_path,
        config.model.tokenizer,
        config.model.seed,
        config.engine.max_num_seqs,
        config.engine.max_seq_len,
        config.engine.dtype,
        config.engine.tensor_parallel_degree,
        config.engine.sequence_parallel_degree,
        device,
    )


def _get_engine(config: LLMConfig, device: Optional[str] = None):
    """Per-process engine cache, keyed as the reference keys it (``:22-32``)
    and by device: map tasks that reuse a process reuse its engine. Built
    under a lock: the driver's task threads share one engine."""
    key = _engine_key(config, device)
    with _ENGINE_LOCK:
        eng = _ENGINE_CACHE.get(key)
        if eng is None:
            from ray_tpu_torch.llm.engine import TorchEngine
            from ray_tpu_torch.ops import launch_counts

            t0 = time.perf_counter()
            eng = TorchEngine(config, device=device)
            _ENGINE_BUILT[key] = {"seconds": time.perf_counter() - t0,
                                  "launches": launch_counts()}
            _ENGINE_CACHE[key] = eng
    return eng


@dataclasses.dataclass
class ProcessorConfig:
    llm_config: LLMConfig
    batch_size: int = 16
    prompt_column: str = "prompt"
    output_column: str = "generated_text"
    sampling_params: Optional[dict] = None
    # Engine replicas: >0 runs the inference stage on a warm actor pool of
    # this size (each actor holds ONE engine for its lifetime, on
    # 1/concurrency of the card); 0 = stateless tasks with the per-process
    # engine cache.
    concurrency: int = 1
    # where the engines run: None is the card, "cpu" the CPU
    device: Optional[str] = None


def _sampling(d: dict) -> SamplingParams:
    allowed = {f for f in SamplingParams.__dataclass_fields__}
    return SamplingParams(**{k: v for k, v in d.items() if k in allowed})


def infer_block(config: ProcessorConfig, batch: dict) -> dict:
    """One batch (``ray_tpu/llm/batch.py:68-86``): every prompt submitted to
    the process's engine at once, each waited for (a dead decode loop
    surfaces as the request's error, raised here), the texts added as an
    object array under ``output_column``."""
    engine = _get_engine(config.llm_config, config.device)
    sp = dict(config.sampling_params or {})
    prompts = [str(p) for p in batch[config.prompt_column]]
    reqs = [engine.submit(p, sampling_params=_sampling(sp)) for p in prompts]
    texts = []
    for r in reqs:
        engine._await_done(r)
        if r.error is not None:
            raise r.error
        texts.append(engine.tokenizer.decode(r.out_tokens))
    out = dict(batch)
    out[config.output_column] = np.asarray(texts, dtype=object)
    return out


def build_llm_processor(
    config: ProcessorConfig,
    preprocess: Optional[Callable[[dict], dict]] = None,
    postprocess: Optional[Callable[[dict], dict]] = None,
) -> Callable:
    """Returns fn(Dataset) -> Dataset adding generated text per row:
    ``preprocess`` on each row, the inference stage, ``postprocess`` on
    each row."""
    engine = config.llm_config.engine
    if config.concurrency > 0 and (engine.tensor_parallel_degree > 1
                                   or engine.sequence_parallel_degree > 1):
        raise ValueError("a tensor- or sequence-parallel engine is a gang of rank processes, "
                         "which an actor process cannot spawn: use concurrency=0")

    def apply(ds):
        from ray_tpu_torch.data import ActorPoolStrategy

        if preprocess is not None:
            ds = ds.map(preprocess)
        compute = None
        if config.concurrency > 0:
            share = {} if config.device == "cpu" else {"GPU": 1.0 / config.concurrency}
            compute = ActorPoolStrategy(size=config.concurrency, resources=share)
        ds = ds.map_batches(
            functools.partial(infer_block, config),
            batch_size=config.batch_size,
            batch_format="dict",
            compute=compute,
        )
        if postprocess is not None:
            ds = ds.map(postprocess)
        return ds

    return apply
