"""Offline batch inference: the port's counterpart of ``ray_tpu/llm/batch.py``.

``build_llm_processor(config)`` returns ``apply``: an iterable of
column-dict blocks in, blocks out, each with the generated text of every
row under ``output_column``. The engine is built once per process and key
(``_get_engine``) and every prompt of a block is submitted to it at once,
so a block is one continuously batched run. A tensor- or
sequence-parallel config gets its gang through ``TorchEngine``.

The port has no Dataset runtime and imports none: the reference's
``map_batches`` / ``ActorPoolStrategy`` wiring (``:88-104``) stays out.
The block function, ``infer_block(config, batch)``, is public, so a Dataset
of any runtime can map it over its blocks (``functools.partial`` binds the
config).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Iterator, Optional

import numpy as np

from ray_tpu_torch.llm.config import LLMConfig, SamplingParams

_ENGINE_CACHE: dict = {}


def _get_engine(config: LLMConfig, device: Optional[str] = None):
    """Per-process engine cache, keyed as the reference keys it (``:22-32``)
    and by device: map tasks that reuse a process reuse its engine."""
    key = (
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
    eng = _ENGINE_CACHE.get(key)
    if eng is None:
        from ray_tpu_torch.llm.engine import TorchEngine

        eng = TorchEngine(config, device=device)
        _ENGINE_CACHE[key] = eng
    return eng


@dataclasses.dataclass
class ProcessorConfig:
    llm_config: LLMConfig
    batch_size: int = 16
    prompt_column: str = "prompt"
    output_column: str = "generated_text"
    sampling_params: Optional[dict] = None
    # where the engines run: None is the card, "cpu" the CPU (the
    # reference's ``concurrency``, its actor pool's size, has no runtime to
    # size here)
    device: Optional[str] = None


def _sampling(d: dict) -> SamplingParams:
    allowed = {f for f in SamplingParams.__dataclass_fields__}
    return SamplingParams(**{k: v for k, v in d.items() if k in allowed})


def infer_block(config: ProcessorConfig, batch: dict) -> dict:
    """One block (``ray_tpu/llm/batch.py:68-86``): every prompt submitted to
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
) -> Callable[[Iterable[dict]], Iterator[dict]]:
    """Returns ``apply(blocks)``: for each column-dict block, in order,
    ``preprocess`` on each row, then the rows in slices of
    ``batch_size`` through ``infer_block``, then ``postprocess`` on each
    row; yields the output blocks."""

    def rows(block: dict, fn) -> dict:
        n = len(next(iter(block.values()))) if block else 0
        out = [fn({k: v[i] for k, v in block.items()}) for i in range(n)]
        return {k: [r[k] for r in out] for k in (out[0] if out else block)}

    def apply(blocks: Iterable[dict]) -> Iterator[dict]:
        for block in blocks:
            if preprocess is not None:
                block = rows(block, preprocess)
            n = len(block[config.prompt_column])
            for i in range(0, n, config.batch_size):
                part = infer_block(config, {k: v[i : i + config.batch_size]
                                            for k, v in block.items()})
                yield part if postprocess is None else rows(part, postprocess)

    return apply
