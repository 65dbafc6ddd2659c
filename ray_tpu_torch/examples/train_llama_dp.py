"""Data-parallel Llama training with TorchTrainer: the counterpart of
``examples/train_llama_dp.py``.

    python -m ray_tpu_torch.examples.train_llama_dp             # one rank, one card
    python -m ray_tpu_torch.examples.train_llama_dp --cpu 2     # two CPU ranks (gloo)

``train_loop(config)`` builds ``make_train_step(cfg,
dp_group=torch.distributed.group.WORLD)`` on the rank's device, takes the
batch seed from rank 0 (``broadcast_from_rank_zero``), reads each step's
batch from the rank's ``"train"`` dataset shard (``get_dataset_shard``)
through ``data.iter_device_batches`` when the trainer was given one
(rows {"tokens": [seq_len + 1]}), else draws it from (seed, rank, step),
or, with ``global_batch``, takes its rows of the global batch drawn from
(seed, step), and reports ``{"loss", "step", "world_size"}`` (with the
step's wall ms, grad norm and kernel launch counts) after every step. The
last step reports the params as a checkpoint
(``Checkpoint.from_state_dict``) with each tensor's bit checksum and
whether every rank holds the same (an all-gather), and,
when asked, the last-token logits of a probe prompt through the serving
``prefill`` of a serving config. Config keys:

- ``model``: "tiny" (``LlamaConfig.tiny``) or "bench" (``bench.py:31-47``,
  ``tools/train_bench.py:bench_config``); ``model_kwargs``: overrides;
- ``steps``, ``batch``, ``seq_len``, ``seed``; ``optimizer``: kwargs of
  ``default_optimizer``;
- ``global_batch``: B rows a step, drawn from (seed, step) whatever the
  world size; rank r of w takes rows [r B / w, (r + 1) B / w). dp's
  gradient is the mean over the global batch, so a run whose world size
  changes (an elastic resize) computes the same function;
- ``state_checkpoint_at``: after this step, report the whole train state
  (params, AdamW moments, step) as a checkpoint; a restarted rank resumes
  from it (``get_checkpoint``); ``state_checkpoint_every``: the same after
  every k-th step but the last. Rank 0 alone writes a checkpoint (the
  session keeps rank 0's only);
- ``fail_once_after``: raise after this step in an attempt that did not
  resume from a checkpoint (the failure-and-resume check);
- ``probe``: {"tokens": [...], "model_kwargs": ..., "max_seq_len": ...},
  the served model's ``ModelConfig.model_kwargs`` and engine length.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

import ray_tpu_torch.train as train
from ray_tpu_torch.data import iter_device_batches
from ray_tpu_torch.models.llama import LlamaConfig, init_kv_cache, param_template, prefill
from ray_tpu_torch.models.training import TrainState, default_optimizer, make_train_step
from ray_tpu_torch.ops import launch_counts
from ray_tpu_torch.train import Checkpoint


def model_config(config: dict) -> LlamaConfig:
    kw = dict(config.get("model_kwargs", {}))
    if config.get("model", "tiny") == "bench":
        from ray_tpu_torch.tools.train_bench import bench_config

        return bench_config(**kw)
    return LlamaConfig.tiny(max_seq_len=config["seq_len"], **kw)


def serve_config(probe: dict) -> LlamaConfig:
    """The config ``TorchEngine`` resolves for ModelConfig("tiny",
    model_kwargs=probe["model_kwargs"]) at ``probe["max_seq_len"]`` (bf16)."""
    from ray_tpu_torch.llm.config import EngineConfig, ModelConfig, resolve_llama_config
    from ray_tpu_torch.llm.tokenizer import ByteTokenizer

    return resolve_llama_config(
        ModelConfig(model_id="tiny", model_kwargs=probe["model_kwargs"]),
        EngineConfig(max_seq_len=probe["max_seq_len"]),
        min_vocab=ByteTokenizer().vocab_size,
    )


@torch.inference_mode()
def probe_logits(params: dict, cfg: LlamaConfig, tokens: list) -> np.ndarray:
    """Last-token fp32 logits [vocab] of ``tokens`` through ``prefill``."""
    dev = params["embed"].device
    ids = torch.tensor([tokens], dtype=torch.int32, device=dev)
    logits, _ = prefill(params, init_kv_cache(cfg, 1, len(tokens), dev), ids, cfg)
    return logits[0].float().cpu().numpy()


def bit_checksums(params: dict) -> dict[str, int]:
    """Per tensor, sum over i of bits[i] * (i mod 65521 + 1), the bits read
    as int16: equal checksums mean equal bits, in order, with high
    probability. Computed on the tensors' device, in chunks (exact int64)."""
    out = {}
    for name, t in params.items():
        bits = t.detach().contiguous().reshape(-1).view(torch.int16)
        total, chunk = 0, 1 << 26
        for start in range(0, bits.numel(), chunk):
            part = bits[start:start + chunk].long()
            w = torch.arange(start, start + part.numel(), device=part.device) % 65521 + 1
            total += int((part * w).sum())
        out[name] = total % (1 << 64)
    return out


def equal_across_ranks(checksums: dict, device) -> bool:
    """Whether every rank of the process group holds these checksums (an
    all-gather over the group)."""
    vals = [c - (1 << 64) if c >= 1 << 63 else c for c in checksums.values()]  # as int64
    mine = torch.tensor(vals, dtype=torch.int64, device=device)
    every = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(every, mine)
    return all(torch.equal(e, mine) for e in every)


def global_batch(cfg: LlamaConfig, config: dict, seed: int, step: int) -> np.ndarray:
    """The ``global_batch`` rows of tokens of ``step`` [B, seq_len + 1]."""
    rng = np.random.default_rng([seed, step])
    return rng.integers(0, cfg.vocab_size, (config["global_batch"], config["seq_len"] + 1),
                        dtype=np.int32)


def _batch(cfg: LlamaConfig, config: dict, seed: int, rank: int, world: int, step: int,
           device) -> dict:
    if "global_batch" in config:
        B = config["global_batch"]
        if B % world:
            raise ValueError(f"global_batch {B} does not split over {world} ranks")
        toks = global_batch(cfg, config, seed, step)[rank * B // world:(rank + 1) * B // world]
    else:
        rng = np.random.default_rng([seed, rank, step])
        toks = rng.integers(0, cfg.vocab_size, (config["batch"], config["seq_len"] + 1),
                            dtype=np.int32)
    return {"tokens": torch.from_numpy(toks).to(device)}


def _state_checkpoint_due(config: dict, step: int) -> bool:
    every = config.get("state_checkpoint_every")
    return (step == config.get("state_checkpoint_at")
            or bool(every) and step % every == 0 and step < config["steps"])


def _nbytes(tree: dict) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _tensors(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _tensors(v)
        elif isinstance(v, torch.Tensor):
            yield v


def train_loop(config: dict) -> None:
    ctx = train.get_context()
    rank, device = ctx.get_world_rank(), train.get_device()
    cfg = model_config(config)
    optimizer = default_optimizer(**config.get("optimizer", {}))
    init_fn, step_fn = make_train_step(cfg, optimizer, device=device, dp_group=dist.group.WORLD)
    seed = train.broadcast_from_rank_zero(config.get("seed", 0))
    restored = {}
    chk = train.get_checkpoint()
    if chk is not None:
        t0 = time.perf_counter()
        meta = param_template(cfg)  # allocates nothing
        like = TrainState(meta, optimizer.init(meta), 0).state_dict()
        state = TrainState.from_state_dict(chk.to_state_dict(like=like, device=device))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
        restored = {"resumed_from_step": state.step, "resumed_from": chk.path,
                    "checkpoint_read_s": seconds, "checkpoint_bytes": _nbytes(state.state_dict())}
    else:
        state = init_fn(seed)
    shard = train.get_dataset_shard("train")
    batches = (None if shard is None else
               iter_device_batches(shard, batch_size=config["batch"], device=device))
    for _ in range(state.step, config["steps"]):
        if batches is None:
            batch = _batch(cfg, config, seed, rank, ctx.get_world_size(), state.step, device)
        else:
            batch = next(batches)
        before = launch_counts()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        loss = m["loss"].item()  # waits for the step
        metrics = {"loss": loss, "step": state.step, "grad_norm": m["grad_norm"].item(),
                   "backend": dist.get_backend(), "world_size": ctx.get_world_size(),
                   "step_ms": (time.perf_counter() - t0) * 1e3,
                   "launches": {k: v - before[k] for k, v in launch_counts().items()},
                   **restored}
        restored = {}  # on the first step after a resume only
        checkpoint = None
        if _state_checkpoint_due(config, state.step):
            if rank == 0:
                checkpoint, metrics = _timed_checkpoint(state.state_dict(), metrics)
        elif state.step == config["steps"]:
            metrics["checksums"] = bit_checksums(state.params)
            metrics["params_equal_across_ranks"] = equal_across_ranks(metrics["checksums"], device)
            if "probe" in config:
                metrics["probe_logits"] = probe_logits(
                    state.params, serve_config(config["probe"]), config["probe"]["tokens"])
            if rank == 0:
                checkpoint, metrics = _timed_checkpoint(state.params, metrics)
        train.report(metrics, checkpoint=checkpoint)
        if state.step == config.get("fail_once_after") and chk is None:
            raise RuntimeError(f"injected failure after step {state.step} (fail_once_after)")


def _timed_checkpoint(tree: dict, metrics: dict):
    t0 = time.perf_counter()
    checkpoint = Checkpoint.from_state_dict(tree)
    return checkpoint, {**metrics, "checkpoint_write_s": time.perf_counter() - t0,
                        "checkpoint_bytes": _nbytes(tree)}


def main(argv=None) -> None:
    import argparse

    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", type=int, default=0, help="CPU ranks (gloo); 0: one rank a card")
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)
    scaling = (ScalingConfig(num_workers=args.cpu, use_gpu=False) if args.cpu
               else ScalingConfig(num_workers=1))
    result = TorchTrainer(
        train_loop,
        train_loop_config={"model": "tiny", "steps": args.steps, "batch": 8, "seq_len": 64},
        scaling_config=scaling,
        run_config=RunConfig(name="llama-dp-example"),
    ).fit()
    print("final:", {k: result.metrics.get(k) for k in ("loss", "step")},
          "checkpoint:", result.checkpoint, "error:", result.error)


if __name__ == "__main__":
    main()
