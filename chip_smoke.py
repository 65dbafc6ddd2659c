#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (ray_tpu_torch): its serving path
(dense, MoE and multi-LoRA; one process, a gang of rank processes, prefill
and decode disaggregated, and offline batch inference), its
training path (dense and MoE, remat "full" and "dots"), its int8 weight
path, the entry() twin, the Train layer's train -> checkpoint -> serve
path, its elastic resizing on the host's card ledger and Tune's trials on
it, Data's actor pools and Train ingest, Serve's runtime (replica
processes, handles, the HTTP proxy, autoscaling), ray_tpu_torch.util
(placement groups, ActorPool, Queue, pubsub, metrics, tracing, the state
API), compiled DAGs over shared-memory channels with internal_kv and the
dashboard, job submission, the demand autoscaler over card-pool nodes, the
command line, and the RL stack
(ray_tpu_torch.rllib), its runner and learner processes included.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, one JSON line each; any failing phase exits non-zero:
  1. device   — needs CUDA; the card's name and power limit; TF32 off.
  2. build    — nvcc builds every kernel from ray_tpu_torch/ops/csrc/, one
                process per source, in parallel.
  3. kernels  — each kernel against its plain PyTorch version on the card:
                RMSNorm at the serving path's shapes, and at the decode
                shape [16, 3072] with the residual add fused in (s and y
                bit-equal to the eager add then the unfused kernel; its
                time beside the plain twin's, the eager add + kernel's and
                its byte bound); the three
                flash-attention kernels (forward: TMA, wgmma, warp-
                specialised; backward dQ, backward dK/dV) at the train
                bench shape, the 3B GQA head shape, a ragged T and T = 1,
                each with a broken control (K one position off, V one
                element off) that must fail the limits; times, plain and
                library times (SDPA, with enable_gqa at the GQA shape;
                SDPA's backward on K/V repeated to H heads there), bounds,
                and each kernel's TFLOP/s and share of its bound.
  4. quant    — the int8 path of ray_tpu_torch.ops: llama3.2-3b (full width
                and depth, seeded bf16 weights) quantized per output row
                with quantize_int8 and dequantized to bf16 with
                dequantize_int8, all 197 weight matrices; launch counts
                reset before and read after (197 each); kernel and plain
                version bit-equal on every matrix; x @ deq(q).T within 1e-2
                relative of x @ w, and a broken control (q one column off)
                beyond it; per shape, kernel, plain and library times, the
                byte bound, and quantize_int8's time on the path's own w.T
                view (the boundary copy included).
  5. serve    — ray_tpu_torch.llm.LLMServer serves llama3.2-3b (full depth,
                seeded random weights) with the fused RMSNorm, greedy and
                seeded sampled requests; kernel launch counts are reset
                just before and read just after; every decode step is a
                CUDA-graph replay (decode_graph_replays == decode_steps).
  5a. gang_serve — the serve phase's model through GangLLMServer (llm/gang.py):
                one rank process holding the card in a one-rank NCCL world,
                decode_steps 4, run-ahead 2: 16 concurrent greedy requests
                equal token for token to the single-process TorchEngine's on
                the same config; RMSNorm launches counted in the rank; tok/s,
                TTFT, rank start-up and plan round trip beside the serve
                phase's; a rank killed mid-request and its replay equal to
                an uninterrupted run.
  5b. disagg  — prefill/decode disaggregation (llm/disagg.py) on the serve
                model with well-conditioned weights: a PrefillWorker and a
                DecodeWorker in one process behind a DisaggRouter, the 16
                prompts one at a time, 32 tokens: each equal to
                TorchEngine.generate's; every decode step a graph replay;
                RMSNorm launches (2L+1) a prefill and a step; a handoff one
                position short must change the tokens; the handoff's bytes,
                its ms each way, TTFT through the router, decode tok/s.
  5c. batch   — build_llm_processor (llm/batch.py) with concurrency 0 (task
                stages on driver threads, one engine in this process) over
                a port Dataset of 32 prompts in blocks of 16, greedy, 32
                tokens: each row's text equal to the processor engine's
                generate, in input order; graph replays and RMSNorm
                launches as the serve phase derives them; rows/s, tok/s.
  5d. decode_graph — the engine's DecodeGraph at full 3B width and depth
                (well-conditioned weights, 16 rows at 96 positions): 8
                graphed steps against 8 eager decode_steps on cloned caches
                (greedy tokens equal; the logits' max difference reported),
                a broken control (replays without the next tokens copied
                in: the tokens must differ), then the graphed step's device
                ms, kernels and idle share beside the eager step's and the
                step's byte bound.
  6. numerics — a 2-layer model at full 3B width on the card through the
                kernel (fp32 and bf16), against the same weights in fp32
                through the plain path on the CPU, and a broken control
                that the bf16 limit must refuse.
  7. train    — the JAX package's flagship train configuration (bench.py:
                1.2B params, 16 layers, batch 4 x 2048, remat, splash
                attention) through make_train_step: 2 warm-up and 6 timed
                steps, finite losses, attention launch counts equal to
                2L x steps (forward, re-run by remat) and L x steps (each
                backward kernel), then one profiled step.
  8. train_numerics — 2 layers at the bench width with well-conditioned
                weights: loss and grads in bf16 on the card through the
                kernels against fp32 on the CPU through dense attention, a
                broken control (the kernel fed K one position off) that
                must exceed the grad limit, and the fused cross-entropy's
                loss against the plain one.
  9. moe_serve — llama3.2-3b with 8 experts of top-2 (full width and depth,
                18 B params, seeded bf16) through LLMServer: 16 concurrent
                greedy requests x 32 tokens, every decode step a graph
                replay, RMSNorm launches counted; then 8 graphed MoE decode
                steps against 8 eager ones (tokens equal, a control that
                must differ).
 10. moe_numerics — 2 MoE layers at 3B width, bf16 and fp32 on the card
                against fp32 on the CPU (the numerics limits, the routes
                held equal for bf16), a control with one expert's w_down
                shifted.
 11. moe_train — bench.py's train widths with 8 experts top-2, capacity
                1.25, at the depth that fits: 2 warm-up and 3 timed steps,
                attention launches 2L/L/L, and a loss that falls over 5
                steps from well-conditioned weights.
 12. lora_serve — llama3.2-3b with two adapters loaded by load_lora: a
                mixed batch of 16 equal to each request's sequential run,
                base requests equal to the serve phase's tokens.
 12a. gang_lora — the gang_serve phase's one-rank gang with max_loras=2
                (prefill buckets from 128: one chunk a prompt, padded as
                lora_serve pads it), LLMServer over it, lora_serve's two
                adapters loaded: its mixed batch of 16 equal token for token;
                RMSNorm launches counted in the rank; a rank killed mid
                adapter request, the gang rebuilt with its adapters and the
                replay equal; after unload_lora, base requests equal to the
                serve phase's tokens.
 13. train_dots — the train phase's configuration under remat "dots", in
                turns with "full" (full, dots, dots, full).
 14. graft_entry — ray_tpu_torch.graft_entry.entry() in bf16 and fp32 on
                the card against fp64 on the CPU, with a broken control.
 15. train_serve — train -> checkpoint -> serve: TorchTrainer runs the
                example train loop on one rank (a spawned process, NCCL) at
                the train phase's configuration, fails on purpose after
                step 3, resumes from its step-2 checkpoint (the whole train
                state) to the same step-3 loss, and reports the params;
                LLMServer serves that checkpoint (weights' checksums equal,
                prefill logits within the bf16 limit, a swapped-leaf copy
                refused, 16 x 32 greedy tokens, graph replays).
 15a. elastic — elastic training and the host's card ledger
                (tools/elastic_bench.py's one-card parts): (a) a group of 2
                (min 1) at the bench widths, ELASTIC_DEPTH layers, starts at
                the one free card, checkpoints its state every 2 of 6 steps,
                polls resize_decision without firing, charges no failure;
                attention launches 2L / L / L a step in the rank; (b) a
                process actor holding the card makes a one-card trainer
                refuse to start, naming its pid; SIGKILLed, the card returns
                and the trainer finishes; (c) two learner processes at
                {"GPU": 0.5} on the card, each update bit-equal to a local
                learner's (a control must miss), and a two-policy PPO at
                {"GPU": 1} whose second group raises naming the first's
                learner. No lease left.
 15b. tune   — Tune on the port's own processes through Tuner.fit
                (tools/tune_bench.py) at the bench widths, ELASTIC_DEPTH
                layers, 4 x 2048 tokens a step: (a) four ASHA trials of the
                example loop over a 4-point learning-rate grid at
                {"GPU": 0.25} each, all four leases held on the card at once,
                each trial's peak memory, ASHA's decisions replayed equal,
                the card's tokens/s over a step the four take together; (b)
                TorchTrainer as a trainable (the trial a CPU slot, its nested
                rank the card), losses within rel 1e-6 of direct fits, one
                trial's tokens/s alone; (c) PPO.as_trainable at {"GPU": 0.5}
                a trial. Attention launches 2L / L / L a step, counted in the
                trial processes and the nested rank. No lease left.
 15c. data   — Data on the port's own processes (tools/data_bench.py): (a)
                build_llm_processor(..., concurrency=2) over the batch
                phase's 32 prompts (data.from_items, parallelism 2) on two
                actor processes, each leasing half of the card and building
                one 3B engine: every text equal to the batch phase's, in
                order, every decode step a graph replay, RMSNorm launches
                in each actor equal to its engine's count, two half-card
                leases while it runs and none after; rows/s, tok/s, each
                actor's start-up, engine build and peak memory; (b) a
                one-rank TorchTrainer at the bench widths, ELASTIC_DEPTH
                layers, fed a port Dataset of seeded token rows through
                get_dataset_shard and iter_device_batches: its 3 losses
                equal to the same steps in this process, attention
                launches 2L / L / L a step in the rank.
 15d. serve_app — Serve's runtime on the port's own processes
                (tools/serve_bench.py): serve.run of an ingress deployment (CPU)
                whose handle forwards to an LLMServer deployment on the serve
                phase's config, each replica a process leasing half of the card,
                autoscaled 1..2; an echo deployment; the HTTP proxy. 16
                concurrent greedy HTTP completions x 32 tokens drive the upscale
                to 2 replicas; handle calls and 2 SSE streams reach both; the
                downscale to 1; a replica killed and replaced. Every text equal
                to the serve phase's, every decode step a graph replay, RMSNorm
                launches in each replica equal to its engine's count (read there
                before the controller stops it), targets 1 -> 2 -> 1, two
                half-card leases at the peak and none after; tok/s through the
                proxy, HTTP p50/p99, SSE TTFT, the echo round trip by handle and
                by HTTP, each replica's start-up, engine build and peak memory,
                the upscale's and the replacement's seconds.
 15e. openai_app — the rest of Serve (tools/serve_bench.py:openai_app): (a)
                serve.schema.deploy of the OpenAI app (build_openai_app via
                serve_bench.openai_builder) on the serve phase's config, one
                LLMServer replica leasing half of the card, the router's
                num_replicas overridden to 2 (status() shows it); through
                the proxy /v1/models, 16 concurrent greedy /v1/completions x
                32 tokens, a chat completion, two SSE streams (a completion
                and the chat), an unknown model; (b) an ASGI ingress (a CPU
                process) at /api whose /generate calls the LLM deployment's
                handle off its event loop; (c) once (a) is deleted,
                build_gang_deployment(num_workers=1): a replica spawning
                one NCCL rank that leases the card, 16 concurrent
                completions through GangLLMServer.__call__, the replica's
                process killed and a new gang serving one more request.
                Every completion's text equal to the serve phase's (an SSE
                stream's chunks joined to its per-token texts), the chat's
                to its own stream's; every decode step a graph replay and
                RMSNorm launches equal to the engine's count in the LLM
                replica and in each gang's rank (read there); no lease, no
                serve process and no rank left after serve.shutdown(); tok/s
                and HTTP p50/p99 through the router, SSE TTFT, the
                replica's start-up and engine build, the gang's start-up,
                the seconds to replace the killed gang.
 15f. util     — ray_tpu_torch.util (tools/util_bench.py:util_actors):
                placement_group([{"GPU": 0.5}] * 2, "STRICT_PACK") on the
                card ledger; two engine actors placed in its bundles, each
                building the batch phase's engine on its half card;
                ActorPool.map of the batch phase's 32 prompts in blocks of
                16; a Queue(maxsize=8) on a CPU actor from which one engine
                actor pulls the first block. Every text equal to the batch
                phase's; RMSNorm launches in each actor equal to its
                engine's count; the actors' token counters merged by
                state.cluster_metrics equal to the tokens generated; each
                block's span under the driver's in state.timeline(); the 3
                actors ALIVE in state.list_actors() and on the "actors"
                channel; one killed (DEAD, its bundle still reserved);
                remove_placement_group ends the other and no lease is left;
                each actor's start-up, engine build and peak memory, tok/s,
                the group's time to ready, the time to free after removal.
 15g. dag     — compiled DAGs (tools/dag_bench.py:dag_actors): two engine
                actors on half-card leases, each building the batch phase's
                engine, in the graph x = a.generate(inp), [x, b.generate(x)]
                (stage 2 continues from stage 1's texts), over the batch
                phase's 32 prompts in blocks of 16: eager, compiled (shared-
                memory channels under /dev/shm, a loop thread in each actor)
                twice, eager; one block straight to a with the loops idle and
                after teardown, 3 turns each (the idle loop's cost); a chain
                of two CPU actors, eager and compiled in turns (µs a round
                trip); the dashboard (start_dashboard(port=0)) read over HTTP
                and an internal_kv counter kept from inside stage 1's actor.
                Limits: stage 1's
                texts equal to the batch phase's, stage 2's equal across the
                four runs; every decode step a graph replay, RMSNorm launches in
                each actor equal to its engine's count; /api/actors shows both
                engines ALIVE on the card, /api/stacks each one's dag-loop
                thread, /api/logs one entry an actor, /metrics non-empty; the
                KV counter equal to stage 1's rows; after teardown both
                engines answer and no channel file is left; no lease after.
 15h. jobs    — job submission (tools/jobs_bench.py:jobs_part): a port
                driver submitted with JobSubmissionClient().submit_job, whose
                engine actor on a half-card lease runs the batch phase's first
                16 prompts, and a job holding a half-card lease until
                stop_job. Limits: the first job RUNNING then SUCCEEDED, its
                log (get_job_logs and tail_job_logs) holding the batch
                phase's texts, its engine's decode steps graph replays and
                RMSNorm launches equal to its count; the second STOPPED, its
                process group gone, no lease; a second JobManager on the
                same log directory lists both.
 15i. autoscaler — the demand autoscaler (tools/autoscaler_bench.py): on a
                card ledger of its own over the card's physical id,
                FakeNodeProvider claims the ledger and Autoscaler runs one
                group, NodeGroup({"GPU": 1, "CPU": 4}, min 0, max 1),
                idle_timeout_s 1. With no node a placement group [{"GPU":
                0.5, "CPU": 1}] stays PENDING and is the state's demand;
                update() adds the node and the group is placed on its
                card; an engine actor in bundle 0 builds the batch phase's
                engine and runs its first 16 prompts; the group removed,
                the node goes idle, drains and is terminated. Limits: texts
                equal to the batch phase's, every decode step a graph
                replay, RMSNorm launches in the actor equal to its engine's
                count, scaled_up and scaled_down once each, the drain
                record drained, no node, pool or lease file left on either
                ledger. Seconds from demand to the node and to the group
                placed, from idle to drained and to terminated; the actor's
                start-up and build; tok/s; update() ms.
 15j. cli     — the command line (tools/cli_bench.py) as subprocesses of
                this driver: job submit of a short script (SUCCEEDED, exit
                0); job submit --no-wait of a job holding a half-card lease,
                shown by status in the job's process group, RUNNING in job
                list and job status, gone from status after job stop; logs,
                attached to this driver through its session file, listing
                every captured process of the earlier phases; timeline -o
                writing events; drain-node --ledger of a one-card node made
                with FakeNodeProvider on a ledger of its own (drained, exit
                0; no match, exit 1), status --ledger showing it drained, no
                node left. Each command's seconds.
 15k. core    — the core API (tools/core_bench.py): ray_tpu_torch.init(num_cpus=4)
                in process mode; put of the batch phase's 32 prompts; two
                @remote(num_gpus=0.5) tasks, each in a worker leasing half of
                the card from the ledger and building the batch phase's
                engine, each generating its block of 16 prompts (greedy, 32
                tokens); a num_gpus=1 task queued behind the halves and
                cancelled; wait(num_returns=1), get of both, a CPU task
                chained on both refs counting their tokens; a max_retries=1
                task whose worker dies once; a raising task; shutdown().
                Limits: 32/32 texts equal to the batch phase's in order,
                RMSNorm launches in each worker since its engine was built
                equal to its engine's count, every decode step a graph
                replay, TaskCancelledError, the retry's return, TaskError
                that is its cause, the chained count equal to the tokens
                generated, no lease, worker or segment left after
                shutdown(). Each worker's start-up and build, tok/s, a warm
                CPU task's round trip and a 4 MiB array's put / get.
 16. parallel — (a) ring attention's per-block arithmetic at full width in
                one process: q/k/v [4, 2048, 16, 128] bf16, causal, cut
                into 4 sequence shards of 512; for each simulated rank the
                per-block forward, LSE merge and backward that
                ring_attention runs between transfers (10 forward, 10 dQ
                and 10 dK/dV launches with causal block skipping), held to
                one whole-sequence call of the kernels within the attention
                limits, a control with one block at the wrong global offset
                that must fail them, and the blocks' summed time beside the
                whole call's; (b) graft_entry.dryrun_multichip on one NCCL
                rank a card at the bench widths (16 layers; the pp and MoE
                meshes 4 layers, 4 experts; 4 x 2048 tokens a data shard):
                one step on every mesh of the JAX sweep, each mesh's loss
                and grad norm within the train numerics limit of the
                unsharded make_train_step on the same seed and batch, and a
                control on the first mesh (unembed's gradient counted twice
                in the backward: the loss stays within the limit, the grad
                norm must not), step ms per mesh, the flash launches
                counted in the rank.
 17. rllib   — ray_tpu_torch.rllib, the learner on the card, env runners on
                the CPU: PPO on CartPole-v1 through Algorithm.train at
                tests/test_rllib.py:48-69's settings (8 envs x 128 steps,
                minibatch 256, 8 epochs, lr 1e-3, hidden (64, 64), 25
                iterations; the return must rise by more than 20, the JAX
                test's limit) and on MiniBreakout-v0 (conv torso, 5
                iterations, finite losses): env steps/s, learner ms per
                iteration and per minibatch update (CUDA events), returns;
                the learner's parameters and Adam moments on cuda; each
                algorithm's update (PPO vector and conv, DQN, IMPALA, APPO,
                BC, MARWIL, SAC) 3 times on the card and on the CPU from the
                same weights and batches (fp32, TF32 off), the losses within
                rtol 1e-5 and the parameters within 1e-5 (the CPU tests'
                limits), a broken control (the card's batches with actions
                shifted one row) that must fail them, and the update's ms on
                both; one PPO update's kernels and the device's busy share
                (profiler). Every kernel counter set to 0 before and read
                after: all 0 (no TPU kernel lies on the RL path).
 18. rllib_remote — RLlib's remote half (rllib_bench.remote_parts): IMPALA
                and APPO on CartPole-v1 at tests/test_rllib.py:270-328's
                settings, 25 iterations, 2 runner processes x 4 envs x 50
                steps feeding the V-trace update on the card (2 samples in
                flight reported every iteration; returns up by > 20 and >
                25; env steps/s, update ms by CUDA events, and the share of
                each iteration spent waiting for a fragment, which must stay
                under 0.4: the runners sample while the card updates); PPO
                with a runner process SIGKILLed and replaced (>= 1 healthy,
                then 2, a new pid; the replacement's seconds); a learner
                process on the card (num_learners=1) against a local learner
                from the same state within 1e-5 after one update_from_batch,
                and a shifted-actions control that must fail it (round trip
                vs local ms); SAC on Reach-v0 over 2 runner processes (replay
                >= 700, log_alpha kept by save/restore). Counters 0, in
                this process and in the learner process (read there); no
                process of the phase left after each stop.
After each phase that spawns processes, a {"ledger_after": phase,
"holders": [...], "nodes": [...]} line lists the card ledger's live leases
(a rank or actor that leaked shows there, under its pid) and its nodes.
Then the kernels summary
line, the nvidia-smi line, and, last, {"ok": true, "device": {...}}.

Imports nothing of JAX and nothing of the ray_tpu package.
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys
import threading
import time

L_3B = 28


def emit(obj: dict) -> None:
    """One JSON line, written whole (the log monitor's thread prints the
    children's lines to this stream too)."""
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


def phase_kernels(torch, card: str) -> dict:
    """RMSNorm kernel vs rmsnorm_plain at serving's shapes. bf16 must agree
    within one bf16 rounding step (rtol 2^-7, atol 1e-6, compared in fp32):
    both compute in fp32 and round once, so they differ by at most the
    rounding of a last-ulp fp32 difference. fp32 within 1e-5."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops import rmsnorm
    from ray_tpu_torch.ops.rmsnorm import rmsnorm_plain
    from ray_tpu_torch.tools.decode_profile import HBM_BYTES_PER_S, graph_us, timed

    def call_us(fn):
        return timed(fn, 200, warmup=10)[1] * 1e3

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [
        ("decode", (16, 3072), torch.bfloat16, True),
        ("prefill_chunk", (256, 3072), torch.bfloat16, True),
        ("ragged", (15, 3072), torch.bfloat16, False),
        ("fp32", (64, 128), torch.float32, False),
    ]
    rows_out, max_err = [], 0.0
    for tag, shape, dt, measured in cases:
        x = torch.randn(shape, generator=gen, device="cuda").to(dt)
        w = (1.0 + 0.1 * torch.randn(shape[-1], generator=gen, device="cuda")).to(dt)
        before = rmsnorm.launches
        out = rmsnorm(x, w, 1e-5)
        torch.cuda.synchronize()
        if rmsnorm.launches != before + 1:
            raise AssertionError("rmsnorm wrapper did not launch its kernel")
        ref = rmsnorm_plain(x, w, 1e-5)
        rtol, atol = (2**-7, 1e-6) if dt == torch.bfloat16 else (1e-5, 1e-5)
        torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=atol)
        err = (out.float() - ref.float()).abs().max().item()
        max_err = max(max_err, err)
        row = {"shape": list(shape), "dtype": str(dt).split(".")[-1], "max_abs_err": err,
               "rtol": rtol, "atol": atol}
        if measured:
            nbytes = 2 * x.numel() * x.element_size() + w.numel() * w.element_size()
            lib = (lambda: F.rms_norm(x, (shape[-1],), w, 1e-5)) if hasattr(F, "rms_norm") else None
            row.update(
                bytes=nbytes,
                bound_us=nbytes / HBM_BYTES_PER_S * 1e6,
                kernel_us=graph_us(lambda: rmsnorm(x, w, 1e-5)),
                plain_us=graph_us(lambda: rmsnorm_plain(x, w, 1e-5)),
                library_us=graph_us(lib) if lib else None,
                kernel_call_us=call_us(lambda: rmsnorm(x, w, 1e-5)),
                plain_call_us=call_us(lambda: rmsnorm_plain(x, w, 1e-5)),
                # wrapper launches for this shape: the check, the graph
                # captures and the eager loop (graph replays do not call it)
                launches=rmsnorm.launches - before,
            )
        rows_out.append({"case": tag, **row})
    fused = _fused_row(torch, gen)
    attention = _attention_rows(torch)
    emit({"phase": "kernels", "card": card, "rmsnorm": rows_out, "rmsnorm_fused": fused,
          "attention": attention["rows"],
          "attention_limits": attention["limits"],
          "timing": "kernel_us/plain_us/library_us: device time per call from a "
                    "replayed CUDA graph; *_call_us: eager calls back to back; "
                    "sdpa_fwd_bwd_us: eager calls, CUDA events; sdpa_bwd_us: the aten "
                    "flash backward alone from a replayed CUDA graph"})
    return {"max_abs_err": max_err, "rows": rows_out, "fused": fused, "attention": attention}


def _fused_row(torch, gen) -> dict:
    """add_rmsnorm at the decode shape [16, 3072] bf16: s = x + r and y =
    rmsnorm(s) in one launch, bit-equal (tolerance 0) to the eager add then
    the unfused kernel, and y within the bf16 limits of the plain twin."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops import add_rmsnorm, rmsnorm
    from ray_tpu_torch.ops.rmsnorm import add_rmsnorm_plain
    from ray_tpu_torch.tools.decode_profile import HBM_BYTES_PER_S, graph_us, timed

    shape = (16, 3072)
    x, r = (torch.randn(shape, generator=gen, device="cuda").bfloat16() for _ in range(2))
    w = (1.0 + 0.1 * torch.randn(shape[-1], generator=gen, device="cuda")).bfloat16()
    before = rmsnorm.launches
    s, y = add_rmsnorm(x, r, w, 1e-5)
    torch.cuda.synchronize()
    if rmsnorm.launches != before + 1:
        raise AssertionError("add_rmsnorm did not launch the kernel once")
    s_ref = x + r
    y_ref = rmsnorm(s_ref, w, 1e-5)
    s_p, y_p = add_rmsnorm_plain(x, r, w, 1e-5)
    bit_equal = (torch.equal(s.view(torch.int16), s_ref.view(torch.int16))
                 and torch.equal(y.view(torch.int16), y_ref.view(torch.int16)))
    if not bit_equal:
        raise AssertionError("add_rmsnorm differs from the eager add then the kernel")
    torch.testing.assert_close(y.float(), y_p.float(), rtol=2**-7, atol=1e-6)
    if not torch.equal(s, s_p):
        raise AssertionError("add_rmsnorm's s differs from the plain twin's")
    # x and r read, s and y written, w read once
    nbytes = 4 * x.numel() * x.element_size() + w.numel() * w.element_size()
    lib = (lambda: F.rms_norm(x + r, (shape[-1],), w, 1e-5)) if hasattr(F, "rms_norm") else None
    return {
        "shape": list(shape), "dtype": "bfloat16", "bit_equal_to_add_then_kernel": bit_equal,
        "max_abs_err": (y.float() - y_p.float()).abs().max().item(), "rtol": 2**-7, "atol": 1e-6,
        "bytes": nbytes, "bound_us": nbytes / HBM_BYTES_PER_S * 1e6,
        "kernel_us": graph_us(lambda: add_rmsnorm(x, r, w, 1e-5)),
        "plain_us": graph_us(lambda: add_rmsnorm_plain(x, r, w, 1e-5)),
        "add_then_kernel_us": graph_us(lambda: rmsnorm(x + r, w, 1e-5)),
        "add_then_library_us": graph_us(lib) if lib else None,
        "kernel_call_us": timed(lambda: add_rmsnorm(x, r, w, 1e-5), 200, warmup=10)[1] * 1e3,
        "library": "none computes add + norm in one call; add_then_library_us is torch's add "
                   "then F.rms_norm",
    }


# (B, T, H, KV, D): the train bench shape, llama3.2-3b's GQA head shape at
# the bench's batch and length, a T that is a multiple of none of the 128-,
# 64- and 32-row blocks, and T = 1
ATTN_CASES = [
    ("bench", (4, 2048, 16, 16, 128), True),
    ("gqa3b", (4, 2048, 24, 8, 128), True),
    ("ragged", (2, 200, 4, 2, 128), False),
    ("t1", (1, 1, 2, 1, 128), False),
]


def _attention_rows(torch) -> dict:
    """The flash-attention kernels against their plain versions on the same
    bf16 inputs (the backward from the kernel's own o and lse), with the
    limits of ops/flash_attention.py fixed before the first run; a broken
    control per row must fail them."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops.flash_attention import (
        MAX_ABS_LIMIT, REL_RMS_LIMIT, agreement, flash_attention, flash_attention_bwd_dkdv_kernel,
        flash_attention_bwd_dq_kernel, flash_attention_bwd_plain, flash_attention_fwd_kernel,
        flash_attention_fwd_plain,
    )
    from ray_tpu_torch.models.training import H100_BF16_DENSE_FLOPS
    from ray_tpu_torch.tools.decode_profile import HBM_BYTES_PER_S, graph_us, timed

    f = flash_attention

    def kernels(q, k, v, do):
        o, lse = flash_attention_fwd_kernel(q, k, v)
        dq, delta = flash_attention_bwd_dq_kernel(q, k, v, o, lse, do)
        dk, dv = flash_attention_bwd_dkdv_kernel(q, k, v, lse, delta, do)
        return o, lse, dq, dk, dv, delta

    def bound(flops, nbytes):
        t_ops, t_bytes = flops / H100_BF16_DENSE_FLOPS, nbytes / HBM_BYTES_PER_S
        return {"bound_us": max(t_ops, t_bytes) * 1e6,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "flops": flops, "bytes": nbytes}

    gen = torch.Generator(device="cuda").manual_seed(3)
    rows, max_err = [], 0.0
    for tag, (B, T, H, KV, D), measured in ATTN_CASES:
        q, k, v, do = (torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)
                       for s in ((B, T, H, D), (B, T, KV, D), (B, T, KV, D), (B, T, H, D)))
        before = (f.launches_fwd, f.launches_bwd_dq, f.launches_bwd_dkdv)
        o, lse, dq, dk, dv, delta = kernels(q, k, v, do)
        torch.cuda.synchronize()
        if (f.launches_fwd, f.launches_bwd_dq, f.launches_bwd_dkdv) != tuple(b + 1 for b in before):
            raise AssertionError("the flash-attention wrappers did not launch their kernels")
        o_p, lse_p = flash_attention_fwd_plain(q, k, v)
        refs = dict(zip(("o", "dq", "dk", "dv"),
                        (o_p, *flash_attention_bwd_plain(q, k, v, o, lse, do))))
        checks = {n: agreement(x, refs[n]) for n, x in zip(("o", "dq", "dk", "dv"), (o, dq, dk, dv))}
        lse_err = (lse - lse_p).abs().max().item()
        # broken control: K one position off along T, V one element off along D
        ko, vo = torch.roll(k, 1, dims=1), torch.roll(v, 1, dims=3)
        co, _, cdq, cdk, cdv, _ = kernels(q, ko, vo, do)
        control = {n: agreement(x, refs[n]) for n, x in zip(("o", "dq", "dk", "dv"), (co, cdq, cdk, cdv))}
        del ko, vo, co, cdq, cdk, cdv
        row = {"case": tag, "shape_bthkd": [B, T, H, KV, D], "lse_max_abs_err": lse_err,
               **{f"{n}_{m}": c[m] for n, c in checks.items() for m in ("max_abs_err", "rel_rms_err")},
               "control_rel_rms_err": {n: c["rel_rms_err"] for n, c in control.items()}}
        bad = [n for n, c in checks.items() if not c["ok"]]
        if bad or lse_err > 1e-4:
            raise AssertionError(f"attention {tag}: {bad or 'lse'} outside the limits: {row}")
        if all(c["ok"] for c in control.values()):
            raise AssertionError(f"attention {tag}: the broken control passed the limits: {row}")
        max_err = max(max_err, *(c["max_abs_err"] for c in checks.values()))
        if measured:
            npairs = T * (T + 1) // 2  # causal (query, key) pairs
            qb, kvb, rowb = B * T * H * D * 2, B * T * KV * D * 2, B * H * T * 4
            hd = B * H * D * npairs
            row["fwd"] = {"kernel_us": graph_us(lambda: flash_attention_fwd_kernel(q, k, v), 20, 10),
                          "plain_us": graph_us(lambda: flash_attention_fwd_plain(q, k, v), 3, 3),
                          **bound(4 * hd, 2 * qb + 2 * kvb + rowb)}
            row["bwd_dq"] = {
                "kernel_us": graph_us(lambda: flash_attention_bwd_dq_kernel(q, k, v, o, lse, do), 20, 10),
                **bound(6 * hd, 4 * qb + 2 * kvb + 2 * rowb)}
            row["bwd_dkdv"] = {
                "kernel_us": graph_us(
                    lambda: flash_attention_bwd_dkdv_kernel(q, k, v, lse, delta, do), 20, 10),
                **bound(8 * hd, 2 * qb + 4 * kvb + 2 * rowb)}
            for key in ("fwd", "bwd_dq", "bwd_dkdv"):  # useful FLOPs a second; share of the bound
                r = row[key]
                r["tflops"] = r["flops"] / r["kernel_us"] / 1e6
                r["bound_share"] = r["bound_us"] / r["kernel_us"]
            # the plain backward computes dq, dk and dv together
            plain_bwd = graph_us(lambda: flash_attention_bwd_plain(q, k, v, o, lse, do), 2, 3)
            row["bwd_dq"]["plain_us"] = row["bwd_dkdv"]["plain_us"] = plain_bwd
            row["bwd_bound_us"] = bound(10 * hd, 4 * qb + 4 * kvb + 2 * rowb)["bound_us"]
            # the library yardstick, timed here only: SDPA ([B, H, T, D] views)
            qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
            gqa = {"enable_gqa": True} if H != KV else {}
            row["sdpa_fwd_us"] = graph_us(
                lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, **gqa), 20, 10)
            leaves = [t.detach().requires_grad_(True) for t in (qt, kt, vt)]

            def sdpa_fwd_bwd():
                out = F.scaled_dot_product_attention(*leaves, is_causal=True, **gqa)
                torch.autograd.grad(out, leaves, dot)

            row["sdpa_fwd_bwd_us"] = timed(sdpa_fwd_bwd, 10, warmup=2)[1] * 1e3
            del leaves
            # the library's backward alone: one aten call gives dq, dk and dv,
            # the function of the dQ and dK/dV kernels together. Its flash
            # backward takes equal head counts only, so at GQA it reads K and
            # V repeated to H heads, as the JAX reference feeds its Pallas
            # kernels (ray_tpu/models/llama.py:315-322); the repeat is made
            # once, outside the timed graph (and its dk, dv are per q head)
            aten = torch.ops.aten
            if H == KV:
                kr, vr = kt, vt
            else:
                kr, vr = (t.repeat_interleave(H // KV, dim=1) for t in (kt, vt))
            (so, slse, cq, ck, mq, mk, seed, offset,
             _) = aten._scaled_dot_product_flash_attention(qt, kr, vr, 0.0, True)
            row["sdpa_bwd_us"] = graph_us(
                lambda: aten._scaled_dot_product_flash_attention_backward(
                    dot, qt, kr, vr, so, slse, cq, ck, mq, mk, 0.0, True, seed, offset),
                20, 10)
            row["sdpa_bwd_kv"] = ("as given" if H == KV else
                                  f"K, V repeated {H // KV}x to H heads outside the timed graph")
            row["bwd_pair_us"] = row["bwd_dq"]["kernel_us"] + row["bwd_dkdv"]["kernel_us"]
            del so, slse, kr, vr
        rows.append(row)
        del q, k, v, do, o, lse, dq, dk, dv, delta, o_p, lse_p, refs
        torch.cuda.empty_cache()
    limits = {"rel_rms_err": REL_RMS_LIMIT, "max_abs_err_of_max_ref": MAX_ABS_LIMIT,
              "lse_max_abs_err": 1e-4}
    return {"rows": rows, "limits": limits, "max_abs_err": max_err}


def _quant_matrices(params: dict, cfg):
    """Every weight matrix of the model by output row, as the JAX package's
    test quantizes ``w.T`` (tests/test_ops.py:89): per layer wq, wk, wv,
    wo, w_gate, w_up and w_down as [out, in] views, then the tied embedding
    once, whose rows are the unembedding's output rows."""
    e = cfg.d_model
    for layer in range(cfg.n_layers):
        for name in ("wq", "wk", "wv"):
            yield name, params[name][layer].reshape(e, -1).T
        yield "wo", params["wo"][layer].reshape(-1, e).T
        for name in ("w_gate", "w_up", "w_down"):
            yield name, params[name][layer].T
    yield "embed", params["embed"]


def phase_quant(torch, card: str) -> dict:
    """llama3.2-3b's weights through quantize_int8 and dequantize_int8 on
    the card. Limits: the kernels equal their plain versions bit for bit
    (q, scales, bf16 output); x @ deq(q).T, in fp32 on a seeded bf16 batch
    [16, in], within the JAX package's 1e-2 relative error of x @ w
    (tests/test_ops.py:94), and the broken control (q rolled one column,
    dequantized by the plain version) above it."""
    from ray_tpu_torch.models.llama import LlamaConfig, init_params
    from ray_tpu_torch.ops import dequantize_int8, quantize_int8
    from ray_tpu_torch.ops.quant import dequantize_int8_plain, quantize_int8_plain, reset_launches
    from ray_tpu_torch.tools.decode_profile import HBM_BYTES_PER_S, graph_us

    limit = 1e-2
    cfg = LlamaConfig.llama32_3b()
    if (cfg.d_model, cfg.n_layers, cfg.n_kv_heads * cfg.head_dim, cfg.d_ff, cfg.vocab_size,
            cfg.tie_embeddings, cfg.dtype) != (3072, L_3B, 1024, 8192, 128256, True, torch.bfloat16):
        raise AssertionError(f"not the 3B shape: {cfg}")
    params = init_params(cfg, seed=0, device="cuda")
    mats = list(_quant_matrices(params, cfg))
    gen = torch.Generator(device="cuda").manual_seed(4)
    batch = {}  # a bf16 batch [16, in] per input width

    def rel(a, b):
        return (torch.linalg.norm(a - b) / torch.linalg.norm(b)).item()

    reset_launches()  # counts from here on are the path's
    q_err = s_err = out_err = 0.0
    unequal, kinds, shapes = [], {}, {}
    for kind, w in mats:
        q, s = quantize_int8(w)
        out = dequantize_int8(q, s)
        q_p, s_p = quantize_int8_plain(w)
        out_p = dequantize_int8_plain(q, s)
        q_err = max(q_err, (q.int() - q_p.int()).abs().max().item())
        s_err = max(s_err, (s - s_p).abs().max().item())
        out_err = max(out_err, (out.float() - out_p.float()).abs().max().item())
        if not (torch.equal(q, q_p) and torch.equal(s, s_p)
                and torch.equal(out.view(torch.int16), out_p.view(torch.int16))):
            unequal.append(kind)
        x = batch.setdefault(w.shape[1], torch.randn(16, w.shape[1], generator=gen,
                                                     device="cuda").bfloat16()).float()
        ref = x @ w.float().T
        err = rel(x @ out.float().T, ref)
        control = rel(x @ dequantize_int8_plain(torch.roll(q, 1, dims=1), s).float().T, ref)
        k = kinds.setdefault(kind, {"shape": list(w.shape), "matrices": 0, "max_rel_err": 0.0,
                                    "min_control_rel_err": math.inf})
        k["matrices"] += 1
        k["max_rel_err"] = max(k["max_rel_err"], err)
        k["min_control_rel_err"] = min(k["min_control_rel_err"], control)
        shapes.setdefault(tuple(w.shape), w)
    launches = {"quantize_int8": quantize_int8.launches, "dequantize_int8": dequantize_int8.launches}

    # device time per call at each shape, from a replayed CUDA graph: the
    # kernels on a contiguous copy of the first matrix of that shape, and
    # quantize_int8 on the path's own view (w.T: the copy at the boundary,
    # then the kernel)
    rows = []
    for (r, c), view in shapes.items():
        w = view.contiguous()
        q, s = quantize_int8(w)
        lib_out = torch.empty(r, c, dtype=torch.bfloat16, device="cuda")
        big = r * c > 1e8  # the embedding: fewer calls a graph
        n, reps = (5, 5) if big else (20, 10)
        q_bytes = r * c * (w.element_size() + 1) + 4 * r
        d_bytes = r * c * (1 + 2) + 4 * r
        rows.append({
            "shape": [r, c], "dtype": "bfloat16", "matrices": sum(
                k["matrices"] for k in kinds.values() if k["shape"] == [r, c]),
            "quantize": {"kernel_us": graph_us(lambda: quantize_int8(w), n, reps),
                         "path_us": graph_us(lambda: quantize_int8(view), n, reps),
                         "path_copies": not view.is_contiguous(),
                         "plain_us": graph_us(lambda: quantize_int8_plain(w), max(n // 4, 2), reps),
                         "bytes": q_bytes, "bound_us": q_bytes / HBM_BYTES_PER_S * 1e6},
            "dequantize": {"kernel_us": graph_us(lambda: dequantize_int8(q, s), n, reps),
                           "plain_us": graph_us(lambda: dequantize_int8_plain(q, s), max(n // 4, 2), reps),
                           "library_us": graph_us(lambda: torch.mul(q, s[:, None], out=lib_out), n, reps),
                           "library_bit_equal": torch.equal(
                               lib_out.view(torch.int16), dequantize_int8(q, s).view(torch.int16)),
                           "bytes": d_bytes, "bound_us": d_bytes / HBM_BYTES_PER_S * 1e6},
        })
    # the whole model once through the path: per shape, matrices x (one
    # quantize + one dequantize); "path" counts the boundary copies of w.T
    model_us = {key: sum(t["matrices"] * (t["quantize"][qk] + t["dequantize"][dk]) for t in rows)
                for key, qk, dk in (("kernels", "kernel_us", "kernel_us"),
                                    ("path", "path_us", "kernel_us"),
                                    ("bound", "bound_us", "bound_us"))}
    out = {
        "phase": "quant", "card": card, "model": "llama3.2-3b", "matrices": len(mats),
        "launches": launches, "launches_expected": len(mats), "model_us": model_us,
        "kernel_vs_plain": {"unequal": unequal, "q_max_abs_err": q_err, "scales_max_abs_err": s_err,
                            "out_max_abs_err": out_err},
        "matmul_rel_err_limit": limit, "by_kind": kinds, "timing": rows,
        "library": "dequantize: torch.mul(q, scales[:, None], out=<bf16>); quantize: none "
                   "(no single PyTorch call computes it)",
    }
    emit(out)
    del params, mats, batch, shapes
    torch.cuda.empty_cache()
    n = out["matrices"]
    if n != 7 * L_3B + 1:
        raise AssertionError(f"{n} matrices, not 7L + 1")
    if launches != {"quantize_int8": n, "dequantize_int8": n}:
        raise AssertionError(f"quant launches {launches} != {n} each")
    if unequal:
        raise AssertionError(f"quant kernels differ from their plain versions on {unequal}")
    worst = max(k["max_rel_err"] for k in kinds.values())
    if worst > limit:
        raise AssertionError(f"int8 weights: matmul relative error {worst} > {limit}")
    if min(k["min_control_rel_err"] for k in kinds.values()) <= limit:
        raise AssertionError("quant: the broken control passed the matmul limit")
    return out


def phase_serve(torch, card: str) -> dict:
    import numpy as np

    from ray_tpu_torch.llm import EngineConfig, LLMConfig, LLMServer, ModelConfig, SamplingParams
    from ray_tpu_torch.ops import rmsnorm
    from ray_tpu_torch.tools.decode_profile import HBM_BYTES_PER_S

    cfg = LLMConfig(
        model=ModelConfig(model_id="llama3.2-3b", tokenizer="byte", seed=0,
                          model_kwargs={"fused_rmsnorm": True}),
        engine=EngineConfig(
            max_num_seqs=16, max_seq_len=1024,
            prefill_buckets=(32, 64, 128, 256, 512, 1024),
            prefill_chunk=256, decode_steps=8, decode_runahead=1,
        ),
    )
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server = LLMServer(cfg)
    init_s = time.perf_counter() - t0
    eng = server.engine
    try:
        mcfg = eng.model_cfg
        if (mcfg.d_model, mcfg.n_layers, mcfg.n_heads, mcfg.n_kv_heads, mcfg.d_ff,
                mcfg.vocab_size) != (3072, L_3B, 24, 8, 8192, 128256):
            raise AssertionError(f"not the 3B shape: {mcfg}")
        # ~700 tokens: chunks [0, 256), [256, 512), then the rest. A repeat
        # hits the cached 512-token prefix and prefills the same last chunk
        # at the same shapes as the cold run, so its tokens must be equal.
        long_prompt = "".join(f"[{i:03d}] the port serves a long shared preamble. " for i in range(14))
        # warm-up: allocator growth, cuBLAS handles, each prefill shape used
        # (another long prompt, so the measured one starts cold)
        server.completions({"prompt": "warm up " * 12, "max_tokens": 16, "ignore_eos": True})
        eng.generate("W" + long_prompt, sampling_params=SamplingParams(max_tokens=4, ignore_eos=True))

        stats0 = eng.get_stats()
        rmsnorm.launches = 0  # counts from here on are the main path's

        # 16 concurrent greedy completions, distinct ~100-byte prompts
        prompts = [f"Request {i:02d}: " + "write a short note about serving a model on one card. " * 2
                   for i in range(16)]
        prompts = [p[:100] for p in prompts]
        replies = [None] * 16
        # TTFT of these same requests: the engine's own per-request ttft_s,
        # read from the outputs that the server's generate calls return
        outs = []
        generate = eng.generate

        def observed(*args, **kwargs):
            out = generate(*args, **kwargs)
            outs.append(out)
            return out

        def one(i):
            replies[i] = server.completions(
                {"prompt": prompts[i], "max_tokens": 64, "temperature": 0.0, "ignore_eos": True}
            )

        eng.generate = observed
        try:
            t0 = time.perf_counter()
            threads = [threading.Thread(target=one, args=(i,)) for i in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            wall = time.perf_counter() - t0
        finally:
            del eng.generate  # back to the class's method
        for i, r in enumerate(replies):
            if r is None or r["usage"]["completion_tokens"] != 64:
                raise AssertionError(f"completion {i} did not return 64 tokens: {r}")
        ttft = np.asarray([o.metrics["ttft_s"] for o in outs]) * 1e3
        if len(ttft) != 16:
            raise AssertionError(f"{len(ttft)} engine outputs for 16 completions")

        chat = server.chat({"messages": [{"role": "user", "content": "Say hello."}],
                            "max_tokens": 32, "ignore_eos": True})
        if chat["usage"]["completion_tokens"] != 32 or chat["object"] != "chat.completion":
            raise AssertionError(f"chat: {chat}")
        chunks = list(server.completions_stream({"prompt": "Stream this.", "max_tokens": 24,
                                                 "ignore_eos": True}))
        if len(chunks) != 25 or chunks[-1]["choices"][0]["finish_reason"] != "length":
            raise AssertionError(f"stream gave {len(chunks)} chunks")

        sp = SamplingParams(max_tokens=64, temperature=0.0, ignore_eos=True)
        # a seeded sampled request gives the same tokens whatever shares its
        # batch: alone, then beside a greedy request
        hot = SamplingParams(max_tokens=32, temperature=0.8, top_k=50, seed=7, ignore_eos=True)
        s1 = eng.generate("Sample this.", sampling_params=hot)
        other = eng.submit("Something else entirely.", sampling_params=sp)
        s2 = eng.generate("Sample this.", sampling_params=hot)
        if not other.done.wait(600) or other.error is not None:
            raise AssertionError(f"greedy request beside the sampled one failed: {other.error!r}")
        if len(s1.token_ids) != 32 or s1.token_ids != s2.token_ids:
            raise AssertionError("a seeded sampled request changed its tokens")
        greedy = eng.generate("Sample this.", sampling_params=sp)
        sampled_equal_greedy = sum(x == y for x, y in zip(s1.token_ids, greedy.token_ids))

        # shorter than the smallest prefix bucket: both runs are cold
        a = eng.generate("Repeat after me.", sampling_params=sp)
        b = eng.generate("Repeat after me.", sampling_params=sp)
        if a.metrics["prefix_hit_tokens"] or a.token_ids != b.token_ids:
            raise AssertionError("a repeated greedy prompt changed its tokens")
        hits0 = eng.get_stats()["prefix_cache_hits"]
        c = eng.generate(long_prompt + "Q?", sampling_params=sp)
        d = eng.generate(long_prompt + "Q?", sampling_params=sp)
        if (c.metrics["prefix_hit_tokens"] or eng.get_stats()["prefix_cache_hits"] <= hits0
                or d.metrics["prefix_hit_tokens"] != 512):
            raise AssertionError("the repeated long prompt missed the prefix cache")
        if c.token_ids != d.token_ids:
            raise AssertionError("a prefix-cache hit changed the greedy tokens")

        launches = rmsnorm.launches
        stats = eng.get_stats()
        delta = {k: stats[k] - stats0[k] for k in
                 ("decode_programs", "decode_steps", "decode_graph_replays", "prefill_mid_chunks",
                  "prefill_final_chunks", "decode_device_ms", "decode_programs_timed")}
        if delta["decode_graph_replays"] != delta["decode_steps"]:
            raise AssertionError(f"decode steps that were no graph replay: {delta}")
        n_norms = 2 * L_3B + 1
        expected = (n_norms * (delta["decode_steps"] + delta["prefill_final_chunks"])
                    + (n_norms - 1) * delta["prefill_mid_chunks"])
        if launches < n_norms * delta["decode_programs"] or launches != expected:
            raise AssertionError(f"rmsnorm launches {launches} != expected {expected} ({delta})")

        weight_bytes = sum(p.numel() * p.element_size() for p in eng.params.values())
        kv_bytes = sum(2 * pool.cache["k"].numel() * pool.cache["k"].element_size()
                       for pool in eng._pools)
        step_bound_ms = (weight_bytes + kv_bytes) / HBM_BYTES_PER_S * 1e3
        result = {
            "phase": "serve", "card": card, "model": "llama3.2-3b",
            "params": sum(p.numel() for p in eng.params.values()),
            "engine_init_s": init_s,
            "wall_s_16x64": wall,
            "out_tok_per_s": 16 * 64 / wall,
            "ttft_ms_p50": float(np.percentile(ttft, 50)),
            "ttft_ms_p99": float(np.percentile(ttft, 99)),
            "decode_program_ms_mean": delta["decode_device_ms"] / delta["decode_programs_timed"],
            "decode_step_ms_mean": (delta["decode_device_ms"] / delta["decode_programs_timed"]
                                    / cfg.engine.decode_steps),
            "decode_steps_per_program": cfg.engine.decode_steps,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "decode_step_bytes": weight_bytes + kv_bytes,
            "decode_step_bound_ms": step_bound_ms,
            "decode_bound_tok_per_s": 16 / (step_bound_ms / 1e3),
            "rmsnorm_launches": launches, "rmsnorm_launches_expected": expected, **delta,
            "prefix_hit_tokens": d.metrics["prefix_hit_tokens"],
            "sampled_tokens": len(s1.token_ids), "sampled_equal_greedy": sampled_equal_greedy,
        }
        emit(result)
        # the 16 greedy requests' tokens, for lora_serve's base requests
        result["tokens_by_prompt"] = {tuple(o.prompt_token_ids): o.token_ids for o in outs}
        return result
    finally:
        eng.shutdown()


def _graph_vs_eager(torch, params, cfg, B: int, S: int, steps: int, seed: int) -> dict:
    """``steps`` replays of a DecodeGraph over a cache of B rows prefilled
    with 96 seeded tokens, each replay's greedy tokens copied into the
    graph's input, against ``steps`` eager decode_steps on a clone of the
    cache; then a broken control, the replays without the copy, on another
    clone. RMSNorm launches are counted over the copied replays. Returns
    the graph, its cache and input, and the comparison."""
    from ray_tpu_torch.llm.engine import DecodeGraph
    from ray_tpu_torch.models.llama import decode_step, init_kv_cache, prefill
    from ray_tpu_torch.ops import rmsnorm

    prompt = torch.randint(0, cfg.vocab_size, (B, 96), generator=torch.Generator().manual_seed(seed),
                           dtype=torch.int32).cuda()
    cache = init_kv_cache(cfg, B, S, "cuda")
    logits, _ = prefill(params, cache, prompt, cfg)
    first = logits.argmax(-1).to(torch.int32)
    eager_cache = {k: v.clone() for k, v in cache.items()}
    control_cache = {k: v.clone() for k, v in cache.items()}
    tokens = first.clone()
    graph = DecodeGraph(params, cache, tokens, cfg)

    tok, eager = first, []
    for _ in range(steps):
        lg, _ = decode_step(params, eager_cache, tok, cfg)
        tok = lg.argmax(-1).to(torch.int32)
        eager.append((lg.clone(), tok))

    def replays(copy: bool) -> list:
        tokens.copy_(first)
        out = []
        for _ in range(steps):
            lg = graph.replay()
            nxt = lg.argmax(-1).to(torch.int32)
            if copy:
                tokens.copy_(nxt)
            out.append((lg.clone(), nxt))
        return out

    rmsnorm.launches = 0
    graphed = replays(True)
    launches = rmsnorm.launches
    for k in cache:
        cache[k].copy_(control_cache[k])
    control = replays(False)
    torch.cuda.synchronize()
    return {
        "graph": graph, "cache": cache, "tokens": tokens, "rmsnorm_launches": launches,
        "tokens_equal": all(torch.equal(g[1], e[1]) for g, e in zip(graphed, eager)),
        "control_tokens_equal": all(torch.equal(c[1], e[1]) for c, e in zip(control, eager)),
        "logits_max_abs_diff": max((g[0] - e[0]).abs().max().item() for g, e in zip(graphed, eager)),
    }


def phase_decode_graph(torch, card: str) -> dict:
    """The decode step as the engine runs it on the card, one CUDA graph
    (DecodeGraph), against eager decode_step: llama3.2-3b at full width and
    depth with well-conditioned weights, 16 rows prefilled with 96 tokens in
    a 1024-slot cache, cloned for the eager run and the control. Limits:
    8 graphed steps, each step's greedy tokens copied into the graph's
    input, give the eager steps' tokens exactly (the logits' max difference
    is reported); RMSNorm counts 2L+1 launches a replay; a broken control,
    8 replays without the copy, gives other tokens. Then the graphed step's
    device time, kernels and idle share (profiler) beside the eager step's
    and the step's weight + KV byte bound."""
    from ray_tpu_torch.models.llama import LlamaConfig, decode_step
    from ray_tpu_torch.tools.decode_profile import HBM_BYTES_PER_S, _profile, timed

    cfg = LlamaConfig.llama32_3b(max_seq_len=1024, fused_rmsnorm=True)
    params = _conditioned_params(torch, cfg, seed=5)
    B, S, steps = 16, 1024, 8
    with torch.inference_mode():
        g = _graph_vs_eager(torch, params, cfg, B, S, steps, seed=5)
        graph, cache, tokens = g["graph"], g["cache"], g["tokens"]
        equal, control_equal, max_diff, launches = (
            g["tokens_equal"], g["control_tokens_equal"], g["logits_max_abs_diff"], g["rmsnorm_launches"])

        weight_bytes = sum(p.numel() * p.element_size() for p in params.values())
        kv_bytes = 2 * cache["k"].numel() * cache["k"].element_size()
        graph_host_ms, graph_span_ms = timed(graph.replay, 20, warmup=3)
        graph_prof = _profile(graph.replay, 10)
        eager_host_ms, eager_span_ms = timed(lambda: decode_step(params, cache, tokens, cfg), 10)
        eager_prof = _profile(lambda: decode_step(params, cache, tokens, cfg), 3)
    out = {
        "phase": "decode_graph", "card": card, "model": "llama3.2-3b", "batch": B, "stripe": S,
        "steps": steps, "tokens_equal": equal, "logits_max_abs_diff": max_diff,
        "control_tokens_equal": control_equal, "rmsnorm_launches": launches,
        "rmsnorm_launches_expected": (2 * cfg.n_layers + 1) * steps,
        "step_bound_ms": (weight_bytes + kv_bytes) / HBM_BYTES_PER_S * 1e3,
        "graph": {"host_ms": graph_host_ms, "span_ms": graph_span_ms, **graph_prof},
        "eager": {"host_ms": eager_host_ms, "span_ms": eager_span_ms, **eager_prof},
        "timing": "span_ms: CUDA events over back-to-back steps; idle_share and kernel "
                  "times from torch.profiler",
    }
    emit(out)
    del graph, params, cache, g
    torch.cuda.empty_cache()
    if not equal:
        raise AssertionError(f"graphed decode tokens differ from eager (max logit diff {max_diff})")
    if launches != out["rmsnorm_launches_expected"]:
        raise AssertionError(f"rmsnorm launches {launches} over {steps} replays")
    if control_equal:
        raise AssertionError("decode_graph: the broken control gave the eager tokens")
    # the profiler's own count of RMSNorm kernels a step, graphed and eager
    for mode in ("graph", "eager"):
        seen = out[mode]["rmsnorm_launches_per_call"]
        if seen != 2 * cfg.n_layers + 1:
            raise AssertionError(f"decode_graph: the {mode} step's trace holds {seen} RMSNorm kernels")
    return out


def _conditioned_params(torch, cfg, seed: int) -> dict:
    """Weights on the card in ``cfg.dtype`` whose activations stay O(1):
    every matmul weight N(0, 1) x its input width^-1/2, the (tied)
    embedding N(0, 1) x d_model^-1/2, norms 1 + 0.1 N(0, 1). The engine's
    init mirrors the JAX package's, which draws wq/wk/wv with fan_in = head
    count: attention scores of O(100), where bf16 alone puts ~20% error on
    the logits and a numerics check cannot tell a sound run from a broken
    one."""
    from ray_tpu_torch.models.llama import _param_shapes

    gen = torch.Generator(device="cuda").manual_seed(seed)
    width = {"embed": cfg.d_model, "unembed": cfg.d_model, "wq": cfg.d_model, "wk": cfg.d_model, "wv": cfg.d_model,
             "wo": cfg.n_heads * cfg.head_dim, "w_gate": cfg.d_model, "w_up": cfg.d_model,
             "w_down": cfg.d_ff, "moe_w_gate": cfg.d_model, "moe_w_up": cfg.d_model,
             "moe_w_down": cfg.d_ff,
             # router logits of std 3: bf16 rounding rarely reorders a
             # token's experts
             "moe_router": cfg.d_model / 9}
    params = {}
    for name, shape in sorted(_param_shapes(cfg).items()):
        t = torch.randn(shape, generator=gen, device="cuda",
                        dtype=torch.float32 if "norm" in name else cfg.dtype)
        params[name] = (1.0 + 0.1 * t).to(cfg.dtype) if "norm" in name else t * width[name] ** -0.5
    return params


def phase_numerics(torch, card: str) -> dict:
    """2 layers at full 3B width, prefill of 2 x 64 tokens, last-token
    logits against the same weights upcast to fp32 through the plain path
    on the CPU (TF32 is off, so fp32 matmuls on the card are full fp32).
    Limits, on the RMS logit error relative to the RMS logit:

    - fp32 on the card through the kernel: 1e-4. Only summation order
      differs (cuBLAS vs the CPU, the kernel's reduction vs torch's).
    - bf16 on the card through the kernel: 5e-2. bf16 weights and
      activations keep 8 significant bits; through 2 layers and a
      3072-wide LM head that reads ~1.7e-2 on these weights.
    - a broken control, the bf16 run with every norm weight rolled by one
      element (a kernel reading w one element off), must read above the
      bf16 limit: the check can tell a fault from bf16 rounding."""
    from ray_tpu_torch.models.llama import LlamaConfig, init_kv_cache, prefill

    bf16 = LlamaConfig.llama32_3b(n_layers=2, max_seq_len=128, fused_rmsnorm=True)
    fp32 = dataclasses.replace(bf16, dtype=torch.float32)
    params = _conditioned_params(torch, bf16, seed=1)
    tokens = torch.randint(0, bf16.vocab_size, (2, 64), generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32)

    def logits(cfg, device, dtype, p=params):
        p = {k: v.to(device=device, dtype=dtype) for k, v in p.items()}
        with torch.inference_mode():
            out, _ = prefill(p, init_kv_cache(cfg, 2, 64, device), tokens.to(device), cfg)
        if not torch.isfinite(out).all() or out.shape != (2, cfg.vocab_size):
            raise AssertionError(f"logits on {device} in {dtype}: wrong shape or not finite")
        return out.float().cpu()

    def rel_rms(a, b):
        return ((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt()).item()

    rolled = {k: torch.roll(v, 1, dims=-1) if "norm" in k else v for k, v in params.items()}
    ref = logits(dataclasses.replace(fp32, fused_rmsnorm=False), "cpu", torch.float32)
    card32 = logits(fp32, "cuda", torch.float32)
    card16 = logits(bf16, "cuda", torch.bfloat16)
    control = logits(bf16, "cuda", torch.bfloat16, rolled)
    out = {
        "phase": "numerics", "card": card, "layers": 2, "d_model": bf16.d_model,
        "vocab": bf16.vocab_size, "tokens": list(tokens.shape), "ref_rms": ref.pow(2).mean().sqrt().item(),
        "fp32_rel_rms_err": rel_rms(card32, ref), "fp32_limit": 1e-4,
        "fp32_max_abs_err": (card32 - ref).abs().max().item(),
        "fp32_top1_agreement": (card32.argmax(-1) == ref.argmax(-1)).float().mean().item(),
        "bf16_rel_rms_err": rel_rms(card16, ref), "bf16_limit": 5e-2,
        "bf16_max_abs_err": (card16 - ref).abs().max().item(),
        "bf16_top1_agreement": (card16.argmax(-1) == ref.argmax(-1)).float().mean().item(),
        "bf16_min_cosine": torch.nn.functional.cosine_similarity(card16, ref, dim=-1).min().item(),
        "control_rel_rms_err": rel_rms(control, ref),
    }
    emit(out)
    if out["fp32_rel_rms_err"] > out["fp32_limit"]:
        raise AssertionError(f"fp32 slice on the card: {out['fp32_rel_rms_err']} > {out['fp32_limit']}")
    if out["bf16_rel_rms_err"] > out["bf16_limit"]:
        raise AssertionError(f"bf16 slice on the card: {out['bf16_rel_rms_err']} > {out['bf16_limit']}")
    if out["control_rel_rms_err"] <= out["bf16_limit"]:
        raise AssertionError(f"the broken control passed: {out['control_rel_rms_err']}")
    return out


def phase_train(torch, card: str) -> dict:
    """The JAX package's flagship train configuration (bench.py:31-47),
    value for value, through make_train_step on the card."""
    from ray_tpu_torch.tools.train_bench import bench_config, profile_step, run

    cfg = bench_config()
    if (cfg.vocab_size, cfg.d_model, cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff,
            cfg.max_seq_len, cfg.attention, cfg.remat, cfg.fused_ce) != (
            32000, 2048, 16, 16, 16, 8192, 2048, "splash", True, False):
        raise AssertionError(f"not the bench config: {cfg}")
    out = run(cfg, batch=4, seq=2048, warmup=2, steps=6)
    live = {k: out.pop(k) for k in ("state", "step_fn", "batch")}
    L, steps = cfg.n_layers, out["steps"]
    expected = {"fwd": 2 * L * steps, "bwd_dq": L * steps, "bwd_dkdv": L * steps}
    out["launches_expected"] = expected
    if out["launches"] != expected:
        raise AssertionError(f"attention launches {out['launches']} != {expected}")
    if not all(math.isfinite(x) for x in out["losses"]):
        raise AssertionError(f"non-finite train loss: {out['losses']}")
    out["profile"] = profile_step(live["step_fn"], live["state"], live["batch"])
    emit({"phase": "train", "card": card, "model": "bench.py train config", **out})
    del live
    torch.cuda.empty_cache()
    return out


def phase_train_numerics(torch, card: str) -> dict:
    """2 layers at the bench width (d_model 2048, 16 heads of 128, d_ff
    8192, vocab 32000), batch 2 x 256, weights drawn well-conditioned on
    the card: the loss and the grads of wq, wk, wv, wo and embed in bf16
    on the card through the kernels, against the same weights in fp32 on
    the CPU through dense_attention. Limits, fixed before the first run
    from the same arithmetic in bf16 on the CPU (dense attention, widths
    512-2048: grads 1.9-2.2e-2 relative RMS, loss 3e-5-9e-5 relative):
    - each grad's RMS error relative to its RMS: 6e-2;
    - the loss, relative: 1e-3;
    - a broken control, the kernel fed K one position off (a kernel that
      reads K one row off), must read above the grad limit (rehearsed:
      1.2-1.4);
    - the fused cross-entropy's loss against the plain one, both bf16 on
      the card on the same params and batch: 1e-4 relative."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.llama import loss_fn
    from ray_tpu_torch.ops.flash_attention import flash_attention, reset_launches
    from ray_tpu_torch.tools.train_bench import bench_config, make_batch

    grad_limit, loss_limit, fused_limit = 6e-2, 1e-3, 1e-4
    cfg = bench_config(n_layers=2)
    ref_cfg = dataclasses.replace(cfg, dtype=torch.float32, attention="full", remat=False)
    params = _conditioned_params(torch, cfg, seed=2)
    batch = make_batch(cfg, 2, 256, seed=2, device="cpu")
    names = ("wq", "wk", "wv", "wo", "embed")

    def loss_and_grads(c, device, dtype):
        p = {k: v.detach().to(device=device, dtype=dtype).requires_grad_(True)
             for k, v in params.items()}
        loss = loss_fn(p, {k: t.to(device) for k, t in batch.items()}, c)
        grads = torch.autograd.grad(loss, [p[n] for n in names])
        if not torch.isfinite(loss):
            raise AssertionError(f"train_numerics: non-finite loss on {device} in {dtype}")
        return loss.item(), {n: g.float().cpu() for n, g in zip(names, grads)}

    def rel_rms(a, b):
        return ((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt()).item()

    ref_loss, ref = loss_and_grads(ref_cfg, "cpu", torch.float32)
    reset_launches()
    card_loss, got = loss_and_grads(cfg, "cuda", torch.bfloat16)
    f = flash_attention
    launches = (f.launches_fwd, f.launches_bwd_dq, f.launches_bwd_dkdv)
    if launches != (2 * cfg.n_layers, cfg.n_layers, cfg.n_layers):
        raise AssertionError(f"train_numerics: attention launches {launches}")
    orig = llama._attention
    llama._attention = lambda q, k, v, c: orig(q, torch.roll(k, 1, dims=1), v, c)
    try:
        ctl_loss, ctl = loss_and_grads(cfg, "cuda", torch.bfloat16)
    finally:
        llama._attention = orig
    with torch.no_grad():
        p16 = {k: v.detach() for k, v in params.items()}
        on_card = {k: t.cuda() for k, t in batch.items()}
        plain_loss = loss_fn(p16, on_card, cfg).item()
        fused_loss = loss_fn(p16, on_card, dataclasses.replace(cfg, fused_ce=True)).item()
    out = {
        "phase": "train_numerics", "card": card, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "tokens": list(batch["tokens"].shape),
        "ref_loss": ref_loss, "bf16_loss": card_loss,
        "loss_rel_err": abs(card_loss - ref_loss) / abs(ref_loss), "loss_limit": loss_limit,
        "grad_rel_rms_err": {n: rel_rms(got[n], ref[n]) for n in names}, "grad_limit": grad_limit,
        "control_loss_rel_err": abs(ctl_loss - ref_loss) / abs(ref_loss),
        "control_grad_rel_rms_err": {n: rel_rms(ctl[n], ref[n]) for n in names},
        "plain_ce_loss": plain_loss, "fused_ce_loss": fused_loss,
        "fused_vs_plain_rel_err": abs(fused_loss - plain_loss) / abs(plain_loss),
        "fused_limit": fused_limit, "attention_launches": list(launches),
    }
    emit(out)
    worst = max(out["grad_rel_rms_err"].values())
    if worst > grad_limit or out["loss_rel_err"] > loss_limit:
        raise AssertionError(f"train_numerics: bf16 on the card outside the limits ({worst})")
    if max(out["control_grad_rel_rms_err"].values()) <= grad_limit:
        raise AssertionError("train_numerics: the broken control passed the grad limit")
    if out["fused_vs_plain_rel_err"] > fused_limit:
        raise AssertionError("train_numerics: fused and plain cross-entropy disagree")
    return out


def gc_collect(torch) -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def phase_gang_serve(torch, card: str, serve: dict) -> dict:
    """Gang serving on the card (llm/gang.py): GangLLMServer with one rank,
    a spawned process holding the card in a one-rank NCCL world, on the
    serving mesh path (every axis 1), at llama3.2-3b full width and depth
    (seeded bf16 weights, fused RMSNorm), 16 slots x 1024, chunk 256,
    decode_steps 4, decode_runahead 2.

    Same config, the single-process TorchEngine first: its 16 greedy
    completions of the serve phase's prompts (64 tokens). Then the gang:
    start-up, a warm-up, the rank's counters set to 0, the same 16
    requests submitted at once (tok/s, TTFT p50/p99, plan round trip from
    dispatch to rank 0's reply), the counters read in the rank. Limits:
    every first token equal to the engine's, and every full completion too
    (expected share 1.0: the same kernels at the same shapes, prefill
    chunks padded to 256 in both, each decode step the replay of a graph
    over the same [16, ...] cache); RMSNorm launches counted in the rank
    equal (2L+1) per decode step and per final chunk, 2L per mid chunk, as
    the serve phase derives them; every decode step a graph replay. Then a
    seeded sampled request whose rank is killed after its first token
    streamed: the gang is rebuilt and the replayed stream equals an
    uninterrupted run of the same request."""
    import numpy as np

    from ray_tpu_torch.llm import (EngineConfig, LLMConfig, ModelConfig, SamplingParams,
                                   TorchEngine)
    from ray_tpu_torch.llm.gang import GangLLMServer

    cfg = LLMConfig(
        model=ModelConfig(model_id="llama3.2-3b", tokenizer="byte", seed=0,
                          model_kwargs={"fused_rmsnorm": True}),
        engine=EngineConfig(max_num_seqs=16, max_seq_len=1024, prefill_buckets=(256, 512, 1024),
                            prefill_chunk=256, decode_steps=4, decode_runahead=2),
    )
    prompts = _serve_prompts()
    greedy = SamplingParams(max_tokens=64, temperature=0.0, ignore_eos=True)

    def wait(r):
        if not r.done.wait(600) or r.error is not None:
            raise AssertionError(f"gang_serve: a request failed: {r.error!r}")

    def run(submit):
        """The 16 prompts submitted at once; each request waited for."""
        reqs = [submit(p) for p in prompts]
        for r in reqs:
            wait(r)
        return reqs

    eng = TorchEngine(cfg)
    try:
        eng.generate("warm up " * 12, sampling_params=greedy)
        t0 = time.perf_counter()
        ref = run(lambda p: eng.submit(p, sampling_params=greedy))
        engine_wall = time.perf_counter() - t0
        ref_tokens = [list(r.out_tokens) for r in ref]
    finally:
        eng.shutdown()
        del eng
        gc_collect(torch)

    t0 = time.perf_counter()
    gang = GangLLMServer(cfg)
    startup_s = time.perf_counter() - t0
    try:
        wait(gang.submit("warm up " * 12, greedy))
        gang.rank_counts(reset=True)  # counts from here on are the main path's
        n_plans = len(gang.plan_times())
        t0 = time.perf_counter()
        reqs = run(lambda p: gang.submit(p, greedy))
        wall = time.perf_counter() - t0
        (counts,) = gang.rank_counts()
        plans = np.asarray(gang.plan_times()[n_plans:])
        launches = counts["launches"]["rmsnorm"]
        prog = counts["programs"]
        n_norms = 2 * L_3B + 1
        expected = (n_norms * (prog["decode_steps"] + prog["prefill_final_chunks"])
                    + (n_norms - 1) * prog["prefill_mid_chunks"])
        ttft = np.asarray([r.first_token_t - r.submitted_t for r in reqs]) * 1e3
        got = [r.out_tokens for r in reqs]
        first_equal = sum(g[0] == w[0] for g, w in zip(got, ref_tokens))
        full_equal = sum(g == w for g, w in zip(got, ref_tokens))

        # a rank killed mid-request, the gang rebuilt, the request replayed
        hot = SamplingParams(max_tokens=64, temperature=0.8, top_k=50, seed=7, ignore_eos=True)
        req = gang.submit("Sample this after a rank dies.", hot)
        req.stream_queue.get(timeout=600)
        streamed_at_kill = len(req.out_tokens)
        t0 = time.perf_counter()
        gang.workers[0].kill()
        wait(req)
        replay_s = time.perf_counter() - t0
        again = gang.submit("Sample this after a rank dies.", hot)
        wait(again)
        stats = gang.stats()
        out = {
            "phase": "gang_serve", "card": card, "model": "llama3.2-3b",
            "gang": gang.gang_info, "ranks": gang.num_workers,
            "decode_steps_per_plan": cfg.engine.decode_steps,
            "decode_runahead": cfg.engine.decode_runahead,
            "gang_startup_s": startup_s,
            "rank_startup_s": gang.gang_info["rank_startup_s"][0],
            "wall_s_16x64": wall,
            "out_tok_per_s": 16 * 64 / wall,
            "ttft_ms_p50": float(np.percentile(ttft, 50)),
            "ttft_ms_p99": float(np.percentile(ttft, 99)),
            "plans": len(plans),
            "plan_roundtrip_ms_p50": float(np.percentile(plans[:, 0], 50)),
            "plan_roundtrip_ms_mean": float(plans[:, 0].mean()),
            "plan_exec_ms_mean": float(plans[:, 1].mean()),
            # dispatch -> the rank takes it up: the pipe, and the wait behind
            # the plan in flight (run-ahead)
            "plan_queue_ms_mean": float((plans[:, 0] - plans[:, 1]).mean()),
            "decode_step_device_ms": prog["decode_device_ms"] / prog["decode_steps"],
            "rmsnorm_launches": launches, "rmsnorm_launches_expected": expected,
            "rank_flash_launches": {k: v for k, v in counts["launches"].items()
                                    if k.startswith("flash")},
            **{k: prog[k] for k in ("decode_programs", "decode_steps", "decode_graph_replays",
                                    "prefill_mid_chunks", "prefill_final_chunks")},
            "engine_out_tok_per_s": 16 * 64 / engine_wall,
            "first_tokens_equal_engine": first_equal,
            "full_completions_equal_engine_share": full_equal / 16,
            "full_completions_equal_expected_share": 1.0,
            "serve_phase": {k: serve[k] for k in ("out_tok_per_s", "ttft_ms_p50", "ttft_ms_p99",
                                                  "decode_step_ms_mean",
                                                  "decode_steps_per_program")},
            "kill": {"streamed_at_kill": streamed_at_kill, "rebuilds": stats["rebuilds"],
                     "replay_s": replay_s, "replay_equal": req.out_tokens == again.out_tokens,
                     "tokens": len(req.out_tokens)},
        }
    finally:
        gang.shutdown()
    emit(out)
    if first_equal != 16:
        raise AssertionError(f"gang_serve: {16 - first_equal} first tokens differ from the "
                             "engine's")
    if full_equal != 16:
        raise AssertionError(f"gang_serve: {16 - full_equal} completions differ from the engine's")
    if launches != expected or prog["decode_graph_replays"] != prog["decode_steps"]:
        raise AssertionError(f"gang_serve: rmsnorm launches {launches} != {expected}, or a decode "
                             f"step was no graph replay ({prog})")
    if out["kill"]["rebuilds"] != 1 or not out["kill"]["replay_equal"] or len(req.out_tokens) != 64:
        raise AssertionError(f"gang_serve: the replay after the kill: {out['kill']}")
    return out


MOE = {"moe_experts": 8, "moe_top_k": 2}
SERVE_BUCKETS = (32, 64, 128, 256, 512, 1024)


def _serve_config(model_kwargs: dict, **engine_kw):
    """The serve phase's engine shape: llama3.2-3b, 16 slots x 1024, chunk
    256, 8 decode steps a program."""
    from ray_tpu_torch.llm import EngineConfig, LLMConfig, ModelConfig

    return LLMConfig(
        model=ModelConfig(model_id="llama3.2-3b", tokenizer="byte", seed=0,
                          model_kwargs={"fused_rmsnorm": True, **model_kwargs}),
        engine=EngineConfig(max_num_seqs=16, max_seq_len=1024, prefill_buckets=SERVE_BUCKETS,
                            prefill_chunk=256, decode_steps=8, decode_runahead=1, **engine_kw),
    )


def _serve_prompts() -> list:
    """The serve phase's 16 distinct ~100-byte prompts."""
    prompts = [f"Request {i:02d}: " + "write a short note about serving a model on one card. " * 2
               for i in range(16)]
    return [p[:100] for p in prompts]


def _concurrent(server, bodies: list) -> tuple:
    """``bodies`` through server.completions, one thread each, all at once.
    Returns (the engine's RequestOutput of each body, in order, wall s)."""
    eng = server.engine
    generate = eng.generate
    outs = {}

    def observed(prompt, **kwargs):
        out = generate(prompt, **kwargs)
        outs[(prompt, kwargs.get("lora"))] = out
        return out

    replies = [None] * len(bodies)

    def one(i):
        replies[i] = server.completions(bodies[i])

    eng.generate = observed
    try:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=one, args=(i,)) for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
    finally:
        del eng.generate  # back to the class's method
    for i, (b, r) in enumerate(zip(bodies, replies)):
        if r is None or "error" in r or r["usage"]["completion_tokens"] != b["max_tokens"]:
            raise AssertionError(f"request {i} did not return {b['max_tokens']} tokens: {r}")
    return [outs[(b["prompt"], b.get("_lora"))] for b in bodies], wall


def _step_delta(stats0: dict, stats: dict) -> dict:
    return {k: stats[k] - stats0[k] for k in
            ("decode_programs", "decode_steps", "decode_graph_replays", "prefill_mid_chunks",
             "prefill_final_chunks", "decode_device_ms", "decode_programs_timed")}


def phase_moe_serve(torch, card: str) -> dict:
    """llama3.2-3b with 8 experts of top-2 (the MoE variant the LLM config
    names), full width and depth, seeded bf16 weights, served through
    LLMServer with the fused RMSNorm. 16 concurrent greedy requests x 32
    tokens: every decode step a graph replay, RMSNorm launches as the
    serve phase counts them. Then 8 graphed MoE decode steps against 8
    eager ones on cloned caches (tokens equal; a control replayed without
    the next tokens copied in gives other tokens). The decode step's byte
    bound reads every expert: the batched branch streams the whole bank."""
    import numpy as np

    from ray_tpu_torch.llm import LLMServer
    from ray_tpu_torch.ops import rmsnorm
    from ray_tpu_torch.tools.decode_profile import HBM_BYTES_PER_S, _profile

    cfg = _serve_config(MOE)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server = LLMServer(cfg)
    init_s = time.perf_counter() - t0
    eng = server.engine
    try:
        mcfg = eng.model_cfg
        if (mcfg.d_model, mcfg.n_layers, mcfg.n_heads, mcfg.n_kv_heads, mcfg.d_ff, mcfg.vocab_size,
                mcfg.tie_embeddings, mcfg.moe_experts, mcfg.moe_top_k) != (
                3072, L_3B, 24, 8, 8192, 128256, True, 8, 2):
            raise AssertionError(f"not the 3B MoE shape: {mcfg}")
        server.completions({"prompt": "warm up " * 12, "max_tokens": 16, "ignore_eos": True})
        stats0 = eng.get_stats()
        rmsnorm.launches = 0  # counts from here on are the main path's
        bodies = [{"prompt": p, "max_tokens": 32, "temperature": 0.0, "ignore_eos": True}
                  for p in _serve_prompts()]
        outs, wall = _concurrent(server, bodies)
        launches = rmsnorm.launches
        delta = _step_delta(stats0, eng.get_stats())
    finally:
        eng.shutdown()
    if delta["decode_graph_replays"] != delta["decode_steps"]:
        raise AssertionError(f"moe_serve: decode steps that were no graph replay: {delta}")
    n_norms = 2 * L_3B + 1
    expected = (n_norms * (delta["decode_steps"] + delta["prefill_final_chunks"])
                + (n_norms - 1) * delta["prefill_mid_chunks"])
    if launches != expected:
        raise AssertionError(f"moe_serve: rmsnorm launches {launches} != expected {expected} ({delta})")
    ttft = np.asarray([o.metrics["ttft_s"] for o in outs]) * 1e3
    params = eng.params
    weight_bytes = sum(p.numel() * p.element_size() for p in params.values())
    kv_bytes = sum(2 * pool.cache["k"].numel() * pool.cache["k"].element_size() for pool in eng._pools)
    step_bound_ms = (weight_bytes + kv_bytes) / HBM_BYTES_PER_S * 1e3
    program_ms = delta["decode_device_ms"] / delta["decode_programs_timed"]
    del server, eng, outs
    gc_collect(torch)
    with torch.inference_mode():
        g = _graph_vs_eager(torch, params, mcfg, 16, 1024, 8, seed=7)
        prof = _profile(g["graph"].replay, 5)
    out = {
        "phase": "moe_serve", "card": card, "model": "llama3.2-3b + 8 experts top-2",
        "params": sum(p.numel() for p in params.values()), "engine_init_s": init_s,
        "wall_s_16x32": wall, "out_tok_per_s": 16 * 32 / wall,
        "ttft_ms_p50": float(np.percentile(ttft, 50)), "ttft_ms_p99": float(np.percentile(ttft, 99)),
        "decode_program_ms_mean": program_ms, "decode_step_ms_mean": program_ms / 8,
        "decode_step_bytes": weight_bytes + kv_bytes, "decode_step_bound_ms": step_bound_ms,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "rmsnorm_launches": launches, "rmsnorm_launches_expected": expected, **delta,
        "graphed_vs_eager": {k: g[k] for k in ("tokens_equal", "control_tokens_equal",
                                               "logits_max_abs_diff", "rmsnorm_launches")},
        "graphed_step_profile": prof,
    }
    emit(out)
    del g, params
    gc_collect(torch)
    if not out["graphed_vs_eager"]["tokens_equal"]:
        raise AssertionError("moe_serve: graphed MoE decode tokens differ from eager")
    if out["graphed_vs_eager"]["control_tokens_equal"]:
        raise AssertionError("moe_serve: the broken control gave the eager tokens")
    return out


def phase_moe_numerics(torch, card: str) -> dict:
    """phase_numerics for the MoE variant: 2 layers at full 3B width with 8
    experts of top-2, prefill of 2 x 64 tokens (G = 128: the prefill's
    expert-by-expert branch), last-token logits on the card (fp32 and bf16,
    through the RMSNorm kernel) against the same weights in fp32 on the
    CPU through the plain path, on the RMS logit error relative to the RMS
    logit. Router logits have a std of 3 (_conditioned_params). Limits:
    - fp32: 1e-4, every token on the reference's experts;
    - bf16: 5e-2 against the reference run on the card's expert choices
      (at its own gates), and those choices equal to the reference's for
      at least 95% of (layer, token) expert sets. bf16 rounding reorders
      a token's experts near a tie, and such a token then carries another
      expert's output: on the CPU at widths 768 and 1536 this doubles the
      bf16 error (4.1-4.4e-2, against 2.1-2.5e-2 on equal choices; 2-3.5%
      of sets changed), and on an H100 the card's own choices read 6.8e-2.
      That error is reported beside the gated one;
    - a broken control: one expert's w_down shifted by one element along
      d_model in every layer, on the card copy only (the expert that the
      reference routes row 0's last token to first in layer 0), must
      exceed the bf16 limit against the reference on its own choices."""
    from ray_tpu_torch.models.llama import LlamaConfig, init_kv_cache, prefill
    from ray_tpu_torch.parallel import moe

    bf16 = LlamaConfig.llama32_3b(n_layers=2, max_seq_len=128, fused_rmsnorm=True, **MOE)
    fp32 = dataclasses.replace(bf16, dtype=torch.float32)
    params = _conditioned_params(torch, bf16, seed=6)
    tokens = torch.randint(0, bf16.vocab_size, (2, 64), generator=torch.Generator().manual_seed(6),
                           dtype=torch.int32)
    topk = moe.topk_gates

    def logits(cfg, device, dtype, p=params, force=None):
        """Last-token logits and each layer's expert choices [layers, G, k].
        ``force`` gives the choices instead, at this run's own gates."""
        routes = []

        def recording(bank, x, k):
            probs, vals, idx = topk(bank, x, k)
            if force is not None:
                idx = force[len(routes)].to(x.device)
                vals = probs.gather(-1, idx)
                vals = vals / vals.sum(-1, keepdim=True).clamp_min(1e-9)
            routes.append(idx.cpu())
            return probs, vals, idx

        p = {k: v.to(device=device, dtype=dtype) for k, v in p.items()}
        moe.topk_gates = recording
        try:
            with torch.inference_mode():
                out, _ = prefill(p, init_kv_cache(cfg, 2, 64, device), tokens.to(device), cfg)
        finally:
            moe.topk_gates = topk
        if not torch.isfinite(out).all() or out.shape != (2, cfg.vocab_size):
            raise AssertionError(f"moe logits on {device} in {dtype}: wrong shape or not finite")
        return out.float().cpu(), torch.stack(routes)

    def rel_rms(a, b):
        return ((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt()).item()

    def set_agreement(a, b):
        """Share of (layer, token) whose chosen expert sets are equal."""
        return (a.sort(-1).values == b.sort(-1).values).all(-1).float().mean().item()

    plain = dataclasses.replace(fp32, fused_rmsnorm=False)
    ref, ref_routes = logits(plain, "cpu", torch.float32)
    expert = int(ref_routes[0, 63, 0])  # layer 0, row 0's last token, first choice
    shifted = dict(params)
    shifted["moe_w_down"] = params["moe_w_down"].clone()
    shifted["moe_w_down"][:, expert] = torch.roll(params["moe_w_down"][:, expert], 1, dims=-1)
    card32, routes32 = logits(fp32, "cuda", torch.float32)
    card16, routes16 = logits(bf16, "cuda", torch.bfloat16)
    control, control_routes = logits(bf16, "cuda", torch.bfloat16, shifted)
    del shifted
    # the reference with the card's expert choices: bf16 reorders a token's
    # experts near a tie, and a changed choice moves that token by a whole
    # expert's output, which is routing, not arithmetic
    ref16, _ = logits(plain, "cpu", torch.float32, force=routes16)
    ref_control, _ = logits(plain, "cpu", torch.float32, force=control_routes)
    out = {
        "phase": "moe_numerics", "card": card, "layers": 2, "d_model": bf16.d_model, "experts": 8,
        "top_k": 2, "tokens": list(tokens.shape), "ref_rms": ref.pow(2).mean().sqrt().item(),
        "fp32_rel_rms_err": rel_rms(card32, ref), "fp32_limit": 1e-4,
        "fp32_route_set_agreement": set_agreement(routes32, ref_routes),
        "bf16_rel_rms_err_same_routes": rel_rms(card16, ref16), "bf16_limit": 5e-2,
        "bf16_route_set_agreement": set_agreement(routes16, ref_routes), "route_set_limit": 0.95,
        "bf16_rel_rms_err_own_routes": rel_rms(card16, ref),
        "bf16_route_position_agreement": (routes16 == ref_routes).float().mean().item(),
        "bf16_max_abs_err_same_routes": (card16 - ref16).abs().max().item(),
        "bf16_top1_agreement": (card16.argmax(-1) == ref.argmax(-1)).float().mean().item(),
        "control_expert": expert, "control_rel_rms_err_same_routes": rel_rms(control, ref_control),
    }
    emit(out)
    del params
    gc_collect(torch)
    if out["fp32_rel_rms_err"] > out["fp32_limit"] or out["fp32_route_set_agreement"] < 1.0:
        raise AssertionError(f"moe fp32 on the card: {out['fp32_rel_rms_err']} > {out['fp32_limit']}")
    if out["bf16_rel_rms_err_same_routes"] > out["bf16_limit"]:
        raise AssertionError(f"moe bf16 on the card: {out['bf16_rel_rms_err_same_routes']} > 5e-2")
    if out["bf16_route_set_agreement"] < out["route_set_limit"]:
        raise AssertionError(f"moe bf16 routes: {out['bf16_route_set_agreement']} agree < 0.95")
    if out["control_rel_rms_err_same_routes"] <= out["bf16_limit"]:
        raise AssertionError("moe_numerics: the broken control passed the bf16 limit")
    return out


def phase_moe_train(torch, card: str) -> dict:
    """bench.py's train widths with 8 experts, top-2, capacity 1.25 (batch
    4 x 2048, bf16, remat "full", splash) through make_train_step, at the
    depth that fits (tools/moe_train_bench.py:moe_layers), the optimizer at
    its peak rate from step 2 (moe_optimizer): 2 warm-up and 3 timed steps
    from init_params' weights, finite losses, attention launches 2L/L/L a
    step. Then the learning check: 5 steps on one fixed batch from
    well-conditioned weights (_conditioned_params), the last loss below
    the first. From init_params' weights at this width the gradient norm
    reads ~2e7 and the loss moves by +-0.02 from step to step whatever the
    rate (on an H100: 11.01-11.05 over 7 steps), so those steps show no
    learning either way."""
    from ray_tpu_torch.models.training import TrainState, make_train_step
    from ray_tpu_torch.tools.moe_train_bench import (
        measured, moe_layers, moe_optimizer, moe_train_config, reckoned_peak_bytes,
    )
    from ray_tpu_torch.tools.train_bench import make_batch, profile_step, run

    L, why = moe_layers()
    cfg = moe_train_config(L)
    out = run(cfg, batch=4, seq=2048, warmup=2, steps=3, optimizer=moe_optimizer())
    live = {k: out.pop(k) for k in ("state", "step_fn", "batch")}
    profile = profile_step(live["step_fn"], live["state"], live["batch"])
    del live
    gc_collect(torch)
    steps = out["steps"]
    expected = {"fwd": 2 * L * steps, "bwd_dq": L * steps, "bwd_dkdv": L * steps}
    params = _conditioned_params(torch, cfg, seed=8)
    opt = moe_optimizer()
    _, step_fn = make_train_step(cfg, opt)
    state, batch, learn = TrainState(params, opt.init(params), 0), make_batch(cfg, 4, 2048, seed=8), []
    for _ in range(5):
        state, metrics = step_fn(state, batch)
        learn.append(metrics["loss"])
    learn = [float(x) for x in learn]
    del params, state, metrics, batch
    gc_collect(torch)
    out = {
        "phase": "moe_train", "card": card, "model": "bench.py train widths + 8 experts top-2",
        "layers": L, "depth_rule": why, "reckoned_peak_gb": reckoned_peak_bytes(cfg) / 1e9,
        "optimizer": "default_optimizer with 1 warm-up step (peak rate 3e-4 from step 2)",
        **measured(cfg, out), "learning_losses": learn, "launches_expected": expected,
        "profile": profile,
        "mfu_note": "mfu counts each token through its top-k experts (6 x active params + "
                    "attention); mfu_capacity_slots counts the capacity buffers' slots "
                    "(capacity factor x top-k)",
    }
    emit(out)
    if out["launches"] != expected:
        raise AssertionError(f"moe_train: attention launches {out['launches']} != {expected}")
    if not all(math.isfinite(x) for x in out["losses"] + learn):
        raise AssertionError(f"moe_train: non-finite loss: {out['losses']}, {learn}")
    if not learn[-1] < learn[0]:
        raise AssertionError(f"moe_train: the loss did not fall over {len(learn)} steps: {learn}")
    return out


def phase_train_dots(torch, card: str, full: dict) -> dict:
    """The train phase's configuration with remat_policy="dots", in turns
    with "full" in this phase (full, dots, dots, full: 2 warm-up and 3 timed
    steps each), so both read the card in the same state; the train
    phase's own "full" reading stands beside them. Attention launches
    stay 2L/L/L a step under "dots" (the attention kernel is no matmul op,
    so the policy recomputes it)."""
    from ray_tpu_torch.tools.train_bench import bench_config, run

    runs = []
    for policy in ("full", "dots", "dots", "full"):
        cfg = bench_config(remat_policy=policy)
        out = run(cfg, batch=4, seq=2048, warmup=2, steps=3)
        for k in ("state", "step_fn", "batch"):
            del out[k]
        gc_collect(torch)
        runs.append({"policy": policy, **out})
    L, steps = cfg.n_layers, runs[0]["steps"]
    expected = {"fwd": 2 * L * steps, "bwd_dq": L * steps, "bwd_dkdv": L * steps}
    ms = {p: [r["step_ms"] for r in runs if r["policy"] == p] for p in ("full", "dots")}
    peak = {p: max(r["peak_mem_gib"] for r in runs if r["policy"] == p) for p in ("full", "dots")}
    out = {"phase": "train_dots", "card": card, "model": "bench.py train config, remat dots vs full",
           "step_ms": ms, "peak_mem_gib": peak, "launches_expected": expected,
           "runs": [{k: r[k] for k in ("policy", "step_ms", "mfu", "peak_mem_gib", "losses", "launches")}
                    for r in runs],
           "train_phase_full_step_ms": full["step_ms"], "train_phase_full_peak_mem_gib": full["peak_mem_gib"]}
    emit(out)
    for r in runs:
        if r["launches"] != expected:
            raise AssertionError(f"train_dots: {r['policy']} attention launches {r['launches']} != {expected}")
        if not all(math.isfinite(x) for x in r["losses"]):
            raise AssertionError(f"train_dots: non-finite loss: {r['losses']}")
    return {"launches": next(r for r in runs if r["policy"] == "dots")["launches"], **out}


def phase_lora_serve(torch, card: str, serve: dict) -> dict:
    """llama3.2-3b at full depth with max_loras=2, lora_rank=8, served
    through LLMServer (prefix caching off, so every prefill is cold). Two
    seeded adapters loaded with load_lora. 16 requests of 32 tokens on the
    serve phase's prompts, on adapters (none, "a", "b") in turn, run one
    by one and then all at once: each request's tokens equal in both runs;
    the base requests' tokens equal the serve phase's (no-LoRA engine, same
    weights) first 32; adapted tokens differ from the base somewhere; every
    decode step a graph replay while slots change adapters."""
    from ray_tpu_torch.llm import LLMServer, SamplingParams
    from ray_tpu_torch.ops import rmsnorm
    from ray_tpu_torch.tools.decode_profile import _profile

    cfg = _serve_config({}, max_loras=2, lora_rank=8, enable_prefix_caching=False)
    server = LLMServer(cfg)
    eng = server.engine
    try:
        gen = torch.Generator(device="cuda").manual_seed(9)
        mcfg = eng.model_cfg
        adapter_weights = {}  # host copies, for the gang_lora phase
        for name in ("a", "b"):
            # A: N(0, 1) / sqrt(d_model); B: N(0, 1) x 4 / sqrt(rank): deltas
            # of O(4) on q and v, whose entries are O(10) under this init
            weights = {k: torch.randn(v.shape[:1] + v.shape[2:], generator=gen, device="cuda")
                       * (mcfg.d_model**-0.5 if k.endswith("_a") else 4 * cfg.engine.lora_rank**-0.5)
                       for k, v in eng.loras.items()}
            server.load_lora(name, weights)
            adapter_weights[name] = {k: v.cpu() for k, v in weights.items()}
        if server.list_loras() != ["a", "b"]:
            raise AssertionError(f"lora_serve: loaded {server.list_loras()}")
        server.completions({"prompt": "warm up " * 12, "max_tokens": 16, "ignore_eos": True,
                            "_lora": "a"})
        adapters = [(None, "a", "b")[i % 3] for i in range(16)]
        bodies = [{"prompt": p, "max_tokens": 32, "temperature": 0.0, "ignore_eos": True,
                   **({"_lora": a} if a else {})} for p, a in zip(_serve_prompts(), adapters)]
        sp = SamplingParams(max_tokens=32, temperature=0.0, ignore_eos=True)
        sequential = [eng.generate(b["prompt"], sampling_params=sp, lora=b.get("_lora")).token_ids
                      for b in bodies]
        stats0 = eng.get_stats()
        rmsnorm.launches = 0  # counts from here on are the path's
        outs, wall = _concurrent(server, bodies)
        launches = rmsnorm.launches
        delta = _step_delta(stats0, eng.get_stats())
    finally:
        eng.shutdown()
    n_norms = 2 * L_3B + 1
    expected = (n_norms * (delta["decode_steps"] + delta["prefill_final_chunks"])
                + (n_norms - 1) * delta["prefill_mid_chunks"])
    with torch.inference_mode():  # the pool's decode graph, adapters and all
        prof = _profile(eng._pools[0].graph.replay, 5)
    mixed = [o.token_ids for o in outs]
    base = {tuple(o.prompt_token_ids): o.token_ids for o, a in zip(outs, adapters) if a is None}
    base_equal = all(serve["tokens_by_prompt"][k][:32] == t for k, t in base.items())
    adapted_differ = sum(
        o.token_ids != serve["tokens_by_prompt"][tuple(o.prompt_token_ids)][:32]
        for o, a in zip(outs, adapters) if a)
    out = {
        "phase": "lora_serve", "card": card, "model": "llama3.2-3b", "max_loras": 2, "lora_rank": 8,
        "requests": 16, "adapters": adapters, "wall_s_16x32": wall, "out_tok_per_s": 16 * 32 / wall,
        "serve_out_tok_per_s_16x64": serve["out_tok_per_s"],
        "mixed_equal_sequential": mixed == sequential, "base_requests": len(base),
        "base_equal_no_lora_engine": base_equal, "adapted_requests_differing_from_base": adapted_differ,
        "decode_program_ms_mean": delta["decode_device_ms"] / delta["decode_programs_timed"],
        "rmsnorm_launches": launches, "rmsnorm_launches_expected": expected, **delta,
        "graphed_step_profile": prof,
    }
    emit(out)
    del server, eng, outs
    gc_collect(torch)
    if delta["decode_graph_replays"] != delta["decode_steps"]:
        raise AssertionError(f"lora_serve: decode steps that were no graph replay: {delta}")
    if launches != expected:
        raise AssertionError(f"lora_serve: rmsnorm launches {launches} != expected {expected}")
    if not out["mixed_equal_sequential"]:
        raise AssertionError("lora_serve: the mixed batch's tokens differ from the sequential runs'")
    if not base_equal or len(base) != 6:
        raise AssertionError("lora_serve: base requests differ from the no-LoRA engine's tokens")
    if adapted_differ == 0:
        raise AssertionError("lora_serve: no adapter changed any request's tokens")
    # for the gang_lora phase: the adapters, the requests and their tokens
    return {**out, "adapter_weights": adapter_weights, "bodies": bodies, "mixed": mixed}


def _copy_params(torch, dst: dict, src: dict) -> None:
    """``src`` into ``dst`` leaf by leaf, in place (a captured decode graph
    reads ``dst``'s tensors where they are)."""
    with torch.no_grad():
        for name, t in dst.items():
            t.copy_(src[name])


def phase_disagg(torch, card: str) -> dict:
    """Prefill/decode disaggregation (llm/disagg.py) at llama3.2-3b's full
    width and depth, fused RMSNorm, max_seq_len 1024, the serve phase's
    prefill buckets: a PrefillWorker and a DecodeWorker in one process
    behind a DisaggRouter, and TorchEngines of the same config for the
    reference, all holding the same well-conditioned weights
    (_conditioned_params, copied in place).

    The serve phase's 16 prompts go one at a time through the router, 32
    tokens each, greedy with EOS honoured in both paths. Limits: each
    request's tokens equal TorchEngine.generate's with the pool sized to
    one slot (max_num_seqs 1), which sums in the disaggregated path's order
    (a B = 1 decode graph; the same 128-wide prefill); every decode step a
    graph replay; RMSNorm launches, set to 0 just before the 16 requests,
    equal (2L+1) per prefill and per decode step. (The 16-slot engine's
    B = 16 GEMMs round otherwise in bf16, so its tokens part from these
    after a few positions.) A broken control, one
    request decoded from its handoff with ``length`` one short, must give
    other tokens. Reported: the handoff's bytes, its ms device -> host (in
    the prefill worker) and host -> device (in the decode worker), TTFT
    through the router (the call to the prefill's return), decode tok/s."""
    import numpy as np

    from ray_tpu_torch.llm import (DecodeWorker, DisaggRouter, PrefillWorker, SamplingParams,
                                   TorchEngine)
    from ray_tpu_torch.ops import rmsnorm

    cfg = _serve_config({})
    pw, dw = PrefillWorker(cfg), DecodeWorker(cfg)
    cond = _conditioned_params(torch, pw.model_cfg, seed=13)
    for params in (pw.params, dw.params):
        _copy_params(torch, params, cond)
    prompts = _serve_prompts()
    sp = SamplingParams(max_tokens=32, temperature=0.0)
    eng = TorchEngine(dataclasses.replace(
        cfg, engine=dataclasses.replace(cfg.engine, max_num_seqs=1)))
    try:
        _copy_params(torch, eng.params, cond)
        want = [eng.generate(p, sampling_params=sp).token_ids for p in prompts]
    finally:
        eng.shutdown()
    del eng, cond
    gc_collect(torch)

    got, ttft, to_host, to_device, decode_tps = [], [], [], [], []
    prefill, decode = pw.prefill, dw.decode

    def observed_prefill(prompt):
        handoff = prefill(prompt)
        ttft.append((time.perf_counter() - t0) * 1e3)
        to_host.append(pw.last["to_host_ms"])
        return handoff

    def observed_decode(handoff, max_tokens):
        out = decode(handoff, max_tokens)
        got.append(out["token_ids"])
        to_device.append(dw.last["to_device_ms"])
        decode_tps.append(dw.last["decode_steps"] / (dw.last["decode_ms"] / 1e3))
        return out

    router = DisaggRouter(pw, dw)
    router({"prompt": "warm up " * 12, "max_tokens": 8})  # allocator, cuBLAS handles
    pw.prefill, dw.decode = observed_prefill, observed_decode
    try:
        counts0 = dict(dw.counts)
        rmsnorm.launches = 0  # counts from here on are the path's
        wall0 = time.perf_counter()
        for p in prompts:
            t0 = time.perf_counter()
            reply = router({"prompt": p, "max_tokens": 32})
            if reply["num_tokens"] != len(got[-1]):
                raise AssertionError(f"disagg: the router's reply {reply} for {got[-1]}")
        wall = time.perf_counter() - wall0
        launches = rmsnorm.launches
    finally:
        del pw.prefill, dw.decode  # back to the classes' methods
    steps = {k: dw.counts[k] - counts0[k] for k in ("decode_steps", "decode_graph_replays")}
    expected = (2 * L_3B + 1) * (len(prompts) + steps["decode_steps"])
    handoff = pw.prefill(prompts[0])
    control = dw.decode(dict(handoff, length=handoff["length"] - 1), 32)["token_ids"]
    equal = sum(g == w for g, w in zip(got, want))
    out = {
        "phase": "disagg", "card": card, "model": "llama3.2-3b", "requests": len(prompts),
        "max_tokens": 32, "weights": "conditioned (seed 13)",
        "handoff_bytes": pw.last["handoff_bytes"], "handoff_dtype": str(handoff["k"].dtype),
        "handoff_pinned": bool(handoff["k"].is_pinned()),
        "prefill_bucket": pw.last["bucket"],
        "to_host_ms_p50": float(np.percentile(to_host, 50)),
        "to_device_ms_p50": float(np.percentile(to_device, 50)),
        "to_host_gb_per_s": pw.last["handoff_bytes"] / (np.percentile(to_host, 50) / 1e3) / 1e9,
        "to_device_gb_per_s": (pw.last["handoff_bytes"] / (np.percentile(to_device, 50) / 1e3)
                               / 1e9),
        "ttft_ms_p50": float(np.percentile(ttft, 50)), "ttft_ms_p99": float(np.percentile(ttft, 99)),
        "decode_tok_per_s_p50": float(np.percentile(decode_tps, 50)),
        "wall_s_16x32": wall, "out_tok_per_s": sum(len(g) for g in got) / wall,
        "tokens_equal_engine_1_slot": equal, "tokens": [len(g) for g in got],
        **steps,
        "rmsnorm_launches": launches, "rmsnorm_launches_expected": expected,
        "control_tokens_equal": control == got[0],
    }
    emit(out)
    del pw, dw, handoff
    gc_collect(torch)
    if equal != len(prompts):
        raise AssertionError(f"disagg: {len(prompts) - equal} requests differ from the engine's")
    if steps["decode_graph_replays"] != steps["decode_steps"] or launches != expected:
        raise AssertionError(f"disagg: rmsnorm launches {launches} != {expected}, or a decode "
                             f"step was no graph replay ({steps})")
    if out["control_tokens_equal"]:
        raise AssertionError("disagg: the handoff one position short gave the same tokens")
    return out


BATCH_SAMPLING = {"max_tokens": 32, "temperature": 0.0, "ignore_eos": True}


def _batch_prompts() -> list:
    """The batch phase's 32 prompts: the serve phase's 16 and 16 more."""
    return _serve_prompts() + [f"Row {i:02d}: summarise offline batch inference on a card."
                               for i in range(16)]


def phase_batch(torch, card: str) -> dict:
    """Offline batch inference (llm/batch.py): build_llm_processor with
    concurrency 0 (task stages on the driver's threads, one engine in this
    process) over a port Dataset of the serve phase's 16 prompts and 16
    more, in 2 blocks of 16, greedy, 32 tokens, on llama3.2-3b (full width
    and depth, seeded bf16 weights, the fused RMSNorm; prefix caching off,
    so every prefill is cold). Limits: each row's text equal to
    TorchEngine.generate's for the same prompt on the processor's engine,
    rows in input order; every decode step a graph replay; RMSNorm
    launches, set to 0 just before the processor runs, equal to the count
    the engine's counters give. Reported: rows/s and output tok/s. The
    texts go on to the data phase."""
    from ray_tpu_torch import data
    from ray_tpu_torch.llm import ProcessorConfig, SamplingParams, build_llm_processor
    from ray_tpu_torch.llm import batch
    from ray_tpu_torch.ops import rmsnorm

    cfg = _serve_config({}, enable_prefix_caching=False)
    prompts = _batch_prompts()
    proc = build_llm_processor(ProcessorConfig(llm_config=cfg, batch_size=16, concurrency=0,
                                               sampling_params=BATCH_SAMPLING))
    proc(data.from_items([{"prompt": "warm up " * 12}])).take_all()  # builds the engine
    eng = batch._get_engine(cfg)
    try:
        stats0 = eng.get_stats()
        rmsnorm.launches = 0  # counts from here on are the path's
        t0 = time.perf_counter()
        out_ds = proc(data.from_items([{"prompt": p, "row": i} for i, p in enumerate(prompts)],
                                      parallelism=2)).materialize()
        wall = time.perf_counter() - t0
        launches = rmsnorm.launches
        delta = _step_delta(stats0, eng.get_stats())
        blocks = out_ds.get_internal_block_refs()
        rows = out_ds.take_all()
        texts = [str(r["generated_text"]) for r in rows]
        want = [eng.generate(p, sampling_params=SamplingParams(**BATCH_SAMPLING))
                for p in prompts]
    finally:
        eng.shutdown()
        batch._ENGINE_CACHE.clear()
    n_norms = 2 * L_3B + 1
    expected = (n_norms * (delta["decode_steps"] + delta["prefill_final_chunks"])
                + (n_norms - 1) * delta["prefill_mid_chunks"])
    equal = sum(t == w.text for t, w in zip(texts, want))
    in_order = [int(r["row"]) for r in rows] == list(range(len(prompts)))
    out = {
        "phase": "batch", "card": card, "model": "llama3.2-3b", "rows": len(prompts),
        "blocks": len(blocks), "block_rows": [len(b["prompt"]) for b in blocks],
        "max_tokens": 32, "wall_s": wall, "rows_per_s": len(prompts) / wall,
        "out_tok_per_s": sum(len(w.token_ids) for w in want) / wall,
        "texts_equal_engine": equal, "in_order": in_order, "rmsnorm_launches": launches,
        "rmsnorm_launches_expected": expected, **delta,
    }
    emit(out)
    del eng
    gc_collect(torch)
    if equal != len(prompts) or len(texts) != len(prompts) or not in_order:
        raise AssertionError(f"batch: {len(prompts) - equal} rows differ from the engine's text, "
                             f"or rows out of order")
    if delta["decode_graph_replays"] != delta["decode_steps"] or launches != expected:
        raise AssertionError(f"batch: rmsnorm launches {launches} != {expected}, or a decode step "
                             f"was no graph replay ({delta})")
    return {**out, "texts": texts}


def phase_gang_lora(torch, card: str, serve: dict, lora: dict) -> dict:
    """Multi-LoRA on a gang (llm/gang.py): the gang_serve phase's one-rank
    gang (a spawned process holding the card in a one-rank NCCL world,
    decode_steps 4, run-ahead 2) with max_loras=2, lora_rank=8, served as
    LLMServer(engine=gang.engine), at llama3.2-3b full width and depth
    (seeded bf16 weights, fused RMSNorm). Prefill buckets (128, ..., 1024):
    the gang prefills in chunks of its smallest bucket, so a ~100-token
    prompt is one chunk padded to 128, as the lora_serve engine pads it.

    load_lora with the lora_serve phase's two adapters; the rank's counters
    set to 0; the lora_serve phase's mixed batch of 16 (adapters none, a, b
    in turn, 32 tokens) at once: each request's tokens equal lora_serve's,
    every decode step a graph replay, RMSNorm launches counted in the rank
    equal to (2L+1) per decode step and final chunk, 2L per mid chunk. A
    seeded sampled adapter request whose rank is killed after its first
    token: the gang is rebuilt with its adapters and the replay equals an
    uninterrupted run; an adapter request after the rebuild equals
    lora_serve's again. After unload_lora of both, base requests equal the
    serve phase's tokens (first 32)."""
    from ray_tpu_torch.llm import SamplingParams
    from ray_tpu_torch.llm.gang import GangLLMServer
    from ray_tpu_torch.llm.server import LLMServer

    cfg = _serve_config({}, max_loras=2, lora_rank=8)
    cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, prefill_buckets=(128, 256, 512, 1024), decode_steps=4, decode_runahead=2))

    def wait(r):
        if not r.done.wait(600) or r.error is not None:
            raise AssertionError(f"gang_lora: a request failed: {r.error!r}")

    t0 = time.perf_counter()
    gang = GangLLMServer(cfg)
    startup_s = time.perf_counter() - t0
    try:
        server = LLMServer(cfg, engine=gang.engine)
        for name, weights in lora["adapter_weights"].items():
            server.load_lora(name, weights)
        if server.list_loras() != ["a", "b"]:
            raise AssertionError(f"gang_lora: loaded {server.list_loras()}")
        sp = SamplingParams(max_tokens=32, temperature=0.0, ignore_eos=True)
        wait(gang.engine.submit("warm up " * 12, sampling_params=sp, lora="a"))
        gang.rank_counts(reset=True)  # counts from here on are the path's
        t0 = time.perf_counter()
        reqs = [gang.engine.submit(b["prompt"], sampling_params=sp, lora=b.get("_lora"))
                for b in lora["bodies"]]
        for r in reqs:
            wait(r)
        wall = time.perf_counter() - t0
        (counts,) = gang.rank_counts()
        mixed = [r.out_tokens for r in reqs]
        launches = counts["launches"]["rmsnorm"]
        prog = counts["programs"]

        hot = SamplingParams(max_tokens=64, temperature=0.8, top_k=50, seed=7, ignore_eos=True)
        req = gang.engine.submit("Sample this after a rank dies.", sampling_params=hot, lora="b")
        req.stream_queue.get(timeout=600)
        gang.workers[0].kill()
        wait(req)
        again = gang.engine.submit("Sample this after a rank dies.", sampling_params=hot,
                                   lora="b")
        wait(again)
        rebuilds = gang.stats()["rebuilds"]
        after = gang.engine.submit(lora["bodies"][1]["prompt"], sampling_params=sp, lora="a")
        wait(after)
        for name in ("a", "b"):
            server.unload_lora(name)
        base = [gang.engine.submit(p, sampling_params=sp) for p in _serve_prompts()]
        for r in base:
            wait(r)
    finally:
        gang.shutdown()
    n_norms = 2 * L_3B + 1
    expected = (n_norms * (prog["decode_steps"] + prog["prefill_final_chunks"])
                + (n_norms - 1) * prog["prefill_mid_chunks"])
    base_equal = sum(r.out_tokens == serve["tokens_by_prompt"][tuple(r.prompt_ids)][:32]
                     for r in base)
    out = {
        "phase": "gang_lora", "card": card, "model": "llama3.2-3b", "ranks": gang.num_workers,
        "max_loras": 2, "lora_rank": 8, "gang_startup_s": startup_s,
        "adapters": [b.get("_lora") for b in lora["bodies"]],
        "wall_s_16x32": wall, "out_tok_per_s": 16 * 32 / wall,
        "lora_serve_out_tok_per_s": lora["out_tok_per_s"],
        "mixed_equal_lora_serve": sum(g == w for g, w in zip(mixed, lora["mixed"])),
        "rmsnorm_launches": launches, "rmsnorm_launches_expected": expected,
        **{k: prog[k] for k in ("decode_programs", "decode_steps", "decode_graph_replays",
                                "prefill_mid_chunks", "prefill_final_chunks")},
        "kill": {"rebuilds": rebuilds, "replay_equal": req.out_tokens == again.out_tokens,
                 "tokens": len(req.out_tokens),
                 "adapter_after_rebuild_equal_lora_serve": after.out_tokens == lora["mixed"][1]},
        "base_after_unload_equal_serve": base_equal,
    }
    emit(out)
    gc_collect(torch)
    if out["mixed_equal_lora_serve"] != 16:
        raise AssertionError(f"gang_lora: {16 - out['mixed_equal_lora_serve']} requests differ "
                             "from lora_serve's tokens")
    if launches != expected or prog["decode_graph_replays"] != prog["decode_steps"]:
        raise AssertionError(f"gang_lora: rmsnorm launches {launches} != {expected}, or a decode "
                             f"step was no graph replay ({prog})")
    kill = out["kill"]
    if (rebuilds != 1 or not kill["replay_equal"] or kill["tokens"] != 64
            or not kill["adapter_after_rebuild_equal_lora_serve"]):
        raise AssertionError(f"gang_lora: the rebuild with adapters: {kill}")
    if base_equal != 16:
        raise AssertionError(f"gang_lora: {16 - base_equal} base requests after unload_lora "
                             "differ from the serve phase's tokens")
    return out


def phase_graft_entry(torch, card: str) -> dict:
    """ray_tpu_torch.graft_entry.entry() on the card: its bf16 forward, and
    the same weights in fp32, against an fp64 reference on the CPU. The
    entry's weights are ill-conditioned (init_params draws wq/wk with
    fan_in = the head count: attention scores of std ~64, a nearly one-hot
    softmax), so bf16 alone is far from the reference: on the CPU the
    port's bf16 reads 0.53 and the JAX entry's 0.56 relative RMS, fp32
    8.2e-4. Limits, fixed from those CPU readings before the first card
    run: fp32 1e-2, bf16 0.75; a broken control (layer 0's wo rolled by
    one along d_model: 1.42 on the CPU) must exceed both."""
    from ray_tpu_torch.graft_entry import entry, entry_config
    from ray_tpu_torch.models.llama import forward

    fn, (params, tokens) = entry()
    cfg = entry_config()

    def run(p, device, dtype):
        c = dataclasses.replace(cfg, dtype=dtype)
        with torch.inference_mode():
            out = forward({k: v.to(device=device, dtype=dtype) for k, v in p.items()}, tokens.to(device), c)
        if not torch.isfinite(out).all() or out.shape != (2, 128, cfg.vocab_size):
            raise AssertionError(f"graft_entry on {device} in {dtype}: wrong shape or not finite")
        return out.double().cpu()

    def rel_rms(a, b):
        return ((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt()).item()

    with torch.inference_mode():
        card16 = fn(params, tokens).double().cpu()
    ref = run(params, "cpu", torch.float64)
    broken = dict(params)
    broken["wo"] = params["wo"].clone()
    broken["wo"][0] = torch.roll(params["wo"][0], 1, dims=-1)
    out = {
        "phase": "graft_entry", "card": card, "config": "4 layers, d 512, 8/4 heads, d_ff 1408, "
        "vocab 4096, bf16, 2 x 128 tokens", "logits": list(card16.shape),
        "bf16_rel_rms_err": rel_rms(card16, ref), "bf16_limit": 0.75,
        "cpu_bf16_rel_rms_err": rel_rms(run(params, "cpu", torch.bfloat16), ref),
        "fp32_rel_rms_err": rel_rms(run(params, "cuda", torch.float32), ref), "fp32_limit": 1e-2,
        "bf16_top1_agreement": (card16.argmax(-1) == ref.argmax(-1)).double().mean().item(),
        "control_fp32_rel_rms_err": rel_rms(run(broken, "cuda", torch.float32), ref),
        "control_bf16_rel_rms_err": rel_rms(run(broken, "cuda", torch.bfloat16), ref),
    }
    emit(out)
    if out["fp32_rel_rms_err"] > out["fp32_limit"] or out["bf16_rel_rms_err"] > out["bf16_limit"]:
        raise AssertionError(f"graft_entry: outside the limits: {out}")
    if out["control_fp32_rel_rms_err"] <= out["fp32_limit"] or out["control_bf16_rel_rms_err"] <= out["bf16_limit"]:
        raise AssertionError("graft_entry: the broken control passed a limit")
    return out


TRAIN_SERVE_WIDTHS = dict(vocab_size=32000, d_model=2048, n_layers=16, n_heads=16, n_kv_heads=16,
                          d_ff=8192)


def _swapped_copy(src: str, dst: str, a: str, b: str) -> None:
    """A copy of the checkpoint at ``src`` whose leaves ``a`` and ``b``
    trade names: the same data file (hard-linked), the manifest's keys
    swapped."""
    import os
    import shutil

    from ray_tpu_torch.train.checkpoint import _PYTREE_DATA, _PYTREE_MANIFEST, read_manifest

    os.makedirs(dst)
    try:
        os.link(os.path.join(src, _PYTREE_DATA), os.path.join(dst, _PYTREE_DATA))
    except OSError:
        shutil.copyfile(os.path.join(src, _PYTREE_DATA), os.path.join(dst, _PYTREE_DATA))
    manifest = read_manifest(src)
    manifest["keys"] = [{a: b, b: a}.get(k, k) for k in manifest["keys"]]
    with open(os.path.join(dst, _PYTREE_MANIFEST), "w") as f:
        json.dump(manifest, f)


def _ring_blocks(torch, q, k, v, do, P: int, wrong_offset: bool = False):
    """Ring attention's per-block steps for each of P simulated ranks on one
    card, the functions ``ring_attention`` runs between its transfers:
    (o, lse, dq, dk, dv) of the whole sequence. ``wrong_offset``: the last
    rank's own block is read as an earlier rank's (no causal mask)."""
    from ray_tpu_torch.parallel.ring_attention import (
        block_backward, block_forward, merge_blocks, ring_steps)

    t = q.shape[1] // P
    scale = q.shape[-1] ** -0.5

    def sl(x, i):
        return x[:, i * t:(i + 1) * t]

    def steps(i):
        for src, mode in ring_steps(i, P, True):
            if mode is not None:
                yield src, (False if wrong_offset and i == P - 1 and src == i else mode)

    outs, lses = [], []
    for i in range(P):
        o_acc = lse = None
        for src, mode in steps(i):
            o_acc, lse = merge_blocks(o_acc, lse, *block_forward(
                sl(q, i), sl(k, src), sl(v, src), mode, scale))
        outs.append(o_acc.to(q.dtype))
        lses.append(lse)
    dq = [torch.zeros(sl(q, 0).shape, dtype=torch.float32, device=q.device) for _ in range(P)]
    dk = [torch.zeros(sl(k, 0).shape, dtype=torch.float32, device=q.device) for _ in range(P)]
    dv = [torch.zeros_like(x) for x in dk]
    for i in range(P):
        for src, mode in steps(i):
            a, b, c = block_backward(sl(q, i), sl(k, src), sl(v, src), outs[i], lses[i],
                                     sl(do, i), mode, scale)
            dq[i] += a
            dk[src] += b
            dv[src] += c
    return (torch.cat(outs, 1), torch.cat(lses, -1), torch.cat(dq, 1).to(q.dtype),
            torch.cat(dk, 1).to(k.dtype), torch.cat(dv, 1).to(v.dtype))


def phase_parallel(torch, card: str) -> dict:
    """(a) The ring's per-block arithmetic at the bench attention shape, in
    one process, against one whole-sequence call of the kernels (the
    attention limits of ops/flash_attention.py, unchanged), with a control
    at the wrong global offset; (b) the JAX sweep's meshes on one NCCL rank
    a card at the bench widths, each held to the unsharded step within the
    train numerics phase's loss limit (1e-3 relative), loss and grad norm,
    with a control whose backward counts one leaf's gradient twice and
    must fail the grad norm's limit."""
    from ray_tpu_torch.graft_entry import dryrun_multichip
    from ray_tpu_torch.models.training import H100_BF16_DENSE_FLOPS
    from ray_tpu_torch.ops.flash_attention import (
        MAX_ABS_LIMIT, REL_RMS_LIMIT, agreement, flash_attention, flash_attention_bwd_kernel,
        flash_attention_fwd_kernel, reset_launches)
    from ray_tpu_torch.tools.decode_profile import graph_us

    limit = 1e-3  # the train numerics phase's loss limit
    B, T, H, D, P = 4, 2048, 16, 128, 4
    gen = torch.Generator(device="cuda").manual_seed(16)
    q, k, v, do = (torch.randn((B, T, H, D), generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    reset_launches()
    ring = _ring_blocks(torch, q, k, v, do, P)
    torch.cuda.synchronize()
    f = flash_attention
    launches = {"fwd": f.launches_fwd, "bwd_dq": f.launches_bwd_dq,
                "bwd_dkdv": f.launches_bwd_dkdv}
    blocks = P * (P + 1) // 2
    o, lse = flash_attention_fwd_kernel(q, k, v)
    whole = (o, lse) + flash_attention_bwd_kernel(q, k, v, o, lse, do)
    names = ("o", "lse", "dq", "dk", "dv")
    checks = {n: agreement(a, b) for n, a, b in zip(names, ring, whole)}
    control = {n: agreement(a, b) for n, a, b in
               zip(names, _ring_blocks(torch, q, k, v, do, P, wrong_offset=True), whole)}
    ring_us = graph_us(lambda: _ring_blocks(torch, q, k, v, do, P), 2, 5)

    def whole_call():
        o, lse = flash_attention_fwd_kernel(q, k, v)
        flash_attention_bwd_kernel(q, k, v, o, lse, do)

    whole_us = graph_us(whole_call, 2, 5)
    npairs = T * (T + 1) // 2
    ring_out = {
        "shape_bthd": [B, T, H, D], "sp": P, "launches": launches,
        "launches_expected": {key: blocks for key in launches},
        **{f"{n}_{m}": c[m] for n, c in checks.items() for m in ("max_abs_err", "rel_rms_err")},
        "control_rel_rms_err": {n: c["rel_rms_err"] for n, c in control.items()},
        "limits": {"rel_rms_err": REL_RMS_LIMIT, "max_abs_err_of_max_ref": MAX_ABS_LIMIT},
        "blocks_fwd_bwd_us": ring_us, "whole_fwd_bwd_us": whole_us,
        "blocks_over_whole": ring_us / whole_us,
        "fwd_bwd_bound_us": 14 * B * H * D * npairs / H100_BF16_DENSE_FLOPS * 1e6,
    }
    del q, k, v, do, o, lse, whole, ring
    torch.cuda.empty_cache()

    n = torch.cuda.device_count()
    recs = dryrun_multichip(n, widths="bench", init="conditioned", timed_steps=3, reference=True,
                            control_leaf="unembed", timeout_s=600)
    meshes = []
    for r in recs:
        row = {k: r[k] for k in ("label", "loss", "grad_norm", "ref_loss", "ref_grad_norm",
                                 "first_step_ms", "step_ms", "tokens", "launches",
                                 "unsharded_function")}
        row["mesh"] = {a: s for a, s in r["mesh"].items() if s > 1}
        row["loss_rel_err"] = abs(r["loss"] - r["ref_loss"]) / abs(r["ref_loss"])
        row["grad_norm_rel_err"] = abs(r["grad_norm"] - r["ref_grad_norm"]) / r["ref_grad_norm"]
        row["tokens_per_s"] = r["tokens"] / r["step_ms"] * 1e3
        if "control" in r:
            c = r["control"]
            row["control"] = {
                **c, "loss_rel_err": abs(c["loss"] - r["ref_loss"]) / abs(r["ref_loss"]),
                "grad_norm_rel_err": abs(c["grad_norm"] - r["ref_grad_norm"]) / r["ref_grad_norm"]}
        meshes.append(row)
    parallel_launches = {key: sum(m["launches"][key] for m in meshes) for key in launches}
    out = {"phase": "parallel", "card": card, "ring": ring_out, "ranks": n, "limit": limit,
           "widths": "bench.py train config (16 layers; pp and MoE meshes 4 layers, 4 experts)",
           "meshes": meshes, "launches": parallel_launches}
    emit(out)
    bad = [n for n, c in checks.items() if not c["ok"]]
    if bad:
        raise AssertionError(f"parallel: ring blocks outside the attention limits: {bad}")
    if all(c["ok"] for c in control.values()):
        raise AssertionError("parallel: the wrong-offset control passed the attention limits")
    if launches != ring_out["launches_expected"]:
        raise AssertionError(f"parallel: ring launches {launches} != {blocks} each")
    # the control: the first mesh's step with unembed's gradient counted
    # twice has the true loss, and only the grad norm can catch it
    control = meshes[0]["control"]
    if control["loss_rel_err"] > limit:
        raise AssertionError(f"parallel: the control's forward changed: {control}")
    if control["grad_norm_rel_err"] <= limit:
        raise AssertionError(f"parallel: the doubled-gradient control passed the limit: {control}")
    for m in meshes:
        # on one card every mesh computes the unsharded function; on more,
        # MoE under ep or pp routes per shard, as the JAX package does
        held = n == 1 or m["unsharded_function"]
        if held and (m["loss_rel_err"] > limit or m["grad_norm_rel_err"] > limit):
            raise AssertionError(f"parallel: {m['label']} outside the limit: {m}")
        if n == 1:
            L = 4 if m["label"].startswith("pp2") or "moe" in m["label"] else 16
            if m["launches"] != {"fwd": 2 * L, "bwd_dq": L, "bwd_dkdv": L}:
                raise AssertionError(f"parallel: {m['label']} launches {m['launches']} (L {L})")
    return out


def phase_rllib(torch, card: str) -> dict:
    """RLlib on the card: PPO's training loop (CartPole-v1 and
    MiniBreakout-v0) through ``Algorithm.train``, and every algorithm's
    update on the card against the same update on the CPU, with a broken
    control; the kernel counters set to 0 before and read after (the RL
    path runs no kernel of ops/csrc)."""
    from ray_tpu_torch.ops import add_launch_counts, launch_counts
    from ray_tpu_torch.tools import rllib_bench as rb

    add_launch_counts({k: -v for k, v in launch_counts().items()})
    cartpole = rb.ppo_train("CartPole-v1", None, 25)
    breakout = rb.ppo_train("MiniBreakout-v0", None, 5)
    updates = {}
    for name in rb.ALGOS:
        run, cpu, ctrl = (rb.update_runs(name, None), rb.update_runs(name, "cpu"),
                          rb.update_runs(name, None, control=True))
        updates[name] = {**rb.agreement(run, cpu), "update_ms": run["update_ms"],
                         "cpu_update_ms": cpu["update_ms"],
                         "control": rb.agreement(ctrl, cpu)}
    profile = rb.profile_update()
    launches = launch_counts()
    out = {"phase": "rllib", "card": card, "ppo_cartpole": cartpole, "ppo_breakout": breakout,
           "updates": updates,
           "limits": {"loss_rtol": rb.LOSS_RTOL, "loss_atol": rb.LOSS_ATOL,
                      "param_atol": rb.PARAM_ATOL},
           "profile_ppo_update": profile, "launches": launches}
    emit(out)
    first, last = cartpole["return_first"], cartpole["return_last"]
    if first is None or last is None or not last > first + 20:
        raise AssertionError(f"rllib: PPO CartPole did not improve by > 20: {first} -> {last}")
    for run in (cartpole, breakout):
        if not all(math.isfinite(x) for x in run["losses"]):
            raise AssertionError(f"rllib: non-finite loss on {run['env']}: {run['losses']}")
        if run["learner_tensors_on"] != ["cuda"]:
            raise AssertionError(f"rllib: learner tensors on {run['learner_tensors_on']}")
    bad = [n for n, u in updates.items() if not u["ok"]]
    if bad:
        raise AssertionError(f"rllib: card updates outside the CPU limits: {bad}")
    passed = [n for n, u in updates.items() if u["control"]["ok"]]
    if passed:
        raise AssertionError(f"rllib: the shifted-actions control passed the limits: {passed}")
    if any(launches.values()):
        raise AssertionError(f"rllib: kernel launches on the RL path: {launches}")
    return out


# IMPALA/APPO's share of an iteration spent waiting for a fragment: with
# sampling in series with the update it would be 0.46-0.67 (a 200-step
# fragment takes a runner 4.6-7.2 ms, the update 3.5-5.5 ms on an H100)
WAIT_SHARE_LIMIT = 0.4


def phase_rllib_remote(torch, card: str) -> dict:
    """RLlib's remote half on the card: IMPALA and APPO's asynchronous
    pipeline (runner processes on the CPU, the V-trace update on the card
    in this process), a runner process killed and replaced, a learner
    process on the card held against a local learner with a control, and
    SAC over runner processes through save and restore; the kernel
    counters set to 0 before and read after, and no process of the phase
    left after each ``stop``."""
    from ray_tpu_torch.ops import add_launch_counts, launch_counts
    from ray_tpu_torch.tools import rllib_bench as rb

    add_launch_counts({k: -v for k, v in launch_counts().items()})
    parts = rb.remote_parts(None, 25)
    # this process's counts, and the learner process's (it started at 0)
    learner = parts["remote_learner"]["process_launches"]
    launches = {k: v + learner[k] for k, v in launch_counts().items()}
    out = {"phase": "rllib_remote", "card": card, **parts, "launches": launches,
           "wait_share_limit": WAIT_SHARE_LIMIT}
    emit(out)
    for name, gain in (("impala", 20), ("appo", 25)):
        run = parts[name]
        # the result key only: every _next_batch refills the pipeline
        if any(n != 2 for n in run["in_flight"]):
            raise AssertionError(f"rllib_remote: {name} samples in flight {run['in_flight']}")
        # the overlap: waiting for fragments takes under half of an iteration
        if not run["wait_share"] < WAIT_SHARE_LIMIT:
            raise AssertionError(f"rllib_remote: {name} waits {run['wait_share']:.3f} of an "
                                 f"iteration for fragments (limit {WAIT_SHARE_LIMIT})")
        first, last = run["return_first"], run["return_last"]
        if first is None or last is None or not last > first + gain:
            raise AssertionError(f"rllib_remote: {name} did not improve by > {gain}: "
                                 f"{first} -> {last}")
        if not all(math.isfinite(x) for x in run["losses"]):
            raise AssertionError(f"rllib_remote: non-finite {name} loss: {run['losses']}")
        if run["update_tensors_on"] != ["cuda"]:
            raise AssertionError(f"rllib_remote: {name} update on {run['update_tensors_on']}")
    rep = parts["replacement"]
    if not (rep["healthy"][1] >= 1 and rep["healthy"][2] == 2 and rep["new_pid"] != rep["old_pid"]):
        raise AssertionError(f"rllib_remote: the killed runner was not replaced: {rep}")
    rl = parts["remote_learner"]
    if not rl["ok"] or rl["remote_tensors_on"] != ["cuda"]:
        raise AssertionError(f"rllib_remote: the learner process disagrees: {rl}")
    if rl["control_ok"]:
        raise AssertionError(f"rllib_remote: the shifted-actions control passed: {rl}")
    sac = parts["sac"]
    if sac["replay_size"] < 700 or not sac["log_alpha_equal"]:
        raise AssertionError(f"rllib_remote: SAC over runner processes: {sac}")
    left = {name: p["children_left"] for name, p in parts.items() if p["children_left"]}
    if left:
        raise AssertionError(f"rllib_remote: processes left after stop: {left}")
    if any(launches.values()):
        raise AssertionError(f"rllib_remote: kernel launches on the RL path: {launches}")
    return out


def phase_train_serve(torch, card: str, train: dict) -> dict:
    """Train -> checkpoint -> serve at the bench width, through the entry
    points a user calls.

    TorchTrainer runs ray_tpu_torch.examples.train_llama_dp.train_loop on
    one rank (a spawned process, one card, an NCCL process group; the batch
    seed goes through broadcast_from_rank_zero) on bench.py's train config
    (1.20 B params, batch 4 x 2048, remat, the attention kernels). Attempt
    0 runs 2 steps, reports the whole train state (params, AdamW moments,
    step) as a checkpoint, runs step 3 and raises on purpose. Attempt 1
    (FailureConfig(max_failures=1)) resumes from the step-2 checkpoint,
    re-runs step 3 (its loss must equal attempt 0's), runs step 4 and
    reports the params as the final checkpoint, with their bit checksums
    and the prefill logits of a probe prompt. Every step launches the
    attention kernels 2L / L / L times; no rank outlives fit().

    LLMServer then serves the final checkpoint (ModelConfig.checkpoint_path,
    the bench widths, fused RMSNorm, 16 slots): the restored weights'
    checksums equal the rank's; the probe's prefill logits lie within the
    numerics phase's bf16 limit (5e-2 relative RMS) of the rank's; 16
    concurrent greedy requests x 32 tokens complete, every decode step a
    graph replay, RMSNorm launches as counted. Broken control: a copy of
    the checkpoint with the wq and wk leaves swapped (equal shapes at
    16/16 heads) restores and must fail the logits limit; that restore's
    peak device memory is one copy of the params."""
    import multiprocessing
    import shutil
    import tempfile

    import numpy as np

    from ray_tpu_torch.examples import train_llama_dp as ex
    from ray_tpu_torch.llm import EngineConfig, LLMConfig, LLMServer, ModelConfig
    from ray_tpu_torch.llm.tokenizer import ByteTokenizer
    from ray_tpu_torch.models.llama import param_template
    from ray_tpu_torch.ops import rmsnorm
    from ray_tpu_torch.train import (CheckpointConfig, FailureConfig, RunConfig, ScalingConfig,
                                     TorchTrainer, restore_state_dict)

    limit = 5e-2  # the numerics phase's bf16 limit
    L = TRAIN_SERVE_WIDTHS["n_layers"]
    serve_kwargs = {**TRAIN_SERVE_WIDTHS, "fused_rmsnorm": True}
    probe = {"tokens": ByteTokenizer().encode("The port trains, checkpoints and serves one model."),
             "model_kwargs": serve_kwargs, "max_seq_len": 256}
    config = {"model": "bench", "steps": 4, "batch": 4, "seq_len": 2048, "seed": 0,
              "state_checkpoint_at": 2, "fail_once_after": 3, "probe": probe}
    gc_collect(torch)  # the parent holds no model while the rank runs
    storage = tempfile.mkdtemp(prefix="train-serve-")
    try:
        trainer = TorchTrainer(
            ex.train_loop, train_loop_config=config,
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            run_config=RunConfig(name="train_serve", storage_path=storage,
                                 failure_config=FailureConfig(max_failures=1),
                                 checkpoint_config=CheckpointConfig(num_to_keep=1)),
        )
        t0 = time.perf_counter()
        result = trainer.fit()
        fit_s = time.perf_counter() - t0
        left = [p.name for p in multiprocessing.active_children() if "-rank-" in p.name]
        if result.error is not None or left:
            raise AssertionError(f"train_serve: fit failed ({result.error}) or left {left}")
        h = result.metrics_history
        if [m["step"] for m in h] != [1, 2, 3, 3, 4]:
            raise AssertionError(f"train_serve: steps reported {[m['step'] for m in h]}")
        a0, a1 = h[2], h[3]  # step 3 in attempts 0 and 1
        if a1.get("resumed_from_step") != 2 or not a1["resumed_from"].endswith(
                "attempt_000/checkpoint_000001"):
            raise AssertionError(f"train_serve: attempt 1 did not resume from step 2: {a1}")
        expected = {"flash_attention_fwd": 2 * L, "flash_attention_bwd_dq": L,
                    "flash_attention_bwd_dkdv": L}
        bad = [m["launches"] for m in h
               if any(m["launches"][k] != n for k, n in expected.items())]
        if bad or not all(math.isfinite(m["loss"]) for m in h):
            raise AssertionError(f"train_serve: attention launches {bad} or a loss not finite")
        if {m["backend"] for m in h} != {"nccl"}:
            raise AssertionError(f"train_serve: the rank's process group is not NCCL: {h[0]}")
        loss_diff = abs(a1["loss"] - a0["loss"])
        if loss_diff > 1e-6 * abs(a0["loss"]):
            raise AssertionError(f"train_serve: resumed step-3 loss {a1['loss']} != {a0['loss']}")
        final = h[-1]
        ckpt = result.checkpoint.path

        # serving the checkpoint
        rank_logits = final["probe_logits"]
        cfg = LLMConfig(
            model=ModelConfig(model_id="tiny", tokenizer="byte", seed=0, model_kwargs=serve_kwargs,
                              checkpoint_path=ckpt),
            engine=EngineConfig(max_num_seqs=16, max_seq_len=256, prefill_buckets=(32, 64, 128, 256),
                                prefill_chunk=256, decode_steps=8, decode_runahead=1),
        )
        t0 = time.perf_counter()
        server = LLMServer(cfg)
        engine_init_s = time.perf_counter() - t0
        eng = server.engine
        try:
            if eng.model_cfg != ex.serve_config(probe):
                raise AssertionError(f"train_serve: served config {eng.model_cfg}")
            served_checksums = ex.bit_checksums(eng.params)
            served_logits = ex.probe_logits(eng.params, eng.model_cfg, probe["tokens"])
            server.completions({"prompt": "warm up " * 12, "max_tokens": 16, "ignore_eos": True})
            stats0 = eng.get_stats()
            rmsnorm.launches = 0  # counts from here on are the path's
            bodies = [{"prompt": p, "max_tokens": 32, "temperature": 0.0, "ignore_eos": True}
                      for p in _serve_prompts()]
            outs, wall = _concurrent(server, bodies)
            launches = rmsnorm.launches
            delta = _step_delta(stats0, eng.get_stats())
        finally:
            eng.shutdown()
        del server, eng
        gc_collect(torch)
        n_norms = 2 * L + 1
        norms_expected = (n_norms * (delta["decode_steps"] + delta["prefill_final_chunks"])
                          + (n_norms - 1) * delta["prefill_mid_chunks"])

        # the broken control: wq and wk swapped, restored onto the card
        ctl_dir = ckpt + "_swapped"
        _swapped_copy(ckpt, ctl_dir, "wq", "wk")
        mcfg = ex.serve_config(probe)
        # bytes the restore asked the allocator for (its blocks may round up
        # by as much as 1 MiB each: a large block is not split for less)
        torch.cuda.synchronize()
        base = torch.cuda.memory_stats()["requested_bytes.all.current"]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        swapped = restore_state_dict(ctl_dir, like=param_template(mcfg), device="cuda")
        torch.cuda.synchronize()
        ctl_read_s = time.perf_counter() - t0
        restore_peak = torch.cuda.memory_stats()["requested_bytes.all.peak"] - base
        param_bytes = sum(t.numel() * t.element_size() for t in swapped.values())
        ctl_logits = ex.probe_logits(swapped, mcfg, probe["tokens"])
        del swapped
        gc_collect(torch)
    finally:
        shutil.rmtree(storage, ignore_errors=True)

    def rel_rms(a, b):
        return float(np.sqrt(np.mean((a - b) ** 2) / np.mean(b ** 2)))

    steps_ms = [m["step_ms"] for m in h]
    gb = 1e9
    ttft = np.asarray([o.metrics["ttft_s"] for o in outs]) * 1e3
    out = {
        "phase": "train_serve", "card": card, "model": "bench.py train config",
        "params": ex.model_config(config).num_params(), "fit_s": fit_s,
        "rank_startup_s": trainer._controller.rank_startup_s,
        "losses": [m["loss"] for m in h], "steps": [m["step"] for m in h],
        "step_ms": steps_ms,
        # steps 2 and 4: neither the first step of a process nor a resumed one
        "steady_step_ms": [h[1]["step_ms"], h[4]["step_ms"]],
        "train_phase_step_ms": train["step_ms"],
        "resumed_from": a1["resumed_from"], "step3_loss_attempt0": a0["loss"],
        "step3_loss_attempt1": a1["loss"], "step3_loss_diff": loss_diff,
        "step3_bit_equal": a1["loss"] == a0["loss"],
        "launches": {k: sum(m["launches"][k] for m in h) for k in expected},
        "launches_per_step": expected,
        "state_checkpoint_gb": h[1]["checkpoint_bytes"] / gb,
        "state_checkpoint_write_s": h[1]["checkpoint_write_s"],
        "state_checkpoint_write_gb_per_s": h[1]["checkpoint_bytes"] / gb / h[1]["checkpoint_write_s"],
        "state_checkpoint_read_s": a1["checkpoint_read_s"],
        "state_checkpoint_read_gb_per_s": a1["checkpoint_bytes"] / gb / a1["checkpoint_read_s"],
        "params_checkpoint_gb": final["checkpoint_bytes"] / gb,
        "params_checkpoint_write_s": final["checkpoint_write_s"],
        "params_checkpoint_write_gb_per_s": final["checkpoint_bytes"] / gb / final["checkpoint_write_s"],
        "params_checkpoint_read_to_card_s": ctl_read_s,
        "params_checkpoint_read_gb_per_s": param_bytes / gb / ctl_read_s,
        "engine_init_s": engine_init_s,
        "checksums_equal": served_checksums == final["checksums"],
        "logits_rel_rms_err": rel_rms(served_logits, rank_logits),
        "logits_max_abs_err": float(np.abs(served_logits - rank_logits).max()),
        "logits_bit_equal": bool(np.array_equal(served_logits, rank_logits)),
        "logits_limit": limit,
        "control_logits_rel_rms_err": rel_rms(ctl_logits, rank_logits),
        "restore_peak_bytes": restore_peak, "param_bytes": param_bytes,
        "requests": len(bodies), "wall_s_16x32": wall, "out_tok_per_s": 16 * 32 / wall,
        "ttft_ms_p50": float(np.percentile(ttft, 50)), "ttft_ms_p99": float(np.percentile(ttft, 99)),
        "decode_program_ms_mean": delta["decode_device_ms"] / delta["decode_programs_timed"],
        "rmsnorm_launches": launches, "rmsnorm_launches_expected": norms_expected, **delta,
    }
    emit(out)
    if not out["checksums_equal"]:
        raise AssertionError("train_serve: the served weights' checksums differ from the rank's")
    if out["logits_rel_rms_err"] > limit:
        raise AssertionError(f"train_serve: served logits {out['logits_rel_rms_err']} > {limit}")
    if out["control_logits_rel_rms_err"] <= limit:
        raise AssertionError("train_serve: the swapped-leaf control passed the logits limit")
    if delta["decode_graph_replays"] != delta["decode_steps"]:
        raise AssertionError(f"train_serve: decode steps that were no graph replay: {delta}")
    if launches != norms_expected:
        raise AssertionError(f"train_serve: rmsnorm launches {launches} != {norms_expected}")
    # one copy of the params on the card, no more
    if restore_peak != param_bytes:
        raise AssertionError(f"train_serve: restore peak {restore_peak} B for {param_bytes} B")
    return out


ELASTIC_DEPTH = 4  # layers of the elastic phase's capped start (widths full)


def phase_elastic(torch, card: str) -> dict:
    """Elastic training and the host's card ledger on one card, through the
    entry points a user calls (ray_tpu_torch.tools.elastic_bench, which the
    four-card run shares):

    (a) TorchTrainer(train_loop, ScalingConfig(num_workers=2,
    min_workers=1, use_gpu=True)) at the bench widths (bench.py:31-47,
    depth cut to ELASTIC_DEPTH layers: 4 x 2048 tokens a step, a state
    checkpoint every 2 of 6 steps) starts at world size 1 from the ledger's
    one free card, polls resize_decision (never firing: no headroom),
    resizes never and charges no failure; the rank's attention launches
    are 2L / L / L a step, counted in the rank.
    (b) A process actor holding the card (a learner on cuda) makes a
    one-card TorchTrainer refuse to start, naming the holder's pid; after
    the holder's SIGKILL the same trainer starts and finishes; no lease is
    left.
    (c) Two learner processes at resources_per_learner={"GPU": 0.5} hold
    half the card each, each one's update bit-equal to a local learner's (a
    shifted-actions control must miss); a two-policy PPO at {"GPU": 1} a
    learner: the second policy's group raises, naming the first's learner
    (the control for the groups that shared card 0 unknowingly)."""
    from ray_tpu_torch.tools import elastic_bench as eb

    gc_collect(torch)  # the parent holds no model while the ranks run
    parts = {"capped_start": eb.capped_start("cuda", depth=ELASTIC_DEPTH, steps=6, every=2),
             "ledger_on_card": eb.ledger_on_card("cuda"),
             "shared_learners": eb.shared_learners("cuda")}
    for name, part in parts.items():
        emit({"phase": "elastic", "card": card, **part})
    failed = {name: p["failed_checks"] for name, p in parts.items() if not p["ok"]}
    if failed:
        raise AssertionError(f"elastic: {failed}")
    capped = parts["capped_start"]
    out = {"phase": "elastic", "card": card, "layers": capped["layers"],
           "launches": capped["launches"], "rank_startup_s": capped["rank_startup_s"],
           "resize_checks": capped["resize_checks"], "step_ms": capped["step_ms"],
           "state_checkpoint_write_s": capped["state_checkpoint_write_s"],
           "state_checkpoint_read_s": capped["state_checkpoint_read_s"],
           "holders_seen": parts["ledger_on_card"]["holders_seen"]
           + parts["shared_learners"]["holders_seen"]}
    emit(out)
    return out


def phase_tune(torch, card: str) -> dict:
    """Tune on the port's own processes, through Tuner.fit as a user calls
    it (ray_tpu_torch.tools.tune_bench) at the bench widths (bench.py:31-47),
    depth cut to ELASTIC_DEPTH layers, batch 4 x 2048:

    (a) four trials of the example train loop over a 4-point learning-rate
    grid, each with_resources({"GPU": 0.25}), under ASHA (max_t 6 steps,
    grace 2, reduction factor 2, loss, min): four trial leases held on the
    card at once, each trial's peak memory, the controller's results
    replayed through a fresh ASHA to the same decisions, the card's total
    tokens/s over step 2 with the four together.
    (b) TorchTrainer(train_loop, ScalingConfig(num_workers=1, use_gpu=True))
    as a trainable over a 2-point grid, max_concurrent_trials=1: the trial
    leases a CPU slot and its nested rank the card; each trial's losses
    within rel 1e-6 of a direct fit() at the same learning rate; the
    nested rank's steps give one trial's tokens/s alone on the card.
    (c) PPO.as_trainable at {"GPU": 0.5} a trial, 2 learning rates, 2
    iterations, the learner on the card.
    The attention launches of (a) and (b), counted in the trial processes
    and the nested ranks, are 2L / L / L a step."""
    from ray_tpu_torch.tools import tune_bench as tb

    if tb.DEPTH != ELASTIC_DEPTH:
        raise AssertionError(f"tune: tune_bench's depth {tb.DEPTH} != {ELASTIC_DEPTH}")
    gc_collect(torch)  # the parent holds no model while the trials run
    parts = {"asha_shared": tb.asha_shared("cuda"),
             "trainer_trainable": tb.trainer_trainable("cuda"),
             "ppo_trainable": tb.ppo_trainable("cuda")}
    for name, part in parts.items():
        emit({"phase": "tune", "card": card, **part})
    failed = {name: p["failed_checks"] for name, p in parts.items() if not p["ok"]}
    asha, trainer = parts["asha_shared"], parts["trainer_trainable"]
    launches = {k: asha["launches"][k] + trainer["launches"][k] for k in tb.ATTENTION}
    steps = asha["steps_total"] + trainer["steps_total"]
    L = ELASTIC_DEPTH
    want = dict(zip(tb.ATTENTION, (2 * L * steps, L * steps, L * steps)))
    if launches != want:
        failed["launches"] = f"{launches} != {want} ({steps} steps of {L} layers)"
    if failed:
        raise AssertionError(f"tune: {failed}")
    out = {"phase": "tune", "card": card,
           "layers": f"{L} of 16 (bench widths; depth cut as the elastic phase's)",
           "launches": launches, "steps": steps,
           "most_trial_leases_held": asha["most_trial_leases_held"],
           "peak_memory_gb": asha["peak_memory_gb"],
           "shared_tokens_per_s": asha["shared_tokens_per_s"],
           "alone_tokens_per_s": trainer["alone_tokens_per_s"],
           "asha_decisions_equal": asha["decisions"] == asha["replayed_decisions"],
           "trainer_max_rel_diff": trainer["max_rel_diff"],
           "trial_startup_s": asha["trial_startup_s"],
           "fit_s": {name: p["fit_s"] for name, p in parts.items()}}
    emit(out)
    return out


def phase_data(torch, card: str, batch: dict) -> dict:
    """Data on the port's own processes (ray_tpu_torch.tools.data_bench),
    through the entry points a user calls:

    (a) build_llm_processor(ProcessorConfig(..., batch_size=16,
    concurrency=2)) over data.from_items(the batch phase's 32 prompts,
    parallelism=2): llama3.2-3b at full width and depth (seeded bf16
    weights, the fused RMSNorm, the batch phase's engine), greedy, 32
    tokens, on two actor processes that each lease half of the card and
    build one engine. Limits: every row's text equal to the batch phase's
    text for that prompt, in input order (the same blocks of 16, so the
    decode GEMMs have the same M); in each actor every decode step a graph
    replay and the RMSNorm launches since its engine was built, counted in
    its own process, equal to what its engine's counters give; two
    half-card leases while the stage runs, none after. Reported: rows/s,
    output tok/s, each actor's start-up, engine build and peak memory.
    (b) TorchTrainer with one rank running the example loop at the bench
    widths cut to ELASTIC_DEPTH layers, datasets={"train": a port Dataset
    of 12 seeded token rows}, read through get_dataset_shard and
    iter_device_batches: each of its 3 steps' losses equal to the same
    steps run in this process on the same rows; attention launches 2L / L /
    L a step in the rank."""
    from ray_tpu_torch.tools import data_bench as db

    if db.DEPTH != ELASTIC_DEPTH:
        raise AssertionError(f"data: data_bench's depth {db.DEPTH} != {ELASTIC_DEPTH}")
    cfg = _serve_config({}, enable_prefix_caching=False)
    if db.card_llm_config() != cfg:
        raise AssertionError("data: data_bench's engine is not the batch phase's")
    gc_collect(torch)  # the parent holds no model while the actors run
    parts = {"batch_actors": db.batch_actors(cfg, _batch_prompts(), BATCH_SAMPLING,
                                             batch["texts"]),
             "train_ingest": db.train_ingest("cuda")}
    for name, part in parts.items():
        emit({"phase": "data", "card": card, **part})
    failed = {name: p["failed_checks"] for name, p in parts.items() if not p["ok"]}
    if failed:
        raise AssertionError(f"data: {failed}")
    actors, ingest = parts["batch_actors"], parts["train_ingest"]
    out = {"phase": "data", "card": card, "model": "llama3.2-3b",
           "rows_per_s": actors["rows_per_s"], "out_tok_per_s": actors["out_tok_per_s"],
           "rows_per_s_after_build": actors["rows_per_s_after_build"],
           "out_tok_per_s_after_build": actors["out_tok_per_s_after_build"],
           "actor_startup_s": [a["startup_s"] for a in actors["actors"]],
           "engine_build_s": [a["engine_build_s"] for a in actors["actors"]],
           "actor_peak_memory_gb": [a["peak_memory_gb"] for a in actors["actors"]],
           "texts_equal_batch_phase": actors["texts_equal"],
           "ingest_layers": ingest["layers"], "ingest_losses_equal": ingest["losses_equal"],
           "ingest_rank_startup_s": ingest["rank_startup_s"], "ingest_step_ms": ingest["step_ms"],
           "ingest_fit_s": ingest["fit_s"],
           "launches": {**actors["launches"], **ingest["launches"]}}
    emit(out)
    return out


def phase_serve_app(torch, card: str, serve: dict) -> dict:
    """Serve's runtime on the port's own processes
    (ray_tpu_torch.tools.serve_bench.serve_app), through the entry points a
    user calls: serve.run of an ingress deployment (a CPU process, leasing
    nothing) whose handle forwards each request's JSON body to an LLMServer
    deployment on the serve phase's config (llama3.2-3b at full width and
    depth, seeded bf16 weights, the fused RMSNorm, 16 slots x 1024), each of
    its replicas a process leasing {"GPU": 0.5} of the card, autoscaled
    between 1 and 2; an echo deployment on the CPU; start_proxy(port=0).
    Traffic: a warm-up; 20 echo round trips through the handle and 20 over
    HTTP; 16 concurrent greedy HTTP completions of 32 tokens (the upscale to
    2 replicas); calls through the llm handle until the second replica has
    served one (at least 4); 2 SSE streams; the downscale to 1; the
    remaining replica's process killed, its replacement ready, one more
    request. Limits: every text equal to the serve phase's greedy text for
    its prompt (its first 32 tokens; an SSE stream's chunks joined equal to
    the per-token texts); in each replica every decode step a graph replay
    and the RMSNorm launches, counted in its own process before the
    controller stops it, equal to what its engine's counters give; targets 1
    -> 2 -> 1; two leases of half of card 0 at the peak and none after
    serve.shutdown()."""
    from ray_tpu_torch.llm.tokenizer import get_tokenizer
    from ray_tpu_torch.tools import serve_bench as sb

    cfg = _serve_config({})
    if sb.card_llm_config() != cfg or sb.serve_prompts() != _serve_prompts():
        raise AssertionError("serve_app: serve_bench's engine or prompts are not the serve phase's")
    want = sb.expected_texts(serve["tokens_by_prompt"], _serve_prompts(), get_tokenizer("byte"))
    gc_collect(torch)  # the parent holds no model while the replicas run
    out = {"phase": "serve_app", "card": card, "model": "llama3.2-3b",
           **sb.serve_app(cfg, _serve_prompts(), want)}
    emit(out)
    if not out["ok"]:
        raise AssertionError(f"serve_app: {out['failed_checks']}")
    return out


def phase_openai_app(torch, card: str, serve: dict) -> dict:
    """The rest of Serve on the port's own processes
    (ray_tpu_torch.tools.serve_bench.openai_app), through the entry points
    a user calls: the OpenAI app deployed from a config
    (serve.schema.deploy; build_openai_app of the serve phase's config,
    llama3.2-3b at full width and depth, seeded bf16 weights, the fused
    RMSNorm, 16 slots x 1024, one LLMServer replica of {"GPU": 0.5}, two
    router replicas); an ASGI ingress calling the LLM deployment's handle;
    then a gang deployment (build_gang_deployment, one NCCL rank spawned by
    its replica, prefill buckets from 128 so that its chunk pads a prompt
    as the serve phase's engine did), killed once and replaced. Limits:
    every completion's text equal to the serve phase's greedy text for its
    prompt (its first 32 tokens; an SSE stream's chunks joined to the
    per-token texts), the chat's to its own stream's; every decode step of
    the LLM replica and of each gang's rank a graph replay and its RMSNorm
    launches, counted in its own process, equal to what its engine's
    counters give; the router override shown by status(); half of card 0
    leased by the LLM replica and card 0 by the gang's rank, none and no
    process left after serve.shutdown()."""
    from ray_tpu_torch.llm.tokenizer import get_tokenizer
    from ray_tpu_torch.tools import serve_bench as sb

    cfg = _serve_config({})
    if sb.card_llm_config() != cfg or sb.serve_prompts() != _serve_prompts():
        raise AssertionError("openai_app: serve_bench's engine or prompts are not the serve "
                             "phase's")
    want = sb.expected_texts(serve["tokens_by_prompt"], _serve_prompts(), get_tokenizer("byte"))
    gc_collect(torch)  # the parent holds no model while the replicas run
    out = {"phase": "openai_app", "card": card, "model": "llama3.2-3b",
           **sb.openai_app(cfg, _serve_prompts(), want)}
    emit(out)
    if not out["ok"]:
        raise AssertionError(f"openai_app: {out['failed_checks']}")
    return out


def phase_util(torch, card: str, batch: dict) -> dict:
    """ray_tpu_torch.util on the port's own processes
    (ray_tpu_torch.tools.util_bench.util_actors), through the entry points
    a user calls: placement_group([{"GPU": 0.5}] * 2, "STRICT_PACK") on the
    host's card ledger; two engine actors placed in its bundles
    (PlacementGroupSchedulingStrategy), each building the batch phase's
    engine (llama3.2-3b at full width and depth, seeded bf16 weights, the
    fused RMSNorm, 16 slots x 1024, prefix caching off) on the half card
    its bundle leases; ActorPool.map of the batch phase's 32 prompts in
    blocks of 16, greedy, 32 tokens; a Queue(maxsize=8) on a CPU actor,
    passed to one engine actor, which pulls the first block from it; a
    metrics.Counter of output tokens in each actor and a tracing.span
    around each block. Limits: every text (32 through the pool, 16 through
    the queue) equal to the batch phase's for its prompt, in input order;
    in each actor every decode step a graph replay and the RMSNorm
    launches since its engine was built, counted in its own process, equal
    to what its engine's counters give; the merged token counter
    (state.cluster_metrics) equal to the tokens generated; each block's
    span in state.timeline() under the driver's span; the 3 actors ALIVE
    in state.list_actors() with their pids and the engines' card, the
    bundles on the card in list_placement_groups(), ALIVE for each on the
    "actors" channel; one engine actor killed: DEAD on the channel, its
    bundle still reserved; remove_placement_group ends the other, and no
    lease is left."""
    from ray_tpu_torch.tools import data_bench as db
    from ray_tpu_torch.tools import util_bench as ub

    cfg = _serve_config({}, enable_prefix_caching=False)
    if db.card_llm_config() != cfg:
        raise AssertionError("util: data_bench's engine is not the batch phase's")
    gc_collect(torch)  # the parent holds no model while the actors run
    part = ub.util_actors(cfg, _batch_prompts(), BATCH_SAMPLING, batch["texts"])
    emit({"phase": "util", "card": card, **part})
    if not part["ok"]:
        raise AssertionError(f"util: {part['failed_checks']}")
    out = {"phase": "util", "card": card, "model": "llama3.2-3b",
           "out_tok_per_s": part["out_tok_per_s"], "map_s": part["map_s"],
           "actor_startup_s": [a["startup_s"] for a in part["actors"]],
           "engine_build_s": [a["engine_build_s"] for a in part["actors"]],
           "actor_peak_memory_gb": [a["peak_memory_gb"] for a in part["actors"]],
           "group_ready_s": part["group_ready_s"], "actors_placed_s": part["actors_placed_s"],
           "free_after_remove_s": part["free_after_remove_s"],
           "texts_equal_batch_phase": part["texts_equal"],
           "queue_texts_equal": part["queue_texts_equal"],
           "merged_tokens": part["merged_tokens"], "launches": part["launches"]}
    emit(out)
    return out


def phase_dag(torch, card: str, batch: dict) -> dict:
    """Compiled DAGs on the port's own processes
    (ray_tpu_torch.tools.dag_bench.dag_actors), through the entry points a
    user calls: two engine actors, each on a half-card lease
    (spawn_env.assign_cards) building the batch phase's engine (llama3.2-3b
    at full width and depth, seeded bf16 weights, the fused RMSNorm, 16
    slots x 1024, prefix caching off), bound as x = a.bind("generate", inp,
    ...), MultiOutputNode([x, b.bind("generate", x, ...)]); the batch
    phase's 32 prompts in blocks of 16, greedy, 32 tokens, after a warm-up
    block, in four runs: through dag.execute, twice through
    dag.experimental_compile() (a channel under /dev/shm an edge, a loop
    thread in each actor), through dag.execute again. Limits: stage 1's
    texts equal to the batch phase's for their prompts in every run; stage
    2's equal to the first eager run's in every run; in each actor every decode step a
    graph replay and the RMSNorm launches since its engine was built equal
    to what its engine's counters give; the dashboard's /api/actors shows
    both ALIVE on the card, /api/stacks each one's dag-loop thread,
    /api/logs one entry for each of the phase's four actors, /metrics
    non-empty; the internal_kv counter kept in stage 1's actor equal to its
    rows; after teardown both actors answer a normal call and none of the
    DAG's channel files is left; no lease after the kill. Reported: the
    actors' start-up, engine build and peak memory, tok/s eager and
    compiled, the idle loop's cost (a block with the loops idle against
    one after teardown), the CPU chain's round trip compiled and eager
    (median and 90th percentile of each of four turns)."""
    from ray_tpu_torch.tools import dag_bench
    from ray_tpu_torch.tools import data_bench as db

    cfg = _serve_config({}, enable_prefix_caching=False)
    if db.card_llm_config() != cfg:
        raise AssertionError("dag: data_bench's engine is not the batch phase's")
    gc_collect(torch)  # the parent holds no model while the actors run
    part = dag_bench.dag_actors(cfg, _batch_prompts(), BATCH_SAMPLING, batch["texts"])
    emit({"phase": "dag", "card": card, **part})
    if not part["ok"]:
        raise AssertionError(f"dag: {part['failed_checks']}")
    out = {"phase": "dag", "card": card, "model": "llama3.2-3b",
           "eager_out_tok_per_s": part["eager_out_tok_per_s"],
           "compiled_out_tok_per_s": part["compiled_out_tok_per_s"],
           "idle_loop_tok_per_s": part["idle_loop_tok_per_s"],
           "no_loop_tok_per_s": part["no_loop_tok_per_s"], "idle_loop_cost": part["idle_loop_cost"],
           "chain_eager_us": part["chain_eager_us"], "chain_compiled_us": part["chain_compiled_us"],
           "host_loadavg": part["host_loadavg"],
           "compile_s": part["compile_s"], "actors_ready_s": part["actors_ready_s"],
           "actor_startup_s": [a["startup_s"] for a in part["actors"]],
           "engine_build_s": [a["engine_build_s"] for a in part["actors"]],
           "actor_peak_memory_gb": [a["peak_memory_gb"] for a in part["actors"]],
           "stage1_equal_batch_phase": part["stage1_equal_compiled"],
           "stage2_equal_first_eager": part["stage2_equal_first_eager"],
           "launches": part["launches"]}
    emit(out)
    return out


def phase_jobs(torch, card: str, batch: dict) -> dict:
    """Job submission on the port's own processes
    (ray_tpu_torch.tools.jobs_bench.jobs_part), through the entry points a
    user calls: JobSubmissionClient().submit_job of a port driver ("python
    -m ray_tpu_torch.tools.jobs_bench --entrypoint ..."), whose engine
    actor on a half-card lease builds the batch phase's engine and runs the
    batch phase's first 16 prompts in one block, greedy, 32 tokens; and of
    a job whose actor holds a half-card lease until stop_job. Limits: the
    first job RUNNING then SUCCEEDED, its log (get_job_logs and
    tail_job_logs) holding each prompt's text equal to the batch phase's,
    in its engine actor every decode step a graph replay and the RMSNorm
    launches equal to its engine's count; the second job STOPPED, its
    process group gone and no lease in the ledger; a second JobManager on
    the same log directory lists both."""
    from ray_tpu_torch.tools import jobs_bench

    gc_collect(torch)
    part = jobs_bench.jobs_part(_batch_prompts()[:16], batch["texts"][:16])
    emit({"phase": "jobs", "card": card, **part})
    if not part["ok"]:
        raise AssertionError(f"jobs: {part['failed_checks']}")
    out = {"phase": "jobs", "card": card, "model": "llama3.2-3b", "run_s": part["run_s"],
           "hold_s": part["hold_s"], "stop_s": part["stop_s"],
           "engine_build_s": part["engine_build_s"], "peak_memory_gb": part["peak_memory_gb"],
           "texts_equal_batch_phase": part["texts_equal"], "launches": part["launches"]}
    emit(out)
    return out


def phase_autoscaler(torch, card: str, batch: dict) -> dict:
    """The demand autoscaler on the port's own processes
    (ray_tpu_torch.tools.autoscaler_bench.autoscaler_part), through the
    entry points a user calls: on a card ledger of its own over this card's
    physical id, FakeNodeProvider and Autoscaler with one group of one
    card and 4 CPU slots a node (0 to 1 groups, idle_timeout_s 1); a
    placement group [{"GPU": 0.5, "CPU": 1}] PENDING with no node, placed
    once update() adds the node; an engine actor in its bundle building the
    batch phase's engine (llama3.2-3b at full width and depth, seeded bf16
    weights, the fused RMSNorm, 16 slots x 1024, prefix caching off) and
    running the batch phase's first 16 prompts, greedy, 32 tokens; the
    group removed, the node drained and terminated. Limits: texts equal to
    the batch phase's, every decode step a graph replay, the actor's
    RMSNorm launches since its engine was built equal to its engine's
    count, one scale-up and one scale-down, the drain record drained, no
    node, pool or lease left on either ledger."""
    from ray_tpu_torch.accelerator import GPUAcceleratorManager
    from ray_tpu_torch.tools import autoscaler_bench
    from ray_tpu_torch.tools import data_bench as db

    cfg = _serve_config({}, enable_prefix_caching=False)
    if db.card_llm_config() != cfg:
        raise AssertionError("autoscaler: data_bench's engine is not the batch phase's")
    gc_collect(torch)  # the parent holds no model while the actor runs
    part = autoscaler_bench.autoscaler_part(
        cfg, _batch_prompts()[:16], BATCH_SAMPLING, batch["texts"][:16],
        card=GPUAcceleratorManager.get_physical_card_ids()[0])
    emit({"phase": "autoscaler", "card": card, **part})
    if not part["ok"]:
        raise AssertionError(f"autoscaler: {part['failed_checks']}")
    out = {"phase": "autoscaler", "card": card, "model": "llama3.2-3b",
           **{k: part[k] for k in ("demand_to_node_s", "demand_to_placed_s", "actor_startup_s",
                                   "engine_build_s", "peak_memory_gb", "out_tok_per_s",
                                   "idle_to_drained_s", "idle_to_terminated_s",
                                   "update_ms_median", "update_ms_max", "updates",
                                   "scaled_up", "scaled_down", "launches")},
           "texts_equal_batch_phase": part["texts_equal"]}
    emit(out)
    return out


def phase_cli(torch, card: str) -> dict:
    """The command line (ray_tpu_torch.tools.cli_bench.cli_part) run as
    subprocesses of this driver: job submit, a job holding a half-card
    lease seen by status and job list/status and stopped, logs and timeline
    attached to this driver through its session file, drain-node and
    status on a one-card node of a ledger of its own."""
    from ray_tpu_torch.tools import cli_bench

    part = cli_bench.cli_part()
    emit({"phase": "cli", "card": card, **part})
    if not part["ok"]:
        raise AssertionError(f"cli: {part['failed_checks']}")
    out = {"phase": "cli", "card": card, "seconds": part["seconds"],
           "commands": part["commands"], "command_s_median": part["command_s_median"],
           "logs_listed": part["logs_listed"], "timeline_events": part["timeline_events"]}
    emit(out)
    return out


def phase_core(torch, card: str, batch: dict) -> dict:
    """The core API (ray_tpu_torch.tools.core_bench.core_part), through the
    entry points a user calls: init, put, two @remote(num_gpus=0.5) tasks
    building the batch phase's engine (llama3.2-3b at full width and depth,
    seeded bf16 weights, the fused RMSNorm, 16 slots x 1024, prefix caching
    off) on the half card each worker leases, generating the batch phase's
    32 prompts in two blocks of 16 (greedy, 32 tokens); a whole-card task
    queued behind them and cancelled; wait, get, a chained CPU task, a
    retried and a raising task; shutdown. Limits: texts equal to the batch
    phase's, every decode step a graph replay, each worker's RMSNorm
    launches since its engine was built equal to its engine's count, the
    chained count equal to the tokens generated, nothing left after
    shutdown."""
    from ray_tpu_torch.tools import core_bench
    from ray_tpu_torch.tools import data_bench as db

    cfg = _serve_config({}, enable_prefix_caching=False)
    if db.card_llm_config() != cfg:
        raise AssertionError("core: data_bench's engine is not the batch phase's")
    gc_collect(torch)  # the parent holds no model while the workers run
    part = core_bench.core_part(cfg, _batch_prompts(), BATCH_SAMPLING, batch["texts"])
    emit({"phase": "core", "card": card, **part})
    if not part["ok"]:
        raise AssertionError(f"core: {part['failed_checks']}")
    out = {"phase": "core", "card": card, "model": "llama3.2-3b",
           "out_tok_per_s": part["out_tok_per_s"], "submit_to_done_s": part["submit_to_done_s"],
           "worker_startup_s": [w["startup_s"] for w in part["workers"]],
           "engine_build_s": [w["engine_build_s"] for w in part["workers"]],
           "worker_peak_memory_gb": [w["peak_memory_gb"] for w in part["workers"]],
           "round_trip_ms_median": part["round_trip_ms_median"],
           "put_4mib_ms_median": part["put_4mib_ms_median"],
           "get_4mib_ms_median": part["get_4mib_ms_median"],
           "texts_equal_batch_phase": part["texts_equal"], "chained_count": part["chained_count"],
           "launches": part["launches"]}
    emit(out)
    return out


def emit_holders(phase: str) -> None:
    """The card ledger's live leases and nodes after a phase that spawns
    processes: a rank or actor that outlived its phase shows here, under its
    pid, and so does a node the autoscaler left."""
    from ray_tpu_torch._private.cards import default_ledger

    ledger = default_ledger()
    emit({"ledger_after": phase, "holders": [str(h) for h in ledger.holders()],
          "nodes": [str(n) for n in ledger.nodes()]})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card", file=sys.stderr)
        return 2
    import ray_tpu_torch  # noqa: F401 — fails here outside a checkout of the repo
    from ray_tpu_torch._native import build
    from ray_tpu_torch._private import log_capture
    from ray_tpu_torch.tools.decode_profile import card as nvidia_smi

    smi = nvidia_smi()
    card = f"{torch.cuda.get_device_name(0)} ({smi})"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
          "count": torch.cuda.device_count(), "tf32": "off (matmul and cudnn)"})

    t0 = time.perf_counter()
    build.build()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for name in build.sources() for ln in build.build_log(name).splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": build_s, "sources": build.sources(), "ptxas": ptxas})

    timings = {}

    spawning = {"gang_serve", "gang_lora", "train_serve", "elastic", "tune", "data", "serve_app",
                "openai_app", "util", "dag", "jobs", "autoscaler", "cli", "core", "parallel",
                "rllib_remote"}

    def timed_phase(name, fn):
        t = time.perf_counter()
        result = fn(torch, card)
        timings[name] = time.perf_counter() - t
        if name in spawning:
            emit_holders(name)
        return result

    k = timed_phase("kernels", phase_kernels)
    quant = timed_phase("quant", phase_quant)
    torch.cuda.empty_cache()
    serve = timed_phase("serve", phase_serve)
    torch.cuda.empty_cache()
    gang_serve = timed_phase("gang_serve", lambda torch, card: phase_gang_serve(torch, card, serve))
    disagg = timed_phase("disagg", phase_disagg)
    batch = timed_phase("batch", phase_batch)
    timed_phase("decode_graph", phase_decode_graph)
    timed_phase("numerics", phase_numerics)
    train = timed_phase("train", phase_train)
    timed_phase("train_numerics", phase_train_numerics)
    gc_collect(torch)
    moe_serve = timed_phase("moe_serve", phase_moe_serve)
    timed_phase("moe_numerics", phase_moe_numerics)
    moe_train = timed_phase("moe_train", phase_moe_train)
    lora_serve = timed_phase("lora_serve", lambda torch, card: phase_lora_serve(torch, card, serve))
    gang_lora = timed_phase("gang_lora",
                            lambda torch, card: phase_gang_lora(torch, card, serve, lora_serve))
    dots = timed_phase("train_dots", lambda torch, card: phase_train_dots(torch, card, train))
    timed_phase("graft_entry", phase_graft_entry)
    train_serve = timed_phase("train_serve", lambda torch, card: phase_train_serve(torch, card, train))
    elastic = timed_phase("elastic", phase_elastic)
    tune = timed_phase("tune", phase_tune)
    data = timed_phase("data", lambda torch, card: phase_data(torch, card, batch))
    serve_app = timed_phase("serve_app", lambda torch, card: phase_serve_app(torch, card, serve))
    openai = timed_phase("openai_app", lambda torch, card: phase_openai_app(torch, card, serve))
    util = timed_phase("util", lambda torch, card: phase_util(torch, card, batch))
    dag = timed_phase("dag", lambda torch, card: phase_dag(torch, card, batch))
    jobs = timed_phase("jobs", lambda torch, card: phase_jobs(torch, card, batch))
    autoscaler = timed_phase("autoscaler", lambda torch, card: phase_autoscaler(torch, card, batch))
    timed_phase("cli", phase_cli)
    core = timed_phase("core", lambda torch, card: phase_core(torch, card, batch))
    gc_collect(torch)
    parallel = timed_phase("parallel", phase_parallel)
    rllib = timed_phase("rllib", phase_rllib)
    rllib_remote = timed_phase("rllib_remote", phase_rllib_remote)
    emit({"phase": "timings", "seconds": timings, "build_seconds": build_s})
    log_capture.flush()  # the children's last lines, before the summary lines

    decode = next(r for r in k["rows"] if r["case"] == "decode")
    fused = k["fused"]
    bench = next(r for r in k["attention"]["rows"] if r["case"] == "bench")
    gqa3b = next(r for r in k["attention"]["rows"] if r["case"] == "gqa3b")
    attention_kernels = [
        ("flash_attention_fwd", "fwd", "ray_tpu/models/llama.py:334", bench["sdpa_fwd_us"]),
        ("flash_attention_bwd_dq", "bwd_dq", "ray_tpu/models/llama.py:334", bench["sdpa_bwd_us"]),
        ("flash_attention_bwd_dkdv", "bwd_dkdv", "ray_tpu/models/llama.py:334", bench["sdpa_bwd_us"]),
    ]
    # the backward pair computes one function, dq, dk and dv: its bound (10
    # flops per causal pair and head dim, S and dP once) and its library
    # time (one aten backward call) stand on both rows beside the per-kernel
    # bounds, which count the S and dP that each kernel recomputes
    bwd_pair = {"bwd_function_bound_ms": bench["bwd_bound_us"] / 1e3,
                "bwd_pair_ms": bench["bwd_pair_us"] / 1e3,
                "gqa3b_bwd_pair_ms": gqa3b["bwd_pair_us"] / 1e3,
                "gqa3b_bwd_function_bound_ms": gqa3b["bwd_bound_us"] / 1e3,
                "library_note": "aten._scaled_dot_product_flash_attention_backward: dq, dk, dv "
                                "together, the function of both backward kernels; at gqa3b on "
                                "K, V repeated to H heads outside the timed graph"}
    # the quant rows at w_gate/w_up's shape [8192, 3072] (56 of the 197
    # matrices); the quant phase line has every shape
    mlp_up = next(r for r in quant["timing"] if r["shape"] == [8192, 3072])
    kvp = quant["kernel_vs_plain"]
    quant_kernels = [
        ("quantize_int8", "quantize", "ray_tpu/ops/quant.py:20",
         max(kvp["q_max_abs_err"], kvp["scales_max_abs_err"])),
        ("dequantize_int8", "dequantize", "ray_tpu/ops/quant.py:29", kvp["out_max_abs_err"]),
    ]
    emit({"kernels": [{
        "name": "rmsnorm",
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/rmsnorm.cu",
        "replaces": "ray_tpu/ops/rmsnorm.py:23",
        "launches": serve["rmsnorm_launches"],
        # each serving path, its counter set to 0 just before it
        "launches_by_path": {"serve": serve["rmsnorm_launches"],
                             # the gang's rank process, its own counters
                             "gang_serve": gang_serve["rmsnorm_launches"],
                             "moe_serve": moe_serve["rmsnorm_launches"],
                             "lora_serve": lora_serve["rmsnorm_launches"],
                             "disagg": disagg["rmsnorm_launches"],
                             "batch": batch["rmsnorm_launches"],
                             # the data phase's two actor processes, their own counters
                             "data": data["launches"]["rmsnorm"],
                             # the serve_app phase's LLMServer replicas, their own counters
                             "serve_app": serve_app["launches"]["rmsnorm"],
                             # the openai_app phase's LLMServer replica and
                             # its gangs' rank processes, their own counters
                             "openai_app": openai["launches"]["openai_app"],
                             "gang_app": openai["launches"]["gang_app"],
                             # the util phase's two placed engine actors, their own counters
                             "util": util["launches"]["rmsnorm"],
                             # the dag phase's two engine actors, their own counters
                             "dag": dag["launches"]["rmsnorm"],
                             # the jobs phase's engine actor, spawned by the job's driver
                             "jobs": jobs["launches"]["rmsnorm"],
                             # the autoscaler phase's engine actor, placed on the new node's card
                             "autoscaler": autoscaler["launches"]["rmsnorm"],
                             # the core phase's two card-share task workers, their own counters
                             "core": core["launches"]["rmsnorm"],
                             # the gang's rank process, its own counters
                             "gang_lora": gang_lora["rmsnorm_launches"],
                             "train_serve": train_serve["rmsnorm_launches"],
                             "rllib": rllib["launches"]["rmsnorm"],
                             "rllib_remote": rllib_remote["launches"]["rmsnorm"]},
        "max_abs_err": k["max_abs_err"],
        "ms": decode["kernel_us"] / 1e3,
        "plain_ms": decode["plain_us"] / 1e3,
        "bound_ms": decode["bound_us"] / 1e3,
        "bound_by": "bytes",
        "library_ms": decode["library_us"] / 1e3 if decode["library_us"] is not None else None,
        # the residual add fused in (add_rmsnorm) at the same shape
        "fused_ms": fused["kernel_us"] / 1e3,
        "fused_bound_ms": fused["bound_us"] / 1e3,
        "fused_plain_ms": fused["plain_us"] / 1e3,
        "fused_add_then_kernel_ms": fused["add_then_kernel_us"] / 1e3,
        "fused_bit_equal": fused["bit_equal_to_add_then_kernel"],
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/flash_attention" + ("_fwd.cu" if key == "fwd" else ".cu"),
        "replaces": replaces,
        "launches": train["launches"][key],
        # each training path's timed steps, the counters set to 0 before them
        "launches_by_path": {"train": train["launches"][key], "moe_train": moe_train["launches"][key],
                             "train_dots": dots["launches"][key],
                             # the trainer's rank process, its own counters
                             "train_serve": train_serve["launches"][name],
                             # the elastic group's one rank (ELASTIC_DEPTH layers, 6 steps)
                             "elastic": elastic["launches"][name],
                             # the tune phase's trial processes and nested
                             # rank (ELASTIC_DEPTH layers), their own counters
                             "tune": tune["launches"][name],
                             # the data phase's ingest rank (ELASTIC_DEPTH layers, 3 steps)
                             "data": data["launches"][name],
                             # the sweep's first step on each mesh, counted in the rank
                             "parallel": parallel["launches"][key],
                             "rllib": rllib["launches"][name],
                             "rllib_remote": rllib_remote["launches"][name]},
        "max_abs_err": k["attention"]["max_abs_err"],
        "ms": bench[key]["kernel_us"] / 1e3,
        "plain_ms": bench[key]["plain_us"] / 1e3,
        "bound_ms": bench[key]["bound_us"] / 1e3,
        "bound_by": bench[key]["bound_by"],
        "library_ms": lib_us / 1e3 if lib_us is not None else None,
        **(bwd_pair if key.startswith("bwd") else {}),
        "tflops": bench[key]["tflops"],
        "bound_share": bench[key]["bound_share"],
        "gqa3b_ms": gqa3b[key]["kernel_us"] / 1e3,
        "gqa3b_bound_ms": gqa3b[key]["bound_us"] / 1e3,
        "gqa3b_library_ms": gqa3b["sdpa_fwd_us" if key == "fwd" else "sdpa_bwd_us"] / 1e3,
        "gqa3b_tflops": gqa3b[key]["tflops"],
        "gqa3b_bound_share": gqa3b[key]["bound_share"],
    } for name, key, replaces, lib_us in attention_kernels] + [{
        "name": name,
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/quant.cu",
        "replaces": replaces,
        "launches": quant["launches"][name],
        "launches_by_path": {"quant": quant["launches"][name], "rllib": rllib["launches"][name],
                             "rllib_remote": rllib_remote["launches"][name]},
        "max_abs_err": err,
        "ms": mlp_up[key]["kernel_us"] / 1e3,
        "plain_ms": mlp_up[key]["plain_us"] / 1e3,
        "bound_ms": mlp_up[key]["bound_us"] / 1e3,
        "bound_by": "bytes",
        "library_ms": mlp_up[key]["library_us"] / 1e3 if "library_us" in mlp_up[key] else None,
        "shape": mlp_up["shape"],
        **({"path_ms": mlp_up[key]["path_us"] / 1e3} if "path_us" in mlp_up[key] else {}),
        **({"library_bit_equal": mlp_up[key]["library_bit_equal"]} if "library_us" in mlp_up[key]
           else {"library_note": "no single PyTorch call computes per-row absmax int8 quantization"}),
    } for name, key, replaces, err in quant_kernels]})
    sys.stdout.write(smi + "\n")
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
