"""Gang-scheduled LLM serving: one replica that spans several cards, the
port's counterpart of ``ray_tpu/llm/gang.py``.

The JAX package's replica owns a STRICT_PACK placement group of
``EngineWorker`` actors that rendezvous into one ``jax.distributed`` world.
The port's replica spawns its ranks on this host through the Train layer's
worker group (``train/_internal/worker_group.py:WorkerGroup.start_loop``):
one process a card under NCCL (``CUDA_VISIBLE_DEVICES`` set before CUDA
starts), or gloo ranks on the CPU when the caller asks for it, joined by a
``TCPStore`` rendezvous. Each rank hosts the same lockstep SPMD engine
(``llm/spmd.py``) over the serving mesh.

Continuous batching under the lockstep rule: the server runs the ONE
scheduler (admission, chunked prefill pacing, prefix-cache bookkeeping,
finish detection) and sends a plan per iteration to every rank, in one
order, down each rank's FIFO pipe, from one dispatcher thread (the
reference's per-actor mailboxes); every rank executes the plan's programs
and rank 0 sends the sampled tokens back. A request is admitted chunk by
chunk while other slots keep decoding.

Throughput knobs as in the reference: ``decode_steps`` packs K decode
steps into one plan (one pipe round trip per K tokens); ``decode_runahead``
keeps a bounded window of plans in flight with strictly ordered apply (the
ranks chain sampled tokens on the device); ``max_concurrent_admissions``
interleaves several chunked prefills per plan. Stop/EOS is honoured on the
host after the fact: over-decoded tail tokens of finished requests are
discarded at apply.

Fault tolerance: sampling keys are derived from (request seed, token
index), so when a rank dies (its process exits, or its pipe ends) the
server stops the whole gang, spawns a fresh one with a fresh rendezvous
store, loads its adapters again, and replays the requests in flight; the
regenerated tokens are byte-identical and already-streamed ones are
skipped.

Multi-LoRA, as the JAX engine serves it on a tp/sp mesh
(``ray_tpu/llm/engine.py:435-480``): ``add_lora``/``remove_lora`` go to
every rank through the scheduler thread, in the plan stream's order, and
each rank writes the stack slot in place; an adapter is visible to
``submit`` only once every rank holds it. Each admission plan names its
request's adapter, and adapter requests bypass the prefix cache, as in
both engines.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import queue
import random
import threading
import time
import uuid
from collections import OrderedDict, deque
from typing import Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch.llm.config import LLMConfig, SamplingParams, resolve_llama_config
from ray_tpu_torch.llm.engine import RequestOutput, adapter_tensors
from ray_tpu_torch.llm.pacing import TokenPacer
from ray_tpu_torch.llm.server import LLMServer
from ray_tpu_torch.llm.tokenizer import get_tokenizer
from ray_tpu_torch.models.llama import init_lora_stack
from ray_tpu_torch.ops import add_launch_counts, launch_counts
from ray_tpu_torch.train._internal.worker_group import WorkerGroup
from ray_tpu_torch.train.config import ScalingConfig


class EngineWorker:
    """One rank of the gang, built inside the rank after its rendezvous:
    the sharded params, the slot cache and the decode graph
    (``SPMDGenerator`` + ``SPMDEngineWorker``)."""

    def __init__(self, config: LLMConfig, device: torch.device):
        from ray_tpu_torch.llm.spmd import SPMDEngineWorker, SPMDGenerator

        self.rank = dist.get_rank()
        self.gen = SPMDGenerator(config, device=device)
        self.eng = SPMDEngineWorker(config, self.gen)

    def info(self) -> dict:
        dev = self.gen.device
        return {
            "rank": self.rank,
            "world": dist.get_world_size(),
            "backend": dist.get_backend(),
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "mesh": {k: int(v) for k, v in
                     zip(self.gen.mesh.mesh_dim_names, self.gen.mesh.mesh.shape)},
        }

    def generate_batch(self, token_lists, params_dict: Optional[dict]):
        """Lockstep whole-batch generation (``SPMDGenerator.generate_batch``,
        the reference's offline batch entry): every rank computes the same
        tokens, rank 0 returns them and the others ``True``."""
        sp = SamplingParams(**params_dict) if params_dict else None
        out = self.gen.generate_batch(token_lists, sampling_params=sp)
        return out if self.rank == 0 else True

    def counts(self, reset: bool) -> dict:
        """This rank's kernel launches (every counter, by kernel name) and
        program counters; ``reset`` sets both to 0 after reading them."""
        out = {"launches": launch_counts(), "programs": dict(self.eng.counts)}
        if reset:
            add_launch_counts({k: -n for k, n in out["launches"].items()})
            self.eng.counts.update({k: type(v)(0) for k, v in self.eng.counts.items()})
        return out


def _engine_rank(config: dict, conn, inbox, device: torch.device) -> None:
    """A gang rank's loop (run by ``WorkerGroup.start_loop`` after the
    rendezvous): build the engine, say ``ready``, then execute the inbox's
    messages in order until ``stop`` or the server's end of the pipe
    closes. Rank 0 answers each plan; every rank answers ``counts``."""
    worker = EngineWorker(config["llm_config"], device)
    conn.send({"kind": "ready", "rank": worker.rank, "info": worker.info(),
               "startup_s": time.time() - config["spawned_at"]})
    while True:
        try:
            msg = inbox.recv()
        except EOFError:
            return
        if msg["op"] == "step":
            recv_t = time.monotonic()
            out = worker.eng.step(msg["plan"])
            if worker.rank == 0:
                # time.monotonic is CLOCK_MONOTONIC: one clock for every
                # process of the host, so the server can subtract
                conn.send({"kind": "step", "seq": msg["seq"], "out": out, "recv_t": recv_t,
                           "sent_t": time.monotonic()})
        elif msg["op"] == "counts":
            conn.send({"kind": "counts", "rank": worker.rank, **worker.counts(msg["reset"])})
        elif msg["op"] == "lora":
            worker.eng.set_lora(msg["idx"], msg["weights"])
            conn.send({"kind": "lora", "rank": worker.rank})
        elif msg["op"] == "stop":
            return


class _RankFailed(RuntimeError):
    """A gang rank died, failed or went silent: the gang must be rebuilt."""


class _GangRequest:
    _seq = itertools.count()

    def __init__(self, request_id: str, prompt_ids: list, params: SamplingParams,
                 lora_idx: int = 0):
        self.seq = next(self._seq)
        self.request_id = request_id
        self.lora_idx = lora_idx  # adapter stack slot; 0 = the base model
        self.prompt_ids = prompt_ids
        self.params = params  # seed is always concrete (replay determinism)
        self.out_tokens: list[int] = []  # emitted (streamed) tokens
        self.gen_count = 0  # tokens APPLIED in the CURRENT run (replay-aware)
        # tokens DISPATCHED in the current run: run-ahead plans are built
        # against this future view; keys stay (seed, token_index)-derived
        self.disp_count = 0
        self.last_token = 0
        self.finish_reason: Optional[str] = None
        self.error: Optional[BaseException] = None
        self.done = threading.Event()
        self.stream_queue: "queue.Queue" = queue.Queue()
        self.submitted_t = time.time()
        self.first_token_t: Optional[float] = None
        self.done_t: Optional[float] = None
        self.prefix_hit_tokens = 0
        self.pacer = TokenPacer()  # smooths K-token bursts for SSE


class GangLLMServer:
    """A replica whose ONE engine is a gang of ``num_workers`` rank
    processes on this host (tp x sp of the config by default; more ranks
    at tp = sp = 1 replicate). ``device`` None puts one rank on each
    visible card (NCCL) and raises when there are too few; ``"cpu"`` runs
    gloo ranks on the CPU. The OpenAI-shaped methods are ``LLMServer``'s
    over ``self.engine``, the gang behind ``TorchEngine``'s surface, so a
    gang streams the same text through either front; a gang that is down
    or shut down, or a timed-out wait, gets a 400 reply as in the
    reference."""

    _PREFIX_CAP = 8  # cached prompt prefixes per gang (mirrored on the ranks)

    def __init__(self, llm_config: LLMConfig, num_workers: Optional[int] = None, device=None):
        ec = llm_config.engine
        self.llm_config = llm_config
        self.tokenizer = get_tokenizer(llm_config.model.tokenizer)
        self.num_workers = num_workers or ec.tensor_parallel_degree * ec.sequence_parallel_degree
        self._use_gpu = torch.device("cuda" if device is None else device).type == "cuda"
        # guards the rank group against a concurrent rebuild swap; plans are
        # sent by the one scheduler thread, so every rank gets one order
        self._lockstep = threading.Lock()
        self._group: Optional[WorkerGroup] = None
        self._plan_seq = itertools.count()
        self._replies: dict[int, dict] = {}
        self._rank_replies: dict[int, dict] = {}
        self._stop = False
        # multi-LoRA: the stacks' shapes and dtype (meta tensors; None at
        # max_loras=0), name -> slot of the adapters every rank holds, and
        # slot -> host weights of every adapter loaded or being loaded (a
        # rebuilt gang loads them again)
        self.lora_template = None
        if ec.max_loras > 0:
            mcfg = resolve_llama_config(llm_config.model, ec, min_vocab=self.tokenizer.vocab_size)
            self.lora_template = init_lora_stack(mcfg, ec.max_loras, ec.lora_rank, "meta")
        self._lora_slots: dict[str, int] = {}
        self._lora_weights: dict[int, dict] = {}
        self._lora_lock = threading.Lock()
        self.engine = GangEngine(self)
        self._front = LLMServer(llm_config, engine=self.engine,
                                reply_errors=(ValueError, RuntimeError, TimeoutError))
        try:
            self._spawn_gang()
        except BaseException:
            # a failed construction must not leave rank processes behind
            self.shutdown()
            raise
        # ---- scheduler state (the gang's single brain) ----
        self.n_slots = ec.max_num_seqs
        self.max_len = ec.max_seq_len
        self.chunk = min(ec.prefill_buckets)
        # host-side only (the ranks run any K), so retunable live
        self._decode_steps = max(1, ec.decode_steps)
        self._decode_runahead = max(1, ec.decode_runahead)
        self._max_admissions = max(1, ec.max_concurrent_admissions)
        self._cv = threading.Condition()
        self._queue: deque = deque()
        # DISPATCH-view slot table: bound when a final prefill chunk is
        # dispatched, freed when the finish is applied OR when every
        # budgeted token has been dispatched (the stripe handoff is safe
        # because the ranks run plans in dispatch order)
        self._slots: list = [None] * self.n_slots
        self._adms: "OrderedDict[int, dict]" = OrderedDict()  # slot -> admission
        # dispatched plans whose results have not been read yet (run-ahead
        # window; apply is strictly in dispatch order)
        self._inflight: deque = deque()
        self._max_inflight_seen = 0
        self._max_admissions_seen = 0
        self._prefix_index: "OrderedDict[str, int]" = OrderedDict()
        # prefix-KV snapshots owed to the NEXT plan (several final chunks
        # can land in one plan)
        self._pending_stores: list = []
        self._pending_evict: list = []
        self._prefix_hits = 0
        self._prefix_misses = 0
        self._rebuilds = 0
        self._need_rebuild = False
        self._fatal: Optional[BaseException] = None
        # requests for the ranks' counters, served by the scheduler thread
        # (it alone reads the ranks' pipes)
        self._control: deque = deque()
        # per applied plan: (dispatch -> rank 0's reply, rank 0's execution) ms
        self._plan_ms: deque = deque(maxlen=100_000)
        self._loop_thread = threading.Thread(
            target=self._loop, daemon=True, name="gang-scheduler"
        )
        self._loop_thread.start()

    @property
    def workers(self) -> list:
        """The gang's rank processes (``multiprocessing.Process``)."""
        return list(self._group.procs) if self._group is not None else []

    def set_perf_knobs(
        self,
        decode_steps: Optional[int] = None,
        decode_runahead: Optional[int] = None,
        max_concurrent_admissions: Optional[int] = None,
    ):
        """Retune the gang's throughput knobs live. Safe between requests:
        plans already in flight keep their shape; new plans pick up the new
        values. The high-water marks in ``stats`` restart from 0, so they
        read what the new knobs reach."""
        with self._cv:
            if decode_steps is not None:
                self._decode_steps = max(1, int(decode_steps))
            if decode_runahead is not None:
                self._decode_runahead = max(1, int(decode_runahead))
            if max_concurrent_admissions is not None:
                self._max_admissions = max(1, int(max_concurrent_admissions))
            self._max_inflight_seen = 0
            self._max_admissions_seen = 0
            self._cv.notify_all()

    # -- the rank group --------------------------------------------------------

    def _spawn_gang(self):
        """Spawn the whole gang (a fresh rendezvous store) and wait until
        every rank has built its engine, within the config's start-up
        budget (``LLMConfig.compile_budget_s``)."""
        n = self.num_workers
        group = WorkerGroup(ScalingConfig(num_workers=n, use_gpu=self._use_gpu),
                            experiment_name="gang")
        self._group = group
        self._replies = {}
        self._rank_replies = {}
        budget = self.llm_config.compile_budget_s()
        group.start_loop(_engine_rank, {"llm_config": self.llm_config, "spawned_at": time.time()})
        deadline = time.monotonic() + budget
        ready: dict[int, dict] = {}
        while len(ready) < n:
            if time.monotonic() > deadline:
                raise TimeoutError(f"gang ranks {sorted(set(range(n)) - set(ready))} were not "
                                   f"ready within {budget:.0f} s")
            msgs, exited = group.poll(0.1)
            for m in msgs:
                if m["kind"] == "ready":
                    ready[m["rank"]] = m
                elif m["kind"] == "error":
                    raise RuntimeError(f"gang rank {m['rank']} failed to start:\n{m['error']}")
            if exited:
                raise RuntimeError(f"gang ranks {sorted(exited)} exited during start-up")
        self.gang_info = {**ready[0]["info"],
                          "rank_startup_s": [ready[r]["startup_s"] for r in range(n)]}

    def _stop_gang(self, wait_s: float):
        """Stop and reap every rank: ``stop`` to each, ``wait_s`` to exit on
        its own, then terminate and kill (``WorkerGroup.shutdown``)."""
        group, self._group = self._group, None
        if group is None:
            return
        for r in range(len(group.procs)):  # the ranks that were spawned
            try:
                group.send(r, {"op": "stop"})
            except OSError:
                pass  # that rank has gone
        group.shutdown(wait_s=wait_s)

    def _send_all(self, msg: dict):
        with self._lockstep:
            for r in range(self.num_workers):
                self._group.send(r, msg)

    def _take(self, timeout: float):
        """Read what the ranks sent within ``timeout`` (plan replies, by
        sequence number; counter replies, by rank). Raises ``_RankFailed``
        for a rank's error, exit or closed pipe."""
        if self._stop:
            raise RuntimeError("gang is shut down")
        msgs, exited = self._group.poll(timeout)
        for m in msgs:
            if m["kind"] == "step":
                self._replies[m["seq"]] = m
            elif m["kind"] in ("counts", "lora"):
                self._rank_replies[m["rank"]] = m
            elif m["kind"] == "error":
                raise _RankFailed(f"gang rank {m['rank']} failed:\n{m['error']}")
        if exited:
            raise _RankFailed(f"gang ranks {sorted(exited)} exited (codes {exited})")

    def _result(self, seq: int, timeout: float = 600.0) -> dict:
        """Rank 0's reply to plan ``seq``, waiting up to ``timeout``."""
        deadline = time.monotonic() + timeout
        while seq not in self._replies:
            if time.monotonic() > deadline:
                raise _RankFailed(f"no reply to plan {seq} within {timeout:.0f} s")
            self._take(0.1)
        return self._replies.pop(seq)

    def rank_counts(self, reset: bool = False, timeout: float = 120.0) -> list[dict]:
        """Every rank's kernel launch counters (``ops.launch_counts``,
        counted inside the rank) and program counters, by rank, after the
        plans sent before this call; ``reset`` sets them to 0 after."""
        return self._control_call({"op": "counts", "reset": reset}, timeout)

    def _control_call(self, msg: dict, timeout: float = 120.0) -> list[dict]:
        """``msg`` to every rank, sent by the scheduler thread between
        plans (it alone reads the pipes); every rank's reply, by rank."""
        req = {"msg": msg, "done": threading.Event(), "out": None, "error": None}
        with self._cv:
            self._control.append(req)
            self._cv.notify_all()
        if not req["done"].wait(timeout):
            raise TimeoutError(f"the gang did not answer {msg['op']!r}")
        if req["error"] is not None:
            raise req["error"]
        return req["out"]

    def _ask_all(self, msg: dict) -> list[dict]:
        """Send ``msg`` to every rank and wait for each one's reply (the
        scheduler thread, or start-up before it exists)."""
        self._rank_replies = {}
        self._send_all(msg)
        deadline = time.monotonic() + 120.0
        while len(self._rank_replies) < self.num_workers:
            if time.monotonic() > deadline:
                raise _RankFailed(f"the ranks did not answer {msg['op']!r}")
            self._take(0.1)
        return [self._rank_replies[r] for r in range(self.num_workers)]

    def _serve_control(self):
        while self._control:
            req = self._control.popleft()
            try:
                req["out"] = self._ask_all(req["msg"])
            except Exception as e:  # noqa: BLE001 — handed to the caller
                req["error"] = e
                if isinstance(e, (_RankFailed, OSError)):
                    self._need_rebuild = True
            finally:
                req["done"].set()

    # -- scheduler loop ------------------------------------------------------

    def submit(self, prompt: str, params: SamplingParams,
               lora: Optional[str] = None) -> _GangRequest:
        return self.submit_ids(self.tokenizer.encode(prompt), params, lora)

    def submit_ids(self, ids: list[int], params: SamplingParams,
                   lora: Optional[str] = None) -> _GangRequest:
        if len(ids) > self.max_len - 1:
            raise ValueError(
                f"prompt length {len(ids)} exceeds the maximum "
                f"{self.max_len - 1} (max_seq_len)"
            )
        lora_idx = 0
        if lora:
            if lora not in self._lora_slots:
                raise KeyError(f"unknown LoRA adapter: {lora!r}")
            lora_idx = self._lora_slots[lora]
        if params.seed is None:
            # every request gets a concrete seed: replay after a gang
            # rebuild must regenerate the exact streamed tokens
            params = dataclasses.replace(params, seed=random.getrandbits(31))
        req = _GangRequest(f"gang-{uuid.uuid4().hex[:12]}", list(ids), params, lora_idx)
        with self._cv:
            # checked under _cv so it cannot race _fail_outstanding's final
            # queue snapshot: after shutdown() or a scheduler crash no
            # thread drains the queue, so a late submit must fail loudly
            if self._stop:
                raise RuntimeError("gang is shut down")
            if self._fatal is not None:
                raise RuntimeError(f"gang is down: {self._fatal}")
            self._queue.append(req)
            self._cv.notify_all()
        return req

    def _loop(self):
        try:
            self._loop_body()
        finally:
            # ANY scheduler exit (clean shutdown or a crash) must fail the
            # requests still owed tokens, or streaming consumers block
            # forever on a stream_queue that never gets its sentinel
            err = self._fatal or RuntimeError(
                "gang is shut down" if self._stop else "gang scheduler crashed"
            )
            if self._fatal is None and not self._stop:
                self._fatal = err
            self._fail_outstanding(err)

    def _loop_body(self):
        while not self._stop:
            with self._cv:
                while (
                    not self._stop
                    and not self._need_rebuild
                    and not self._control
                    and not self._adms
                    and not any(self._slots)
                    and not self._queue
                    and not self._inflight
                ):
                    self._cv.wait(timeout=1.0)
                if self._stop:
                    return
            if self._need_rebuild:
                self._do_rebuild()
                continue
            if self._control:
                self._serve_control()
                continue
            plan, record = self._build_plan()
            # ordered apply with a bounded run-ahead window: at most
            # decode_runahead plans are ever in flight. Before dispatching
            # a new plan the window is drained to make room; with nothing
            # new to dispatch, drain one record and rebuild the plan (its
            # apply may free a slot / finish a request).
            window = self._decode_runahead - 1 if plan is not None else 0
            failed = False
            while len(self._inflight) > window:
                rec = self._inflight.popleft()
                try:
                    reply = self._result(rec["seq"])
                except Exception as e:  # noqa: BLE001 — a rank died mid-step
                    # the popped record, and the freshly built one, whose
                    # dispatch state already advanced in _build_plan, may be
                    # the ONLY references to a request whose slot was freed
                    # at dispatch: put both back so the rebuild replays them
                    self._inflight.appendleft(rec)
                    if record is not None:
                        self._inflight.append(record)
                    self._do_rebuild(cause=e)
                    failed = True
                    break
                self._plan_ms.append(((reply["sent_t"] - rec["t"]) * 1e3,
                                      (reply["sent_t"] - reply["recv_t"]) * 1e3))
                self._apply(rec, reply["out"])
                if plan is None:
                    break  # state changed: try to build again
            if failed or plan is None:
                continue  # a stale plan must not reach the rebuilt gang
            record["seq"] = next(self._plan_seq)
            record["t"] = time.monotonic()
            try:
                self._send_all({"op": "step", "seq": record["seq"], "plan": plan})
            except Exception as e:  # noqa: BLE001 — send to a dead rank
                # the record's requests advanced at build time and may no
                # longer be visible via slots/admissions
                self._inflight.append(record)
                self._do_rebuild(cause=e)
                continue
            self._inflight.append(record)
            self._max_inflight_seen = max(self._max_inflight_seen, len(self._inflight))

    def _build_plan(self):
        """Build the next lockstep plan against the DISPATCH view and the
        record needed to apply its results later. Admission chunk cursors,
        slot bindings, token counts and prefix-cache bookkeeping all advance
        here (dispatch time) so run-ahead plans stack correctly; apply only
        accounts sampled tokens against the record."""
        plan: dict = {}
        record: dict = {"admits": [], "decode": None}
        if self._pending_evict:
            plan["evict"] = self._pending_evict
            self._pending_evict = []
        if self._pending_stores:
            plan["stores"] = self._pending_stores
            self._pending_stores = []
        # top up the admission pipeline: every free slot can start admitting
        # as long as the concurrency cap allows
        while len(self._adms) < self._max_admissions:
            with self._cv:
                free = next(
                    (i for i, r in enumerate(self._slots) if r is None and i not in self._adms),
                    None,
                )
                req = self._queue.popleft() if (free is not None and self._queue) else None
            if req is None:
                break
            self._start_admission(req, free)
        self._max_admissions_seen = max(self._max_admissions_seen, len(self._adms))
        # one chunk per in-flight admission per plan (chunked prefill keeps
        # per-plan prompt work bounded so decode latency stays flat)
        if self._adms:
            admits = []
            for slot, a in list(self._adms.items()):
                ch = a["chunks"][a["idx"]]
                admits.append(
                    {
                        "slot": slot,
                        "tokens": ch["tokens"],
                        "eff": ch["eff"],
                        "start": ch["start"],
                        "final": ch["final"],
                        "fresh": a["idx"] == 0,
                        "seed_prefix": a["prefix_key"] if a["idx"] == 0 else None,
                        "temp": float(a["req"].params.temperature),
                        "top_k": int(a["req"].params.top_k),
                        "key": np.asarray([a["req"].params.seed & 0xFFFFFFFF, 0], np.uint32),
                        "lora": a["req"].lora_idx,
                    }
                )
                a["idx"] += 1
                record["admits"].append(a)
                if ch["final"]:
                    del self._adms[slot]
                    req = a["req"]
                    # bind the dispatch view now: the NEXT plan (possibly
                    # dispatched before this one is applied) decodes this
                    # slot starting from the first token sampled on the rank
                    self._slots[slot] = req
                    req.disp_count = 1
                    if a["store_key"]:
                        # prompt KV complete in the slot: snapshot it in the
                        # next plan (stores precede admits on the ranks, so a
                        # later admission reusing the slot cannot race it)
                        self._pending_stores.append(
                            {"slot": slot, "m": a["store_m"], "key": a["store_key"]}
                        )
                        self._prefix_index[a["store_key"]] = a["store_m"]
                        while len(self._prefix_index) > self._PREFIX_CAP:
                            old_key, _ = self._prefix_index.popitem(last=False)
                            self._pending_evict.append(old_key)
            plan["admits"] = admits
        # decode: K steps for every slot that still has budgeted tokens to
        # dispatch. Keys are (seed, token_index)-derived per step, so the
        # stream is byte-identical at any K and replay-deterministic.
        K = self._decode_steps
        binding = {}
        S = self.n_slots
        temps = np.zeros((S,), np.float32)
        top_ks = np.full((S,), 50, np.int32)
        keys = np.zeros((K, S, 2), np.uint32)
        for i, r in enumerate(self._slots):
            if r is None:
                continue
            budget = min(r.params.max_tokens, self.max_len - len(r.prompt_ids))
            if r.disp_count >= budget:
                continue
            temps[i] = r.params.temperature
            top_ks[i] = r.params.top_k
            seed = r.params.seed & 0xFFFFFFFF
            base = r.disp_count
            for k in range(K):
                keys[k, i] = (seed, base + k)
            binding[i] = (r, base)
            r.disp_count += K
            if r.disp_count >= budget:
                # every budgeted token is now in flight: free the dispatch
                # slot for the next admission (the finish itself is applied
                # when the tokens land; stripe reuse is ordered after the
                # last decode program that reads it)
                self._slots[i] = None
        if binding:
            plan["decode"] = {"steps": K, "temps": temps, "top_ks": top_ks, "keys": keys}
            record["decode"] = {"binding": binding, "steps": K}
        if not plan:
            return None, None
        return plan, record

    def _start_admission(self, req: _GangRequest, slot: int):
        ids = req.prompt_ids
        C = self.chunk
        L = len(ids)
        # bucket-aligned strict-prefix length; an adapted request neither
        # reuses base-model KV (its V carries the adapter's delta) nor
        # stores its own
        m = C * ((L - 1) // C) if req.lora_idx == 0 else 0
        prefix_key = None
        store_key = None
        if m > 0:
            key = hashlib.sha1(np.asarray(ids[:m], np.int32).tobytes()).hexdigest()
            if self._prefix_index.get(key) == m:
                prefix_key = key
                self._prefix_index.move_to_end(key)
                req.prefix_hit_tokens = m
                self._prefix_hits += 1
            else:
                store_key = key
                self._prefix_misses += 1
        start = m if prefix_key is not None else 0
        chunks = []
        pos = start
        while pos < L:
            eff = min(C, L - pos)
            tok = np.zeros((1, C), np.int32)
            tok[0, :eff] = ids[pos : pos + eff]
            chunks.append({"tokens": tok, "eff": eff, "start": pos, "final": pos + eff >= L})
            pos += eff
        self._adms[slot] = {
            "req": req,
            "slot": slot,
            "chunks": chunks,
            "idx": 0,
            "prefix_key": prefix_key,
            "store_key": store_key,
            "store_m": m,
        }

    def _apply(self, record: dict, res: dict):
        """Account one fetched plan's sampled tokens, strictly in dispatch
        order. Requests that finished earlier (EOS/stop applied from a
        previous record) discard their over-decoded tail tokens."""
        admit_toks = res.get("admit_toks") or {}
        for a in record["admits"]:
            slot = a["slot"]
            if slot not in admit_toks:
                continue  # mid chunk: KV only, nothing to account
            req = a["req"]
            if req.finish_reason is not None:
                continue  # failed/finished while the chunk was in flight
            if req.first_token_t is None:
                req.first_token_t = time.time()
            if not self._process_token(req, int(admit_toks[slot])):
                # finished on its very first token: unbind the dispatch
                # view if no later admission already took the slot
                if self._slots[slot] is req:
                    self._slots[slot] = None
        dec = record.get("decode")
        if dec is not None and res.get("toks") is not None:
            toks = res["toks"]  # [K][S]
            n_applied: dict[int, int] = {}
            for k in range(dec["steps"]):
                for slot, (r, base) in dec["binding"].items():
                    if r.finish_reason is not None:
                        continue  # over-decoded tail: discard
                    n_applied[slot] = n_applied.get(slot, 0) + 1
                    if not self._process_token(r, int(toks[k][slot])):
                        if self._slots[slot] is r:
                            self._slots[slot] = None
            # pacing: a block of n tokens landed at once for each request;
            # the SSE drain spreads them over the observed block interval
            for slot, n in n_applied.items():
                dec["binding"][slot][0].pacer.note_block(n)

    def _process_token(self, req: _GangRequest, t: int) -> bool:
        """Account one sampled token; returns False when the request
        finished (replay-aware: regenerated tokens are not re-streamed)."""
        p = req.params
        idx = req.gen_count
        req.gen_count += 1
        eos = self.tokenizer.eos_id
        stop = set(p.stop_token_ids or ())
        if (t == eos and not p.ignore_eos) or t in stop:
            self._finish(req, "stop")
            return False
        req.last_token = t
        if idx >= len(req.out_tokens):
            req.out_tokens.append(t)
            req.stream_queue.put(t)
        if req.gen_count >= p.max_tokens:
            self._finish(req, "length")
            return False
        if len(req.prompt_ids) + req.gen_count >= self.max_len:
            self._finish(req, "length")
            return False
        return True

    def _finish(self, req: _GangRequest, reason: str):
        req.finish_reason = reason
        req.done_t = time.time()
        req.stream_queue.put(None)
        req.done.set()

    def _fail_request(self, req: _GangRequest, exc: BaseException):
        req.error = exc
        req.finish_reason = "error"
        req.stream_queue.put(None)
        req.done.set()

    # -- fault tolerance -----------------------------------------------------

    def _outstanding(self) -> list:
        """Every unfinished request the scheduler still owes tokens:
        dispatch-view slots, in-flight admissions, AND requests only
        referenced by undelivered run-ahead records (their slots were
        freed at dispatch when the budget filled). Queue NOT included."""
        seen: dict[int, _GangRequest] = {}
        for r in self._slots:
            if r is not None:
                seen[id(r)] = r
        for a in self._adms.values():
            seen[id(a["req"])] = a["req"]
        for record in self._inflight:
            for a in record["admits"]:
                seen[id(a["req"])] = a["req"]
            if record["decode"] is not None:
                for r, _ in record["decode"]["binding"].values():
                    seen[id(r)] = r
        return [r for r in seen.values() if r.finish_reason is None]

    def _fail_outstanding(self, err: BaseException):
        """Fail every request still owed tokens, queued ones included, so
        streaming consumers always get their sentinel."""
        live = self._outstanding()
        self._inflight.clear()
        self._slots = [None] * self.n_slots
        self._adms = OrderedDict()
        with self._cv:
            queued = list(self._queue)
            self._queue.clear()
        for r in live + [q for q in queued if q.finish_reason is None]:
            self._fail_request(r, err)

    def _do_rebuild(self, cause: Optional[BaseException] = None):
        """A rank died: the process group is broken for every survivor, so
        stop the whole gang, spawn a fresh one, load its adapters again,
        and replay the requests in flight (deterministic seeds make the
        replayed prefix byte-identical; already-streamed tokens are
        skipped)."""
        self._need_rebuild = False
        if self._stop:
            # shutdown() is reaping the gang: a failure here is the teardown
            # itself, not a death to recover from. Stranded requests must
            # still be failed, or their consumers block forever.
            self._fail_outstanding(cause or RuntimeError("gang shut down mid-request"))
            return
        live = self._outstanding()
        self._inflight.clear()
        self._rebuilds += 1
        self._slots = [None] * self.n_slots
        self._adms = OrderedDict()
        # the ranks' prefix stores died with the gang: reset the mirror
        self._prefix_index.clear()
        self._pending_stores = []
        self._pending_evict = []
        with self._lockstep:
            self._stop_gang(wait_s=0.0)
            try:
                self._spawn_gang()
            except Exception as e:  # noqa: BLE001 — the gang cannot come back
                self._fatal = e
                self._stop_gang(wait_s=0.0)
                with self._cv:
                    queued = list(self._queue)
                    self._queue.clear()
                for r in live + queued:
                    self._fail_request(r, e)
                return
        try:
            # the adapters come back before any plan reaches the new ranks
            for idx, weights in sorted(self._lora_weights.items()):
                self._ask_all({"op": "lora", "idx": idx, "weights": weights})
        except (_RankFailed, OSError):
            self._need_rebuild = True  # a rank died again: the loop rebuilds once more
        for r in live:
            # replay from the prompt; the emitted prefix is skipped on re-stream
            r.gen_count = 0
            r.disp_count = 0
        with self._cv:
            for r in sorted(live, key=lambda r: r.seq, reverse=True):
                self._queue.appendleft(r)
            self._cv.notify_all()

    # -- multi-LoRA ----------------------------------------------------------

    def add_lora(self, name: str, adapters: dict) -> int:
        """Load an adapter into a free stack slot on every rank and return
        the slot (``TorchEngine.add_lora``'s contract). ``adapters``:
        {wq_a: [L, e, r], wq_b: [L, r, h, hd], wv_a: [L, e, r],
        wv_b: [L, r, kv, hd]}, tensors or numpy arrays, whole (each rank
        cuts the B matrices to its heads)."""
        if self.lora_template is None:
            raise ValueError("engine built with max_loras=0")
        with self._lora_lock:
            if name in self._lora_slots:
                return self._lora_slots[name]
            free = [i for i in range(1, self.llm_config.engine.max_loras + 1)
                    if i not in self._lora_weights]
            if not free:
                raise RuntimeError(f"all {self.llm_config.engine.max_loras} LoRA slots in use")
            idx = free[0]
            weights = {k: a.detach().to("cpu", self.lora_template[k].dtype)
                       for k, a in adapter_tensors(name, adapters, self.lora_template).items()}
            self._lora_weights[idx] = weights  # a rebuild from here on reloads it
            try:
                self._control_call({"op": "lora", "idx": idx, "weights": weights})
            except BaseException:
                self._lora_weights.pop(idx, None)
                raise
            self._lora_slots[name] = idx
        return idx

    def remove_lora(self, name: str) -> None:
        with self._lora_lock:
            idx = self._lora_slots.pop(name, None)
            if idx is None:
                return
            try:
                self._control_call({"op": "lora", "idx": idx, "weights": None})
            finally:
                del self._lora_weights[idx]

    def list_loras(self) -> list[str]:
        return sorted(self._lora_slots)

    # -- OpenAI surface ------------------------------------------------------

    def _wait_unary(self, req: _GangRequest) -> None:
        if not req.done.wait(timeout=600):
            raise TimeoutError("gang generation timed out")
        if req.error is not None:
            raise req.error

    def completions(self, body: dict) -> dict:
        return self._front.completions(body)

    def chat(self, body: dict) -> dict:
        return self._front.chat(body)

    def tokens(self, req: _GangRequest) -> Iterator[int]:
        """The request's tokens as the scheduler emits them; multi-step
        bursts are paced into spaced emissions. Raises the request's error
        after the stream ends."""
        while True:
            tok = req.stream_queue.get()
            if tok is None:
                break
            req.pacer.gate(backlog=not req.stream_queue.empty())
            yield tok
        if req.error is not None:
            raise req.error

    def completions_stream(self, body: dict):
        """Generator of OpenAI ``text_completion`` chunk dicts, one per
        generated token."""
        return self._front.completions_stream(body)

    def chat_stream(self, body: dict):
        """Generator of OpenAI ``chat.completion.chunk`` dicts."""
        return self._front.chat_stream(body)

    def __call__(self, request) -> dict:
        """Direct-proxy entry (``ray_tpu/llm/gang.py:909-923``): a request
        with ``.path`` and ``.json()``; a gang can also sit behind an OpenAI
        router, which calls ``completions``/``chat`` itself."""
        path = request.path or ""
        if path.endswith("/models") or path.endswith("/model_info"):
            return self.model_info()
        try:
            body = request.json() or {}
        except Exception:  # noqa: BLE001 — any unparsable body is the client's error
            return {"error": {"message": "invalid JSON body", "code": 400}}
        if path.endswith("/chat/completions") or path.endswith("/chat"):
            return self.chat(body)
        if path.endswith("/completions"):
            return self.completions(body)
        return {"error": {"message": f"unknown route {path}", "code": 404}}

    # -- ops -----------------------------------------------------------------

    def model_info(self) -> dict:
        return {**self._front.model_info(), "gang": self.gang_info}

    def stats(self) -> dict:
        # active = unfinished requests the gang still owes tokens: the
        # dispatch-view slot table PLUS requests whose slot was freed at
        # dispatch but whose tokens still ride undelivered run-ahead
        # records. A lock-free snapshot racing the scheduler thread: counts
        # may be transiently stale (a monitoring surface).
        active: set = {id(r) for r in list(self._slots)
                       if r is not None and r.finish_reason is None}
        try:
            for rec in list(self._inflight):
                dec = rec.get("decode")
                if dec is not None:
                    for r, _ in dec["binding"].values():
                        if r.finish_reason is None:
                            active.add(id(r))
        except RuntimeError:  # deque mutated mid-iteration: keep the snapshot
            pass
        plan_ms = np.asarray(list(self._plan_ms) or [(0.0, 0.0)])
        return {
            "gang": self.gang_info,
            "num_workers": self.num_workers,
            "active_slots": len(active),
            "admitting": len(self._adms),
            "queued": len(self._queue),
            "inflight_plans": len(self._inflight),
            "max_inflight_seen": self._max_inflight_seen,
            "max_admissions_seen": self._max_admissions_seen,
            "decode_steps": self._decode_steps,
            "decode_runahead": self._decode_runahead,
            "max_concurrent_admissions": self._max_admissions,
            "prefix_hits": self._prefix_hits,
            "prefix_misses": self._prefix_misses,
            "rebuilds": self._rebuilds,
            # per applied plan, dispatch -> rank 0's reply (same host clock)
            # and rank 0's execution of it
            "plans_applied": len(self._plan_ms),
            "plan_roundtrip_ms_p50": float(np.percentile(plan_ms[:, 0], 50)),
            "plan_roundtrip_ms_mean": float(plan_ms[:, 0].mean()),
            "plan_exec_ms_mean": float(plan_ms[:, 1].mean()),
        }

    def plan_times(self) -> list:
        """Per applied plan, in order: (dispatch -> rank 0's reply, rank 0's
        execution of it) ms, one host clock."""
        return list(self._plan_ms)

    def check_health(self):
        """A dead rank triggers an IN-PLACE gang rebuild (the replica heals
        itself); only a gang that cannot come back reports unhealthy."""
        if self._fatal is not None:
            raise RuntimeError(f"gang is down: {self._fatal}")
        if any(not p.is_alive() for p in self.workers):
            with self._cv:
                self._need_rebuild = True
                self._cv.notify_all()

    def shutdown(self):
        self._stop = True
        # shutdown may run as __init__'s cleanup BEFORE the scheduler state
        # exists (a failed spawn): it must still reap the ranks
        if hasattr(self, "_cv"):
            with self._cv:
                self._cv.notify_all()
        thread = getattr(self, "_loop_thread", None)
        if thread is not None and thread is not threading.current_thread():
            # the loop re-checks _stop on every wake-up and every 0.1 s read
            thread.join(timeout=10.0)
        with self._lockstep:
            self._stop_gang(wait_s=10.0)


class GangEngine:
    """``TorchEngine``'s public surface (``generate``, ``generate_stream``,
    ``submit``/``drain``, the adapters, ``get_stats``, ``shutdown``) over a
    gang of tp x sp ranks on this host: what ``TorchEngine(config)`` is for
    a tensor- or sequence-parallel config, where the JAX engine serves it
    as one process over the host's devices. ``LLMServer`` serves it
    unchanged. ``loras`` holds the adapter stacks' shapes and dtype (meta
    tensors; the stacks live on the ranks), None at max_loras=0."""

    def __init__(self, gang: GangLLMServer):
        self.gang = gang
        self.config = gang.llm_config
        self.tokenizer = gang.tokenizer
        self.loras = gang.lora_template

    @property
    def _thread(self) -> threading.Thread:
        return self.gang._loop_thread

    def add_lora(self, name: str, adapters: dict) -> int:
        return self.gang.add_lora(name, adapters)

    def remove_lora(self, name: str) -> None:
        self.gang.remove_lora(name)

    def list_loras(self) -> list[str]:
        return self.gang.list_loras()

    def submit(self, prompt=None, *, prompt_token_ids=None, sampling_params=None,
               lora: Optional[str] = None) -> _GangRequest:
        if prompt_token_ids is None:
            if prompt is None:
                raise ValueError("prompt or prompt_token_ids required")
            prompt_token_ids = self.tokenizer.encode(prompt)
        # as TorchEngine: a prompt too long keeps its last max_seq_len - 1 tokens
        max_prompt = self.config.engine.max_seq_len - 1
        return self.gang.submit_ids(list(prompt_token_ids)[-max_prompt:],
                                    sampling_params or SamplingParams(), lora)

    def _await_done(self, req: _GangRequest) -> None:
        """``TorchEngine._await_done``: returns when the request has ended,
        a failure left on ``req.error`` (the scheduler fails every
        outstanding request on its way out, so a dead gang never hangs)."""
        if not req.done.wait(timeout=600):
            req.error = TimeoutError("gang generation timed out")

    def drain(self, req: _GangRequest) -> Iterator[dict]:
        for tok in self.gang.tokens(req):
            yield {"token_id": tok, "text": self.tokenizer.decode([tok]), "done": False}

    def generate(self, prompt=None, *, prompt_token_ids=None, sampling_params=None,
                 lora: Optional[str] = None) -> RequestOutput:
        req = self.submit(prompt, prompt_token_ids=prompt_token_ids,
                          sampling_params=sampling_params, lora=lora)
        self.gang._wait_unary(req)
        return RequestOutput(
            request_id=req.request_id,
            prompt_token_ids=req.prompt_ids,
            token_ids=list(req.out_tokens),
            text=self.tokenizer.decode(req.out_tokens),
            finish_reason=req.finish_reason or "stop",
            metrics={
                "ttft_s": (req.first_token_t or time.time()) - req.submitted_t,
                "num_generated": len(req.out_tokens),
                "prefix_hit_tokens": req.prefix_hit_tokens,
            },
        )

    def generate_stream(self, prompt=None, *, prompt_token_ids=None, sampling_params=None,
                        lora: Optional[str] = None) -> Iterator[dict]:
        """Yields {'token_id', 'text', 'done'} increments."""
        req = self.submit(prompt, prompt_token_ids=prompt_token_ids,
                          sampling_params=sampling_params, lora=lora)
        yield from self.drain(req)

    def get_stats(self) -> dict:
        return self.gang.stats()

    def shutdown(self):
        self.gang.shutdown()
