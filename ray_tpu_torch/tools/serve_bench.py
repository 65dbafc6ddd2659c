"""Serve on the card: an application of LLMServer replicas that each lease
half of the card, behind an ingress deployment and the HTTP proxy, through
the entry points a user calls.

    python -m ray_tpu_torch.tools.serve_bench          # the card: the smoke's serve_app part
    python -m ray_tpu_torch.tools.serve_bench --cpu    # rehearsal on the CPU, tiny model

``serve_app`` (``chip_smoke.py``'s serve_app phase runs it) deploys, with
``ray_tpu_torch.serve.run``:

- ``llm``: ``LLMServer(llm_config)``, ``ray_actor_options={"resources":
  {"GPU": 0.5}}``, ``AutoscalingConfig(min_replicas=1, max_replicas=2,
  target_ongoing_requests=4, upscale_delay_s=0, downscale_delay_s=30,
  metrics_interval_s=0.1)``: each replica a process leasing half of the
  card from the host's ledger and building one engine on it (``cuda:0``
  there);
- ``ingress`` (CPU, leasing nothing): ``Ingress(llm)``, which forwards a
  request's JSON body through its handle to ``LLMServer.completions``, or,
  for ``"stream": true``, to ``completions_stream`` as SSE (the handle in
  the ingress process goes through the driver's router);
- ``echo`` (CPU): ``Echo``, the framework's own round trip;

then ``start_proxy(port=0)``, and drives: a warm-up request; 20 echo round
trips through the handle and 20 over HTTP; 16 concurrent greedy HTTP
completions of 32 tokens (the burst that drives the upscale to 2
replicas); once the second replica is ready, calls through the ``llm``
handle until it has served one (at least 4), and 2 SSE streams over HTTP;
each replica's kernel counters, read in its own process before the
controller stops it; the downscale back to 1 replica; the remaining
replica's process killed, its replacement ready, and one more request.

Limits (``failed_checks``; any makes ``ok`` false): every text equal to
the expected text for its prompt (an SSE stream's chunks, joined, equal to
the per-token texts); in each replica every decode step a graph replay and
the RMSNorm launches since its baseline equal to what its engine's
counters give (2L+1 a step and a final prefill chunk, 2L a mid chunk);
targets 1 -> 2 -> 1 and two replicas ready at the peak; two leases of half
of card 0 at the peak and none after ``serve.shutdown()``; the killed
replica replaced and the next request answered. On the CPU (``--cpu``)
the replicas lease nothing and their counters stay 0; nothing there is a
device number.
"""

from __future__ import annotations

import http.client
import json
import os
import threading
import time

import numpy as np

from ray_tpu_torch import serve
from ray_tpu_torch._private.cards import default_ledger
from ray_tpu_torch._private.process_actor import get
from ray_tpu_torch.tools.tune_bench import LedgerWatch

BURST = 16
MAX_TOKENS = 32
ECHO_CALLS = 20
HANDLE_CALLS = 4
SSE_STREAMS = 2
AUTOSCALING = dict(min_replicas=1, max_replicas=2, target_ongoing_requests=4.0,
                   upscale_delay_s=0.0, downscale_delay_s=30.0, metrics_interval_s=0.1)


class Ingress:
    """The application's ingress: a request's JSON body to the LLM
    deployment's completions, or, with ``"stream": true``, its streamed
    completion as SSE events."""

    def __init__(self, llm):
        self.llm = llm

    def __call__(self, request):
        body = request.json()
        if body.get("stream"):
            return self._sse(body)
        return self.llm.completions.remote(body).result()

    def _sse(self, body):
        for chunk in self.llm.options(stream=True).completions_stream.remote(body):
            yield f"data: {json.dumps(chunk)}\n\n"
        yield "data: [DONE]\n\n"


class Echo:
    """Gives back what it gets: the framework's own round trip."""

    def __call__(self, x):
        return x.json() if hasattr(x, "json") else x


def replica_report() -> dict:
    """In a replica's process: its pid, kernel launch counters and peak
    device memory."""
    import torch

    from ray_tpu_torch.ops import launch_counts

    return {"pid": os.getpid(), "launches": launch_counts(),
            "peak_memory_gb": (torch.cuda.max_memory_allocated() / 1e9
                               if torch.cuda.is_available() else 0.0)}


def build_apps(llm_config, device=None):
    """(the LLM application, the echo application)."""
    from ray_tpu_torch.llm import LLMServer

    opts = None if device == "cpu" else {"resources": {"GPU": 0.5}}
    llm = serve.deployment(LLMServer, name="llm", max_ongoing_requests=32,
                           autoscaling_config=AUTOSCALING, ray_actor_options=opts,
                           health_check_period_s=1.0).bind(llm_config, device=device)
    app = serve.deployment(Ingress, name="ingress", max_ongoing_requests=64).bind(llm)
    echo = serve.deployment(Echo, name="echo", max_ongoing_requests=8).bind()
    return app, echo


def _post(port: int, body: dict, timeout: float = 600.0) -> tuple:
    """(status, reply JSON or SSE text, seconds to the first body byte, seconds)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    t0 = time.perf_counter()
    conn.request("POST", "/", body=json.dumps(body), headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    first = resp.read(1) if body.get("stream") else b""
    t_first = time.perf_counter() - t0
    data = first + resp.read()
    wall = time.perf_counter() - t0
    conn.close()
    out = data.decode("utf-8", "replace") if body.get("stream") else json.loads(data or b"null")
    return resp.status, out, t_first, wall


def _sse_text(raw: str) -> tuple[str, bool]:
    """(the stream's joined choice texts, whether it ended with [DONE])."""
    events = [e[len("data: "):] for e in raw.split("\n\n") if e.startswith("data: ")]
    done = bool(events) and events[-1] == "[DONE]"
    chunks = [json.loads(e) for e in events if e != "[DONE]"]
    return "".join(c["choices"][0]["text"] for c in chunks), done


def _wait(cond, timeout_s: float, what: str, poll_s: float = 0.05):
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > deadline:
            raise TimeoutError(f"serve_app: {what} within {timeout_s:.0f} s")
        time.sleep(poll_s)


def _ready_replicas(ctrl, name: str) -> list:
    return ctrl.get_replicas_versioned(name)[1]


def _counters(actor) -> dict:
    """A replica's kernel counters and its engine's stats, read in its process."""
    rep = get(actor.call(replica_report), timeout=60)
    rep["stats"] = get(actor.call("handle_request", "stats"), timeout=60)
    rep["info"] = get(actor.call("replica_info"), timeout=60)
    return rep


def _replica_row(base: dict, now: dict, n_layers: int, events: dict) -> dict:
    st = {k: now["stats"][k] - base["stats"][k]
          for k in ("decode_programs", "decode_steps", "decode_graph_replays",
                    "prefill_mid_chunks", "prefill_final_chunks")}
    n_norms = 2 * n_layers + 1
    expected = (n_norms * (st["decode_steps"] + st["prefill_final_chunks"])
                + (n_norms - 1) * st["prefill_mid_chunks"])
    start, ready = events.get("start"), events.get("ready")
    return {"pid": now["pid"],
            "startup_s": ready - start if start is not None and ready is not None else None,
            "engine_build_s": now["info"]["init_s"], "peak_memory_gb": now["peak_memory_gb"],
            "rmsnorm_launches": now["launches"]["rmsnorm"] - base["launches"]["rmsnorm"],
            "rmsnorm_launches_expected": expected, **st}


def serve_app(llm_config, prompts: list, want: dict, device=None) -> dict:
    """The application on the card (``device=None``) or the CPU; ``want``:
    each prompt's expected ``{"text", "stream_text"}`` at ``MAX_TOKENS``."""
    from ray_tpu_torch.serve import api

    on_card = device != "cpu"
    ledger = default_ledger()
    bad, texts = [], []
    t_phase = time.perf_counter()

    def body(p, **kw):
        return {"prompt": p, "max_tokens": MAX_TOKENS, "temperature": 0.0, "ignore_eos": True,
                **kw}

    def check_text(p, text, key="text"):
        texts.append(text == want[p][key])
        if text != want[p][key]:
            bad.append(f"text for {p[:12]!r} differs ({key}): {text!r} != {want[p][key]!r}")

    reports, rows = {}, []
    with LedgerWatch(ledger) as watch:
        app, echo = build_apps(llm_config, device)
        try:
            serve.run(app, name="llm-app", route_prefix="/")
            echo_h = serve.run(echo, name="echo", route_prefix="/echo")
            _, port = serve.start_proxy(port=0)
            ctrl = api._controller
            _wait(lambda: (len(_ready_replicas(ctrl, "llm")) == 1
                           and _ready_replicas(ctrl, "ingress") and _ready_replicas(ctrl, "echo")),
                  600, "the first replicas ready")
            first_ready_s = time.perf_counter() - t_phase
            name1, actor1 = _ready_replicas(ctrl, "llm")[0]
            base = {name1: _counters(actor1)}

            status, reply, _, warm_s = _post(port, body("warm up " * 4, max_tokens=8))
            if status != 200 or "choices" not in reply:
                raise RuntimeError(f"serve_app: the warm-up request failed: {status} {reply}")

            echo_handle_ms, echo_http_ms = [], []
            for i in range(ECHO_CALLS):
                t0 = time.perf_counter()
                if echo_h.remote({"i": i}).result(timeout_s=60) != {"i": i}:
                    bad.append("the echo handle gave another value")
                echo_handle_ms.append((time.perf_counter() - t0) * 1e3)
            for i in range(ECHO_CALLS):
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
                t0 = time.perf_counter()
                conn.request("POST", "/echo", body=json.dumps({"i": i}))
                resp = conn.getresponse()
                got = json.loads(resp.read())
                echo_http_ms.append((time.perf_counter() - t0) * 1e3)
                conn.close()
                if got != {"i": i}:
                    bad.append("the echo over HTTP gave another value")

            # the burst: 16 concurrent greedy completions over HTTP
            burst = prompts[:BURST]
            results = [None] * len(burst)

            def one(i):
                results[i] = _post(port, body(burst[i]))

            t_burst = time.perf_counter()
            threads = [threading.Thread(target=one, args=(i,)) for i in range(len(burst))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(600)
            burst_wall = time.perf_counter() - t_burst
            for p, r in zip(burst, results):
                if r is None or r[0] != 200 or "choices" not in r[1]:
                    bad.append(f"burst request failed: {r}")
                    continue
                check_text(p, r[1]["choices"][0]["text"])
            http_ms = np.asarray([r[3] * 1e3 for r in results if r is not None])

            # the upscale: a second replica, ready
            _wait(lambda: len(_ready_replicas(ctrl, "llm")) == 2, 180, "a second replica ready")
            second_ready_s = time.perf_counter() - t_burst
            (name2, actor2), = [(n, a) for n, a in _ready_replicas(ctrl, "llm") if n != name1]
            base[name2] = _counters(actor2)

            # calls through the handle until the second replica has served one
            llm_h = serve.get_deployment_handle("llm")
            second_reply_s, i = None, 0
            while i < HANDLE_CALLS or second_reply_s is None:
                if i >= 4 * HANDLE_CALLS:
                    bad.append("the second replica served none of the handle's calls")
                    break
                p = prompts[i % len(prompts)]
                check_text(p, llm_h.completions.remote(body(p)).result(timeout_s=600)
                           ["choices"][0]["text"])
                if second_reply_s is None and get(actor2.call("get_metrics"))["total"] > 0:
                    second_reply_s = time.perf_counter() - t_burst
                i += 1
            handle_calls = i

            # SSE streams over HTTP, at once
            streams = [None] * SSE_STREAMS
            sse_prompts = prompts[-SSE_STREAMS:]

            def stream(i):
                streams[i] = _post(port, body(sse_prompts[i], stream=True))

            threads = [threading.Thread(target=stream, args=(i,)) for i in range(SSE_STREAMS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(600)
            ttft_ms = []
            for p, s in zip(sse_prompts, streams):
                if s is None or s[0] != 200:
                    bad.append(f"SSE stream failed: {s}")
                    continue
                text, done = _sse_text(s[1])
                if not done:
                    bad.append("an SSE stream did not end with [DONE]")
                check_text(p, text, "stream_text")
                ttft_ms.append(s[2] * 1e3)

            # each replica's counters, read in its process before any stop
            peak_replicas = len(_ready_replicas(ctrl, "llm"))
            for name, actor in ((name1, actor1), (name2, actor2)):
                reports[name] = (base[name], _counters(actor))

            # the downscale back to one replica
            t_down = time.perf_counter()
            _wait(lambda: ctrl.get_replica_names("llm") and len(ctrl.get_replica_names("llm")) == 1,
                  120, "the downscale to one replica", poll_s=0.1)
            downscale_wait_s = time.perf_counter() - t_down
            (name_k, actor_k), = ctrl.replicas("llm").items()

            # one replica's process killed, its replacement ready, one more request
            t_kill = time.perf_counter()
            os.kill(actor_k.pid, 9)
            _wait(lambda: any(n not in (name1, name2) for n, _ in _ready_replicas(ctrl, "llm")),
                  600, "the killed replica replaced")
            replace_s = time.perf_counter() - t_kill
            (name3, actor3), = _ready_replicas(ctrl, "llm")
            base[name3] = _counters(actor3)
            status, reply, _, _ = _post(port, body(prompts[0]))
            if status != 200 or "choices" not in reply:
                bad.append(f"the request after the replacement failed: {status} {reply}")
            else:
                check_text(prompts[0], reply["choices"][0]["text"])
            reports[name3] = (base[name3], _counters(actor3))

            n_layers = llm_config_layers(llm_config)
            starts = {e[3]["replica"]: e[0] for e in ctrl.events
                      if e[1] == "llm" and e[2] == "start"}
            readies = {e[3]["replica"]: e[0] for e in ctrl.events
                       if e[1] == "llm" and e[2] == "ready"}
            targets = [1] + [e[3]["to"] for e in ctrl.events if e[1] == "llm" and e[2] == "target"]
            for name, (b, n) in reports.items():
                rows.append({"replica": name, **_replica_row(
                    b, n, n_layers, {"start": starts.get(name), "ready": readies.get(name)})})
        finally:
            serve.shutdown()
    holders_after = [str(h) for h in ledger.holders()]
    phase_s = time.perf_counter() - t_phase

    for r in rows:
        if on_card and r["decode_graph_replays"] != r["decode_steps"]:
            bad.append(f"{r['replica']}: a decode step was no graph replay")
        want_launches = r["rmsnorm_launches_expected"] if on_card else 0
        if r["rmsnorm_launches"] != want_launches:
            bad.append(f"{r['replica']}: rmsnorm launches {r['rmsnorm_launches']} != "
                       f"{want_launches}")
    if targets[:3] != [1, 2, 1] or peak_replicas != 2:
        bad.append(f"targets {targets}, {peak_replicas} replicas at the peak: not 1 -> 2 -> 1")
    name = "serve replica serve:llm#"
    llm_holdings = sorted({(json.dumps(h.gpu, sort_keys=True), h.cpu)
                           for hs in watch.seen for h in hs if name in h.name})
    most = max((sum(name in h.name for h in hs) for hs in watch.seen), default=0)
    if on_card and (most != 2 or llm_holdings != [(json.dumps({"0": 0.5}), 0.0)]):
        bad.append(f"not two leases of half of card 0 at the peak: {most}, {llm_holdings}")
    if holders_after:
        bad.append(f"leases left: {holders_after}")
    out_tokens = BURST * MAX_TOKENS
    return {
        "part": "serve_app", "device": device or "cuda", "phase_s": phase_s,
        "first_replica_ready_s": first_ready_s, "warmup_s": warm_s,
        "burst_requests": BURST, "max_tokens": MAX_TOKENS, "burst_wall_s": burst_wall,
        "out_tok_per_s": out_tokens / burst_wall,
        "http_ms_p50": float(np.percentile(http_ms, 50)) if len(http_ms) else None,
        "http_ms_p99": float(np.percentile(http_ms, 99)) if len(http_ms) else None,
        "sse_ttft_ms_p50": float(np.percentile(ttft_ms, 50)) if ttft_ms else None,
        "sse_ttft_ms_p99": float(np.percentile(ttft_ms, 99)) if ttft_ms else None,
        "echo_handle_ms_p50": float(np.percentile(echo_handle_ms, 50)),
        "echo_http_ms_p50": float(np.percentile(echo_http_ms, 50)),
        "burst_to_second_ready_s": second_ready_s, "burst_to_second_reply_s": second_reply_s,
        "handle_calls": handle_calls, "downscale_wait_s": downscale_wait_s,
        "replace_s": replace_s, "targets": targets, "peak_replicas": peak_replicas,
        "texts_equal": sum(texts), "texts": len(texts),
        "most_llm_leases_held": most, "llm_holdings": llm_holdings,
        "holders_after": holders_after, "replicas": rows,
        "launches": {"rmsnorm": sum(r["rmsnorm_launches"] for r in rows)},
        "ok": not bad, "failed_checks": bad,
    }


def llm_config_layers(llm_config) -> int:
    """The model's depth as the engine resolves it."""
    from ray_tpu_torch.llm.config import resolve_llama_config

    return resolve_llama_config(llm_config.model, llm_config.engine).n_layers


def expected_texts(tokens_by_prompt: dict, prompts: list, tokenizer) -> dict:
    """Each prompt's expected text and SSE text at ``MAX_TOKENS`` tokens,
    from greedy token ids of at least that many (keyed by prompt token ids)."""
    out = {}
    for p in prompts:
        toks = tokens_by_prompt[tuple(tokenizer.encode(p))][:MAX_TOKENS]
        out[p] = {"text": tokenizer.decode(toks),
                  "stream_text": "".join(tokenizer.decode([t]) for t in toks)}
    return out


def card_llm_config():
    """The smoke's serve phase's engine: llama3.2-3b at full width and
    depth, seeded bf16 weights, the fused RMSNorm, 16 slots x 1024."""
    from ray_tpu_torch.llm import EngineConfig, LLMConfig, ModelConfig

    return LLMConfig(
        model=ModelConfig(model_id="llama3.2-3b", tokenizer="byte", seed=0,
                          model_kwargs={"fused_rmsnorm": True}),
        engine=EngineConfig(max_num_seqs=16, max_seq_len=1024,
                            prefill_buckets=(32, 64, 128, 256, 512, 1024), prefill_chunk=256,
                            decode_steps=8, decode_runahead=1))


def serve_prompts() -> list:
    """The smoke's serve phase's 16 distinct ~100-byte prompts."""
    prompts = [f"Request {i:02d}: " + "write a short note about serving a model on one card. " * 2
               for i in range(16)]
    return [p[:100] for p in prompts]


def main(argv=None) -> int:
    import argparse

    from ray_tpu_torch.llm import EngineConfig, LLMConfig, ModelConfig, SamplingParams, TorchEngine
    from ray_tpu_torch.tools.decode_profile import card

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="CPU replicas, tiny model")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None
    smi = "cpu (rehearsal)" if args.cpu else card()
    if args.cpu:
        llm = LLMConfig(model=ModelConfig(model_id="tiny", tokenizer="byte", seed=0),
                        engine=EngineConfig(max_num_seqs=16, max_seq_len=128,
                                            prefill_buckets=(32, 64, 128), dtype="float32"))
    else:
        llm = card_llm_config()
    prompts = serve_prompts()
    # the expected tokens: one engine in this process, the prompts together
    eng = TorchEngine(llm, device=device)
    try:
        reqs = [eng.submit(p, sampling_params=SamplingParams(
            max_tokens=MAX_TOKENS, temperature=0.0, ignore_eos=True)) for p in prompts]
        for r in reqs:
            r.done.wait(600)
        tokens = {tuple(eng.tokenizer.encode(p)): r.out_tokens for p, r in zip(prompts, reqs)}
        want = expected_texts(tokens, prompts, eng.tokenizer)
    finally:
        eng.shutdown()
        del eng
    if not args.cpu:
        import torch

        torch.cuda.empty_cache()
    out = serve_app(llm, prompts, want, device=device)
    print(json.dumps({**out, "card": smi}, default=str), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
