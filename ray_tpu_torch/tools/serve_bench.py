"""Serve on the card: an application of LLMServer replicas that each lease
half of the card, behind an ingress deployment and the HTTP proxy, through
the entry points a user calls; and the OpenAI app, an ASGI ingress and a
gang deployment.

    python -m ray_tpu_torch.tools.serve_bench          # the card: the smoke's serve_app part
    python -m ray_tpu_torch.tools.serve_bench --cpu    # rehearsal on the CPU, tiny model
    python -m ray_tpu_torch.tools.serve_bench --part openai_app [--cpu]   # the openai_app part

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

``openai_app`` (the smoke's openai_app phase) runs, in order:

- (a) ``serve.schema.deploy`` of one application whose ``import_path`` is
  ``openai_builder``: ``build_openai_app`` of the same engine config with
  one replica of ``{"GPU": 0.5}``, and one override (``openai-router``'s
  ``num_replicas: 2``, which ``status()`` then shows). Through
  ``start_proxy``: ``/v1/models``; 16 concurrent greedy ``/v1/completions``
  of 32 tokens; one ``/v1/chat/completions``; two SSE streams at once, a
  completion and the same chat; a request for an unknown model;
- (b) an ASGI ingress (``AsgiApi``, a CPU process leasing nothing, at
  ``/api``) serving ``make_asgi_app``'s routes, among them ``/generate``,
  which calls the LLM deployment's handle off the app's event loop;
- (c) after (a)'s application is deleted (its lease with it),
  ``build_gang_deployment(num_workers=1)``: one rank process leasing the
  card, spawned by the replica; 16 concurrent completions through the
  gang's own entry (``GangLLMServer.__call__``, at ``/gang``); the
  replica's process killed, a new gang ready, one more request.

Its limits: every completion's text equal to the expected text for its
prompt (a streamed completion's chunks, joined, to the per-token texts),
``/api/generate``'s too, the chat's equal to its own stream's; in the LLM
replica and in each gang's rank every decode step a graph replay and the
RMSNorm launches equal to what the engine's counters give; the router
override applied; no lease held, no ``serve:`` process and no rank left
after ``serve.shutdown()``.

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

import asyncio
import dataclasses
import http.client
import json
import multiprocessing
import os
import signal
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


def make_asgi_app(generate=None):
    """A plain ASGI app standing in for FastAPI (installed on neither
    machine): path parameters, a middleware, JSON, streamed, disconnect-
    guarded and bodiless routes, a header echoing its input, the lifespan's
    state; with ``generate`` (a blocking function of a JSON body), a
    ``POST /generate`` route that runs it off the event loop."""

    async def app(scope, receive, send):
        if scope["type"] == "lifespan":
            while True:
                msg = await receive()
                if msg["type"] == "lifespan.startup":
                    scope.get("state", {})["from_lifespan"] = "db-pool"
                await send({"type": f"{msg['type']}.complete"})
                if msg["type"] == "lifespan.shutdown":
                    return
        path = scope["path"]
        if path == "/state":
            await _json_resp(send, 200, {"state": scope.get("state", {}).get("from_lifespan")})
            return
        if path == "/nobody":
            # 204 goes out with no chunk framing, or the next request on
            # this kept-alive connection desyncs
            await send({"type": "http.response.start", "status": 204,
                        "headers": [(b"x-deleted", b"yes")]})
            await send({"type": "http.response.body", "body": b""})
            return
        if path == "/redirect":
            # echoes its (decoded) query into a header: CR/LF must not
            # reach the wire
            from urllib.parse import unquote

            target = unquote(scope["query_string"].decode())
            await send({"type": "http.response.start", "status": 302,
                        "headers": [(b"location", target.encode())]})
            await send({"type": "http.response.body", "body": b""})
            return
        if path == "/guarded-stream":
            # Starlette's StreamingResponse shape: a listen_for_disconnect
            # task races the stream
            disconnect = asyncio.ensure_future(_wait_disconnect(receive))
            try:
                await send({"type": "http.response.start", "status": 200,
                            "headers": [(b"content-type", b"text/plain")]})
                for i in range(4):
                    if disconnect.done():
                        return  # the client went: a truncated stream
                    await send({"type": "http.response.body", "body": f"g{i};".encode(),
                                "more_body": True})
                    await asyncio.sleep(0.01)
                await send({"type": "http.response.body", "body": b"gend"})
            finally:
                disconnect.cancel()
            return
        if path.startswith("/items/"):
            item_id = path.split("/")[2]
            if not item_id.isdigit():
                await _json_resp(send, 422, {"error": "item_id must be int"})
                return
            await _json_resp(send, 200, {"item_id": int(item_id),
                                         "q": scope["query_string"].decode()})
            return
        if path == "/echo" and scope["method"] == "POST":
            await _json_resp(send, 200, {"len": len(await _read_body(receive))})
            return
        if path == "/stream":
            await send({"type": "http.response.start", "status": 200,
                        "headers": [(b"content-type", b"text/plain")]})
            for i in range(4):
                await send({"type": "http.response.body", "body": f"part{i};".encode(),
                            "more_body": True})
                await asyncio.sleep(0.01)
            await send({"type": "http.response.body", "body": b"end"})
            return
        if path == "/generate" and generate is not None and scope["method"] == "POST":
            body = json.loads(await _read_body(receive))
            out = await asyncio.get_running_loop().run_in_executor(None, generate, body)
            await _json_resp(send, 200, out)
            return
        await _json_resp(send, 404, {"error": "not found"})

    def middleware(inner):
        """Stamps a header on every response: the whole ASGI chain runs."""

        async def wrapped(scope, receive, send):
            if scope["type"] != "http":
                await inner(scope, receive, send)
                return

            async def send2(message):
                if message["type"] == "http.response.start":
                    message = dict(message)
                    message["headers"] = list(message.get("headers") or []) + [
                        (b"x-middleware", b"on")]
                await send(message)

            await inner(scope, receive, send2)

        return wrapped

    return middleware(app)


async def _json_resp(send, status, obj):
    body = json.dumps(obj).encode()
    await send({"type": "http.response.start", "status": status,
                "headers": [(b"content-type", b"application/json")]})
    await send({"type": "http.response.body", "body": body})


async def _read_body(receive) -> bytes:
    body = b""
    while True:
        msg = await receive()
        body += msg.get("body", b"")
        if not msg.get("more_body"):
            return body


async def _wait_disconnect(receive):
    while (await receive())["type"] != "http.disconnect":
        pass


# in an AsgiApi replica: the handle /generate calls
_GENERATE: dict = {}


def _generate(body: dict) -> dict:
    return _GENERATE["handle"].completions.remote(body).result(timeout_s=600)


@serve.ingress(make_asgi_app(generate=_generate))
class AsgiApi:
    """The ASGI ingress: ``make_asgi_app``'s routes, ``/generate`` going to
    the LLM deployment named ``llm_deployment`` through its handle."""

    def __init__(self, llm_deployment=None):
        if llm_deployment is not None:
            _GENERATE["handle"] = serve.get_deployment_handle(llm_deployment)


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


def _post(port: int, body: dict, timeout: float = 600.0, path: str = "/") -> tuple:
    """(status, reply JSON or SSE text, seconds to the first body byte, seconds)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    t0 = time.perf_counter()
    conn.request("POST", path, body=json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    first = resp.read(1) if body.get("stream") else b""
    t_first = time.perf_counter() - t0
    data = first + resp.read()
    wall = time.perf_counter() - t0
    conn.close()
    out = data.decode("utf-8", "replace") if body.get("stream") else json.loads(data or b"null")
    return resp.status, out, t_first, wall


def _sse_text(raw: str) -> tuple[str, bool]:
    """(the stream's joined choice texts, or a chat stream's joined delta
    contents, and whether it ended with [DONE])."""
    events = [e[len("data: "):] for e in raw.split("\n\n") if e.startswith("data: ")]
    done = bool(events) and events[-1] == "[DONE]"
    chunks = [json.loads(e) for e in events if e != "[DONE]"]
    return "".join(c["choices"][0]["text"] if "text" in c["choices"][0]
                   else c["choices"][0]["delta"].get("content", "") for c in chunks), done


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


ROUTER_REPLICAS = 2  # the deploy config's override of openai-router's num_replicas
GANG_BUCKETS = (128, 256, 512, 1024)


def rehearsal_llm_config():
    """The CPU rehearsal's engine: the tiny model, fp32, 16 slots x 128."""
    from ray_tpu_torch.llm import EngineConfig, LLMConfig, ModelConfig

    return LLMConfig(model=ModelConfig(model_id="tiny", tokenizer="byte", seed=0),
                     engine=EngineConfig(max_num_seqs=16, max_seq_len=128,
                                         prefill_buckets=(32, 64, 128), dtype="float32"))


def openai_builder(args: dict):
    """``schema.deploy``'s ``import_path`` target: ``build_openai_app`` of
    the card's engine config (``{"cpu": true}``: the rehearsal's, on the
    CPU), one LLM replica of ``{"GPU": 0.5}`` (on the CPU: leasing
    nothing)."""
    from ray_tpu_torch.llm import build_openai_app

    cpu = bool(args.get("cpu"))
    cfg = rehearsal_llm_config() if cpu else card_llm_config()
    cfg = dataclasses.replace(cfg, num_replicas=1,
                              ray_actor_options=None if cpu else {"resources": {"GPU": 0.5}})
    return build_openai_app(cfg, device="cpu" if cpu else None)


def gang_llm_config(llm_config):
    """The gang's config: the same engine with prefill buckets from 128, so
    that its prefill chunk (the smallest bucket) pads a ~100-token prompt
    to the width the engine pads it to, and greedy tokens meet."""
    return dataclasses.replace(llm_config, engine=dataclasses.replace(
        llm_config.engine, prefill_buckets=tuple(
            b for b in GANG_BUCKETS if b <= llm_config.engine.max_seq_len)))


def _gang_row(counts: list, n_layers: int) -> dict:
    """The gang's one rank's RMSNorm launches since its reset and what its
    program counters give."""
    (rank,) = counts
    prog = rank["programs"]
    n_norms = 2 * n_layers + 1
    expected = (n_norms * (prog["decode_steps"] + prog["prefill_final_chunks"])
                + (n_norms - 1) * prog["prefill_mid_chunks"])
    return {"rmsnorm_launches": rank["launches"].get("rmsnorm", 0),
            "rmsnorm_launches_expected": expected,
            **{k: prog[k] for k in ("decode_programs", "decode_steps", "decode_graph_replays",
                                    "prefill_mid_chunks", "prefill_final_chunks")}}


def openai_app(llm_config, prompts: list, want: dict, device=None) -> dict:
    """The OpenAI app through a declarative deploy, an ASGI ingress and a
    gang deployment, on the card (``device=None``) or the CPU; ``want``:
    each prompt's expected ``{"text", "stream_text"}`` at ``MAX_TOKENS``
    (for ``llm_config``, which must be ``openai_builder``'s)."""
    from ray_tpu_torch._private.spawn_env import _group_members
    from ray_tpu_torch.llm import build_gang_deployment
    from ray_tpu_torch.serve import api, schema

    on_card = device != "cpu"
    ledger = default_ledger()
    served = llm_config.served_name
    llm_name, gang_name = f"llm:{served}", f"gang:{served}"
    n_layers = llm_config_layers(llm_config)
    bad, texts = [], []
    t_phase = time.perf_counter()

    def body(p, **kw):
        return {"model": served, "prompt": p, "max_tokens": MAX_TOKENS, "temperature": 0.0,
                "ignore_eos": True, **kw}

    def check_text(p, text, key="text", where=""):
        texts.append(text == want[p][key])
        if text != want[p][key]:
            bad.append(f"{where} text for {p[:12]!r} differs ({key}): {text!r} != "
                       f"{want[p][key]!r}")

    def burst(port, path):
        results = [None] * BURST

        def one(i):
            results[i] = _post(port, body(prompts[i]), path=path)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=one, args=(i,)) for i in range(BURST)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t0
        for p, r in zip(prompts, results):
            if r is None or r[0] != 200 or "choices" not in r[1]:
                bad.append(f"{path}: a burst request failed: {r}")
                continue
            check_text(p, r[1]["choices"][0]["text"], where=path)
        return wall, np.asarray([r[3] * 1e3 for r in results if r is not None])

    gang_pids, rows, gang_rows, out = [], [], [], {}
    with LedgerWatch(ledger) as watch:
        try:
            # (a) + (b): deployed together, so that their processes start at once
            deployed = schema.deploy({"applications": [{
                "name": "openai", "route_prefix": "/",
                "import_path": "ray_tpu_torch.tools.serve_bench:openai_builder",
                "args": {"cpu": not on_card},
                "deployments": [{"name": "openai-router", "num_replicas": ROUTER_REPLICAS}]}]})
            serve.run(serve.deployment(AsgiApi, name="asgi", max_ongoing_requests=16)
                      .bind(llm_name), name="asgi", route_prefix="/api")
            _, port = serve.start_proxy(port=0)
            ctrl = api._controller
            _wait(lambda: (len(_ready_replicas(ctrl, llm_name)) == 1
                           and len(_ready_replicas(ctrl, "openai-router")) == ROUTER_REPLICAS
                           and _ready_replicas(ctrl, "asgi")), 600, "the apps' replicas ready")
            out["first_ready_s"] = time.perf_counter() - t_phase
            router_status = schema.status()["applications"]["openai"]["deployments"][
                "openai-router"]
            if (deployed != ["openai"] or router_status["target"] != ROUTER_REPLICAS
                    or router_status["replicas"] != ROUTER_REPLICAS):
                bad.append(f"the deploy's override is not in status(): {router_status}")
            (llm_replica, llm_actor), = _ready_replicas(ctrl, llm_name)
            base = _counters(llm_actor)

            status, reply, _, out["warmup_s"] = _post(port, body("warm up " * 4, max_tokens=8),
                                                      path="/v1/completions")
            if status != 200 or "choices" not in reply:
                raise RuntimeError(f"openai_app: the warm-up request failed: {status} {reply}")
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            conn.request("GET", "/v1/models")
            models = json.loads(conn.getresponse().read())
            conn.close()
            if [m["id"] for m in models.get("data", [])] != [served]:
                bad.append(f"/v1/models: {models}")

            wall, http_ms = burst(port, "/v1/completions")
            out.update(burst_wall_s=wall, out_tok_per_s=BURST * MAX_TOKENS / wall,
                       http_ms_p50=float(np.percentile(http_ms, 50)) if len(http_ms) else None,
                       http_ms_p99=float(np.percentile(http_ms, 99)) if len(http_ms) else None)

            chat = {"model": served, "messages": [{"role": "user", "content": prompts[0]}],
                    "max_tokens": MAX_TOKENS, "temperature": 0.0, "ignore_eos": True}
            status, reply, _, _ = _post(port, chat, path="/v1/chat/completions")
            chat_text = (reply["choices"][0]["message"]["content"]
                         if status == 200 and "choices" in reply else None)
            if chat_text is None or reply["object"] != "chat.completion":
                bad.append(f"the chat completion failed: {status} {reply}")
            # two SSE streams at once: a completion and the same chat
            sse_prompt = prompts[-1]
            streams = [None, None]
            jobs = [(body(sse_prompt, stream=True), "/v1/completions"),
                    ({**chat, "stream": True}, "/v1/chat/completions")]

            def stream(i):
                streams[i] = _post(port, jobs[i][0], path=jobs[i][1])

            threads = [threading.Thread(target=stream, args=(i,)) for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(600)
            for (_, path), st in zip(jobs, streams):
                if st is None or st[0] != 200:
                    bad.append(f"the SSE stream of {path} failed: {st}")
                    continue
                text, done = _sse_text(st[1])
                if not done:
                    bad.append(f"the SSE stream of {path} did not end with [DONE]")
                if path == "/v1/completions":
                    check_text(sse_prompt, text, "stream_text", where="SSE")
                    out["sse_ttft_ms"] = st[2] * 1e3
                elif text != chat_text:
                    bad.append(f"the chat's SSE text {text!r} != its unary text {chat_text!r}")
            status, reply, _, _ = _post(port, {**body(prompts[0]), "model": "no-such-model"},
                                        path="/v1/completions")
            if status != 200 or reply.get("error", {}).get("code") != 404:
                bad.append(f"an unknown model's reply: {status} {reply}")

            # (b) the ASGI ingress
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            conn.request("GET", "/api/items/7?q=x")
            resp = conn.getresponse()
            item = json.loads(resp.read())
            conn.request("GET", "/api/stream")
            resp2 = conn.getresponse()
            streamed = resp2.read()
            conn.close()
            if (resp.status, item, resp.getheader("x-middleware")) != (
                    200, {"item_id": 7, "q": "q=x"}, "on") or streamed != (
                    b"part0;part1;part2;part3;end"):
                bad.append(f"the ASGI routes: {resp.status} {item} {streamed!r}")
            status, reply, _, out["asgi_generate_s"] = _post(port, body(prompts[1]),
                                                            path="/api/generate")
            if status != 200 or "choices" not in reply:
                bad.append(f"/api/generate failed: {status} {reply}")
            else:
                check_text(prompts[1], reply["choices"][0]["text"], where="/api/generate")

            now = _counters(llm_actor)
            starts = {e[3]["replica"]: e[0] for e in ctrl.events if e[2] == "start"}
            readies = {e[3]["replica"]: e[0] for e in ctrl.events if e[2] == "ready"}
            rows.append({"replica": llm_replica, **_replica_row(
                base, now, n_layers, {"start": starts.get(llm_replica),
                                      "ready": readies.get(llm_replica)})})

            # (c) the gang, once the LLM replica has stopped (its lease with it)
            serve.delete("openai")
            _wait(lambda: not any(llm_name in h.name for h in ledger.holders()), 60,
                  "the LLM replica's lease released")
            t_gang = time.perf_counter()
            serve.run(build_gang_deployment(gang_llm_config(llm_config), num_workers=1,
                                            device=device), name="gang", route_prefix="/gang")
            _wait(lambda: _ready_replicas(ctrl, gang_name), 600, "the gang replica ready")
            out["gang_ready_s"] = time.perf_counter() - t_gang
            (g1, gactor1), = _ready_replicas(ctrl, gang_name)
            gang_pids.append(gactor1.pid)
            info = get(gactor1.call("handle_request", "model_info"), timeout=60)["gang"]
            out["gang_rank_startup_s"] = info["rank_startup_s"]
            get(gactor1.call("handle_request", "rank_counts", True), timeout=120)
            wall, _ = burst(port, "/gang/v1/completions")
            out.update(gang_burst_wall_s=wall, gang_out_tok_per_s=BURST * MAX_TOKENS / wall)
            gang_rows.append({"replica": g1, **_gang_row(
                get(gactor1.call("handle_request", "rank_counts"), timeout=120), n_layers)})

            # the gang's replica killed: its rank ends with its process group,
            # its lease with it, and a new gang takes its place
            ranks = set(_group_members(gactor1.pid)) - {gactor1.pid}
            t_kill = time.perf_counter()
            os.kill(gactor1.pid, signal.SIGKILL)
            _wait(lambda: not _group_members(gactor1.pid), 60, "the killed gang's rank gone")
            out["gang_kill_ranks_gone_s"] = time.perf_counter() - t_kill
            _wait(lambda: not any(h.pid in ranks for h in ledger.holders()), 60,
                  "the killed gang's rank's lease free")
            out["gang_kill_leases_free_s"] = time.perf_counter() - t_kill
            _wait(lambda: any(n != g1 for n, _ in _ready_replicas(ctrl, gang_name)), 600,
                  "the killed gang replaced")
            out["gang_replace_s"] = time.perf_counter() - t_kill
            (g2, gactor2), = _ready_replicas(ctrl, gang_name)
            gang_pids.append(gactor2.pid)
            if _group_members(gactor1.pid):
                bad.append(f"the killed gang's processes are alive: {_group_members(gactor1.pid)}")
            get(gactor2.call("handle_request", "rank_counts", True), timeout=120)
            status, reply, _, _ = _post(port, body(prompts[2]), path="/gang/v1/completions")
            if status != 200 or "choices" not in reply:
                bad.append(f"the request to the new gang failed: {status} {reply}")
            else:
                check_text(prompts[2], reply["choices"][0]["text"], where="the new gang")
            gang_rows.append({"replica": g2, **_gang_row(
                get(gactor2.call("handle_request", "rank_counts"), timeout=120), n_layers)})
            starts = {e[3]["replica"]: e[0] for e in ctrl.events if e[2] == "start"}
            readies = {e[3]["replica"]: e[0] for e in ctrl.events if e[2] == "ready"}
            for r in gang_rows:
                r["startup_s"] = readies[r["replica"]] - starts[r["replica"]]
        finally:
            t_shutdown = time.perf_counter()
            serve.shutdown()
            out["shutdown_s"] = time.perf_counter() - t_shutdown
    holders_after = [str(h) for h in ledger.holders()]
    left = [p.pid for p in multiprocessing.active_children()
            if p.name.startswith("serve:")] + [q for pid in gang_pids for q in _group_members(pid)]

    for r in rows + gang_rows:
        if on_card and r["decode_graph_replays"] != r["decode_steps"]:
            bad.append(f"{r['replica']}: a decode step was no graph replay")
        want_launches = r["rmsnorm_launches_expected"] if on_card else 0
        if r["rmsnorm_launches"] != want_launches:
            bad.append(f"{r['replica']}: rmsnorm launches {r['rmsnorm_launches']} != "
                       f"{want_launches}")
    name = "serve replica serve:llm:"
    llm_holdings = sorted({(json.dumps(h.gpu, sort_keys=True), h.cpu)
                           for hs in watch.seen for h in hs if name in h.name})
    gang_holdings = sorted({(json.dumps(h.gpu, sort_keys=True), h.cpu)
                            for hs in watch.seen for h in hs if "GPU ranks" in h.name})
    if on_card and (llm_holdings != [(json.dumps({"0": 0.5}), 0.0)]
                    or gang_holdings != [(json.dumps({"0": 1.0}), 0.0)]):
        bad.append(f"not half of card 0 for the LLM replica and card 0 for the gang's rank: "
                   f"{llm_holdings}, {gang_holdings}")
    if holders_after:
        bad.append(f"leases left: {holders_after}")
    if left:
        bad.append(f"processes left: {left}")
    return {
        "part": "openai_app", "device": device or "cuda", "phase_s": time.perf_counter() - t_phase,
        "burst_requests": BURST, "max_tokens": MAX_TOKENS, **out,
        "texts_equal": sum(texts), "texts": len(texts), "router_replicas": ROUTER_REPLICAS,
        "llm_holdings": llm_holdings, "gang_holdings": gang_holdings,
        "holders_after": holders_after, "processes_left": left,
        "replicas": rows, "gangs": gang_rows,
        "launches": {"openai_app": sum(r["rmsnorm_launches"] for r in rows),
                     "gang_app": sum(r["rmsnorm_launches"] for r in gang_rows)},
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

    from ray_tpu_torch.llm import SamplingParams, TorchEngine
    from ray_tpu_torch.tools.decode_profile import card

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="CPU replicas, tiny model")
    ap.add_argument("--part", choices=("serve_app", "openai_app", "both"), default="serve_app")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None
    smi = "cpu (rehearsal)" if args.cpu else card()
    llm = rehearsal_llm_config() if args.cpu else card_llm_config()
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
    ok = True
    for part, fn in (("serve_app", serve_app), ("openai_app", openai_app)):
        if args.part in (part, "both"):
            out = fn(llm, prompts, want, device=device)
            print(json.dumps({**out, "card": smi}, default=str), flush=True)
            ok = ok and out["ok"]
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
