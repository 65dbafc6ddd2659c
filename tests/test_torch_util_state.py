"""``ray_tpu_torch.util``'s pubsub, metrics, tracing and state API against
the JAX package's (the thread-mode runtime), on the CPU: the mirrors of
``tests/test_platform.py:19-97`` (the state lists, the timeline, spans, the
metrics' Prometheus text, byte for byte) and ``:352`` (pubsub's actor and
node events and a user channel's long poll); the port's own: counters
merged across actor processes, a span in an actor parented by its
caller's, the state API and pubsub from inside a port process, and the
util slice as a whole at a tiny size (``tools/util_bench.py``).

The port's actors are module level and run on a card ledger of their own;
this module imports neither JAX nor ray_tpu at its top.
"""

import json
import threading
import time

import pytest

from ray_tpu_torch._private.cards import CardLedger, use_ledger
from ray_tpu_torch._private.process_actor import ProcessActor, get, start_all

pytestmark = pytest.mark.timeout(300)


class A:
    def ping(self):
        return 1


def f():
    return 2


def work():
    time.sleep(0.01)
    return 1


_tokens = None  # in an actor's process: its one counter


def count_tokens(n: int, tag: str) -> int:
    global _tokens
    from ray_tpu_torch.util import metrics

    if _tokens is None:
        _tokens = metrics.Counter("test_tokens", "tokens", tag_keys=("route",))
    _tokens.inc(n, tags={"route": tag})
    return n


def span_in_actor(name: str) -> None:
    from ray_tpu_torch.util import tracing

    with tracing.span(name):
        pass


def from_inside() -> dict:
    """In a port process: the driver's state and channels over the link."""
    import os

    from ray_tpu_torch.util import pubsub, state

    pubsub.publish("from-child", {"pid": os.getpid()})
    return {"names": sorted(a["name"] for a in state.list_actors() if a["state"] == "ALIVE"),
            "nodes": [n["NodeID"] for n in state.list_nodes()]}


@pytest.fixture(scope="module")
def actors(tmp_path_factory):
    led = CardLedger(str(tmp_path_factory.mktemp("ledger")), cards=[], cpus=8)
    with use_ledger(led):
        made = start_all([ProcessActor(A, name="state-test-actor"),
                          ProcessActor(A, name="state-test-other")])
        yield made
        for a in made:
            a.kill()
    assert led.holders() == []


def _metric_calls(metrics):
    metrics._clear_registry()
    c = metrics.Counter("requests_total", "reqs", tag_keys=("route",))
    c.inc(tags={"route": "/a"})
    c.inc(2, tags={"route": "/a"})
    c.inc(tags={"route": '/b"\\n'})
    g = metrics.Gauge("queue_depth", "depth")
    g.set(7)
    h = metrics.Histogram("latency_ms", "lat", boundaries=[1, 10, 100], tag_keys=("op",))
    for v in (0.5, 5, 50, 500):
        h.observe(v, tags={"op": "get"})
    with pytest.raises(ValueError):
        c.inc(-1)
    snap = metrics.snapshot()
    agg = metrics.MetricsAggregator()
    agg.apply("n1", "r1", snap)
    agg.apply("n1", "r1", snap)  # a replayed snapshot adds nothing
    c.inc(4, tags={"route": "/a"})
    agg.apply("n1", "r1", metrics.snapshot())
    agg.apply("n2", "r2", snap)
    text = metrics.export_prometheus()
    merged = metrics.export_prometheus_merged(agg, local_node="head")
    rendered = metrics.render_prometheus(agg.model())
    metrics._clear_registry()
    return text, merged, rendered


def test_metrics_prometheus_text_byte_equal_jax():
    """``tests/test_platform.py:70``, and the snapshot / aggregator path:
    the same calls give byte-equal text in both packages."""
    from ray_tpu.util import metrics as jm

    from ray_tpu_torch.util import metrics as pm

    jax_out, port_out = _metric_calls(jm), _metric_calls(pm)
    assert port_out == jax_out
    text = port_out[0]
    assert 'requests_total{route="/a"} 7.0' in text
    assert "queue_depth 7.0" in text
    assert 'latency_ms_bucket{op="get",le="+Inf"} 4' in text
    assert 'latency_ms_sum{op="get"} 555.5' in text
    assert 'requests_total{route="/a",node="n1"} 7.0' in port_out[2]


def _spans(tracing, path):
    tracing.clear()
    with tracing.span("outer", run="x"):
        with tracing.span("inner"):
            pass
    spans = tracing.get_spans()
    trace = tracing.export_chrome_trace(path)
    return ([s["name"] for s in spans], spans[0]["parent_id"] == spans[1]["span_id"],
            spans[0]["trace_id"] == spans[1]["trace_id"], spans[1]["attributes"],
            any(e["name"] == "outer" for e in trace))


def test_tracing_spans_equal_jax(ray_start_thread, tmp_path):
    """``tests/test_platform.py:57``."""
    from ray_tpu.util import tracing as jt

    from ray_tpu_torch.util import tracing as pt

    jax_out = _spans(jt, str(tmp_path / "j.json"))
    port_out = _spans(pt, str(tmp_path / "p.json"))
    assert port_out == jax_out == (["inner", "outer"], True, True, {"run": "x"}, True)
    assert json.load(open(tmp_path / "p.json"))
    pt.clear()


@pytest.mark.parametrize("env", [None, "0", "1", "5", "junk"])
def test_trace_sampling_knob_equal_jax(monkeypatch, env):
    from ray_tpu.util import tracing as jt

    from ray_tpu_torch.util import tracing as pt

    if env is None:
        monkeypatch.delenv("RAY_TPU_TRACE_SAMPLE_N", raising=False)
    else:
        monkeypatch.setenv("RAY_TPU_TRACE_SAMPLE_N", env)
    out = []
    for t in (jt, pt):
        t._reset_sampling()
        out.append((t.trace_sample_n(), t.enabled(), t.sampled(b"\x10" * 8)))
        t._reset_sampling()
    assert out[1] == out[0]


def test_state_api_lists_equal_jax(ray_start_thread, actors):
    """``tests/test_platform.py:19``: a named actor and three calls of a
    function show in the lists and the task summary (the port's functions
    run in an actor's process); the port has no object store
    (``list_objects`` is out)."""
    import ray_tpu
    from ray_tpu.util import state as jstate

    from ray_tpu_torch.util import state

    @ray_tpu.remote
    class JA:
        def ping(self):
            return 1

    @ray_tpu.remote
    def jf():
        return 2

    a = JA.options(name="state-test-actor").remote()
    ray_tpu.get(a.ping.remote())
    ray_tpu.get([jf.remote() for _ in range(3)])
    jax_out = (any(x["name"] == "state-test-actor" and x["state"] == "ALIVE"
                   for x in jstate.list_actors()), len(jstate.list_nodes()) >= 1,
               len(jstate.list_workers()) >= 1,
               jstate.summarize_tasks().get("jf", {}).get("FINISHED", 0) >= 3)

    actor = actors[0]
    get(actor.call("ping"))
    get([actor.call(f) for _ in range(3)])
    listed = state.list_actors()
    port_out = (any(x["name"] == "state-test-actor" and x["state"] == "ALIVE" for x in listed),
                len(state.list_nodes()) >= 1, len(state.list_workers()) >= 1,
                state.summarize_tasks().get("f", {}).get("FINISHED", 0) >= 3)
    assert port_out == jax_out == (True, True, True, True)
    row = next(x for x in listed if x["actor_id"] == actor.actor_id)
    assert (row["pid"], row["class_name"], row["cards"], row["pending_tasks"]) == (
        actor.pid, "A", [], 0)
    assert state.summarize_tasks()["A.__init__"]["FINISHED"] >= 2
    node, = state.list_nodes()
    assert node["Resources"] == {"CPU": 8.0, "GPU": 0.0} and node["Alive"]
    assert {w["pid"] for w in state.list_workers()} >= {a.pid for a in actors}


def test_list_tasks_shows_a_call_in_flight(actors):
    from ray_tpu_torch.util import state

    h = actors[1].call(time.sleep, 1.0)
    running = [t for t in state.list_tasks() if t["worker_id"] == actors[1].actor_id]
    assert [(t["name"], t["state"]) for t in running] == [("sleep", "RUNNING")]
    get(h)
    assert not [t for t in state.list_tasks() if t["worker_id"] == actors[1].actor_id]


def test_timeline_export_equal_jax(ray_start_thread, actors, tmp_path):
    """``tests/test_platform.py:43``: five calls, five complete events."""
    import ray_tpu
    from ray_tpu.util.state.api import timeline as jtimeline

    from ray_tpu_torch.util.state import timeline

    @ray_tpu.remote
    def jwork():
        time.sleep(0.01)
        return 1

    ray_tpu.get([jwork.remote() for _ in range(5)])
    get([actors[0].call(work) for _ in range(5)])
    out = []
    for name, tl, path in (("jwork", jtimeline, tmp_path / "j.json"),
                           ("work", timeline, tmp_path / "p.json")):
        trace = tl(str(path))
        loaded = json.load(open(path))
        out.append((len([e for e in trace if e["name"] == name]),
                    all(e["ph"] == "X" and e["dur"] > 0 for e in loaded)))
    assert out[1] == out[0] == (5, True)


def test_pubsub_actor_and_node_events_equal_jax(ray_start_thread, tmp_path):
    """``tests/test_platform.py:352``: ALIVE and DEAD of an actor, the
    node's "added", and a user channel's long poll woken mid-poll."""
    import ray_tpu
    import ray_tpu._private.worker as w
    from ray_tpu.util.pubsub import Subscriber as JSub, publish as jpublish

    from ray_tpu_torch.util.pubsub import Subscriber, publish

    def scenario(Sub, pub, start, kill, add_node):
        out = {}
        sub_actors, sub_nodes = Sub("actors"), Sub("nodes")
        a = start()
        out["alive"] = any(e["state"] == "ALIVE" for e in sub_actors.poll(timeout=10))
        kill(a)
        deadline, dead = time.time() + 15, []
        while time.time() < deadline and not dead:
            dead = [e for e in sub_actors.poll(timeout=2) if e["state"] == "DEAD"]
        out["dead"] = bool(dead)
        add_node()
        out["node_added"] = any(e["event"] == "added" for e in sub_nodes.poll(timeout=10))
        sub_custom = Sub("my-channel")
        t = threading.Thread(target=lambda: (time.sleep(0.4), pub("my-channel", {"k": 42})))
        t0 = time.monotonic()
        t.start()
        got = sub_custom.poll(timeout=10)
        out["custom"] = [e["k"] for e in got]
        out["blocked"] = 0.3 < time.monotonic() - t0 < 5.0
        t.join()
        late = Sub("my-channel", start_from_beginning=False)
        out["late_sees_none"] = late.poll(timeout=0.2) == []
        return out

    @ray_tpu.remote
    class JA:
        def ping(self):
            return 1

    def jstart():
        a = JA.remote()
        assert ray_tpu.get(a.ping.remote(), timeout=60) == 1
        return a

    jax_out = scenario(JSub, jpublish, jstart, ray_tpu.kill,
                       lambda: w.global_worker().controller.add_node({"CPU": 2}))

    led = CardLedger(str(tmp_path / "ledger"), cards=[], cpus=8)
    with use_ledger(led):
        def pstart():
            a = ProcessActor(A)
            assert get(a.ready, timeout=60) is None
            return a

        # the port's one node is "added" when its registry starts
        port_out = scenario(Subscriber, publish, pstart, lambda a: a.kill(), lambda: None)
    assert port_out == jax_out
    assert port_out["custom"] == [42] and port_out["alive"] and port_out["dead"]


def test_counters_merge_across_actor_processes(actors):
    """Each actor's registry is a reporter: counters merge as deltas, a
    second pull adds only what grew; JAX's aggregator on the same
    snapshots gives the same text."""
    from ray_tpu.util import metrics as jm

    from ray_tpu_torch.util import metrics as pm
    from ray_tpu_torch.util import state

    get([actors[0].call(count_tokens, 5, "x"), actors[1].call(count_tokens, 7, "x")])

    def merged():
        rec = {r["name"]: r for r in state.cluster_metrics()}["test_tokens"]
        return sum(v for k, v in rec["values"].items() if k[0] == "x")

    assert merged() == 12.0
    assert merged() == 12.0  # a pull again adds nothing
    get(actors[0].call(count_tokens, 3, "x"))
    assert merged() == 15.0
    snaps = get([a.call(pm.snapshot) for a in actors])
    texts = []
    for m in (jm, pm):
        agg = m.MetricsAggregator()
        for a, snap in zip(actors, snaps):
            agg.apply("host", a.actor_id, snap)
        texts.append(m.render_prometheus(agg.model()))
    assert texts[1] == texts[0] and 'test_tokens{route="x",node="host"} 15.0' in texts[1]


def test_span_in_an_actor_parents_under_its_caller(actors):
    from ray_tpu_torch.util import state, tracing

    with tracing.span("caller"):
        trace_id, span_id = tracing.current_context()
        get(actors[0].call(span_in_actor, "callee"))
    spans = state.cluster_spans()["spans"]
    callee = [s for s in spans if s["name"] == "callee" and s["parent_id"] == span_id]
    assert len(callee) == 1 and callee[0]["trace_id"] == trace_id
    assert callee[0]["pid"] == actors[0].pid
    events = [e for e in state.timeline() if e["name"] == "callee"]
    assert [e["args"]["parent_id"] for e in events] == [span_id]


def test_state_and_pubsub_from_inside_a_port_process(actors):
    from ray_tpu_torch.util import state
    from ray_tpu_torch.util.pubsub import Subscriber

    sub = Subscriber("from-child")
    out = get(actors[1].call(from_inside))
    assert {"state-test-actor", "state-test-other"} <= set(out["names"])
    assert out["nodes"] == [n["NodeID"] for n in state.list_nodes()]
    assert [e["pid"] for e in sub.poll(timeout=10)] == [actors[1].pid]


def test_tenant_quota_and_proxy_stats_equal_jax(ray_start_thread):
    from ray_tpu.util.state import api as japi

    from ray_tpu_torch.util.state import api

    keys = ("tenant", "weight", "priority", "quota", "configured")
    out = []
    for m in (japi, api):
        first = m.set_tenant_quota("t-a", quota={"CPU": 2}, weight=3.0, priority=1)
        again = m.set_tenant_quota("t-a", weight=0.0)
        row = next(r for r in m.tenant_stats() if r["tenant"] == "t-a")
        out.append(([{k: r[k] for k in keys} for r in (first, again, row)], m.proxy_stats()))
    assert out[1] == out[0]
    assert out[1][0][1]["weight"] == 0.01 and out[1][1] == {}


def test_util_slice_on_the_cpu(tmp_path):
    """``tools/util_bench.py``'s phase at a tiny size: placed engine
    actors, the pool and the queue, merged counters, spans, events, the
    kill and the removal; every check passes."""
    from ray_tpu_torch.llm import EngineConfig, LLMConfig, ModelConfig
    from ray_tpu_torch.tools import util_bench as ub

    llm = LLMConfig(model=ModelConfig(model_id="tiny", tokenizer="byte", seed=0),
                    engine=EngineConfig(max_num_seqs=16, max_seq_len=128,
                                        prefill_buckets=(32, 64, 128), dtype="float32"))
    sampling = {"max_tokens": 4, "temperature": 0.0, "ignore_eos": True}
    prompts = [f"Row {i:02d}: a prompt." for i in range(32)]
    want = ub.expected_texts(llm, prompts, sampling, "cpu")
    led = CardLedger(str(tmp_path / "ledger"), cards=[], cpus=8)
    with use_ledger(led):
        out = ub.util_actors(llm, prompts, sampling, want, device="cpu")
    assert out["ok"], out["failed_checks"]
    assert (out["texts_equal"], out["queue_texts_equal"], out["merged_tokens"]) == (32, 16, 192)
    assert led.holders() == []
