"""DAGs in the port (``ray_tpu_torch/dag/``, ``experimental/channel.py``)
against the JAX package's (``ray_tpu/dag/``), on the CPU.

Mirrors ``tests/test_collective_dag.py:119-167`` (function DAG, actor
pipeline, multi-output, input attribute, compiled equals eager, diamond)
and ``tests/test_compiled_channels.py:40-155`` (raw channel round trip,
channel mode, multi-output, an error that propagates and recovers, the
actor usable while compiled, teardown freeing the channels, compiled
against the per-call path). The same graphs run through ``ray_tpu`` (the
``ray_start_thread`` runtime) and through the port's ``ProcessActor``s;
values are equal and errors of the same type. The reference's channel
tests skip without its native arena (``RAY_TPU_ARENA``); its eager results
always run, so the port's compiled values are held against them.

The slice as a whole: a compiled DAG of two tiny-llama engine actors whose
weights come from the JAX package's checkpoint (the actors' params equal
``params_from_jax`` of the JAX engine's, exactly) gives the JAX engine's
greedy tokens, exactly.

The port's actors are spawned once for the module; JAX and ray_tpu are
imported inside the tests only (the actors' processes import this module).
"""

import os
import time

import numpy as np
import pytest

from ray_tpu_torch._private.process_actor import OnInstance, ProcessActor, get, start_all
from ray_tpu_torch.dag import CompiledDAG, FunctionNode, InputNode, MultiOutputNode
from ray_tpu_torch.experimental.channel import Channel, ChannelClosedError, channel_files
from ray_tpu_torch.tools.util_bench import EngineActor
from tests.test_torch_llm_batch import checkpoint  # noqa: F401 — the module fixture

pytestmark = pytest.mark.timeout(300)


class Node:
    """The reference tests' ``Stage`` and ``Adder`` in one class."""

    def __init__(self, k=0):
        self.k, self.calls = k, 0

    def reset(self, k):
        self.k, self.calls = k, 0

    def forward(self, x):
        self.calls += 1
        return x + self.k

    add = forward

    def boom(self, x):
        raise ValueError(f"boom on {x}")

    def nap(self, s):
        time.sleep(s)
        return s

    def num_calls(self):
        return self.calls


def mul(a, b):
    return a * b


def add(a, b):
    return a + b


@pytest.fixture(scope="module")
def actors():
    nodes = start_all([ProcessActor(Node, name=f"dag-node-{i}") for i in range(3)])
    yield nodes
    for a in nodes:
        a.kill()


def _port(actors, *ks):
    get([a.call("reset", k) for a, k in zip(actors, ks)])
    return actors[:len(ks)]


def _jax(*ks):
    import ray_tpu

    cls = ray_tpu.remote(Node)
    return [cls.remote(k) for k in ks]


def _dag_files(compiled) -> list:
    paths = [os.path.basename(ch.path) for ch in compiled._all_channels]
    return [n for n in channel_files() if n.split(".")[0] in paths]


# ---- tests/test_collective_dag.py ------------------------------------------------


def test_function_dag(ray_start_thread):
    import ray_tpu
    from ray_tpu.dag import InputNode as JInputNode

    jmul, jadd = ray_tpu.remote(mul), ray_tpu.remote(add)
    with JInputNode() as jinp:
        jdag = jadd.bind(jmul.bind(jinp, 2), 3)
    with InputNode() as inp:
        dag = FunctionNode(add, (FunctionNode(mul, (inp, 2)), 3))
    for x in (5, 10):
        assert get(dag.execute(x)) == ray_tpu.get(jdag.execute(x)) == 2 * x + 3


def test_remote_function_bind_runs_core_api_tasks(ray_start_thread, tmp_path):
    """``RemoteFunction.bind`` through both packages' ``remote``: each node
    a task of the core API (``ray_tpu/remote_function.py:97-101``)."""
    import ray_tpu
    import ray_tpu_torch
    from ray_tpu.dag import InputNode as JInputNode
    from ray_tpu_torch._private.cards import CardLedger, use_ledger
    from ray_tpu_torch.util import state

    jmul, jadd = ray_tpu.remote(mul), ray_tpu.remote(add)
    with JInputNode() as jinp:
        jdag = jadd.bind(jmul.bind(jinp, 2), 3)
    with use_ledger(CardLedger(str(tmp_path / "ledger"), cards=[], cpus=8)):
        ray_tpu_torch.init(num_cpus=4, mode="thread")
        try:
            pmul, padd = ray_tpu_torch.remote(mul), ray_tpu_torch.remote(add)
            with InputNode() as inp:
                dag = padd.bind(pmul.bind(inp, 2), 3)
            before = state.summarize_tasks()
            for x in (5, 10):
                assert get(dag.execute(x)) == ray_tpu.get(jdag.execute(x)) == 2 * x + 3
            ran = state.summarize_tasks()
            assert [ran[n]["FINISHED"] - before.get(n, {}).get("FINISHED", 0)
                    for n in ("mul", "add")] == [2, 2]
        finally:
            ray_tpu_torch.shutdown()


def test_actor_dag_pipeline(ray_start_thread, actors):
    import ray_tpu
    from ray_tpu.dag import InputNode as JInputNode

    j1, j2 = _jax(1, 10)
    with JInputNode() as jinp:
        jdag = j2.forward.bind(j1.forward.bind(jinp))
    s1, s2 = _port(actors, 1, 10)
    with InputNode() as inp:
        dag = s2.bind("forward", s1.bind("forward", inp))
    assert get(dag.execute(0)) == ray_tpu.get(jdag.execute(0)) == 11
    assert get(s1.call("num_calls")) == ray_tpu.get(j1.num_calls.remote()) == 1


def test_multi_output(ray_start_thread, actors):
    import ray_tpu
    from ray_tpu.dag import InputNode as JInputNode
    from ray_tpu.dag import MultiOutputNode as JMultiOutputNode

    j1, j2 = _jax(1, 2)
    with JInputNode() as jinp:
        jdag = JMultiOutputNode([j1.forward.bind(jinp), j2.forward.bind(jinp)])
    s1, s2 = _port(actors, 1, 2)
    with InputNode() as inp:
        dag = MultiOutputNode([s1.bind("forward", inp), s2.bind("forward", inp)])
    assert get(dag.execute(100)) == ray_tpu.get(jdag.execute(100)) == [101, 102]


def test_input_attribute_node(ray_start_thread):
    import ray_tpu
    from ray_tpu.dag import InputNode as JInputNode

    with JInputNode() as jinp:
        jdag = ray_tpu.remote(add).bind(jinp["a"], jinp["b"])
    with InputNode() as inp:
        dag = FunctionNode(add, (inp["a"], inp["b"]))
    assert get(dag.execute(a=4, b=5)) == ray_tpu.get(jdag.execute(a=4, b=5)) == 9


def test_compiled_dag_matches_eager(ray_start_thread, actors):
    import ray_tpu
    from ray_tpu.dag import InputNode as JInputNode

    j1, j2 = _jax(5, 50)
    with JInputNode() as jinp:
        jdag = j2.forward.bind(j1.forward.bind(jinp))
    jcompiled = jdag.experimental_compile()
    s1, s2 = _port(actors, 5, 50)
    with InputNode() as inp:
        dag = s2.bind("forward", s1.bind("forward", inp))
    compiled = dag.experimental_compile()
    try:
        for x in range(3):
            assert get(compiled.execute(x)) == ray_tpu.get(jcompiled.execute(x)) == x + 55
        # actor state is shared between the eager and compiled paths
        assert get(s1.call("num_calls")) == ray_tpu.get(j1.num_calls.remote()) == 3
    finally:
        compiled.teardown()
        jcompiled.teardown()


def test_compiled_dag_diamond(ray_start_thread):
    import ray_tpu
    from ray_tpu.dag import InputNode as JInputNode

    jmul, jadd = ray_tpu.remote(mul), ray_tpu.remote(add)
    with JInputNode() as jinp:
        jdag = jadd.bind(jmul.bind(jinp, 2), jmul.bind(jinp, 3))
    with InputNode() as inp:
        dag = FunctionNode(add, (FunctionNode(mul, (inp, 2)), FunctionNode(mul, (inp, 3))))
    compiled = dag.experimental_compile()
    # a graph with function nodes runs the per-execute plan, in both packages
    jcompiled = jdag.experimental_compile()
    assert "mode=tasks" in repr(compiled) and "mode=tasks" in repr(jcompiled)
    assert get(compiled.execute(4)) == ray_tpu.get(jcompiled.execute(4)) == 20
    compiled.teardown()
    jcompiled.teardown()


# ---- tests/test_compiled_channels.py ----------------------------------------------


def test_channel_roundtrip_raw():
    ch = Channel.create(slot_size=1 << 16, num_slots=2)
    try:
        ch.write({"a": 1})
        ch.write([1, 2, 3])
        with pytest.raises(TimeoutError):
            ch.write("no room", timeout_s=0.2)  # two slots, both full
        assert ch.read() == {"a": 1}
        assert ch.read() == [1, 2, 3]
        with pytest.raises(ValueError, match="exceeds the channel slot size"):
            ch.write(b"x" * (1 << 17))
        ch.write("last")
        ch.close()
        with pytest.raises(ChannelClosedError):
            ch.write("after close")
        assert ch.read() == "last"  # readable until drained
        with pytest.raises(ChannelClosedError):
            ch.read(timeout_s=1)
    finally:
        ch.destroy()
    assert not [n for n in channel_files() if n.startswith(os.path.basename(ch.path))]


def _relay_in_process(ch_in: Channel, ch_out: Channel, n: int) -> int:
    """In an actor's process: read ``n`` values and write each back plus 1."""
    for _ in range(n):
        ch_out.write(ch_in.read(timeout_s=30) + 1)
    return os.getpid()


def test_channel_crosses_processes_by_its_descriptor(actors):
    """A channel pickles to its path and geometry: another process maps the
    same ring (a blocked reader wakes on the writer's doorbell)."""
    ch_in, ch_out = Channel.create(slot_size=256), Channel.create(slot_size=256)
    try:
        pid = actors[0].call(_relay_in_process, ch_in, ch_out, 50)
        for i in range(50):
            ch_in.write(i)
            assert ch_out.read(timeout_s=30) == i + 1
        assert get(pid) == actors[0].pid != os.getpid()
    finally:
        ch_in.destroy()
        ch_out.destroy()


def test_compiled_channel_mode_active(ray_start_thread, actors):
    import ray_tpu

    j1, j2 = _jax(1, 10)
    a, b = _port(actors, 1, 10)
    with InputNode() as inp:
        dag = b.bind("add", a.bind("add", inp))
    compiled = dag.experimental_compile()
    try:
        assert "mode=channels" in repr(compiled)
        assert len(compiled._all_channels) == 5  # input, a -> b, output, two acks
        for x in range(5):
            assert get(compiled.execute(x)) == ray_tpu.get(
                j2.add.remote(j1.add.remote(x))) == x + 11
    finally:
        compiled.teardown()


def test_compiled_multi_output_channels(ray_start_thread, actors):
    import ray_tpu
    from ray_tpu.dag import InputNode as JInputNode
    from ray_tpu.dag import MultiOutputNode as JMultiOutputNode

    j1, j2 = _jax(1, 2)
    with JInputNode() as jinp:
        jdag = JMultiOutputNode([j1.add.bind(jinp), j2.add.bind(jinp)])
    a, b = _port(actors, 1, 2)
    with InputNode() as inp:
        dag = MultiOutputNode([a.bind("add", inp), b.bind("add", inp)])
    compiled = dag.experimental_compile()
    try:
        assert "mode=channels" in repr(compiled)
        assert get(compiled.execute(100)) == ray_tpu.get(jdag.execute(100)) == [101, 102]
    finally:
        compiled.teardown()


def test_compiled_error_propagates_and_recovers(ray_start_thread, actors):
    import ray_tpu
    from ray_tpu.dag import InputNode as JInputNode

    j1, j2 = _jax(1, 10)
    with JInputNode() as jinp:
        jdag = j2.add.bind(j1.boom.bind(jinp))
    a, b = _port(actors, 1, 10)
    with InputNode() as inp:
        dag = b.bind("add", a.bind("boom", inp))
    compiled = dag.experimental_compile()
    try:
        for x in (3, 4):
            with pytest.raises(ValueError, match=f"boom on {x}") as port_err:
                get(compiled.execute(x))
            with pytest.raises(ValueError, match=f"boom on {x}") as jax_err:
                ray_tpu.get(jdag.execute(x))
            assert isinstance(port_err.value, ValueError) and isinstance(jax_err.value,
                                                                          ValueError)
        # eager, the same error: the downstream node never ran
        with pytest.raises(ValueError, match="boom on 5"):
            get(dag.execute(5))
        assert get(b.call("num_calls")) == 0
    finally:
        compiled.teardown()


def test_compiled_actor_stays_usable(ray_start_thread, actors):
    """The loop runs on a thread of its own: normal calls keep working on a
    max_concurrency=1 actor while the DAG is compiled."""
    import ray_tpu

    j, = _jax(7)
    a, = _port(actors, 7)
    with InputNode() as inp:
        dag = a.bind("add", inp)
    compiled = dag.experimental_compile()
    try:
        assert get(compiled.execute(1)) == ray_tpu.get(j.add.remote(1)) == 8
        assert get(a.call("num_calls"), timeout=30) == ray_tpu.get(j.num_calls.remote()) == 1
        assert get(compiled.execute(2)) == 9
    finally:
        compiled.teardown()


def test_compiled_teardown_frees_channels(actors):
    a, = _port(actors, 1)
    with InputNode() as inp:
        dag = a.bind("add", inp)
    compiled = dag.experimental_compile()
    made = _dag_files(compiled)
    assert len(made) == 3 * 3  # input, output and ack rings, two doorbells each
    assert get(compiled.execute(5)) == 6
    compiled.teardown()
    assert _dag_files(compiled) == []
    assert get(a.call("add", 1)) == 2  # the actor still answers
    with pytest.raises(RuntimeError, match="torn down"):
        compiled.execute(1)


def test_pending_results_drain_in_order_and_a_timed_out_get_retries(actors):
    a, b = _port(actors, 1, 10)
    with InputNode() as inp:
        dag = b.bind("add", a.bind("add", inp))
    compiled = dag.experimental_compile()
    try:
        refs = [compiled.execute(x) for x in range(2)]
        assert get(refs[1]) == 12 and refs[0].done  # the older one came first
        assert get(refs[0]) == 11
    finally:
        compiled.teardown()
    with InputNode() as inp:
        dag = a.bind("nap", inp)
    compiled = dag.experimental_compile()
    try:
        r = compiled.execute(0.5)
        with pytest.raises(TimeoutError):
            get(r, timeout=0.05)
        assert not r.done
        assert get(r, timeout=30) == 0.5  # the retry resumes the same read
        assert get(compiled.execute(0.0)) == 0.0
    finally:
        compiled.teardown()


def test_an_all_actor_graph_never_runs_the_per_execute_plan(actors, monkeypatch):
    """No fallback: a graph of actor nodes whose channels cannot be made
    raises at compile time, and leaves no channel behind."""
    a, = _port(actors, 1)
    with InputNode() as inp:
        dag = a.bind("add", inp)
    made = []
    real = Channel.create.__func__

    def failing(cls, slot_size=4 << 20, num_slots=2):
        if made:
            raise OSError(28, "No space left on device")
        made.append(real(cls, slot_size, num_slots))
        return made[-1]

    monkeypatch.setattr(Channel, "create", classmethod(failing))
    with pytest.raises(OSError, match="No space left"):
        CompiledDAG(dag)
    assert made and not os.path.exists(made[0].path)
    # a node that reads no channel would run free: refused, not planned
    monkeypatch.undo()
    with pytest.raises(ValueError, match="would run free"):
        a.bind("add", 5).experimental_compile()


def _median_us(run, n: int) -> float:
    times = []
    for i in range(n):
        t0 = time.perf_counter()
        run(i)
        times.append(time.perf_counter() - t0)
    return sorted(times)[n // 2] * 1e6


def test_compiled_faster_than_the_per_call_path(actors):
    """The channel path beats the eager one, which sends a call per node and
    routes each value back through the driver: a two-actor chain, in turns
    (eager, compiled, compiled, eager), each turn's median round trip."""
    a, b = _port(actors, 1, 10)
    with InputNode() as inp:
        dag = b.bind("add", a.bind("add", inp))
    n = 50
    get(dag.execute(0))
    compiled = dag.experimental_compile()
    try:
        get(compiled.execute(0))  # warm the loops
        eager = _median_us(lambda i: get(dag.execute(i)), n)
        chan = [_median_us(lambda i: get(compiled.execute(i)), n) for _ in range(2)]
        eager = min(eager, _median_us(lambda i: get(dag.execute(i)), n))
    finally:
        compiled.teardown()
    assert eager / max(chan) > 2.0, (f"channel path only {eager / max(chan):.1f}x faster "
                                     f"({max(chan):.0f} µs vs {eager:.0f} µs a round trip)")


# ---- the slice: two tiny-llama engine actors ----------------------------------------


class TokenEngine(EngineActor):
    """An engine actor whose stage returns each row's text and tokens; a
    later stage takes the texts."""

    def stage(self, rows: list, sampling: dict) -> list:
        from ray_tpu_torch.llm.batch import _sampling

        prompts = [r["text"] if isinstance(r, dict) else r for r in rows]
        reqs = [self.engine.submit(p, sampling_params=_sampling(sampling)) for p in prompts]
        out = []
        for r in reqs:
            self.engine._await_done(r)
            out.append({"text": self.engine.tokenizer.decode(r.out_tokens),
                        "tokens": list(r.out_tokens)})
        return out


def _engine_params(actor) -> dict:
    return {k: v.cpu().numpy() for k, v in actor.engine.params.items()}


def test_compiled_engine_dag_gives_jax_engines_greedy_tokens(checkpoint):  # noqa: F811
    import jax

    from ray_tpu.llm import SamplingParams as JSamplingParams
    from ray_tpu.llm.engine import JaxEngine
    from ray_tpu_torch.models.convert import params_from_jax
    from tests.test_torch_llm_batch import _config, _jax_config

    cfg = _config(checkpoint)
    sampling = {"max_tokens": 4, "temperature": 0.0, "ignore_eos": True}
    prompts = [f"dag row {i}" for i in range(4)]
    engines = start_all([ProcessActor(TokenEngine, (cfg, "cpu"), name=f"dag-llm-{i}")
                         for i in range(2)])
    a, b = engines
    try:
        jeng = JaxEngine(_jax_config(cfg))
        try:
            want = params_from_jax(jax.device_get(jeng.params), device="cpu")
            for actor in engines:
                got = get(actor.call(OnInstance(_engine_params)))
                assert set(got) == set(want)
                assert all(np.array_equal(got[k], want[k].numpy()) for k in want)

            def jax_stage(rows):
                reqs = [jeng.submit(r, sampling_params=JSamplingParams(**sampling)) for r in rows]
                for r in reqs:
                    jeng._await_done(r)
                return [{"text": jeng.tokenizer.decode(r.out_tokens),
                         "tokens": list(r.out_tokens)} for r in reqs]

            j1 = jax_stage(prompts)
            j2 = jax_stage([r["text"] for r in j1])
        finally:
            jeng.shutdown()
        with InputNode() as inp:
            x = a.bind("stage", inp, sampling)
            dag = MultiOutputNode([x, b.bind("stage", x, sampling)])
        compiled = dag.experimental_compile()
        try:
            assert "mode=channels" in repr(compiled)
            s1, s2 = get(compiled.execute(prompts), timeout=120)
        finally:
            compiled.teardown()
        assert [r["tokens"] for r in s1] == [r["tokens"] for r in j1]
        assert [r["tokens"] for r in s2] == [r["tokens"] for r in j2]
        assert all(len(r["tokens"]) == 4 for r in s1 + s2)
        assert get(dag.execute(prompts), timeout=120) == [s1, s2]  # eager: the same
    finally:
        for actor in engines:
            actor.kill()
