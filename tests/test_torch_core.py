"""The port's core API, part 1 (``ray_tpu_torch``: ``init``, ``remote``,
``get``, ``put``, ``wait``, ``cancel``, ``ObjectRef``) against the JAX
package's (``ray_tpu``), in thread mode, on the CPU.

The mirrors of ``tests/test_core_api.py``'s task and object tests
(:14-111, :222-250): each scenario runs the same module-level functions on
the same inputs through ``ray_tpu`` (the ``ray_start_thread`` runtime) and
through ``ray_tpu_torch`` (``init(num_cpus=8, mode="thread")`` on a card
ledger of its own), and the results are equal: values exactly, errors of
the same type and message. Then what only the port has: the tensor round
trip against the reference doubling the same numpy data, the refusal of a
lambda (the port pickles functions by reference), the options that part 2
brings, and the table's freeing.

The functions stay at module level; JAX and ray_tpu are imported inside
the tests only.
"""

import gc
import importlib
import pickle
import threading
import time

import numpy as np
import pytest

import ray_tpu_torch as rt

pytestmark = pytest.mark.timeout(120)

SLOW_S = 2.0
_attempts: dict = {}
_release = threading.Event()


def add(a, b):
    return a + b


def combine(a, b, c=0):
    return a + b + c


def inc(x):
    return x + 1


def three():
    return 1, 2, 3


def boom():
    raise ValueError("broken")


def boom_key():
    raise KeyError("origin")


def passthrough(x):
    return x


def fast():
    return "fast"


def slow():
    time.sleep(SLOW_S)
    return "slow"


def inner(x):
    return x * 2


def outer(x, pkg):
    api = importlib.import_module(pkg)
    return api.get(api.remote(inner).remote(x)) + 1


def impossible():
    return 1


def hog(s):
    t0 = time.monotonic()
    time.sleep(s)
    return t0, time.monotonic()


def double(x):
    return x * 2


def flaky(key, fails):
    _attempts[key] = _attempts.get(key, 0) + 1
    if _attempts[key] <= fails:
        raise RuntimeError(f"transient {_attempts[key]}")
    return _attempts[key]


def held():
    _release.wait(30)
    return "released"


def task_name(pkg):
    return importlib.import_module(pkg).get_runtime_context().get_task_name()


def put_and_return(n, pkg):
    return [importlib.import_module(pkg).put(np.arange(n))]


@pytest.fixture
def port(tmp_path):
    from ray_tpu_torch._private.cards import CardLedger, use_ledger

    with use_ledger(CardLedger(str(tmp_path / "ledger"), cards=[], cpus=8)):
        rt.init(num_cpus=8, mode="thread")
        try:
            yield rt
        finally:
            rt.shutdown()


def _both(scenario):
    """``scenario(api)`` through ray_tpu and ray_tpu_torch: the two results."""
    import ray_tpu

    return scenario(ray_tpu), scenario(rt)


# ---- tests/test_core_api.py ---------------------------------------------------------


def test_put_get(ray_start_thread, port):
    j, p = _both(lambda api: api.get(api.put({"a": 1, "b": [1, 2, 3]})))
    assert p == j == {"a": 1, "b": [1, 2, 3]}


def test_put_get_numpy_large(ray_start_thread, port):
    arr = np.arange(1_000_000, dtype=np.float32)
    j, p = _both(lambda api: api.get(api.put(arr)))
    np.testing.assert_array_equal(p, j)
    np.testing.assert_array_equal(p, arr)
    assert p.dtype == j.dtype == np.float32


def test_simple_task(ray_start_thread, port):
    assert _both(lambda api: api.get(api.remote(add).remote(1, 2))) == (3, 3)


def test_task_with_kwargs_and_refs(ray_start_thread, port):
    def run(api):
        return api.get(api.remote(combine).remote(1, b=api.put(10), c=2))

    assert _both(run) == (13, 13)


def test_task_chaining(ray_start_thread, port):
    def run(api):
        f = api.remote(inc)
        ref = f.remote(0)
        for _ in range(9):
            ref = f.remote(ref)
        return api.get(ref)

    assert _both(run) == (10, 10)


def test_num_returns(ray_start_thread, port):
    def run(api):
        a, b, c = api.remote(num_returns=3)(three).remote()
        return api.get([a, b, c])

    assert _both(run) == ([1, 2, 3], [1, 2, 3])


def test_task_error_propagates(ray_start_thread, port):
    import ray_tpu

    def run(api):
        with pytest.raises(ValueError, match="broken") as ei:
            api.get(api.remote(boom).remote())
        return type(ei.value.cause), str(ei.value.cause), "boom" in ei.value.remote_tb

    assert _both(run) == ((ValueError, "broken", True),) * 2
    with pytest.raises(rt.TaskError):
        rt.get(rt.remote(boom).remote())
    with pytest.raises(ray_tpu.TaskError):
        ray_tpu.get(ray_tpu.remote(boom).remote())


def test_error_propagates_through_chain(ray_start_thread, port):
    def run(api):
        with pytest.raises(Exception) as ei:
            api.get(api.remote(passthrough).remote(api.remote(boom_key).remote()))
        return isinstance(ei.value, KeyError), type(ei.value.cause), str(ei.value.cause)

    assert _both(run) == ((True, KeyError, "'origin'"),) * 2


def test_wait(ray_start_thread, port):
    def run(api):
        f, s = api.remote(fast).remote(), api.remote(slow).remote()
        ready, not_ready = api.wait([f, s], num_returns=1, timeout=SLOW_S / 2)
        return ready == [f], not_ready == [s], api.get(s)

    assert _both(run) == ((True, True, "slow"),) * 2


def test_get_timeout(ray_start_thread, port):
    import ray_tpu

    def run(api):
        with pytest.raises(TimeoutError) as ei:
            api.get(api.remote(slow).remote(), timeout=0.2)
        return type(ei.value).__name__

    assert _both(run) == ("GetTimeoutError",) * 2
    assert issubclass(rt.GetTimeoutError, rt.RayTpuError)
    assert ray_tpu.GetTimeoutError.__mro__[1:2] == (ray_tpu.RayTpuError,)


def test_nested_tasks(ray_start_thread, port):
    j, p = _both(lambda api: api.get(api.remote(outer).remote(10, api.__name__)))
    assert p == j == 21


def test_a_ref_a_task_puts_and_returns_outlives_the_task(ray_start_thread, port):
    """An object a task puts is held until the task's return holds it,
    however the driver's other tasks run beside it."""
    def run(api):
        made = [api.remote(put_and_return).remote(n, api.__name__) for n in range(1, 25)]
        beside = [api.remote(inc).remote(i) for i in range(48)]
        inner = [r for (r,) in api.get(made, timeout=60)]
        gc.collect()
        return ([api.get(r, timeout=60).tolist() for r in inner],
                api.get(beside, timeout=60))

    want = ([list(range(n)) for n in range(1, 25)], list(range(1, 49)))
    assert _both(run) == (want, want)


def test_cluster_and_available_resources(ray_start_thread, port):
    def run(api):
        return api.cluster_resources().get("CPU"), api.available_resources().get("CPU")

    assert _both(run) == ((8.0, 8.0),) * 2


def test_resource_gating(ray_start_thread, port):
    def run(api):
        ref = api.remote(num_cpus=100)(impossible).remote()
        ready, not_ready = api.wait([ref], timeout=0.5)
        # two tasks that each take every CPU run one after the other
        h = api.remote(num_cpus=8)(hog)
        (s1, e1), (s2, e2) = sorted(api.get([h.remote(0.3), h.remote(0.3)], timeout=30))
        return ready, not_ready == [ref], s2 >= e1 - 1e-3

    assert _both(run) == (([], True, True),) * 2


def test_tensor_round_trip_against_the_reference_doubling_numpy(ray_start_thread, port):
    """The counterpart of ``test_jax_array_roundtrip``: a bf16 and an fp32
    tensor doubled in a port task, equal to ray_tpu doubling the same
    numpy data (exact: every value and its double are bf16 numbers)."""
    import ray_tpu
    import torch

    data = np.arange(16, dtype=np.float32) - 4.5
    want = ray_tpu.get(ray_tpu.remote(double).remote(data))
    for dtype in (torch.bfloat16, torch.float32):
        out = rt.get(rt.remote(double).remote(torch.from_numpy(data).to(dtype)))
        assert isinstance(out, torch.Tensor) and out.dtype == dtype and out.shape == (16,)
        np.testing.assert_array_equal(out.float().numpy(), want)


def test_cancel_queued_task(ray_start_thread, port):
    import ray_tpu.exceptions

    def run(api):
        errors = importlib.import_module(api.__name__ + ".exceptions")
        ref = api.remote(num_cpus=100)(impossible).remote()
        dep = api.remote(slow).remote()
        waiting = api.remote(passthrough).remote(dep)  # queued on its argument
        out = []
        for r in (ref, waiting):
            api.cancel(r)
            with pytest.raises(errors.TaskCancelledError):
                api.get(r, timeout=10)
            out.append(True)
        return out + [api.get(dep)]

    assert _both(run) == ([True, True, "slow"],) * 2


def test_retry_exceptions(ray_start_thread, port):
    def run(api):
        key = api.__name__
        ok = api.get(api.remote(flaky).options(max_retries=5, retry_exceptions=True)
                     .remote(key + "-retried", 2))
        with pytest.raises(RuntimeError, match="transient 1"):
            api.get(api.remote(flaky).options(max_retries=5).remote(key + "-not", 2))
        with pytest.raises(RuntimeError, match="transient 2"):
            api.get(api.remote(flaky).options(max_retries=1, retry_exceptions=True)
                    .remote(key + "-short", 5))
        return ok

    assert _both(run) == (3, 3)


def test_list_tasks_shows_the_tasks(ray_start_thread, port):
    import ray_tpu
    from ray_tpu.util import state as jstate
    from ray_tpu_torch.util import state

    def run(api, st):
        _release.clear()
        running = api.remote(held).remote()
        queued = api.remote(num_cpus=100)(impossible).remote()
        blocked = api.remote(passthrough).remote(running)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            rows = {(t["name"], t["state"]) for t in st.list_tasks()}
            if ("held", "RUNNING") in rows:
                break
            time.sleep(0.02)
        _release.set()
        api.get(blocked, timeout=30)
        api.cancel(queued)
        return rows

    want = {("held", "RUNNING"), ("impossible", "PENDING_SCHEDULING"),
            ("passthrough", "PENDING_ARGS_AVAIL")}
    assert run(ray_tpu, jstate) == run(rt, state) == want
    names = state.summarize_tasks()
    assert names["held"]["FINISHED"] == 1 and names["passthrough"]["RUNNING"] == 1
    assert any(e["name"] == "held" and e["cat"] == "task" for e in state.timeline())


def test_runtime_context_names_the_task(ray_start_thread, port):
    """The port names the running task in thread mode as in process mode;
    the reference's thread mode has no task runtime to ask (None), its
    process mode names it (``ray_tpu/_private/worker.py:879-881``)."""
    import ray_tpu

    j, p = _both(lambda api: api.get(api.remote(name="named")(task_name).remote(api.__name__)))
    assert (j, p) == (None, "named")
    ctx = rt.get_runtime_context()
    assert ctx.get_task_name() is None and len(ctx.get_job_id()) == 8
    assert ctx.get_node_id() == rt.nodes()[0]["NodeID"]
    assert ray_tpu.get_runtime_context().get_task_name() is None


# ---- the port's own -----------------------------------------------------------------


def test_a_lambda_or_closure_is_refused_at_remote(port):
    k = 3
    for fn in (lambda x: x, lambda x: x + k):
        f = rt.remote(fn)
        with pytest.raises(TypeError, match="standard pickle, by reference"):
            f.remote(1)


def test_options_part_2_brings_and_the_ones_refused(port):
    with pytest.raises(TypeError, match="num_gpus"):
        rt.remote(num_tpus=1)(add)
    for opts, match in (({"num_returns": "streaming"}, "part 2"),
                        ({"runtime_env": {"py_modules": []}}, "part 2"),
                        ({"tenant": "a"}, "Queue A item 9"),
                        ({"priority": 1}, "Queue A item 9")):
        with pytest.raises(NotImplementedError, match=match):
            rt.remote(**opts)(add)
    with pytest.raises(NotImplementedError, match="part 2"):
        rt.remote(type("Counter", (), {}))
    with pytest.raises(TypeError, match="cannot be called directly"):
        rt.remote(add)(1, 2)
    with pytest.raises(rt.RayTpuError, match="called twice"):
        rt.init(mode="thread")
    assert rt.init(ignore_reinit_error=True) is not None
    with pytest.raises(rt.RayTpuError, match="session file"):
        rt.init(address="auto")


def test_object_ref_by_id(port):
    import asyncio

    ref = rt.put(7)
    assert len(ref.hex()) == 32 and ref.task_id() == ref.hex()[:24]
    again = pickle.loads(pickle.dumps(ref))
    assert again == ref and hash(again) == hash(ref) and again is not ref
    assert rt.get(again) == 7
    assert ref.future().result(timeout=10) == 7

    async def awaited():
        return await ref

    assert asyncio.run(awaited()) == 7
    a, b, c = rt.remote(num_returns=3)(three).remote()
    assert a.task_id() == b.task_id() == c.task_id() != ref.task_id()


def test_a_ref_nested_in_an_argument_resolves_in_the_drivers_table(port):
    inner_ref = rt.put(np.arange(4))
    out = rt.get(rt.remote(passthrough).remote({"ref": inner_ref}))
    assert out["ref"] == inner_ref
    np.testing.assert_array_equal(rt.get(out["ref"]), np.arange(4))


def test_an_object_is_freed_with_its_last_ref(port):
    from ray_tpu_torch._private import worker

    store = worker.driver().store
    ref = rt.put(np.ones(1000))
    nested = rt.put([ref])
    assert rt.get(rt.remote(passthrough).remote(nested))[0] == ref
    del ref
    gc.collect()
    store.collect()
    assert len(store) == 2  # the inner object lives in the outer one
    del nested
    gc.collect()
    deadline = time.monotonic() + 10
    while worker.driver().scheduler.live() and time.monotonic() < deadline:
        time.sleep(0.01)
    store.collect()
    assert len(store) == 0


def test_custom_resources_and_a_card_cap_gate_tasks(tmp_path):
    """``init``'s custom resources and ``num_gpus`` are logical: a task
    holds what it names while it runs, so two that each take all of it run
    one after the other; card shares also lease from the ledger."""
    from ray_tpu_torch._private.cards import CardLedger, use_ledger

    with use_ledger(CardLedger(str(tmp_path / "ledger"), cards=["0", "1"], cpus=8)) as ledger:
        rt.init(num_cpus=8, num_gpus=0.5, resources={"slot": 1}, mode="thread")
        try:
            assert rt.cluster_resources() == {"CPU": 8.0, "GPU": 0.5, "slot": 1.0}
            for opts in ({"resources": {"slot": 1}}, {"num_gpus": 0.5}):
                h = rt.remote(**opts)(hog)
                (s1, e1), (s2, e2) = sorted(rt.get([h.remote(0.3), h.remote(0.3)], timeout=30))
                assert s2 >= e1 - 1e-3, opts
            assert ledger.holders() == []  # the driver's lease for a task ends with it
            ref = rt.remote(resources={"other": 1})(impossible).remote()
            assert rt.wait([ref], timeout=0.3) == ([], [ref])
        finally:
            rt.shutdown()


def test_bf16_tensor_keeps_its_bits(port):
    import torch

    x = torch.randn(3, 5, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    out = rt.get(rt.put(x))
    assert out.dtype == torch.bfloat16 and torch.equal(out.view(torch.int16),
                                                       x.view(torch.int16))
