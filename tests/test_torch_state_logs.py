"""Log capture, the state API's log and stack functions and ``internal_kv``
in the port, against the JAX package's, on the CPU.

Mirrors ``tests/test_worker_logs.py`` (a print in another process reaches
the driver's console prefixed with that process's identity; a dead
process's output can still be fetched; the state API lists the files and
keeps a ring buffer of lines) and ``internal_kv`` from
``tests/test_fault_tolerance.py:245`` without the restart (the port keeps
no snapshot: ``ROADMAP.md``, "Out by decision"). The port's own checks: a
traceback printed in a child reaches the driver's stderr; the KV table
and the log functions answer from a port process through its driver;
``get_worker_stacks`` answers for an actor busy in a method; and a
process actor's exit code survives another thread reaping it first.

JAX and ray_tpu are imported inside the tests only (actors' processes
import this module).
"""

import multiprocessing
import os
import signal
import sys
import threading
import time

import pytest

from ray_tpu_torch._private import log_capture
from ray_tpu_torch._private.process_actor import ActorDiedError, ProcessActor, get, start_all
from ray_tpu_torch.experimental import internal_kv
from ray_tpu_torch.util import state

pytestmark = pytest.mark.timeout(300)


class Talker:
    def speak(self, word: str) -> int:
        print(word)
        return os.getpid()

    def shout(self, word: str) -> bool:
        print(word)
        sys.stdout.flush()
        return True

    def fail_in_a_thread(self, word: str) -> None:
        def boom():
            raise RuntimeError(word)

        t = threading.Thread(target=boom, name="doomed")
        t.start()
        t.join()

    def nap(self, s: float) -> str:
        time.sleep(s)
        return "awake"

    def kv_bump(self, key: str) -> int:
        n = int(internal_kv.kv_get(key, namespace="child") or b"0") + 1
        internal_kv.kv_put(key, str(n).encode(), namespace="child")
        return n

    def logs_seen_from_here(self) -> list:
        return [r["worker_id"] for r in state.list_logs()]


@pytest.fixture(scope="module")
def talker():
    a, = start_all([ProcessActor(Talker, name="talker")])
    yield a
    a.kill()


def _poll(capsys, needle: str, timeout: float = 20.0) -> tuple:
    """Captured (stdout, stderr) until ``needle`` appears in either."""
    out = err = ""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        c = capsys.readouterr()
        out, err = out + c.out, err + c.err
        if needle in out + err:
            break
        time.sleep(0.1)
    return out, err


def test_actor_print_streams_to_driver_prefixed(talker, capsys):
    pid = get(talker.call("speak", "talker-says-ba5e"), timeout=60)
    assert pid == talker.pid != os.getpid()  # really another process
    out, _ = _poll(capsys, "talker-says-ba5e")
    line = next(ln for ln in out.splitlines() if "talker-says-ba5e" in ln)
    assert line == f"(talker pid={pid}) talker-says-ba5e"


def test_a_childs_traceback_reaches_the_driver_stderr(talker, capsys):
    get(talker.call("fail_in_a_thread", "visible-failure-7c1d"), timeout=60)
    _, err = _poll(capsys, "visible-failure-7c1d")
    lines = [ln for ln in err.splitlines() if ln.startswith(f"(talker pid={talker.pid})")]
    assert any("Traceback" in ln for ln in lines), err[-2000:]
    assert any("RuntimeError: visible-failure-7c1d" in ln for ln in lines), err[-2000:]


def test_dead_process_logs_fetchable(ray_start_process):
    """Both packages: a killed process's output stays fetchable by id, and
    the ring buffer holds its line."""
    import ray_tpu
    from ray_tpu.util.state import api as jst

    doomed = ProcessActor(Talker, name="doomed")
    jdoomed = ray_tpu.remote(Talker).remote()
    assert get(doomed.call("shout", "last-words-c0de"), timeout=60)
    assert ray_tpu.get(jdoomed.shout.remote("last-words-c0de"), timeout=60)
    time.sleep(0.5)  # the JAX package's monitor scans every 0.2 s
    doomed.kill()
    ray_tpu.kill(jdoomed)
    time.sleep(1.0)
    for st in (state, jst):
        found = [r for r in st.list_logs()
                 if "last-words-c0de" in st.get_log(r["worker_id"], source="out")]
        assert found, f"{st.__name__}: the dead process's output is not fetchable"
        assert any("last-words-c0de" in e["line"] for e in st.tail_cluster_logs())
    row, = [r for r in state.list_logs() if r["worker_id"] == doomed.actor_id]
    assert row["pid"] == doomed.pid and row["name"] == "doomed" and row["out_bytes"] > 0
    assert state.get_log(doomed.actor_id[:12]) == "last-words-c0de\n"
    with pytest.raises(ValueError, match="no process"):
        state.get_log("not-an-id")


def test_state_api_list_logs_shape(talker):
    get(talker.call("speak", "shape"), timeout=60)
    rows = state.list_logs()
    assert rows, "no log files listed"
    row = next(r for r in rows if r["worker_id"] == talker.actor_id)
    assert {"worker_id", "ip", "pid", "name", "out_bytes", "err_bytes"} <= set(row)
    # from a port process, over its link to the driver: the driver's files
    assert talker.actor_id in get(talker.call("logs_seen_from_here"), timeout=60)
    assert log_capture.session_log_dir().endswith(f"session_{os.getpid()}{os.sep}logs")


def test_internal_kv_matches_the_reference(ray_start_thread):
    """``tests/test_fault_tolerance.py:245`` without the restart: the same
    operations give the same answers in both packages."""
    from ray_tpu.experimental import internal_kv as jkv

    results = []
    for kv in (internal_kv, jkv):
        kv.kv_del("model/stage", namespace="app")
        kv.kv_del("other")
        kv.kv_put("model/stage", b"prefill", namespace="app")
        kv.kv_put("other", b"x")
        results.append([kv.kv_get("model/stage", namespace="app"),
                        kv.kv_get("model/stage"),
                        kv.kv_list(prefix="mo", namespace="app"),
                        kv.kv_list(prefix="zz", namespace="app"),
                        kv.kv_del("other"), kv.kv_del("other"), kv.kv_get("other")])
    assert results[0] == results[1] == [b"prefill", None, ["model/stage"], [], True, False, None]


def test_internal_kv_from_a_port_process(talker):
    internal_kv.kv_del("bumps", namespace="child")
    assert [get(talker.call("kv_bump", "bumps"), timeout=60) for _ in range(3)] == [1, 2, 3]
    assert internal_kv.kv_get("bumps", namespace="child") == b"3"
    assert internal_kv.kv_list(namespace="child") == ["bumps"]


def test_worker_stacks_of_an_actor_busy_in_a_method(talker):
    """The dump is answered by the actor's reader thread: a max_concurrency=1
    actor in the middle of a call answers at once."""
    ref = talker.call("nap", 5.0)
    time.sleep(0.5)
    t0 = time.monotonic()
    stacks = state.get_worker_stacks(talker.actor_id[:8])
    assert time.monotonic() - t0 < 3.0 and not ref.done
    text = stacks[talker.actor_id]
    assert f"pid={talker.pid}" in text
    assert "in nap" in text and "time.sleep(s)" in text, text[:2000]
    assert "--- thread calls" in text  # the reader thread, which answered
    assert get(ref, timeout=60) == "awake"
    assert state.get_worker_stacks("no-such-prefix") == {}


def _reap_children(stop: threading.Event) -> None:
    while not stop.is_set():
        multiprocessing.active_children()  # what every Process.start() does first


def test_exit_code_survives_another_thread_reaping_the_process():
    """A killed actor's pending call reads its exit code (-9) even when
    another thread of this process reaps the process first, as
    ``Process.start`` and ``active_children`` do: the code lands on the
    shared ``Popen`` a moment after this thread's ``waitpid`` fails."""
    actors = start_all([ProcessActor(threading.Event, name=f"reaped-{i}") for i in range(6)])
    stop = threading.Event()
    reaper = threading.Thread(target=_reap_children, args=(stop,), daemon=True)
    try:
        pending = [a.call("wait", 60.0) for a in actors]
        reaper.start()
        for a in actors:
            os.kill(a.pid, signal.SIGKILL)
        for a, p in zip(actors, pending):
            with pytest.raises(ActorDiedError,
                               match=f"pid {a.pid}\\) exited with code -9 before wait returned"):
                get(p, timeout=60)
    finally:
        stop.set()
        reaper.join(10)
        for a in actors:
            a.kill()
    assert all(a._proc.exitcode == -9 for a in actors)
