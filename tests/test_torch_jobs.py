"""Job submission and the dashboard in the port (``ray_tpu_torch/
job_submission/``, ``ray_tpu_torch/dashboard/``) against the JAX package's,
on the CPU.

Mirrors ``tests/test_platform.py:99-130`` (a job's lifecycle, a stopped
job), ``:259`` (a job seen from another process's ``JobManager``) and
``:294`` (the dashboard's page and endpoints, with an actor busy in a
method). The same entrypoints run through both packages' clients; their
statuses, return codes and logs are equal. The port's own checks: a job
is a process group, and stopping one leaves no process of it and no lease
on a test ledger (``tools/jobs_bench.py``'s part at a tiny size: a port
driver's engine actor, and an actor holding a CPU slot until the stop).

JAX and ray_tpu are imported inside the tests only (actors' processes
import this module).
"""

import json
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

from ray_tpu_torch._private.cards import CardLedger
from ray_tpu_torch._private.process_actor import ProcessActor, get
from ray_tpu_torch._private.spawn_env import _group_members

pytestmark = pytest.mark.timeout(300)


def _clients():
    from ray_tpu.job_submission import JobSubmissionClient as JClient
    from ray_tpu_torch.job_submission import JobSubmissionClient

    return JobSubmissionClient(), JClient()


def test_job_submission_lifecycle():
    from ray_tpu_torch.job_submission import JobStatus

    port, jax = _clients()
    ids = [c.submit_job(entrypoint=f"{sys.executable} -c \"print('job says hi')\"")
           for c in (port, jax)]
    assert port._manager.wait_until_finished(ids[0], timeout=60) is JobStatus.SUCCEEDED
    assert jax._manager.wait_until_finished(ids[1], timeout=60).value == "SUCCEEDED"
    assert port.get_job_logs(ids[0]) == jax.get_job_logs(ids[1]) == "job says hi\n"
    assert any(j["job_id"] == ids[0] for j in port.list_jobs())
    assert "".join(port.tail_job_logs(ids[0])) == "job says hi\n"

    bad = [c.submit_job(entrypoint=f"{sys.executable} -c \"raise SystemExit(3)\"")
           for c in (port, jax)]
    assert port._manager.wait_until_finished(bad[0], timeout=60) is JobStatus.FAILED
    assert jax._manager.wait_until_finished(bad[1], timeout=60).value == "FAILED"
    assert port.get_job_info(bad[0])["return_code"] == jax.get_job_info(bad[1])[
        "return_code"] == 3


def test_job_stop():
    from ray_tpu_torch.job_submission import JobStatus

    port, jax = _clients()
    ids = [c.submit_job(entrypoint=f"{sys.executable} -c \"import time; time.sleep(60)\"")
           for c in (port, jax)]
    time.sleep(0.5)
    assert port.get_job_status(ids[0]) is JobStatus.RUNNING
    assert jax.get_job_status(ids[1]).value == "RUNNING"
    assert port.stop_job(ids[0]) and jax.stop_job(ids[1])
    assert port._manager.wait_until_finished(ids[0], timeout=30) is JobStatus.STOPPED
    assert jax._manager.wait_until_finished(ids[1], timeout=30).value == "STOPPED"
    pid = port.get_job_info(ids[0])["pid"]
    assert _group_members(pid) == []  # the job's process group is gone
    assert not port.stop_job(ids[0])  # an ended job stays as it ended


@pytest.mark.parametrize("package", ["ray_tpu_torch", "ray_tpu"])
def test_job_visibility_across_processes(tmp_path, package):
    """Submit in one process, read the status and log from another."""
    import importlib

    jm = importlib.import_module(f"{package}.job_submission")
    log_dir = str(tmp_path / "jobs")
    m1 = jm.JobManager(log_dir=log_dir)
    jid = m1.submit_job(entrypoint=[sys.executable, "-c", "print('xp ok')"])
    assert m1.wait_until_finished(jid, timeout=60).value == "SUCCEEDED"
    code = (f"from {package}.job_submission import JobManager\n"
            f"m = JobManager(log_dir={log_dir!r})\n"
            f"print(m.get_job_status({jid!r}).value)\n"
            f"assert 'xp ok' in m.get_job_logs({jid!r})\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    assert "SUCCEEDED" in r.stdout


def test_a_job_stopped_from_another_process_ends_its_group(tmp_path):
    """Another process's manager stops a job by its pid: the whole process
    group ends, and the owner records STOPPED."""
    from ray_tpu_torch.job_submission import JobManager, JobStatus

    log_dir = str(tmp_path / "jobs")
    m1 = JobManager(log_dir=log_dir)
    # the entrypoint spawns a child of its own, in its group
    code = ("import subprocess, sys, time\n"
            "subprocess.Popen([sys.executable, '-c', 'import time; time.sleep(60)'])\n"
            "print('started', flush=True); time.sleep(60)\n")
    jid = m1.submit_job(entrypoint=[sys.executable, "-c", code])
    deadline = time.monotonic() + 30
    while "started" not in m1.get_job_logs(jid) and time.monotonic() < deadline:
        time.sleep(0.05)
    pid = m1.get_job_info(jid)["pid"]
    assert len(_group_members(pid)) == 2
    assert JobManager(log_dir=log_dir).stop_job(jid)
    assert m1.wait_until_finished(jid, timeout=30) is JobStatus.STOPPED
    assert _group_members(pid) == []


def test_jobs_part_stops_a_job_with_no_lease_left(tmp_path):
    """The smoke's jobs phase at a tiny size: a port driver as a job, its
    engine actor's texts in the job's log; a job whose actor holds a CPU
    slot of a test ledger until ``stop_job``, after which no process of
    its group and no lease is left."""
    from ray_tpu_torch.tools import jobs_bench
    from ray_tpu_torch.tools.util_bench import expected_texts, rehearsal_config

    llm, sampling, prompts, _ = rehearsal_config(cpu=True)
    prompts = prompts[:4]
    want = expected_texts(llm, prompts, sampling, "cpu")
    ledger_root = str(tmp_path / "ledger")
    out = jobs_bench.jobs_part(prompts, want, device="cpu", ledger_root=ledger_root)
    assert out["ok"], out["failed_checks"]
    assert out["held"] and "1 CPU slot" in out["held"][0]
    assert out["hold_status"] == "STOPPED" and out["hold_group_left"] == []
    assert CardLedger(ledger_root, cards=[], cpus=2).holders() == []
    assert out["texts_equal"] == out["tail_texts_equal"] == 4


class Sleeper:
    def nap(self, s):
        time.sleep(s)
        return "awake"


def _get(base: str, path: str):
    try:
        with urllib.request.urlopen(base + path, timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_dashboard_web_ui(ray_start_thread):
    """The page, the JSON endpoints, Prometheus metrics and the stack dump of
    an actor busy in a method; the endpoints the JAX dashboard serves
    answer in both (``/api/objects`` and ``/api/drains`` have no source on
    the port's one host: 404 naming why)."""
    from ray_tpu.dashboard import start_dashboard as jstart
    from ray_tpu.dashboard import stop_dashboard as jstop
    from ray_tpu_torch.dashboard import start_dashboard, stop_dashboard

    sleeper = ProcessActor(Sleeper, name="sleeper")
    try:
        assert get(sleeper.call("nap", 0.01), timeout=60) == "awake"
        ref = sleeper.call("nap", 8.0)  # a call in flight to dump
        time.sleep(0.5)
        base = f"http://127.0.0.1:{start_dashboard(port=0)}"
        jbase = f"http://127.0.0.1:{jstart(port=0)}"
        try:
            status, page = _get(base, "/")
            assert status == 200 and "ray_tpu_torch dashboard" in page
            assert "ray_tpu dashboard" in _get(jbase, "/")[1]
            ov = json.loads(_get(base, "/api/overview")[1])
            assert "CPU" in ov["resources"] and "CPU" in json.loads(
                _get(jbase, "/api/overview")[1])["resources"]
            assert ov["resources"]["CPU"]["total"] >= 1
            nodes = json.loads(_get(base, "/api/nodes")[1])
            assert len(nodes) == 1 == len(json.loads(_get(jbase, "/api/nodes")[1]))
            actors = json.loads(_get(base, "/api/actors")[1])
            assert any(a["class_name"] == "Sleeper" and a["state"] == "ALIVE" for a in actors)
            stacks = json.loads(_get(base, "/api/stacks")[1])
            text = stacks[sleeper.actor_id]
            assert "in nap" in text and "time.sleep(s)" in text, text[:2000]
            assert json.loads(_get(base, f"/api/stacks?worker={sleeper.actor_id[:8]}")[1]).keys() \
                == {sleeper.actor_id}
            logs = json.loads(_get(base, "/api/logs")[1])
            assert any(r["worker_id"] == sleeper.actor_id for r in logs)
            assert "text" in json.loads(_get(base, f"/api/logs?worker={sleeper.actor_id}")[1])
            tasks = json.loads(_get(base, "/api/tasks")[1])
            assert any(t["name"].endswith("nap") for t in tasks["recent"])
            for path in ("/api/workers", "/api/tenants", "/api/timeline", "/metrics"):
                assert _get(base, path)[0] == _get(jbase, path)[0] == 200, path
            for path, why in (("/api/objects", "no object store"), ("/api/drains", "one host")):
                status, body = _get(base, path)
                assert status == 404 and why in body, (path, status, body)
            assert _get(base, "/nowhere")[0] == 404
        finally:
            stop_dashboard()
            jstop()
        assert get(ref, timeout=60) == "awake"
    finally:
        sleeper.kill()
