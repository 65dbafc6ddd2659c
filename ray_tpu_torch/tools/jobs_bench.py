"""Job submission on the card: a port driver submitted as a job, which runs
an engine actor on a half-card lease, and a job that holds a lease until
it is stopped, through the entry points a user calls.

    python -m ray_tpu_torch.tools.jobs_bench          # the card: the smoke's jobs phase
    python -m ray_tpu_torch.tools.jobs_bench --cpu    # rehearsal on the CPU, a tiny model

``chip_smoke.py``'s jobs phase runs ``jobs_part``, which returns one dict
with its measurements, ``ok`` and ``failed_checks``. Two jobs go to
``JobSubmissionClient().submit_job`` at once, each this module run as its
entrypoint:

1. ``--entrypoint``: a port driver. One ``ProcessActor(EngineActor)`` on a
   half-card lease (``spawn_env.assign_cards``; on the CPU, none) builds
   the batch phase's engine and generates the prompts of a JSON file in
   one block; the job prints one JSON line a prompt (its row and text).
2. ``--hold``: a ``ProcessActor`` that holds a half-card lease (on the
   CPU, one CPU slot of the ledger in ``--ledger``), then sleeps until it
   is stopped with ``stop_job``.

Limits: job 1 reads ``RUNNING``, then ``SUCCEEDED``, and its log (through
``get_job_logs`` and through ``tail_job_logs``) holds each prompt's text,
equal to the expected one, and in its engine actor every decode step a
graph replay and the RMSNorm launches since the engine was built equal
what its engine's counters give (the job prints the actor's report);
job 2 reads ``STOPPED``, its process group is
gone and the ledger holds no lease of it; a second ``JobManager`` on the
same log directory lists both jobs. Reported: each job's seconds from
submission to its end (job 1) or to its lease (job 2), and the stop's
seconds. On the CPU the model is tiny; nothing there is a device number.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import threading
import time

from ray_tpu_torch._private.cards import (CardLedger, default_ledger, set_default_ledger,
                                         use_ledger)
from ray_tpu_torch._private.process_actor import ProcessActor, get, start_all
from ray_tpu_torch._private.spawn_env import _group_members, assign_cards
from ray_tpu_torch.job_submission import JobManager, JobStatus, JobSubmissionClient

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
JOB_TIMEOUT_S = 600.0
HOLDING = "holding the lease"


def _entrypoint(args) -> int:
    """Job 1's body: a port driver with one engine actor."""
    from ray_tpu_torch.tools.util_bench import EngineActor, rehearsal_config

    llm, sampling, _, _ = rehearsal_config(args.cpu)
    device = "cpu" if args.cpu else None
    with open(args.prompts) as f:
        prompts = json.load(f)
    lease, = [None] if args.cpu else assign_cards(1, 0.5, "job engine actor")
    actor = ProcessActor(EngineActor, (llm, device), lease=lease, name="job-engine")
    try:
        start_all([actor])
        texts = get(actor.call("generate", prompts, sampling), timeout=JOB_TIMEOUT_S)
        report = get(actor.call("report"))
    finally:
        actor.kill()
    for row, text in enumerate(texts):
        print(json.dumps({"row": row, "text": text}), flush=True)
    print(json.dumps({"report": report}), flush=True)
    return 0


def _hold(args) -> int:
    """Job 2's body: an actor holding a lease, then sleep until stopped."""
    if args.ledger:
        set_default_ledger(CardLedger(args.ledger, cards=[], cpus=2))
    lease, = assign_cards(1, 0, "held job actor", cpu=1) if args.cpu else \
        assign_cards(1, 0.5, "held job actor")
    actor = ProcessActor(threading.Event, lease=lease, name="job-holder")
    start_all([actor])
    print(f"{HOLDING} in pid {actor.pid}", flush=True)
    get(actor.call("wait"), timeout=None)  # until the job is stopped
    return 0


def _texts(log: str) -> list:
    rows = [json.loads(line) for line in log.splitlines() if line.startswith('{"row"')]
    return [r["text"] for r in sorted(rows, key=lambda r: r["row"])]


def _report(log: str) -> dict:
    """Job 1's engine actor's ``report()``, from its log."""
    for line in log.splitlines():
        if line.startswith('{"report"'):
            return json.loads(line)["report"]
    return {}


def jobs_part(prompts: list, want: list, device=None, ledger_root=None) -> dict:
    """The jobs slice: job 1 over ``prompts`` (``want``: each one's text),
    job 2 on ``ledger_root``'s ledger (default: the host's)."""
    ledger = CardLedger(ledger_root, cards=[], cpus=2) if ledger_root else default_ledger()
    with use_ledger(ledger), tempfile.TemporaryDirectory() as tmp:
        prompts_file = os.path.join(tmp, "prompts.json")
        with open(prompts_file, "w") as f:
            json.dump(prompts, f)
        return _jobs(prompts_file, len(prompts), want, device == "cpu", ledger, ledger_root)


def _jobs(prompts_file: str, n: int, want: list, cpu: bool, ledger, ledger_root) -> dict:
    client = JobSubmissionClient()
    manager = client._manager
    base = [sys.executable, "-m", "ray_tpu_torch.tools.jobs_bench"] + (["--cpu"] if cpu else [])
    env = {"working_dir": REPO}
    bad = []
    t0 = time.perf_counter()
    run = client.submit_job(entrypoint=base + ["--entrypoint", "--prompts", prompts_file],
                            runtime_env=env, metadata={"part": "engine"})
    hold = client.submit_job(entrypoint=base + ["--hold"] + (["--ledger", ledger_root]
                                                             if ledger_root else []),
                             runtime_env=env, metadata={"part": "hold"})
    run_status_first = client.get_job_status(run)
    hold_pid = client.get_job_info(hold)["pid"]  # its process group's id
    try:
        deadline = time.monotonic() + JOB_TIMEOUT_S
        while HOLDING not in client.get_job_logs(hold):
            if client.get_job_status(hold).is_terminal() or time.monotonic() > deadline:
                raise RuntimeError(f"the holding job ended or timed out:\n"
                                   f"{client.get_job_logs(hold)[-4000:]}")
            time.sleep(0.1)
        hold_s = time.perf_counter() - t0
        held = [str(h) for h in ledger.holders()]
        t1 = time.perf_counter()
        stopped = client.stop_job(hold)
        stop_s = time.perf_counter() - t1
        tailed = "".join(client.tail_job_logs(run))
        run_status = manager.wait_until_finished(run, timeout=JOB_TIMEOUT_S)
        run_s = time.perf_counter() - t0
        hold_status = manager.wait_until_finished(hold, timeout=60)
    finally:
        for job in (run, hold):  # a failed check leaves no job running
            if not client.get_job_status(job).is_terminal():
                client.stop_job(job)
    logged = client.get_job_logs(run)
    listed = {j["job_id"] for j in JobManager(log_dir=manager._log_dir).list_jobs()}
    holders_after = [str(h) for h in ledger.holders()]
    texts, tail_texts, rep = _texts(logged), _texts(tailed), _report(logged)
    st = rep.get("stats", {})
    n_norms = 2 * rep.get("n_layers", 0) + 1
    expected = (n_norms * (st.get("decode_steps", 0) + st.get("prefill_final_chunks", 0))
                + (n_norms - 1) * st.get("prefill_mid_chunks", 0))
    launches = rep.get("launches_since_build", {}).get("rmsnorm")
    out = {
        "part": "jobs", "device": "cpu" if cpu else "cuda", "rows": n,
        "run_status_first": run_status_first.value, "run_status": run_status.value,
        "run_s": run_s, "texts_equal": sum(t == w for t, w in zip(texts, want)),
        "tail_texts_equal": sum(t == w for t, w in zip(tail_texts, want)),
        "hold_s": hold_s, "held": held, "stop_s": stop_s, "stopped": stopped,
        "hold_status": hold_status.value, "hold_group_left": _group_members(hold_pid),
        "listed_by_second_manager": sorted(listed & {run, hold}),
        "holders_after": holders_after, "log_dir": manager._log_dir,
        "engine_build_s": rep.get("engine_build_s"), "peak_memory_gb": rep.get("peak_memory_gb"),
        "rmsnorm_launches_expected": expected,
        **{k: st.get(k) for k in ("decode_steps", "decode_graph_replays", "prefill_mid_chunks",
                                  "prefill_final_chunks")},
        "launches": {"rmsnorm": launches},
    }
    if (run_status_first, run_status) != (JobStatus.RUNNING, JobStatus.SUCCEEDED):
        bad.append(f"job 1 went {run_status_first.value} -> {run_status.value}, not RUNNING -> "
                   f"SUCCEEDED:\n{logged[-4000:]}")
    if out["texts_equal"] != n or len(texts) != n:
        bad.append(f"job 1's log: {out['texts_equal']} of {n} texts equal")
    if out["tail_texts_equal"] != n or len(tail_texts) != n:
        bad.append(f"job 1's tailed log: {out['tail_texts_equal']} of {n} equal")
    if not rep or launches != (0 if cpu else expected):
        bad.append(f"job 1's engine actor: rmsnorm launches {launches} != {expected}")
    if not cpu and st.get("decode_graph_replays") != st.get("decode_steps"):
        bad.append("job 1's engine actor: a decode step was no graph replay")
    if not held:
        bad.append("the holding job's lease was not in the ledger")
    if not stopped or hold_status is not JobStatus.STOPPED or out["hold_group_left"]:
        bad.append(f"job 2: stopped {stopped}, {hold_status.value}, its group's live "
                   f"processes {out['hold_group_left']}")
    if not {run, hold} <= listed:
        bad.append(f"a second JobManager on {manager._log_dir} does not list both jobs")
    if holders_after:
        bad.append(f"leases left: {holders_after}")
    out["ok"] = not bad
    out["failed_checks"] = bad
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="a tiny model on the CPU")
    ap.add_argument("--entrypoint", action="store_true", help="job 1's body")
    ap.add_argument("--hold", action="store_true", help="job 2's body")
    ap.add_argument("--prompts", help="job 1: a JSON file of prompts")
    ap.add_argument("--ledger", help="job 2: a card ledger's directory (default: the host's)")
    args = ap.parse_args(argv)
    if args.entrypoint:
        return _entrypoint(args)
    if args.hold:
        return _hold(args)
    from ray_tpu_torch.tools.util_bench import expected_texts, rehearsal_config

    llm, sampling, prompts, smi = rehearsal_config(args.cpu)
    device = "cpu" if args.cpu else None
    prompts = prompts[:16]
    want = expected_texts(llm, prompts, sampling, device)
    if not args.cpu:
        import torch

        torch.cuda.empty_cache()
    out = jobs_part(prompts, want, device=device)
    print(json.dumps({**out, "card": smi}, default=str), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
