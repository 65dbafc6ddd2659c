"""The environment a spawned port process starts with.

Shared by the Train layer's rank processes
(``train/_internal/worker_group.py``) and the process actors of
``_private/process_actor.py``. A child process reads its cards and its
thread count from the environment it starts with, before any import in it
can initialise CUDA or size an OpenMP pool, so the parent sets them around
``Process.start`` (``environ``). Their cards and CPU slots are leased from
the host's card ledger (``_private/cards.py``) and held by the child
(``start_process``), and their output goes to the session's log files
(``_private/log_capture.py``). A process that spawns processes of its own
and must not be outlived by them (a Tune trial, ``tune/tuner.py``) leads a
process group (``lead_process_group``), which its parent ends whole,
leases included (``end_process_group``).
"""

from __future__ import annotations

import math
import multiprocessing
import os
import signal
import threading
import time
import uuid
from contextlib import contextmanager, suppress
from typing import Optional

from ray_tpu_torch._private import log_capture
from ray_tpu_torch._private.cards import CardLedger, Lease, default_ledger
from ray_tpu_torch.accelerator import GPUAcceleratorManager

PARENT_POLL_S = 0.2  # how often a group's leader looks for its parent
GROUP_END_S = 10.0  # how long end_process_group waits for the group to exit


@contextmanager
def environ(env: dict):
    """``env`` set in this process's environment, which a process spawned
    inside the block inherits, and the old values put back after."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def assign_cards(n: int, per: float, what: str, *, cpu: float = 0.0,
                 ledger: Optional[CardLedger] = None) -> list[Optional[Lease]]:
    """Leases for ``n`` processes of ``per`` cards each (a share of one
    card below 1, none at 0) and ``cpu`` CPU slots each, taken from the
    host's card ledger all or none (None for a process that asks for
    nothing). Raises when a card is asked for and none is visible, or when
    the processes need more cards than are visible, naming both counts;
    ``LedgerError`` when too few are free, naming the holders. Never a CPU
    fallback. ``what`` names the processes in the message."""
    ledger = ledger or default_ledger()
    if per:
        count = len(ledger.card_ids())
        if count == 0:
            raise RuntimeError(f"{what} need a CUDA device, but none is visible")
        need = math.ceil(per * n - 1e-9)
        if need > count:
            raise RuntimeError(f"{n} {what} of {per:g} card(s) each need {need} cards, "
                               f"but {count} are visible")
    request = {k: v for k, v in (("GPU", per), ("CPU", cpu)) if v}
    if not request:
        return [None] * n
    return ledger.acquire([request] * n, f"{n} {what}")


def start_process(ctx, target, args: tuple, *, name: str, env: dict,
                  lease: Optional[Lease] = None, daemon: bool = False, share: bool = False,
                  log_id: Optional[str] = None):
    """Spawn ``target(*args)`` (a ``spawn`` context's process) with ``env``
    set around its start. The child's stdout and stderr go to files
    ``log_id`` (default: a new id) of the session log directory
    (``_private/log_capture.py``). With a ``lease``, the child receives its
    descriptor and holds it for its life: the parent's copy is closed once
    the child has started (``Lease.bind``), so the lease ends with the
    child, however it ends. With ``share`` the parent keeps its copy too
    (a placement group's bundle): the lease ends with the last holder, or
    when the parent releases it."""
    log_dir = log_capture.session_log_dir()
    env = {**env, log_capture.LOG_DIR_ENV: log_dir}
    args = (log_dir, log_id or uuid.uuid4().hex, target, *args)
    target = _run_logged
    if lease is not None:
        args = (lease.inheritable(), target, *args)
        target = _run_holding
    p = ctx.Process(target=target, name=name, args=args, daemon=daemon)
    with environ(env):
        p.start()
    if lease is not None and not share:
        lease.bind(p.pid)
    return p


def _run_logged(log_dir: str, log_id: str, target, *args):
    """A child's entry: its output to its log files, then ``target(*args)``."""
    log_capture.redirect(log_dir, log_id)
    return target(*args)


def _run_holding(held, target, *args):
    """A child's entry when it holds a lease: ``held``, the lease's
    descriptor, arrived open and stays open; then ``target(*args)``."""
    return target(*args)


def process_env(cards: list, cpu_threads: int) -> dict:
    """The environment of a process that holds ``cards``; with none, a CPU
    process that sees no card and runs ``cpu_threads`` OpenMP threads."""
    if cards:
        return GPUAcceleratorManager.get_visibility_env(cards)
    return {**GPUAcceleratorManager.get_visibility_env([]),
            "OMP_NUM_THREADS": str(max(1, cpu_threads))}


def lead_process_group() -> None:
    """Make this spawned process the leader of a process group of its own,
    which every process it spawns joins, and end that group (SIGKILL) when
    this process's parent goes: a thread compares ``os.getppid()`` with the
    parent's pid every ``PARENT_POLL_S``. Call it first, before spawning
    anything."""
    os.setpgid(0, 0)
    parent = multiprocessing.parent_process()
    parent_pid = parent.pid if parent is not None else os.getppid()

    def watch():
        while os.getppid() == parent_pid:
            time.sleep(PARENT_POLL_S)
        os.killpg(0, signal.SIGKILL)

    threading.Thread(target=watch, name="parent-watch", daemon=True).start()


def _group_members(pgid: int) -> list[int]:
    """The pids of the live processes of process group ``pgid``: not
    zombies, or zombies whose main thread has exited while others have not
    yet (a killed process's open files, its lease among them, close only
    with its last thread)."""
    out = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            if int(fields[2]) == pgid and (fields[0] != "Z"
                                           or len(os.listdir(f"/proc/{entry}/task")) > 1):
                out.append(int(entry))
        except (OSError, IndexError):
            continue
    return out


def kill_group_members(pgid: int, but: int) -> None:
    """SIGKILL every live member of process group ``pgid`` but ``but``: a
    group's leader ending what it spawned before it exits itself."""
    for pid in _group_members(pgid):
        if pid != but:
            with suppress(ProcessLookupError, PermissionError):
                os.kill(pid, signal.SIGKILL)


def end_process_group(pgid: int, ledger: Optional[CardLedger] = None) -> list[int]:
    """SIGKILL every process of the group that ``lead_process_group`` made
    ``pgid`` lead, and wait up to ``GROUP_END_S`` for them to exit and for
    the leases they held in ``ledger`` (default: this process's) to be
    free. A killed process's lease may outlast what ``/proc`` shows of it
    (its lock is dropped when the kernel closes its last file, which on a
    card's host can trail the process's exit), so the ledger itself is
    read. Returns the pids still alive, or still holding a lease, at the
    deadline."""
    seen = {pgid, *_group_members(pgid)}
    with suppress(ProcessLookupError, PermissionError):
        os.killpg(pgid, signal.SIGKILL)
    ledger = ledger or default_ledger()
    deadline = time.monotonic() + GROUP_END_S
    while True:
        left = _group_members(pgid)
        seen.update(left)
        if not left:
            left = sorted({h.pid for h in ledger.holders() if h.pid in seen})
        if not left or time.monotonic() >= deadline:
            return left
        time.sleep(0.02)
