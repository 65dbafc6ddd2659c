"""Worker group: N rank processes on this host, joined in one torch process group.

Counterpart of ``ray_tpu/train/_internal/worker_group.py`` (``TrainWorker``
:32, ``WorkerGroup`` :144). The JAX group is a gang of ray_tpu actors on a
placement group; the port's is ``multiprocessing`` with the ``spawn``
context (CUDA forbids ``fork``), one process per rank:

- *Cards.* Each rank leases what it needs from the host's card ledger
  (``_private/cards.py``, ``rank_request``), all ranks or none, and holds
  the lease for its life: under ``use_gpu`` rank r gets its own cards,
  made visible through ``GPUAcceleratorManager.get_visibility_env`` in the
  environment the child starts with (so no import in the child can
  initialise CUDA before it is set). Asking for more cards than are
  visible, or than are free, raises at once, naming the counts and the
  holders (the counterpart of the placement group's ``TimeoutError``,
  :164-171). CPU ranks see no card and split the host's cores between
  them (``OMP_NUM_THREADS``, unless the caller set it), or run as many
  threads as the CPU slots ``resources_per_worker`` leases them. The
  environment is ``_private/spawn_env.py``'s, which the process actors of
  RLlib's remote half share.
- *Rendezvous.* In place of ``jax.distributed.initialize`` (:74-79) every
  rank calls ``torch.distributed.init_process_group``, NCCL under
  ``use_gpu`` and gloo otherwise, as the reference's
  ``_setup_torch_process_group`` does. The controller hosts the
  rendezvous store on a port the OS picks and brokers its address with
  ``RAY_TPU_WORLD_SIZE``, ``RAY_TPU_RANK`` and ``RAY_TPU_COORDINATOR``
  (:189-220). A GPU rank calls ``torch.cuda.set_device`` before its first
  collective; the group is destroyed when the loop ends.
- *The train function* travels with the standard ``pickle``, by reference
  (a module-level function), together with its config and the rank's
  dataset shards, and is unpickled after the rank's environment is set.
- *Results* come back over one pipe per rank, read by ``poll``, which waits
  on the pipes and the processes' sentinels together, so a rank that dies
  is seen as soon as its pipe is drained.
- *Tune trials* (``tune/tuner.py``) are 1-rank groups started with a
  lease the controller took (``start(leases=...)``: a trial may hold a
  share of a card, which Train ranks may not) and a ledger: the trial
  process leads a process group of its own
  (``spawn_env.lead_process_group``), so that what it spawns ends with it,
  and leases what it spawns from the driver's ledger (``use_ledger``).
- *Long-lived ranks* (``start_loop``, the serving gang of ``llm/gang.py``)
  take the same environment and rendezvous and also get an inbound pipe:
  ``send(rank, msg)`` writes to it, and the rank's loop reads its messages
  in the order they were sent. One thread sending to every rank in turn
  gives every rank the same sequence.
- *The record.* The group registers its ranks in this process's registry
  (``_private/registry.py``, kind ``"rank"``): ``ALIVE`` when started,
  ``DEAD`` when seen exited or stopped. Their environment carries the way
  back to this process (``_private/driver_link.py``).
"""

from __future__ import annotations

import contextlib
import multiprocessing
import os
import pickle
import sys
import time
import traceback
from datetime import timedelta
from multiprocessing.connection import wait
from typing import Any, Optional

import torch
import torch.distributed as dist

from ray_tpu_torch._private import driver_link
from ray_tpu_torch._private.cards import CardLedger, Lease, default_ledger, use_ledger
from ray_tpu_torch._private.registry import registry
from ray_tpu_torch._private.spawn_env import (assign_cards, lead_process_group, process_env,
                                              start_process)
from ray_tpu_torch.accelerator import GPUAcceleratorManager
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import ScalingConfig
from ray_tpu_torch.train.context import TrainContext
from ray_tpu_torch.train.session import _set_session, _TrainSession

_RENDEZVOUS_TIMEOUT = timedelta(seconds=300)


def rank_request(scaling: ScalingConfig) -> dict:
    """What one rank leases from the host's card ledger: its cards under
    ``use_gpu``, and the CPU slots ``resources_per_worker`` names. An
    elastic group of CPU ranks that names none takes one slot a rank, the
    reference's ``resources_per_worker or {"CPU": 1}``: its capacity is
    counted in what its ranks lease. A fixed group names what it needs or
    leases no CPU slot (eight gloo ranks run on fewer cores)."""
    res = scaling.resources_per_worker or {}
    req = {}
    if scaling.use_gpu:
        req["GPU"] = float(scaling.worker_resources()["GPU"])
    if "CPU" in res:
        req["CPU"] = float(res["CPU"])
    elif scaling.elastic and not scaling.use_gpu:
        req["CPU"] = 1.0
    return req


def lease_ranks(scaling: ScalingConfig, n: int) -> list[Optional[Lease]]:
    """Each rank's lease (None for a rank that asks for nothing), all or
    none. Raises when no card is visible under ``use_gpu``, when the ranks
    need more cards than are visible (naming both counts), and
    ``LedgerError`` when too few are free (naming the holders): the
    counterpart of the placement group's ``TimeoutError``
    (``ray_tpu/train/_internal/worker_group.py:160-171``)."""
    req = rank_request(scaling)
    per = req.get("GPU", 0.0)
    if scaling.use_gpu:
        ok, why = GPUAcceleratorManager.validate_resource_request_quantity(per)
        if not ok or per < 1:
            raise ValueError(why or f"a GPU rank needs at least one card, got GPU: {per}")
        if not default_ledger().card_ids():
            raise RuntimeError(
                "ScalingConfig(use_gpu=True) but no CUDA device is visible; pass "
                "ScalingConfig(use_gpu=False) to run the ranks on the CPU"
            )
    return assign_cards(n, per, "GPU ranks" if per else "CPU ranks", cpu=req.get("CPU", 0.0))


def _join(backend: str) -> tuple[int, torch.device]:
    """Join this rank's process group (NCCL on its card, or gloo): (rank,
    device)."""
    env = os.environ
    rank = int(env["RAY_TPU_RANK"])
    device = torch.device("cpu")
    if backend == "nccl":
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    host, port = env["RAY_TPU_COORDINATOR"].rsplit(":", 1)
    store = dist.TCPStore(host, int(port), is_master=False, timeout=_RENDEZVOUS_TIMEOUT)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=int(env["RAY_TPU_WORLD_SIZE"]),
                            timeout=_RENDEZVOUS_TIMEOUT)
    return rank, device


def _rank_main(backend: str, context_kwargs: dict, storage_dir: str,
               checkpoint_path: Optional[str], blob: bytes, conn, spawned_at: float,
               ledger: Optional[CardLedger] = None) -> None:
    """A rank process's body: rendezvous, session, train loop. Sends
    ``started``, then the loop's results, then ``done`` or ``error``. With
    ``ledger`` (a Tune trial) it first becomes a process group's leader and
    runs the loop with ``ledger`` as its default."""
    rank = int(os.environ["RAY_TPU_RANK"])
    if ledger is not None:
        lead_process_group()
    try:
        rank, device = _join(backend)
        train_fn, config, shards = pickle.loads(blob)
        chk = Checkpoint(checkpoint_path) if checkpoint_path else None
        os.makedirs(storage_dir, exist_ok=True)
        _set_session(_TrainSession(TrainContext(**context_kwargs), storage_dir, chk, shards,
                                   conn, device))
        conn.send({"kind": "started", "rank": rank, "startup_s": time.time() - spawned_at})
        with use_ledger(ledger) if ledger is not None else contextlib.nullcontext():
            if config is not None:
                train_fn(config)
            else:
                train_fn()
    except BaseException:
        conn.send({"kind": "error", "rank": rank, "error": traceback.format_exc()})
        sys.exit(1)  # the finally below still runs
    finally:
        _set_session(None)
        if dist.is_initialized():
            dist.destroy_process_group()
    conn.send({"kind": "done", "rank": rank})
    conn.close()


def _loop_main(backend: str, blob: bytes, conn, inbox, spawned_at: float) -> None:
    """A long-lived rank's body: rendezvous, then ``loop_fn(config, conn,
    inbox, device)``, which reads its messages from ``inbox`` and writes
    its replies to ``conn``. Sends ``started``, then ``done`` or ``error``."""
    rank = int(os.environ["RAY_TPU_RANK"])
    try:
        rank, device = _join(backend)
        loop_fn, config = pickle.loads(blob)
        conn.send({"kind": "started", "rank": rank, "startup_s": time.time() - spawned_at})
        loop_fn(config, conn, inbox, device)
    except BaseException:
        conn.send({"kind": "error", "rank": rank, "error": traceback.format_exc()})
        sys.exit(1)  # the finally below still runs
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    try:
        conn.send({"kind": "done", "rank": rank})
    except OSError:
        pass  # the server went (its end of the inbox closed first): nobody reads it
    conn.close()


class WorkerGroup:
    """Spawns, polls and reaps the rank processes of one attempt."""

    def __init__(self, scaling: ScalingConfig, experiment_name: str = "train",
                 trial_id: str = ""):
        self.scaling = scaling
        self.experiment_name = experiment_name
        self.trial_id = trial_id
        self.num_workers = scaling.num_workers
        self.procs: list = []
        self._conns: dict[int, Any] = {}
        self._inboxes: dict[int, Any] = {}
        self._eof: set[int] = set()
        self._store = None
        self._ids: list[str] = []  # each rank's registry id

    def start(self, train_fn, config: Optional[dict], storage_dir: str,
              latest_checkpoint_path: Optional[str], shards: list[dict],
              num_workers: Optional[int] = None, *, leases: Optional[list] = None,
              trial_name: str = "", ledger: Optional[CardLedger] = None) -> None:
        """Spawn the ranks; ``shards[r]`` is rank r's {name: dataset shard}.
        ``leases`` (one a rank) are taken by the caller in place of
        ``lease_ranks``'; ``trial_name`` and ``ledger`` make the ranks Tune
        trials (``_rank_main``)."""
        def args(rank, n, backend, coordinator, send, inbox):
            context = dict(world_size=n, world_rank=rank, local_rank=rank, local_world_size=n,
                           node_rank=0, experiment_name=self.experiment_name,
                           trial_name=trial_name, trial_id=self.trial_id,
                           coordinator_address=coordinator)
            blob = pickle.dumps((train_fn, config, shards[rank]))
            return (backend, context, storage_dir, latest_checkpoint_path, blob, send,
                    time.time(), ledger)

        self._spawn(num_workers or self.scaling.num_workers, _rank_main, args, inbound=False,
                    leases=leases)

    def start_loop(self, loop_fn, config, num_workers: Optional[int] = None) -> None:
        """Spawn ranks that each run ``loop_fn(config, conn, inbox, device)``
        (a module-level function: it travels by name) after the rendezvous,
        with an inbound pipe that ``send`` writes to."""
        blob = pickle.dumps((loop_fn, config))

        def args(rank, n, backend, coordinator, send, inbox):
            return (backend, blob, send, inbox, time.time())

        self._spawn(num_workers or self.scaling.num_workers, _loop_main, args, inbound=True)

    def _spawn(self, n: int, target, args, inbound: bool, leases: Optional[list] = None) -> None:
        self.num_workers = n
        leases = leases if leases is not None else lease_ranks(self.scaling, n)
        backend = "nccl" if self.scaling.use_gpu else "gloo"
        mp = multiprocessing.get_context("spawn")
        # CPU ranks share this host's cores (torchrun's default too), or
        # run as many threads as the CPU slots they lease
        threads = int(os.environ.get("OMP_NUM_THREADS") or (os.cpu_count() or 1) // n)
        try:
            self._store = dist.TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False,
                                        timeout=_RENDEZVOUS_TIMEOUT)
            coordinator = f"127.0.0.1:{self._store.port}"
            for rank, lease in enumerate(leases):
                cards = lease.cards if lease is not None else []
                env = {"RAY_TPU_WORLD_SIZE": str(n), "RAY_TPU_RANK": str(rank),
                       "RAY_TPU_COORDINATOR": coordinator,
                       **process_env(cards, int(lease.cpu) if lease and lease.cpu else threads),
                       **driver_link.child_env()}
                recv, send = mp.Pipe(duplex=False)
                inbox = outbox = None
                if inbound:
                    inbox, outbox = mp.Pipe(duplex=False)
                p = start_process(mp, target, args(rank, n, backend, coordinator, send, inbox),
                                  name=f"{self.experiment_name}-rank-{rank}", env=env,
                                  lease=lease)
                send.close()  # the child holds the write end
                if inbox is not None:
                    inbox.close()  # ... and the read end of its inbox
                    self._inboxes[rank] = outbox
                self.procs.append(p)
                self._conns[rank] = recv
                rank_id = f"{self.experiment_name}-{self.trial_id or 'group'}-{p.pid}-{rank}"
                registry().started(rank_id, kind="rank", name=p.name,
                                   class_name=target.__name__, pid=p.pid, cards=cards,
                                   cpu=lease.cpu if lease is not None else 0.0, state="ALIVE")
                self._ids.append(rank_id)
        finally:
            for lease in leases:  # those no rank took (a failed start)
                if lease is not None:
                    lease.release()

    def send(self, rank: int, msg) -> None:
        """Write ``msg`` to the inbox of a rank from ``start_loop``; raises
        ``OSError`` when the rank has gone."""
        self._inboxes[rank].send(msg)

    def waitables(self) -> list:
        """What ``poll`` waits on: the undrained pipes and the live ranks'
        sentinels (for ``multiprocessing.connection.wait`` over several
        groups)."""
        return ([c for r, c in self._conns.items() if r not in self._eof]
                + [p.sentinel for p in self.procs if p.exitcode is None])

    def poll(self, timeout: float) -> tuple[list[dict], dict[int, int]]:
        """Wait up to ``timeout`` for a message or an exit. Returns the
        messages received (each rank's in the order sent) and {rank:
        exitcode} for ranks that have exited and whose pipes are drained."""
        if any(r not in self._eof for r in self._conns):
            wait(self.waitables(), timeout)
        # read before draining: a rank seen exited here has all its
        # messages in its pipe, so the drain below reaches its end
        exited = {r: p.exitcode for r, p in enumerate(self.procs) if p.exitcode is not None}
        msgs = []
        for r, conn in self._conns.items():
            if r in self._eof:
                continue
            try:
                while conn.poll():
                    msgs.append(conn.recv())
            except EOFError:
                self._eof.add(r)
        ended = {r: code for r, code in exited.items() if r in self._eof}
        for r, code in ended.items():
            registry().set_state(self._ids[r], "DEAD", f"exited with code {code}")
        return msgs, ended

    def shutdown(self, wait_s: float = 0.0) -> None:
        """Give the ranks ``wait_s`` to exit on their own, then terminate,
        join with a deadline, and kill what is left. No rank outlives it."""
        deadline = time.monotonic() + wait_s
        for p in self.procs:
            p.join(max(0.0, deadline - time.monotonic()))
        for p in self.procs:
            if p.is_alive():
                p.terminate()
        deadline = time.monotonic() + 10.0
        for p in self.procs:
            p.join(max(0.0, deadline - time.monotonic()))
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join()
        for rank_id, p in zip(self._ids, self.procs):
            registry().set_state(rank_id, "DEAD", f"stopped (exit code {p.exitcode})")
        for conn in list(self._conns.values()) + list(self._inboxes.values()):
            conn.close()
        self._conns = {}
        self._inboxes = {}
        self._store = None


def run_ranks(train_fn, config: Optional[dict], num_workers: int, use_gpu: bool,
              timeout_s: float, storage_dir: Optional[str] = None) -> list[list[dict]]:
    """Run ``train_fn(config)`` on ``num_workers`` ranks of one process
    group and return each rank's reported metrics, in order, by rank.
    Unlike ``TorchTrainer.fit`` there is no restart and a deadline: a rank's
    error or death, or ``timeout_s`` passing (a hung collective), raises
    ``RuntimeError`` after every rank is stopped."""
    import shutil
    import tempfile

    group = WorkerGroup(ScalingConfig(num_workers=num_workers, use_gpu=use_gpu),
                        experiment_name="ranks")
    own = storage_dir is None
    storage_dir = storage_dir or tempfile.mkdtemp(prefix="ray_tpu_torch_ranks_")
    results: list[list[dict]] = [[] for _ in range(num_workers)]
    done: set[int] = set()
    deadline = time.monotonic() + timeout_s
    try:
        group.start(train_fn, config, storage_dir, None, [{} for _ in range(num_workers)])
        while len(done) < num_workers:
            if time.monotonic() > deadline:
                raise RuntimeError(f"ranks {sorted(set(range(num_workers)) - done)} did not "
                                   f"finish within {timeout_s:.0f} s")
            msgs, exited = group.poll(0.1)
            for m in msgs:
                if m["kind"] == "result":
                    results[m["rank"]].append(m["metrics"])
                elif m["kind"] == "done":
                    done.add(m["rank"])
                elif m["kind"] == "error":
                    raise RuntimeError(f"rank {m['rank']} failed:\n{m['error']}")
            for rank, code in sorted(exited.items()):
                if rank not in done:
                    raise RuntimeError(f"rank {rank} exited with code {code} before its loop "
                                       "finished")
    finally:
        group.shutdown(wait_s=30.0 if len(done) == num_workers else 0.0)
        if own:
            shutil.rmtree(storage_dir, ignore_errors=True)
    return results
