"""Worker group: N rank processes on this host, joined in one torch process group.

Counterpart of ``ray_tpu/train/_internal/worker_group.py`` (``TrainWorker``
:32, ``WorkerGroup`` :144). The JAX group is a gang of ray_tpu actors on a
placement group; the port's is ``multiprocessing`` with the ``spawn``
context (CUDA forbids ``fork``), one process per rank:

- *Cards.* Under ``use_gpu`` rank r gets its own card through
  ``GPUAcceleratorManager.get_visibility_env``, in the environment the
  child starts with (so no import in the child can initialise CUDA before
  it is set); asking for more cards than are visible raises at once,
  naming both counts (the counterpart of the placement group's
  ``TimeoutError``, :164-171). CPU ranks split the host's cores between
  them (``OMP_NUM_THREADS``, unless the caller set it).
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
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import sys
import time
import traceback
from contextlib import contextmanager
from datetime import timedelta
from multiprocessing.connection import wait
from typing import Any, Optional

import torch
import torch.distributed as dist

from ray_tpu_torch.accelerator import GPUAcceleratorManager
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import ScalingConfig
from ray_tpu_torch.train.context import TrainContext
from ray_tpu_torch.train.session import _set_session, _TrainSession

_RENDEZVOUS_TIMEOUT = timedelta(seconds=300)


def gpu_ids_per_rank(scaling: ScalingConfig, n: int) -> Optional[list[list[str]]]:
    """Each rank's card ids under ``use_gpu`` (None for CPU ranks). Raises
    when no card is visible or the ranks need more cards than are."""
    if not scaling.use_gpu:
        return None
    per = scaling.worker_resources()["GPU"]
    ok, why = GPUAcceleratorManager.validate_resource_request_quantity(per)
    if not ok or per < 1:
        raise ValueError(why or f"a GPU rank needs at least one card, got GPU: {per}")
    per = int(per)
    count = GPUAcceleratorManager.get_current_node_num_accelerators()
    if count == 0:
        raise RuntimeError(
            "ScalingConfig(use_gpu=True) but no CUDA device is visible; pass "
            "ScalingConfig(use_gpu=False) to run the ranks on the CPU"
        )
    if per * n > count:
        raise RuntimeError(
            f"{n} GPU ranks of {per} card(s) each need {per * n} cards, "
            f"but {count} are visible"
        )
    visible = GPUAcceleratorManager.get_current_process_visible_accelerator_ids()
    ids = visible if visible is not None else [str(i) for i in range(count)]
    return [ids[r * per:(r + 1) * per] for r in range(n)]


@contextmanager
def _environ(env: dict):
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


def _rank_main(backend: str, context_kwargs: dict, storage_dir: str,
               checkpoint_path: Optional[str], blob: bytes, conn, spawned_at: float) -> None:
    """A rank process's body: rendezvous, session, train loop. Sends
    ``started``, then the loop's results, then ``done`` or ``error``."""
    env = os.environ
    rank = int(env["RAY_TPU_RANK"])
    try:
        device = torch.device("cpu")
        if backend == "nccl":
            device = torch.device("cuda", 0)
            torch.cuda.set_device(device)
        host, port = env["RAY_TPU_COORDINATOR"].rsplit(":", 1)
        store = dist.TCPStore(host, int(port), is_master=False, timeout=_RENDEZVOUS_TIMEOUT)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=int(env["RAY_TPU_WORLD_SIZE"]),
                                timeout=_RENDEZVOUS_TIMEOUT)
        train_fn, config, shards = pickle.loads(blob)
        chk = Checkpoint(checkpoint_path) if checkpoint_path else None
        os.makedirs(storage_dir, exist_ok=True)
        _set_session(_TrainSession(TrainContext(**context_kwargs), storage_dir, chk, shards,
                                   conn, device))
        conn.send({"kind": "started", "rank": rank, "startup_s": time.time() - spawned_at})
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
        self._eof: set[int] = set()
        self._store = None

    def start(self, train_fn, config: Optional[dict], storage_dir: str,
              latest_checkpoint_path: Optional[str], shards: list[dict],
              num_workers: Optional[int] = None) -> None:
        """Spawn the ranks; ``shards[r]`` is rank r's {name: dataset shard}."""
        n = num_workers or self.scaling.num_workers
        self.num_workers = n
        gpu_ids = gpu_ids_per_rank(self.scaling, n)
        backend = "nccl" if gpu_ids else "gloo"
        self._store = dist.TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False,
                                    timeout=_RENDEZVOUS_TIMEOUT)
        coordinator = f"127.0.0.1:{self._store.port}"
        mp = multiprocessing.get_context("spawn")
        for rank in range(n):
            env = {"RAY_TPU_WORLD_SIZE": str(n), "RAY_TPU_RANK": str(rank),
                   "RAY_TPU_COORDINATOR": coordinator}
            if gpu_ids:
                env.update(GPUAcceleratorManager.get_visibility_env(gpu_ids[rank]))
            elif "OMP_NUM_THREADS" not in os.environ:
                # CPU ranks share this host's cores (torchrun's default too)
                env["OMP_NUM_THREADS"] = str(max(1, (os.cpu_count() or 1) // n))
            context = dict(world_size=n, world_rank=rank, local_rank=rank, local_world_size=n,
                           node_rank=0, experiment_name=self.experiment_name,
                           trial_id=self.trial_id, coordinator_address=coordinator)
            blob = pickle.dumps((train_fn, config, shards[rank]))
            recv, send = mp.Pipe(duplex=False)
            p = mp.Process(
                target=_rank_main, name=f"{self.experiment_name}-rank-{rank}",
                args=(backend, context, storage_dir, latest_checkpoint_path, blob, send,
                      time.time()),
            )
            with _environ(env):
                p.start()
            send.close()  # the child holds the write end
            self.procs.append(p)
            self._conns[rank] = recv

    def poll(self, timeout: float) -> tuple[list[dict], dict[int, int]]:
        """Wait up to ``timeout`` for a message or an exit. Returns the
        messages received (each rank's in the order sent) and {rank:
        exitcode} for ranks that have exited and whose pipes are drained."""
        live = [c for r, c in self._conns.items() if r not in self._eof]
        if live:
            wait(live + [p.sentinel for p in self.procs if p.exitcode is None], timeout)
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
        return msgs, {r: code for r, code in exited.items() if r in self._eof}

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
        for conn in self._conns.values():
            conn.close()
        self._conns = {}
        self._store = None
