"""The environment a spawned port process starts with.

Shared by the Train layer's rank processes
(``train/_internal/worker_group.py``) and the process actors of
``_private/process_actor.py``. A child process reads its cards and its
thread count from the environment it starts with, before any import in it
can initialise CUDA or size an OpenMP pool, so the parent sets them around
``Process.start`` (``environ``).
"""

from __future__ import annotations

import os
from contextlib import contextmanager

from ray_tpu_torch.accelerator import GPUAcceleratorManager


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


def assign_cards(n: int, per: int, what: str) -> list[list[str]]:
    """The card ids of ``n`` processes of ``per`` cards each, from the
    cards this process sees. Raises when none is visible or when the
    processes need more than are, naming both counts; never a CPU
    fallback. ``what`` names the processes in the message."""
    count = GPUAcceleratorManager.get_current_node_num_accelerators()
    if count == 0:
        raise RuntimeError(f"{what} need a CUDA device, but none is visible")
    if per * n > count:
        raise RuntimeError(f"{n} {what} of {per} card(s) each need {per * n} cards, "
                           f"but {count} are visible")
    visible = GPUAcceleratorManager.get_current_process_visible_accelerator_ids()
    ids = visible if visible is not None else [str(i) for i in range(count)]
    return [ids[r * per:(r + 1) * per] for r in range(n)]


def process_env(cards: list, cpu_threads: int) -> dict:
    """The environment of a process that holds ``cards``; with none, a CPU
    process that sees no card and runs ``cpu_threads`` OpenMP threads."""
    if cards:
        return GPUAcceleratorManager.get_visibility_env(cards)
    return {**GPUAcceleratorManager.get_visibility_env([]),
            "OMP_NUM_THREADS": str(max(1, cpu_threads))}
