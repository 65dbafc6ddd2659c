"""The host's card ledger: which cards and CPU slots the port's own processes hold.

The port's counterpart of the runtime's resource accounting (the placement
groups and ``ray_tpu.available_resources()`` that the JAX package's Train
layer, learner groups and elastic policy read), narrowed to one host and
to the processes the port spawns: the Train layer's and the gang's ranks
(``train/_internal/worker_group.py``) and RLlib's learner processes
(``_private/process_actor.py``). A process's own use of a card takes no
lease: only the processes it spawns lease.

- *Leases.* A lease is one file in the ledger's directory,
  ``lease-*.json``: what it holds (``{"GPU": {card: share}, "CPU":
  slots}``) and its holder's pid and name. Its holder keeps an exclusive
  ``fcntl.flock`` on it. The parent takes the lock, the child it spawns
  receives a duplicate of the descriptor (``Lease.inheritable``), and the
  parent closes its own once the child has started (``Lease.bind``). The
  lock belongs to that one open file, so the kernel drops it when the
  child exits, however it exits, SIGKILL included. A lease file whose lock
  nobody holds is stale, and the next reader deletes it. One file a lease
  serves whole cards and shares of a card alike, and names its holder.
- *Atomic.* Every read and every acquisition holds the ledger's own lock
  (``ledger.lock``) from start to end, so a set of leases is taken all or
  none across processes: two processes racing for the last card cannot both
  get it, and no reader sees half a lease.
- *Cards* are keyed by physical id
  (``GPUAcceleratorManager.get_physical_card_ids``), so processes with
  different visibility agree on which card is which. A whole-card request
  takes cards of which nobody holds any share; a share (0 < g < 1) packs
  onto the fullest card it still fits.
- *CPU slots* count against the host's ``os.cpu_count()``.
- *Over-asking* raises ``LedgerError`` at once, naming the counts asked,
  visible and free, and the pids holding the rest. Nothing falls back to
  the CPU.

A ledger's directory, cards and CPU total can be given
(``CardLedger(root, cards=..., cpus=...)``), and ``use_ledger`` makes one
the process's default for a block, as a test does with its own under its
``tmp_path``. The default ledger lives in the temporary directory, one per
user: the processes that share it share the ledger.
"""

from __future__ import annotations

import contextlib
import dataclasses
import fcntl
import json
import os
import tempfile
import uuid
from typing import Optional

from ray_tpu_torch.accelerator import GPUAcceleratorManager

_EPS = 1e-9


class LedgerError(RuntimeError):
    """Too few free cards or CPU slots for a request."""


@dataclasses.dataclass(frozen=True)
class Holder:
    """A live lease: its holder's pid and name, and what it holds."""

    pid: int
    name: str
    gpu: dict  # card id -> share held
    cpu: float

    def __str__(self) -> str:
        held = [f"card {c}" if s >= 1 - _EPS else f"{s:g} of card {c}"
                for c, s in self.gpu.items()]
        if self.cpu:
            held.append(f"{self.cpu:g} CPU slot(s)")
        return f"pid {self.pid} ({self.name}: {', '.join(held) or 'nothing'})"


@dataclasses.dataclass(frozen=True)
class Free:
    """What no live process holds."""

    cards: int  # whole cards, of which nobody holds any share
    shares: dict  # card id -> its share that nobody holds
    cpus: float


class _InheritedFd:
    """A lease's descriptor as a spawned child receives it. Pickled while
    the child is being started (it travels among the ``Process``'s
    arguments), it is passed to the child as multiprocessing passes a
    pipe's end (``reduction.DupFd``); the child keeps it open for its life."""

    def __init__(self, fd: int):
        self.fd = fd

    def __reduce__(self):
        from multiprocessing import reduction

        return (_keep_in_child, (reduction.DupFd(self.fd),))


_HELD: list[int] = []  # in a child: the lease descriptors it keeps open


def _keep_in_child(dup) -> int:
    fd = dup.detach()
    os.set_inheritable(fd, False)  # for this process alone, not its children
    _HELD.append(fd)
    return fd


def _read(fd: int) -> dict:
    size = os.fstat(fd).st_size
    return json.loads(os.pread(fd, size, 0) or b"{}")


class Lease:
    """One process's cards and CPU slots, held while its file's descriptor
    is open somewhere: in this process until ``bind``, in the child after."""

    def __init__(self, ledger: "CardLedger", path: str, fd: int, gpu: dict, cpu: float,
                 name: str):
        self._ledger, self.path, self._fd = ledger, path, fd
        self.gpu, self.cpu, self.name = gpu, cpu, name
        self.pid: Optional[int] = None

    @property
    def cards(self) -> list[str]:
        """The physical ids of the cards it holds (whole or a share)."""
        return list(self.gpu)

    def _write(self, pid: int) -> None:
        data = json.dumps({"pid": pid, "name": self.name, "gpu": self.gpu,
                           "cpu": self.cpu}).encode()
        os.ftruncate(self._fd, 0)
        os.pwrite(self._fd, data, 0)

    def inheritable(self) -> _InheritedFd:
        """The descriptor for the arguments of the ``Process`` that will
        hold the lease (``spawn_env.start_process``)."""
        if self._fd is None:
            raise RuntimeError(f"lease {self.path} was released")
        return _InheritedFd(self._fd)

    def bind(self, pid: int) -> None:
        """The started child ``pid`` holds the lease now: record its pid and
        close this process's descriptor."""
        with self._ledger._locked():
            self._write(pid)
        self.pid = pid
        os.close(self._fd)
        self._fd = None

    def release(self) -> None:
        """Give the lease back, when this process holds it (never bound, or
        a holder of its own). A bound lease ends with its child."""
        if self._fd is None:
            return
        with self._ledger._locked():
            self._drop()

    def _drop(self) -> None:  # under the ledger's lock
        with contextlib.suppress(FileNotFoundError):
            os.unlink(self.path)
        os.close(self._fd)
        self._fd = None

    def __repr__(self) -> str:
        return f"<Lease {self.name} gpu={self.gpu} cpu={self.cpu:g} pid={self.pid}>"


class CardLedger:
    """The leases in ``root`` over ``cards`` (physical ids; default: the
    cards this process sees, read at each call) and ``cpus`` CPU slots
    (default: ``os.cpu_count()``)."""

    def __init__(self, root: Optional[str] = None, cards: Optional[list] = None,
                 cpus: Optional[float] = None):
        self.root = root or os.path.join(tempfile.gettempdir(),
                                         f"ray_tpu_torch-cards-{os.getuid()}")
        self._cards = None if cards is None else [str(c) for c in cards]
        self._cpus = cpus

    def card_ids(self) -> list[str]:
        if self._cards is not None:
            return list(self._cards)
        return GPUAcceleratorManager.get_physical_card_ids()

    def cpu_total(self) -> float:
        return float(self._cpus if self._cpus is not None else (os.cpu_count() or 1))

    @contextlib.contextmanager
    def _locked(self):
        os.makedirs(self.root, exist_ok=True)
        fd = os.open(os.path.join(self.root, "ledger.lock"), os.O_RDWR | os.O_CREAT, 0o600)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield
        finally:
            os.close(fd)

    def _live(self) -> list[Holder]:
        """The live leases' holders; stale lease files deleted. Under the
        ledger's lock."""
        out = []
        for name in sorted(os.listdir(self.root)):
            if not (name.startswith("lease-") and name.endswith(".json")):
                continue
            path = os.path.join(self.root, name)
            try:
                fd = os.open(path, os.O_RDWR)
            except FileNotFoundError:
                continue
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except BlockingIOError:  # held: a live lease
                d = _read(fd)
                out.append(Holder(int(d["pid"]), d["name"], dict(d["gpu"]), float(d["cpu"])))
            else:  # nobody holds it: its holder has gone
                with contextlib.suppress(FileNotFoundError):
                    os.unlink(path)
            finally:
                os.close(fd)
        return out

    def holders(self) -> list[Holder]:
        with self._locked():
            return self._live()

    def free(self) -> Free:
        with self._locked():
            return self._free(self._live())

    def _free(self, live: list[Holder]) -> Free:
        used = dict.fromkeys(self.card_ids(), 0.0)
        for h in live:
            for c, s in h.gpu.items():
                if c in used:
                    used[c] += s
        cpus = self.cpu_total() - sum(h.cpu for h in live)
        return Free(cards=sum(u <= _EPS for u in used.values()),
                    shares={c: max(0.0, 1.0 - u) for c, u in used.items()},
                    cpus=max(0.0, cpus))

    def _plan(self, requests: list[dict], what: str, live: list[Holder]) -> list[tuple]:
        """(gpu {card: share}, cpu) for each request, or ``LedgerError``."""
        free = self._free(live)
        shares, cpus = dict(free.shares), free.cpus
        plan = []
        for req in requests:
            g, c = _validated(req)
            gpu = {}
            if g >= 1:
                whole = [k for k, s in shares.items() if s >= 1 - _EPS][:int(g)]
                if len(whole) < g:
                    raise self._error(requests, what, live)
                gpu = dict.fromkeys(whole, 1.0)
            elif g > 0:
                fits = [k for k, s in shares.items() if s >= g - _EPS]
                if not fits:
                    raise self._error(requests, what, live)
                gpu = {min(fits, key=shares.__getitem__): g}  # the fullest that fits
            if c > cpus + _EPS:
                raise self._error(requests, what, live)
            for k, s in gpu.items():
                shares[k] -= s
            cpus -= c
            plan.append((gpu, c))
        return plan

    def _error(self, requests: list[dict], what: str, live: list[Holder]) -> LedgerError:
        free = self._free(live)
        g = sum(r.get("GPU", 0) for r in requests)
        c = sum(r.get("CPU", 0) for r in requests)
        parts = []
        if g:
            partial = {k: round(s, 6) for k, s in free.shares.items() if _EPS < s < 1 - _EPS}
            parts.append(f"{g:g} card(s), but {len(free.shares)} are visible and {free.cards} "
                         f"free" + (f" (shares free: {partial})" if partial else ""))
        if c:
            parts.append(f"{c:g} CPU slot(s), but the host has {self.cpu_total():g} and "
                         f"{free.cpus:g} are free")
        held = "; ".join(str(h) for h in live) or "no live process"
        return LedgerError(f"{what} ask for {' and '.join(parts)}; held by {held}")

    def acquire(self, requests: list[dict], what: str) -> list[Lease]:
        """One lease a request (``{"GPU": g, "CPU": c}``), all or none;
        ``LedgerError`` when they do not fit in what is free now. ``what``
        names the processes, in the leases and in the message."""
        with self._locked():
            plan = self._plan(requests, what, self._live())
            leases: list[Lease] = []
            try:
                for gpu, cpu in plan:
                    path = os.path.join(self.root,
                                        f"lease-{os.getpid()}-{uuid.uuid4().hex[:12]}.json")
                    fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_EXCL, 0o600)
                    fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                    lease = Lease(self, path, fd, gpu, cpu, what)
                    leases.append(lease)
                    lease._write(os.getpid())
            except BaseException:
                for lease in leases:
                    lease._drop()
                raise
        return leases


def _validated(req: dict) -> tuple[float, float]:
    unknown = set(req) - {"GPU", "CPU"}
    g, c = float(req.get("GPU", 0)), float(req.get("CPU", 0))
    if unknown or g < 0 or c < 0 or (g > 1 and g != int(g)):
        raise ValueError(f"a lease takes {{'GPU': a share below 1 or whole cards, 'CPU': "
                         f"slots}}, got {req}")
    return g, c


_default: Optional[CardLedger] = None


def default_ledger() -> CardLedger:
    """This process's ledger: the host's, unless ``use_ledger`` set another."""
    global _default
    if _default is None:
        _default = CardLedger()
    return _default


def set_default_ledger(ledger: CardLedger) -> None:
    """``ledger`` as this process's default for the rest of its life: a
    spawned process that leases from its parent's ledger."""
    global _default
    _default = ledger


@contextlib.contextmanager
def use_ledger(ledger: CardLedger):
    """``ledger`` as this process's default inside the block."""
    global _default
    old, _default = _default, ledger
    try:
        yield ledger
    finally:
        _default = old
