"""The driver's object table, and how a value crosses between processes.

The port's counterpart of the reference's object store
(``ray_tpu/_private/object_store.py``) on one host: every object lives in
the driver, which owns it.

- *Values* are serialized with the standard pickle, protocol 5. Numpy
  arrays travel as out-of-band buffers; a torch tensor as
  ``_private/serialization.py`` gives it (a CUDA tensor comes back as a CPU
  tensor of the same dtype, bf16 included). An ``ObjectRef`` inside a value
  is recorded as a reference the value holds (``contained``): the object
  it names stays alive while the value does.
- *The wire form* of a value is ``("inline", data, buffers, contained)``,
  or, in process mode when its buffers come to ``SHM_THRESHOLD`` bytes or
  more, ``("shm", data, name, layout, contained)``: the buffers laid end to
  end in one POSIX shared-memory segment (``multiprocessing.
  shared_memory``), named after the driver's pid (``segment_prefix``). The
  process that makes a segment writes it; the driver owns it from then on
  and unlinks it when the object is freed. A reader copies the buffers
  out, so no mapping outlives the read.
- *The table* maps each object id to its state (pending, a value, or an
  error), the driver's live ``ObjectRef``s of it (``refs``) and what pins
  it (``pins``: each queued or running task that names it, each object that
  contains it, each running task that made it in a worker process). An
  object is freed when both reach 0. An ``ObjectRef`` collected in the
  driver is queued and counted down at the table's next operation, so a
  finalizer never changes the table under a reader. ``get`` and ``wait``
  block on one condition, with their timeouts.
"""

from __future__ import annotations

import collections
import contextlib
import io
import os
import pickle
import sys
import threading
import time
import uuid
from typing import Callable, Optional

from ray_tpu_torch.object_ref import ObjectRef

SHM_THRESHOLD = 100 * 1024  # buffers of a value from which it crosses in a segment
DRIVER_PID_ENV = "RAY_TPU_TORCH_CORE_DRIVER_PID"
SHM_DIR = "/dev/shm"


def segment_prefix(driver_pid: Optional[int] = None) -> str:
    """The names of one driver's segments start with this."""
    pid = driver_pid or os.environ.get(DRIVER_PID_ENV) or os.getpid()
    return f"rtt-obj-{pid}-"


def driver_segments(driver_pid: Optional[int] = None) -> list[str]:
    """The segments of a driver that exist now."""
    prefix = segment_prefix(driver_pid)
    try:
        return sorted(n for n in os.listdir(SHM_DIR) if n.startswith(prefix))
    except OSError:
        return []


class _Pickler(pickle.Pickler):
    def __init__(self, file, buffers: list, contained: list):
        super().__init__(file, protocol=5, buffer_callback=buffers.append)
        self.contained = contained

    def persistent_id(self, obj):
        if type(obj) is ObjectRef:
            self.contained.append(obj.hex())
            return obj.hex()
        return None

    def reducer_override(self, obj):
        torch = sys.modules.get("torch")
        if torch is not None and isinstance(obj, torch.Tensor):
            from ray_tpu_torch._private.serialization import deserialize_tensor, serialize_tensor

            return deserialize_tensor, (serialize_tensor(obj),)
        return NotImplemented


class _Unpickler(pickle.Unpickler):
    def persistent_load(self, pid):
        return ObjectRef(pid)


def serialize(value, shm: bool) -> tuple:
    """``value``'s wire form; in a segment when ``shm`` and its buffers
    are large."""
    f, buffers, contained = io.BytesIO(), [], []
    _Pickler(f, buffers, contained).dump(value)
    data = f.getvalue()
    raws = [b.raw() for b in buffers]
    size = sum(r.nbytes for r in raws)
    if not shm or size < SHM_THRESHOLD:
        return ("inline", data, [bytes(r) for r in raws], contained)
    from multiprocessing import shared_memory

    name = f"{segment_prefix()}{uuid.uuid4().hex[:16]}"
    seg = shared_memory.SharedMemory(name=name, create=True, size=max(size, 1))
    layout, off = [], 0
    try:
        for r in raws:
            seg.buf[off:off + r.nbytes] = r.cast("B")
            layout.append((off, r.nbytes))
            off += r.nbytes
    finally:
        seg.close()
    return ("shm", data, name, layout, contained)


def deserialize(wire: tuple):
    """The value of a wire form (its buffers copied, writable)."""
    if wire[0] == "inline":
        _, data, bufs, _ = wire
        buffers = [bytearray(b) for b in bufs]
    else:
        _, data, name, layout, _ = wire
        from multiprocessing import shared_memory

        seg = shared_memory.SharedMemory(name=name)
        try:
            with seg.buf[:] as mv:
                buffers = [bytearray(mv[o:o + n]) for o, n in layout]
        finally:
            seg.close()
    return _Unpickler(io.BytesIO(data), buffers=buffers).load()


def contained(wire: tuple) -> list:
    return list(wire[-1])


def unlink(wire) -> None:
    """Free a wire form's segment, if it has one."""
    if isinstance(wire, tuple) and wire and wire[0] == "shm":
        unlink_segment(wire[2])


def unlink_segment(name: str) -> None:
    from multiprocessing import shared_memory

    try:
        seg = shared_memory.SharedMemory(name=name)
    except FileNotFoundError:
        return
    seg.close()
    with contextlib.suppress(FileNotFoundError):
        seg.unlink()


class _Entry:
    __slots__ = ("state", "value", "refs", "pins")

    def __init__(self, pins: int):
        self.state: Optional[bool] = None  # None pending, True a value, False an error
        self.value = None  # the wire form, or the error
        self.refs, self.pins = 0, pins


class ObjectStore:
    """The driver's table (see the module's text)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._entries: dict[str, _Entry] = {}
        self._dead: collections.deque = collections.deque()
        self.closed = False
        self.listener: Optional[Callable[[], None]] = None  # told of every seal

    def install_hooks(self) -> None:
        ObjectRef._on_create = self._add_ref
        ObjectRef._on_delete = self._dead.append

    # -- counts ----------------------------------------------------------------

    def _add_ref(self, oid: str) -> None:
        with self._lock:
            e = self._entries.get(oid)
            if e is not None:
                e.refs += 1

    def collect(self) -> None:
        """Count down the refs collected since the last call."""
        with self._lock:
            while self._dead:
                oid = self._dead.popleft()
                e = self._entries.get(oid)
                if e is not None:
                    e.refs -= 1
                    self._maybe_free(oid, e)

    def pin(self, ids) -> None:
        with self._lock:
            for oid in ids:
                e = self._entries.get(oid)
                if e is not None:
                    e.pins += 1

    def unpin(self, ids) -> None:
        with self._lock:
            for oid in ids:
                e = self._entries.get(oid)
                if e is not None:
                    e.pins -= 1
                    self._maybe_free(oid, e)

    def _maybe_free(self, oid: str, e: _Entry) -> None:
        if e.refs > 0 or e.pins > 0:
            return
        del self._entries[oid]
        if e.state:
            unlink(e.value)
            self.unpin(contained(e.value))

    # -- objects ---------------------------------------------------------------

    def create(self, ids, pins: int = 0) -> None:
        """Pending entries (a task's returns), each with ``pins``."""
        with self._lock:
            for oid in ids:
                self._entries[oid] = _Entry(pins)

    def put(self, oid: str, wire: tuple) -> None:
        """A value made now: ``oid`` holds ``wire``."""
        with self._lock:
            self.collect()
            self._entries[oid] = _Entry(0)
        self.seal(oid, True, wire)

    def seal(self, oid: str, ok: bool, value) -> None:
        """A pending entry's value (``ok``) or error. A value whose entry
        is gone (freed while its task ran) is dropped."""
        with self._lock:
            e = self._entries.get(oid)
            if e is None or e.state is not None or self.closed:
                if ok:
                    unlink(value)
                return
            if ok:
                self.pin(contained(value))
            e.state, e.value = ok, value
            self._cv.notify_all()
        if self.listener is not None:
            self.listener()

    def status(self, oid: str) -> Optional[bool]:
        """None pending, True a value, False an error or gone."""
        with self._lock:
            e = self._entries.get(oid)
            return False if e is None else e.state

    def read(self, oid: str) -> tuple:
        """(True, wire form) or (False, error); an entry that is gone reads
        as ``ObjectLostError``."""
        from ray_tpu_torch.exceptions import ObjectLostError

        with self._lock:
            e = self._entries.get(oid)
            if e is None or e.state is None:
                return False, ObjectLostError(oid)
            return e.state, e.value

    def wait(self, ids: list, num_returns: int, timeout: Optional[float]) -> list:
        """The ids done (a value, an error, or gone) once ``num_returns`` are,
        or when ``timeout`` passes."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            self.collect()
            while True:
                done = [i for i in ids if self._done(i)]
                if len(done) >= num_returns:
                    return done
                left = None if deadline is None else deadline - time.monotonic()
                if left is not None and left <= 0:
                    return done
                self._cv.wait(left if left is None else min(left, 1.0))

    def _done(self, oid: str) -> bool:
        e = self._entries.get(oid)
        return e is None or e.state is not None

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def close(self) -> None:
        """Free everything and unlink every segment this driver made."""
        with self._cv:
            self.closed = True
            entries, self._entries = self._entries, {}
            self._dead.clear()
            self._cv.notify_all()
        for e in entries.values():
            if e.state:
                unlink(e.value)
        for name in driver_segments():
            unlink_segment(name)
