"""Shared-memory channels: the compiled DAG's data plane.

The port's counterpart of ``ray_tpu/experimental/channel.py``, whose ring
lives in the native object store's arena (``ray_tpu/_native/
plasma_store.cc:604-740``). The port has no object store, so a channel is
a file of its own under ``/dev/shm``, mapped with ``mmap`` by each process
that uses it: one writer, one reader, any two processes of the host.

- *The ring.* A 64-byte header (``write_seq``, ``read_seq``, ``closed``,
  the slot size and the slot count, each 8 bytes at an 8-byte offset),
  then ``num_slots`` slots of an 8-byte length and ``slot_size`` bytes of
  payload. The writer copies the pickled value and its length into slot
  ``write_seq % num_slots``, then publishes it with one aligned 8-byte
  store of ``write_seq + 1``; the reader reads the slot, then frees it with
  one store of ``read_seq + 1``. Each counter has one writer, and an
  aligned 8-byte store is one store on the host's CPU, so neither side ever
  sees half a counter, and a value is whole before its sequence number is.
- *Waiting.* A side that finds the ring empty (the reader) or full (the
  writer) blocks in ``select`` on a doorbell, a FIFO beside the ring: the
  writer rings the reader's after each publish, the reader the writer's
  after each free, and ``close`` rings both. A blocked side takes no CPU
  and holds no interpreter lock, so an idle reader inside an engine
  actor's process costs its scheduler thread nothing (the reference polls
  with 5 µs sleeps, ``plasma_store.cc:590``). A ring left in the pipe
  wakes the side once more, to find nothing and block again: a doorbell
  is never lost, since the byte waits in the FIFO until read.
- *Values* travel with the standard ``pickle``, as ``ProcessActor``'s
  calls do; a value larger than the slot raises ``ValueError``.
- *End.* ``close`` marks the channel closed: a blocked or later write
  raises ``ChannelClosedError`` at once, a read does so once the ring is
  drained. ``destroy`` closes the channel and unlinks its files; a process
  that still maps it keeps its mapping until it lets go.
- A ``Channel`` pickles to its path and geometry; each process opens the
  files at its first use.

Not ``multiprocessing.shared_memory``: on Python 3.12 a process that
attaches to a segment registers it with its resource tracker, which
unlinks the segment when that process exits (``track=False`` exists only
from Python 3.13).
"""

from __future__ import annotations

import errno
import mmap
import os
import pickle
import select
import struct
import time
import uuid
from typing import Any, Optional

SHM_DIR = "/dev/shm"
PREFIX = "ray_tpu_torch-ch-"
_HEADER = 64
_SLOT_HEADER = 8
_WRITE_SEQ, _READ_SEQ, _CLOSED, _SLOT_SIZE, _NUM_SLOTS = range(5)
_WAIT_SLICE_S = 1.0  # a blocked side re-reads the ring at least this often


class ChannelClosedError(Exception):
    """The peer closed the channel (the normal teardown signal)."""


def _fifo(path: str, name: str) -> str:
    return f"{path}.{name}"


class Channel:
    """One single-writer, single-reader channel of ``num_slots`` slots of
    ``slot_size`` bytes."""

    def __init__(self, path: str, slot_size: int, num_slots: int):
        self.path, self.slot_size, self.num_slots = path, slot_size, num_slots
        self._mm: Optional[mmap.mmap] = None
        self._hdr: Optional[memoryview] = None
        self._data_bell = self._space_bell = -1  # O_RDWR FIFO descriptors

    @classmethod
    def create(cls, slot_size: int = 4 << 20, num_slots: int = 2) -> "Channel":
        """A new channel's files under ``/dev/shm``; raises ``OSError`` when
        they cannot be made (no fallback)."""
        if slot_size <= 0 or num_slots <= 0:
            raise ValueError(f"slot_size {slot_size} and num_slots {num_slots} must be positive")
        path = os.path.join(SHM_DIR, PREFIX + uuid.uuid4().hex)
        size = _HEADER + num_slots * (_SLOT_HEADER + slot_size)
        try:
            fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_EXCL, 0o600)
            try:
                os.ftruncate(fd, size)  # zeros: both counters 0, open
                os.pwrite(fd, struct.pack("<QQ", slot_size, num_slots), _SLOT_SIZE * 8)
            finally:
                os.close(fd)
            for name in ("data", "space"):
                os.mkfifo(_fifo(path, name), 0o600)
        except OSError:
            _unlink(path)
            raise
        return cls(path, slot_size, num_slots)

    # -- the mapping ----------------------------------------------------------

    def _open(self) -> memoryview:
        if self._hdr is None:
            fd = os.open(self.path, os.O_RDWR)
            try:
                self._mm = mmap.mmap(fd, _HEADER + self.num_slots * (_SLOT_HEADER + self.slot_size))
            finally:
                os.close(fd)
            # O_RDWR: a FIFO opened for both ends opens at once, and its
            # reads never see end-of-file
            self._data_bell = os.open(_fifo(self.path, "data"), os.O_RDWR | os.O_NONBLOCK)
            self._space_bell = os.open(_fifo(self.path, "space"), os.O_RDWR | os.O_NONBLOCK)
            self._hdr = memoryview(self._mm)[:_HEADER].cast("Q")
        return self._hdr

    def _slot(self, seq: int) -> int:
        return _HEADER + (seq % self.num_slots) * (_SLOT_HEADER + self.slot_size)

    @staticmethod
    def _ring(fd: int) -> None:
        try:
            os.write(fd, b"\0")
        except BlockingIOError:  # the FIFO is full of rings: the peer wakes anyway
            pass

    @staticmethod
    def _wait(fd: int, deadline: Optional[float], what: str, timeout_s) -> None:
        """Block until ``fd`` has a ring (then drain it) or a slice passes;
        raise ``TimeoutError`` past ``deadline``."""
        left = _WAIT_SLICE_S
        if deadline is not None:
            left = min(left, deadline - time.monotonic())
            if left <= 0:
                raise TimeoutError(f"channel {what} timed out after {timeout_s} s")
        ready, _, _ = select.select([fd], [], [], left)
        if ready:
            try:
                os.read(fd, 4096)
            except BlockingIOError:
                pass

    # -- the two sides --------------------------------------------------------

    def write(self, value: Any, timeout_s: Optional[float] = None) -> None:
        data = pickle.dumps(value)
        if len(data) > self.slot_size:
            raise ValueError(
                f"serialized value ({len(data)} B) exceeds the channel slot size "
                f"({self.slot_size} B); recompile with a larger buffer_size_bytes")
        hdr = self._open()
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        while True:
            if hdr[_CLOSED]:
                raise ChannelClosedError("channel closed")
            w = hdr[_WRITE_SEQ]
            if w - hdr[_READ_SEQ] < self.num_slots:
                break
            self._wait(self._space_bell, deadline, "write", timeout_s)
        off = self._slot(w)
        self._mm[off + _SLOT_HEADER:off + _SLOT_HEADER + len(data)] = data
        self._mm[off:off + _SLOT_HEADER] = struct.pack("<Q", len(data))
        hdr[_WRITE_SEQ] = w + 1  # publish: one aligned 8-byte store
        self._ring(self._data_bell)

    def read(self, timeout_s: Optional[float] = None) -> Any:
        hdr = self._open()
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        while True:
            r = hdr[_READ_SEQ]
            if hdr[_WRITE_SEQ] > r:
                break
            if hdr[_CLOSED]:
                raise ChannelClosedError("channel closed")
            self._wait(self._data_bell, deadline, "read", timeout_s)
        off = self._slot(r)
        (n,) = struct.unpack("<Q", self._mm[off:off + _SLOT_HEADER])
        data = self._mm[off + _SLOT_HEADER:off + _SLOT_HEADER + n]
        hdr[_READ_SEQ] = r + 1  # free the slot
        self._ring(self._space_bell)
        return pickle.loads(data)

    def close(self) -> None:
        """Signal the end: blocked and later writes raise
        ``ChannelClosedError`` at once, reads once the ring is drained."""
        try:
            hdr = self._open()
        except FileNotFoundError:  # already destroyed
            return
        hdr[_CLOSED] = 1
        self._ring(self._data_bell)
        self._ring(self._space_bell)

    def destroy(self) -> None:
        """Close the channel, unlink its files and let go of this process's
        mapping."""
        self.close()
        _unlink(self.path)
        self.release()

    def release(self) -> None:
        """Let go of this process's mapping and doorbells (the files stay)."""
        if self._hdr is not None:
            self._hdr.release()
            self._hdr = None
            self._mm.close()
            self._mm = None
            for fd in (self._data_bell, self._space_bell):
                os.close(fd)
            self._data_bell = self._space_bell = -1

    def __reduce__(self):
        return (Channel, (self.path, self.slot_size, self.num_slots))

    def __repr__(self):
        return f"Channel({os.path.basename(self.path)}, slots={self.num_slots})"


def _unlink(path: str) -> None:
    for p in (path, _fifo(path, "data"), _fifo(path, "space")):
        try:
            os.unlink(p)
        except OSError as e:
            if e.errno != errno.ENOENT:
                raise


def channel_files() -> list[str]:
    """The channel files under ``/dev/shm`` (rings and doorbells) of every
    live or leaked channel on the host."""
    try:
        return sorted(n for n in os.listdir(SHM_DIR) if n.startswith(PREFIX))
    except OSError:
        return []
