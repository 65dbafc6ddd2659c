"""Log capture: each spawned port process's stdout and stderr in files of
the driver's session log directory, tailed to the driver's console.

The port's counterpart of the reference's per-session log directory and
log monitor (``ray_tpu/_private/controller.py:761-1080``, the scan of
``ray_tpu/_private/log_tail.py``):

- *Files.* Every ``ProcessActor`` and every rank of a ``WorkerGroup``
  (``spawn_env.start_process``) starts by pointing its descriptors 1 and 2
  at ``<id>.out`` and ``<id>.err`` in the session log directory, line
  buffered, and writes ``<id>.json`` (its pid and name). An actor's id is
  its actor id. The files outlive their processes: a dead process's
  output can still be read.
- *The directory* is the driver's (the process that no port process
  spawned): ``<tmp>/ray_tpu_torch-<uid>/session_<pid>/logs``. A spawned
  process receives it in its environment, so what it spawns in turn (a
  gang replica's ranks) writes there too.
- *The monitor.* A thread of the driver reads what each file gained every
  ``SCAN_S``, whole lines only (a line of more than 1 MiB is flushed as
  it is), prints each line to its own stream (``.out`` to stdout, ``.err``
  to stderr) prefixed ``(<name> pid=<pid>)``, and keeps the latest
  ``RING_LINES`` lines in a ring buffer for the state API
  (``tail_cluster_logs``). A child's traceback stays visible on the
  driver's console, as it was when children wrote to the driver's streams.
"""

from __future__ import annotations

import atexit
import collections
import json
import os
import sys
import tempfile
import threading
import time
from typing import Optional

LOG_DIR_ENV = "RAY_TPU_TORCH_LOG_DIR"
SCAN_S = 0.2
RING_LINES = 20000
READ_CAP = 1 << 20  # bytes read from one file in one scan

_dir: Optional[str] = None
_dir_lock = threading.Lock()


def session_log_dir() -> str:
    """This session's log directory: the one this process inherited, or,
    in the driver, its own (made, and its monitor started, at first use)."""
    global _dir
    inherited = os.environ.get(LOG_DIR_ENV)
    if inherited:
        return inherited
    with _dir_lock:
        if _dir is None:
            path = os.path.join(tempfile.gettempdir(), f"ray_tpu_torch-{os.getuid()}",
                                f"session_{os.getpid()}", "logs")
            os.makedirs(path, exist_ok=True)
            _monitor.start(path)
            _dir = path
        return _dir


def child_env() -> dict:
    return {LOG_DIR_ENV: session_log_dir()}


def redirect(log_dir: str, log_id: str) -> None:
    """In a spawned process, before its body: stdout and stderr to its
    files (line buffered), and its pid and name beside them."""
    import multiprocessing

    base = os.path.join(log_dir, log_id)
    for fd, source in ((1, "out"), (2, "err")):
        f = os.open(f"{base}.{source}", os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        os.dup2(f, fd)
        os.close(f)
    for stream in (sys.stdout, sys.stderr):
        if stream is not None:
            stream.reconfigure(line_buffering=True)
    with open(f"{base}.json.tmp", "w") as f:
        json.dump({"id": log_id, "pid": os.getpid(),
                   "name": multiprocessing.current_process().name}, f)
    os.replace(f"{base}.json.tmp", f"{base}.json")


class _Monitor:
    """The driver's tail of its session log directory (see the module's
    text)."""

    def __init__(self):
        self.dir: Optional[str] = None
        self.lock = threading.Lock()
        self.offsets: dict = {}
        self.meta: dict = {}
        self.ring: collections.deque = collections.deque(maxlen=RING_LINES)

    def start(self, path: str) -> None:
        self.dir = path
        threading.Thread(target=self._run, name="log-monitor", daemon=True).start()
        atexit.register(self.scan)  # a child's last lines before this process exits

    def _run(self) -> None:
        while True:
            time.sleep(SCAN_S)
            try:
                self.scan()
            except Exception:  # noqa: BLE001 — the monitor must not die
                pass

    def _meta(self, log_id: str) -> dict:
        m = self.meta.get(log_id)
        if m is None:
            try:
                with open(os.path.join(self.dir, f"{log_id}.json")) as f:
                    m = self.meta[log_id] = json.load(f)
            except (OSError, ValueError):
                return {"pid": "?", "name": log_id[:8]}
        return m

    def scan(self) -> None:
        """One pass: each file's new whole lines, printed and kept."""
        with self.lock:
            try:
                names = sorted(os.listdir(self.dir))
            except OSError:
                return
            for name in names:
                log_id, _, source = name.rpartition(".")
                if source not in ("out", "err"):
                    continue
                path = os.path.join(self.dir, name)
                off = self.offsets.get(name, 0)
                try:
                    size = os.path.getsize(path)
                    if size <= off:
                        continue
                    with open(path, "rb") as f:
                        f.seek(off)
                        data = f.read(min(size - off, READ_CAP))
                except OSError:
                    continue
                nl = data.rfind(b"\n")
                if nl >= 0:
                    data = data[:nl + 1]
                elif len(data) < READ_CAP:
                    continue  # a line not yet ended
                self.offsets[name] = off + len(data)
                self._emit(log_id, source, data.decode(errors="replace").splitlines())

    def _emit(self, log_id: str, source: str, lines: list) -> None:
        m = self._meta(log_id)
        now = time.time()
        for line in lines:
            self.ring.append({"worker_id": log_id, "source": source, "line": line, "t": now,
                              "pid": m["pid"], "name": m["name"]})
        stream = sys.stderr if source == "err" else sys.stdout
        prefix = f"({m['name']} pid={m['pid']})"
        try:
            stream.write("".join(f"{prefix} {line}\n" for line in lines))
            stream.flush()
        except (OSError, ValueError, AttributeError):
            pass


_monitor = _Monitor()


def flush() -> None:
    """Print and keep what the files hold now (the driver's monitor, at
    once)."""
    if _monitor.dir is not None:
        _monitor.scan()


def _require_driver() -> str:
    if _monitor.dir is None:
        raise RuntimeError("no port process has been spawned from this process: no logs")
    return _monitor.dir


def list_logs() -> list[dict]:
    """One row a captured process: its id, pid, name and the bytes of its
    two files (dead processes too)."""
    if _monitor.dir is None:
        return []
    rows = []
    for name in sorted(os.listdir(_monitor.dir)):
        if not name.endswith(".json"):
            continue
        log_id = name[:-len(".json")]
        m = _monitor._meta(log_id)
        sizes = {}
        for source in ("out", "err"):
            try:
                sizes[f"{source}_bytes"] = os.path.getsize(
                    os.path.join(_monitor.dir, f"{log_id}.{source}"))
            except OSError:
                sizes[f"{source}_bytes"] = 0
        rows.append({"worker_id": log_id, "pid": m["pid"], "name": m["name"], "ip": "local",
                     **sizes})
    return rows


def get_log(prefix: str, source: str = "out", tail_bytes: int = 65536) -> str:
    """The last ``tail_bytes`` of one process's ``source`` ("out" or
    "err"), by a prefix of its id; dead processes too."""
    d = _require_driver()
    if source not in ("out", "err"):
        raise ValueError(f"source must be 'out' or 'err', not {source!r}")
    ids = sorted({n.rpartition(".")[0] for n in os.listdir(d) if n.endswith(".json")
                  and n.startswith(prefix)})
    if not ids:
        raise ValueError(f"no process with id prefix {prefix!r}")
    if len(ids) > 1:
        raise ValueError(f"ambiguous id prefix {prefix!r}: {ids}")
    path = os.path.join(d, f"{ids[0]}.{source}")
    try:
        with open(path, "rb") as f:
            f.seek(max(os.path.getsize(path) - tail_bytes, 0))
            return f.read().decode(errors="replace")
    except OSError:
        return ""


def tail(n: int = 1000) -> list[dict]:
    """The latest ``n`` captured lines, across every process."""
    flush()
    with _monitor.lock:
        return list(_monitor.ring)[-n:]
