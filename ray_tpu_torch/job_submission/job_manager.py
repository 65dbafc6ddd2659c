"""Job submission: driver scripts run as supervised subprocesses.

The port's counterpart of ``ray_tpu/job_submission/job_manager.py``: a
``JobManager`` runs each entrypoint as a subprocess, its stdout and stderr
in one log file, and a supervisor thread records how it ended. Each job is
persisted as one JSON file in the manager's ``log_dir``, so another
process (another manager on the same directory) lists the jobs, reads
their status and logs, and stops them.

- *A job is a process group.* A port job's entrypoint is a port driver
  whose actors and ranks lease cards from the host's ledger. Each job
  therefore starts as the leader of a process group of its own (a new
  session), which the processes it spawns join, and ``stop_job`` ends the
  whole group with ``spawn_env.end_process_group``, which waits until no
  lease of the ledger names a process of the group. The reference stops
  only the entrypoint's pid (``ray_tpu/job_submission/job_manager.py:
  260-282``) and leaves its children to its runtime.
- A job started by another manager is stopped the same way, by its pid,
  which is its group's id.
"""

from __future__ import annotations

import enum
import json
import os
import shlex
import subprocess
import tempfile
import threading
import time
import uuid
from typing import Optional

from ray_tpu_torch._private import driver_link, log_capture
from ray_tpu_torch._private.spawn_env import end_process_group

TAIL_POLL_S = 0.2


class JobStatus(str, enum.Enum):
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"

    def is_terminal(self) -> bool:
        return self in (JobStatus.SUCCEEDED, JobStatus.FAILED, JobStatus.STOPPED)


class JobInfo:
    def __init__(self, job_id: str, entrypoint):
        self.job_id = job_id
        self.entrypoint = entrypoint
        self.status = JobStatus.PENDING
        self.start_time: Optional[float] = None
        self.end_time: Optional[float] = None
        self.return_code: Optional[int] = None
        self.log_path: Optional[str] = None
        self.metadata: dict = {}
        self.pid: Optional[int] = None

    def to_dict(self) -> dict:
        return {"job_id": self.job_id, "entrypoint": self.entrypoint,
                "status": self.status.value, "start_time": self.start_time,
                "end_time": self.end_time, "return_code": self.return_code,
                "metadata": self.metadata, "pid": self.pid, "log_path": self.log_path}

    @classmethod
    def from_dict(cls, d: dict) -> "JobInfo":
        info = cls(d["job_id"], d.get("entrypoint"))
        info.status = JobStatus(d.get("status", "PENDING"))
        info.start_time = d.get("start_time")
        info.end_time = d.get("end_time")
        info.return_code = d.get("return_code")
        info.metadata = d.get("metadata") or {}
        info.pid = d.get("pid")
        info.log_path = d.get("log_path")
        return info


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except OSError:
        return False


class JobManager:
    """Supervises job subprocesses; one JSON file a job in ``log_dir``
    (default: ``<tmp>/ray_tpu_torch_jobs``) besides its log."""

    def __init__(self, log_dir: Optional[str] = None):
        self._jobs: dict[str, JobInfo] = {}
        self._procs: dict[str, subprocess.Popen] = {}
        self._lock = threading.Lock()
        self._log_dir = log_dir or os.path.join(tempfile.gettempdir(), "ray_tpu_torch_jobs")
        os.makedirs(self._log_dir, exist_ok=True)
        self._load_persisted()

    # -- persistence ----------------------------------------------------------

    def _meta_path(self, job_id: str) -> str:
        return os.path.join(self._log_dir, f"{job_id}.json")

    def _persist(self, info: JobInfo) -> None:
        tmp = self._meta_path(info.job_id) + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(info.to_dict(), f)
        os.replace(tmp, self._meta_path(info.job_id))

    def _read(self, fname: str) -> Optional[JobInfo]:
        try:
            with open(os.path.join(self._log_dir, fname)) as f:
                return JobInfo.from_dict(json.load(f))
        except (OSError, ValueError, KeyError):
            return None

    def _load_persisted(self) -> None:
        for fname in os.listdir(self._log_dir):
            if not fname.endswith(".json"):
                continue
            info = self._read(fname)
            if info is None:
                continue
            # a RUNNING job whose supervisor (another process) is gone
            # cannot report its end: read it from its pid
            if info.status is JobStatus.RUNNING and info.pid and not _pid_alive(info.pid):
                info.status = JobStatus.FAILED
                info.end_time = info.end_time or time.time()
            with self._lock:
                self._jobs.setdefault(info.job_id, info)

    def _load_persisted_one(self, job_id: str) -> None:
        fresh = self._read(f"{job_id}.json")
        if fresh is None:
            return
        with self._lock:
            mine = self._jobs.get(job_id)
            # the persisted copy wins when it is further along
            if mine is None or (fresh.status.is_terminal() and not mine.status.is_terminal()):
                self._jobs[job_id] = fresh

    # -- jobs -----------------------------------------------------------------

    def submit_job(self, *, entrypoint, submission_id: Optional[str] = None,
                   runtime_env: Optional[dict] = None, metadata: Optional[dict] = None,
                   tenant: Optional[str] = None) -> str:
        """Start ``entrypoint`` (a command line, or an argument list) as the
        leader of a process group of its own; returns the job's id."""
        job_id = submission_id or f"raysubmit_{uuid.uuid4().hex[:16]}"
        info = JobInfo(job_id, entrypoint)
        info.metadata = metadata or {}
        if tenant:
            info.metadata.setdefault("tenant", tenant)
        info.log_path = os.path.join(self._log_dir, f"{job_id}.log")
        with self._lock:
            if job_id in self._jobs:
                raise ValueError(f"job {job_id} already exists")
            self._jobs[job_id] = info
        env = dict(os.environ)
        # a job is a driver of its own, even when a port process submits it
        for key in (driver_link._ADDR_ENV, driver_link._KEY_ENV, log_capture.LOG_DIR_ENV):
            env.pop(key, None)
        env["RAY_TPU_JOB_ID"] = job_id
        if tenant:
            env["RAY_TPU_TENANT"] = tenant
        rt = runtime_env or {}
        env.update({k: str(v) for k, v in (rt.get("env_vars") or {}).items()})
        cwd = rt.get("working_dir") or os.getcwd()
        log_f = open(info.log_path, "wb")
        try:
            proc = subprocess.Popen(
                shlex.split(entrypoint) if isinstance(entrypoint, str) else entrypoint,
                stdout=log_f, stderr=subprocess.STDOUT, env=env, cwd=cwd,
                start_new_session=True)
        except OSError as e:
            info.status = JobStatus.FAILED
            info.end_time = time.time()
            log_f.write(f"failed to launch: {e}\n".encode())
            log_f.close()
            self._persist(info)
            return job_id
        info.status = JobStatus.RUNNING
        info.start_time = time.time()
        info.pid = proc.pid
        self._persist(info)
        with self._lock:
            self._procs[job_id] = proc
        threading.Thread(target=self._supervise, args=(job_id, proc, log_f), daemon=True,
                         name=f"job-supervisor-{job_id}").start()
        return job_id

    def _supervise(self, job_id: str, proc: subprocess.Popen, log_f) -> None:
        rc = proc.wait()
        log_f.close()
        # another process may have persisted STOPPED (a stop by pid)
        self._load_persisted_one(job_id)
        with self._lock:
            info = self._jobs[job_id]
            info.return_code = rc
            info.end_time = time.time()
            if not info.status.is_terminal():
                info.status = JobStatus.SUCCEEDED if rc == 0 else JobStatus.FAILED
            self._procs.pop(job_id, None)
            self._persist(info)

    def _get(self, job_id: str) -> JobInfo:
        with self._lock:
            info = self._jobs.get(job_id)
        if info is None:  # another process may have submitted it since
            self._load_persisted()
            with self._lock:
                info = self._jobs.get(job_id)
        if info is None:
            raise ValueError(f"no job with id {job_id!r}")
        return info

    def get_job_status(self, job_id: str) -> JobStatus:
        info = self._get(job_id)
        if info.status is JobStatus.RUNNING and job_id not in self._procs:
            # another process's job: its persisted state, else its pid
            self._load_persisted_one(job_id)
            info = self._get(job_id)
            if info.status is JobStatus.RUNNING and info.pid and not _pid_alive(info.pid):
                with self._lock:
                    info.status = JobStatus.FAILED
                    info.end_time = info.end_time or time.time()
                    self._persist(info)
        return info.status

    def get_job_info(self, job_id: str) -> dict:
        return self._get(job_id).to_dict()

    def get_job_logs(self, job_id: str) -> str:
        path = self._get(job_id).log_path or os.path.join(self._log_dir, f"{job_id}.log")
        try:
            with open(path) as f:
                return f.read()
        except OSError:
            return ""

    def list_jobs(self) -> list[dict]:
        self._load_persisted()  # jobs of other processes
        with self._lock:
            return [j.to_dict() for j in self._jobs.values()]

    def stop_job(self, job_id: str) -> bool:
        """Mark the job ``STOPPED`` and end its process group, waiting
        until none of the group's processes holds a lease of this
        process's card ledger; False for a job already ended."""
        with self._lock:
            proc = self._procs.get(job_id)
            info = self._jobs.get(job_id)
            if info is None or info.status.is_terminal():
                return False  # never overwrite SUCCEEDED or FAILED
            info.status = JobStatus.STOPPED
            self._persist(info)
        if proc is None and not (info.pid and _pid_alive(info.pid)):
            return False
        end_process_group(info.pid)
        if proc is not None:
            proc.wait()
        return True

    def wait_until_finished(self, job_id: str, timeout: float = 300) -> JobStatus:
        deadline = time.time() + timeout
        while time.time() < deadline:
            st = self.get_job_status(job_id)
            if st.is_terminal():
                return st
            time.sleep(0.2)
        raise TimeoutError(f"job {job_id} still {self.get_job_status(job_id)}")


_default_manager: Optional[JobManager] = None
_manager_lock = threading.Lock()


def _get_manager() -> JobManager:
    global _default_manager
    with _manager_lock:
        if _default_manager is None:
            _default_manager = JobManager()
        return _default_manager


class JobSubmissionClient:
    """The reference's client, over this process's ``JobManager`` (the
    ``address`` is accepted and unused: there is no REST hop)."""

    def __init__(self, address: Optional[str] = None):
        self._manager = _get_manager()

    def submit_job(self, *, entrypoint, submission_id=None, runtime_env=None, metadata=None,
                   tenant=None) -> str:
        return self._manager.submit_job(entrypoint=entrypoint, submission_id=submission_id,
                                        runtime_env=runtime_env, metadata=metadata,
                                        tenant=tenant)

    def get_job_status(self, job_id: str) -> JobStatus:
        return self._manager.get_job_status(job_id)

    def get_job_info(self, job_id: str) -> dict:
        return self._manager.get_job_info(job_id)

    def get_job_logs(self, job_id: str) -> str:
        return self._manager.get_job_logs(job_id)

    def list_jobs(self) -> list[dict]:
        return self._manager.list_jobs()

    def stop_job(self, job_id: str) -> bool:
        return self._manager.stop_job(job_id)

    def tail_job_logs(self, job_id: str):
        """The log's new text, chunk by chunk, until the job has ended
        (each poll reads from the last offset)."""
        path = self._manager._get(job_id).log_path or ""
        offset = 0
        while True:
            ended = self.get_job_status(job_id).is_terminal()
            try:
                with open(path, "rb") as f:
                    f.seek(offset)
                    chunk = f.read()
            except OSError:
                chunk = b""
            if chunk:
                offset += len(chunk)
                yield chunk.decode(errors="replace")
            if ended:
                return
            time.sleep(TAIL_POLL_S)
