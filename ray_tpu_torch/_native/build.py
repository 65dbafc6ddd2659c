"""On-demand nvcc build of the port's CUDA kernels, loaded with ctypes.

Each ``ray_tpu_torch/ops/csrc/<name>.cu`` compiles on its own into
``ray_tpu_torch/_build/lib<name>-<tag>.so`` with a plain C interface (no
PyTorch headers: such a build takes seconds, one that includes them takes
minutes). ``tag`` hashes the source, the shared headers and the flags, so an
edited source builds anew and an unchanged one is reused. Several sources
build in parallel, one nvcc process each, all started together. Processes
that build at once (the ranks of a trainer) take turns on a file lock
(``flock``, released by the kernel if its holder dies): the first builds,
the others find its libraries and load them.

Nothing builds at import: ``load`` builds on the first call that needs a
kernel, ``build`` builds every source up front (for timing the build).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Iterable, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "ops" / "csrc"
BUILD_DIR = _PKG / "_build"

# sm_90a (not sm_90): wgmma/setmaxnreg exist only for the 'a' target.
# -Xptxas=-v writes registers, shared memory and spills into the build log.
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
_BUILD_TIMEOUT_S = 600

_lock = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


class BuildError(RuntimeError):
    pass


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise BuildError(
        "nvcc not found (looked on PATH and under $CUDA_HOME/bin); the CUDA "
        "kernels can only be built where the CUDA toolkit is installed"
    )


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _tag(name: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_tag(name)}.so"


def build(names: Optional[Iterable[str]] = None) -> dict[str, Path]:
    """Compile every named source (default: all) whose library is missing,
    one nvcc per source, all in parallel. Returns name -> library path;
    raises BuildError with nvcc's output if any compile fails."""
    names = list(names) if names is not None else sources()
    out = {name: library_path(name) for name in names}
    if all(lib.exists() for lib in out.values()):
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        # another process may have built them while this one waited
        _compile([(name, lib) for name, lib in out.items() if not lib.exists()])
    return out


def _compile(todo: list) -> None:
    if not todo:
        return
    nvcc = nvcc_path()
    procs = []
    for name, lib in todo:
        tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failures = []
    for name, lib, tmp, proc in procs:
        try:
            log, _ = proc.communicate(timeout=_BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            failures.append(f"{name}: nvcc timed out after {_BUILD_TIMEOUT_S}s\n{log}")
            continue
        lib.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    if failures:
        raise BuildError("\n".join(failures))


def build_log(name: str) -> str:
    """nvcc's output (ptxas register/spill report) from the last build."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``ops/csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _LIBS.get(name)
        if lib is None:
            path = build([name])[name]
            lib = _LIBS[name] = ctypes.CDLL(str(path))
        return lib
