"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source exports plain C functions. On first use it is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``build/cuda/`` at the repository root (git-ignored), named by a hash of
the source and the flags, and loaded with ``ctypes``. No PyTorch header
is included, so a build takes seconds rather than the minutes a
``torch.utils.cpp_extension`` build takes.

Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.

``LAUNCHES`` counts kernel launches by kernel name. Each wrapper adds one
where it launches its kernel, and nowhere else, so a run can show that
its path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cuda"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: Dict[str, int] = {}

_libraries: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def count_launch(name: str) -> None:
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME "
                       "(needed to build the port's CUDA kernels)")


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless a library of the same hash
    exists; returns the library path. The compiler's output (including
    ``-Xptxas -v``: registers, shared memory, spills) is kept beside it
    as ``<name>.log``."""
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / "{}-{}.so".format(src.stem, digest)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(".so.tmp{}".format(os.getpid()))
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    lib.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed on {}:\n{}".format(src, log))
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib


def load(source: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<source>``, built on first use."""
    with _lock:
        if source not in _libraries:
            _libraries[source] = ctypes.CDLL(str(build(source)))
        return _libraries[source]


def build_log(source: str) -> str:
    """The compiler output of the current build of ``csrc/<source>``."""
    return build(source).with_suffix(".log").read_text()


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code (every
    ``csrc`` library exports ``cuda_error_string``)."""
    if status != 0:
        lib.cuda_error_string.restype = ctypes.c_char_p
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        raise RuntimeError("{} failed: CUDA error {} ({})".format(
            what, status, lib.cuda_error_string(status).decode()))
