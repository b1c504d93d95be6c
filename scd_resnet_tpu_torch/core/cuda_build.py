"""Build and load the port's hand-written CUDA kernels and its host
library.

Each ``csrc/*.cu`` source exports plain C functions. On first use it is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``<root>/cuda/``, and ``csrc/scdio.cpp`` (the archive reader, batch
packer and grayscale) with the host compiler (``$CXX``, default
``g++``) under ``<root>/host/``. A library is named by a hash of its
source, its compiler and its flags, built to a temporary name and moved
into place, and loaded with ``ctypes``. No PyTorch header is included,
so a build takes seconds rather than the minutes a
``torch.utils.cpp_extension`` build takes. ``<root>`` is
``build/<fingerprint>/`` at the repository root (git-ignored) unless
``core/compile_cache.enable_compilation_cache`` set another; the
fingerprint names the machine's CPU features and the compilers'
versions, so a new toolchain builds anew instead of loading a library
an older one built.

Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.

``LAUNCHES`` counts kernel launches by kernel name. Each wrapper adds one
where it launches its kernel, and nowhere else, so a run can show that
its path went through the kernels. ``LAYOUT_COPIES`` counts, by the same
names, the tensors converted between a channels-last caller and a
kernel's NCHW layout (``ops/layout``); it stays 0 on an NCHW path.
``FEED`` counts the resident steps whose index vector went to a card
(``steps``) and those of them fed while the card was still running the
previous step's update (``ahead``, ``train/factory.NetworkFactory.
train_resident``); it stays empty on the CPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# -ffp-contract=off: scdio_grayscale_u8 must stay bit-exact to numpy's
# double arithmetic, and a contracted multiply-add rounds once where numpy
# rounds twice. zlib is linked by its soname: the source declares the
# entry points it uses, so zlib's headers and its dev symlink may be absent
HOST_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared", "-Wall",
              "-ffp-contract=off")
HOST_LIBS = ("-l:libz.so.1", "-lpthread")

LAUNCHES: Dict[str, int] = {}
LAYOUT_COPIES: Dict[str, int] = {}
FEED: Dict[str, int] = {}

_libraries: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
_root: Optional[Path] = None


def set_build_root(path: str | os.PathLike) -> None:
    """Where later builds go (``core/compile_cache`` sets it)."""
    global _root
    _root = Path(path)


def build_root() -> Path:
    """The build root, ``build/<fingerprint>/`` by default."""
    if _root is None:
        from scd_resnet_tpu_torch.core.compile_cache import (
            enable_compilation_cache,
        )

        enable_compilation_cache()
    return _root


def reset_launches() -> None:
    """Zero ``LAUNCHES``, ``LAYOUT_COPIES`` and ``FEED``."""
    for counts in (LAUNCHES, LAYOUT_COPIES, FEED):
        for name in counts:
            counts[name] = 0


def count_launch(name: str) -> None:
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


def count_layout_copy(name: str) -> None:
    LAYOUT_COPIES[name] = LAYOUT_COPIES.get(name, 0) + 1


def count_feed(ahead: bool) -> None:
    FEED["steps"] = FEED.get("steps", 0) + 1
    FEED["ahead"] = FEED.get("ahead", 0) + int(ahead)


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


def cxx_path() -> str:
    """The host compiler: ``$CXX``, default ``g++``, on PATH."""
    name = os.environ.get("CXX", "g++")
    found = shutil.which(name)
    if not found:
        raise RuntimeError("host compiler {!r} not found (set CXX; needed "
                           "to build csrc/scdio.cpp)".format(name))
    return found


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` (``.cu`` with ``nvcc`` into
    ``<root>/cuda/``, ``.cpp`` with the host compiler into
    ``<root>/host/``) unless a library of the same hash exists; returns
    the library path. The compiler's output (for ``nvcc`` with
    ``-Xptxas -v``: registers, shared memory, spills) is kept beside it
    as ``<name>.log``; a failed build raises with that output."""
    src = CSRC / source
    if src.suffix == ".cu":
        kind, compiler, flags, libs = "cuda", nvcc_path(), NVCC_FLAGS, ()
    else:
        kind, compiler, flags, libs = "host", cxx_path(), HOST_FLAGS, \
            HOST_LIBS
    digest = hashlib.sha256(src.read_bytes() + " ".join(
        (compiler, *flags, *libs)).encode()).hexdigest()[:16]
    out_dir = build_root() / kind
    lib = out_dir / "{}-{}.so".format(src.stem, digest)
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(".so.tmp{}".format(os.getpid()))
    proc = subprocess.run([compiler, *flags, str(src), "-o", str(tmp),
                           *libs], capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    lib.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("{} failed on {} (exit {}):\n{}".format(
            compiler, src, proc.returncode, log))
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
