"""The build cache of the port's compiled libraries, keyed by machine.

Counterpart of ``scd_resnet_tpu/core/compile_cache.py``. The JAX package
keeps XLA's persistent compilation cache in a directory keyed by the
host's CPU features, because ahead-of-time code compiled for one
machine's instruction set may not run on another. The port compiles its
CUDA kernels with ``nvcc`` and its host library with the host compiler
(``core/cuda_build``); a library built by one toolchain must not be
loaded where another one is installed. So the build root is
``<base>/<fingerprint>/``, the fingerprint naming both the CPU features
(:func:`host_fingerprint`, the JAX package's answer for the same
``/proc/cpuinfo``) and the toolchain (:func:`toolchain_fingerprint`:
``nvcc --version`` and the host compiler's ``--version``). A second
process on the same machine finds every library built and builds
nothing.

``<base>`` is ``build/`` in the checkout, or ``$SCD_COMPILE_CACHE_DIR``
(the counterpart of ``JAX_COMPILATION_CACHE_DIR``), or the ``path`` a
caller gives. ``SCD_NO_COMPILE_CACHE=1`` builds into a fresh directory
under ``<base>`` for each process, removed when the process exits.

Each entry point calls :func:`enable_compilation_cache` first, as the
JAX entry points do; a build before any call takes the defaults. cuDNN's
autotuned algorithm choices and ``torch.export`` have no cache that
outlives a process, so there is nothing of theirs to key here.
"""

from __future__ import annotations

import atexit
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

from scd_resnet_tpu_torch.core import cuda_build

DEFAULT_BASE = Path(__file__).resolve().parents[2] / "build"
BASE_ENV = "SCD_COMPILE_CACHE_DIR"
NO_CACHE_ENV = "SCD_NO_COMPILE_CACHE"

_lock = threading.Lock()
# (base, pid) -> that process's uncached directory
_fresh: Dict[Tuple[str, int], str] = {}


def host_fingerprint(cpuinfo_text: Optional[str] = None) -> str:
    """A short stable id of this machine's instruction-set features: a
    hash of the sorted ``/proc/cpuinfo`` feature flags (their order
    varies between kernels), or the machine architecture where there is
    no such file."""
    if cpuinfo_text is None:
        try:
            with open("/proc/cpuinfo") as f:
                cpuinfo_text = f.read()
        except OSError:
            return platform.machine() or "unknown"
    for line in cpuinfo_text.splitlines():
        if line.lower().startswith(("flags", "features")):
            flags = " ".join(sorted(line.split(":", 1)[1].split()))
            return hashlib.sha1(flags.encode()).hexdigest()[:12]
    return platform.machine() or "unknown"


def _version(command) -> str:
    """What ``command --version`` prints, or why it printed nothing."""
    try:
        proc = subprocess.run([command, "--version"], capture_output=True,
                              text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as err:
        return "{}: {}".format(command, err)
    return "{} (exit {}): {}{}".format(command, proc.returncode, proc.stdout,
                                       proc.stderr)


def toolchain_fingerprint() -> str:
    """A short id of the compilers a build would run: ``nvcc
    --version`` (or that there is no ``nvcc``) and the host compiler's
    ``--version``."""
    try:
        nvcc = _version(cuda_build.nvcc_path())
    except RuntimeError as err:
        nvcc = "nvcc: {}".format(err)
    try:
        cxx = _version(cuda_build.cxx_path())
    except RuntimeError as err:
        cxx = "cxx: {}".format(err)
    return hashlib.sha1((nvcc + "\n" + cxx).encode()).hexdigest()[:12]


def fingerprint() -> str:
    """``<host>-<toolchain>``: the name of this machine's build
    directory."""
    return "{}-{}".format(host_fingerprint(), toolchain_fingerprint())


def _remove_fresh(key: Tuple[str, int]) -> None:
    """Remove a process's uncached directory when that process (not a
    forked child) exits."""
    path = _fresh.pop(key, None)
    if path is not None and os.getpid() == key[1]:
        shutil.rmtree(path, ignore_errors=True)


def enable_compilation_cache(path: Optional[str] = None) -> str:
    """Point every build at ``<base>/<fingerprint>/`` (or, under
    ``SCD_NO_COMPILE_CACHE``, at this process's fresh directory) and
    return it. ``<base>``: ``path``, else ``$SCD_COMPILE_CACHE_DIR``,
    else ``build/`` in the checkout. Calling it again with the same
    environment returns the same directory."""
    base = Path(path or os.environ.get(BASE_ENV) or DEFAULT_BASE)
    with _lock:
        if os.environ.get(NO_CACHE_ENV):
            key = (str(base), os.getpid())
            if key not in _fresh:
                base.mkdir(parents=True, exist_ok=True)
                _fresh[key] = tempfile.mkdtemp(prefix="nocache-",
                                               dir=str(base))
                atexit.register(_remove_fresh, key)
            root = Path(_fresh[key])
        else:
            root = base / fingerprint()
            root.mkdir(parents=True, exist_ok=True)
        cuda_build.set_build_root(root)
    return str(root)
