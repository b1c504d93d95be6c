"""ctypes bindings of the port's host library (``csrc/scdio.cpp``).

Counterpart of ``scd_resnet_tpu/data/native_io.py``: the threaded
archive reader (the zip memory-mapped, npy payloads inflated straight
into one contiguous array by up to ``MAX_THREADS`` threads), the batch
packer (``out[b] = samples[idx[b]]`` by memcpy) and the single-pass
inference grayscale. The library is built from the checkout by
``core/cuda_build`` on first use (``g++``; no zlib headers needed).

Nothing here falls back to another path: a failed build raises with the
compiler's output, a library without the entry points raises, and an
entry the reader cannot read raises with its index and name. The numpy
reader stays the plain version, asked for by name
(``data/archive.read_archive(path, reader="numpy")``).
"""

from __future__ import annotations

import ctypes
import io
import json
import os
import threading
from typing import List, Optional, Tuple

import numpy as np

from scd_resnet_tpu_torch.core import cuda_build
from scd_resnet_tpu_torch.data.archive import MAXTAGLEN

SOURCE = "scdio.cpp"
MAX_THREADS = 8  # the JAX reader's min(8, cpu_count)
ENTRY_POINTS = ("scdio_open", "scdio_close", "scdio_num_samples",
                "scdio_entry_size", "scdio_read_entry", "scdio_load_dataset",
                "scdio_gather_batch", "scdio_grayscale_u8")
_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _floats(ndim: int):
    return np.ctypeslib.ndpointer(np.float32, ndim=ndim, flags="C_CONTIGUOUS")


def get_library() -> ctypes.CDLL:
    """The host library, built on first use, with its signatures
    declared. Raises ``RuntimeError`` when it does not build or lacks an
    entry point."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = cuda_build.load(SOURCE)
        missing = [name for name in ENTRY_POINTS if not hasattr(lib, name)]
        if missing:
            raise RuntimeError("{} lacks {} (a stale library); remove it and "
                               "build again".format(lib._name, missing))
        lib.scdio_open.restype = ctypes.c_void_p
        lib.scdio_open.argtypes = [ctypes.c_char_p]
        lib.scdio_close.restype = None
        lib.scdio_close.argtypes = [ctypes.c_void_p]
        lib.scdio_num_samples.restype = ctypes.c_int64
        lib.scdio_num_samples.argtypes = [ctypes.c_void_p]
        lib.scdio_entry_size.restype = ctypes.c_int64
        lib.scdio_entry_size.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.scdio_read_entry.restype = ctypes.c_int
        lib.scdio_read_entry.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                         ctypes.c_char_p]
        lib.scdio_load_dataset.restype = ctypes.c_int
        lib.scdio_load_dataset.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, _floats(3), _floats(3),
            np.ctypeslib.ndpointer(np.int32, ndim=1, flags="C_CONTIGUOUS"),
            ctypes.c_int]
        lib.scdio_gather_batch.restype = None
        lib.scdio_gather_batch.argtypes = [
            _floats(3), ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64, ndim=1, flags="C_CONTIGUOUS"),
            ctypes.c_int64, _floats(3)]
        lib.scdio_grayscale_u8.restype = None
        lib.scdio_grayscale_u8.argtypes = [
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")]
        _lib = lib
        return _lib


def reader_threads() -> int:
    """The reader's threads: as many as cores, at most ``MAX_THREADS``."""
    return min(MAX_THREADS, os.cpu_count() or 1)


def _read_entry(lib, handle, name: str) -> bytes:
    size = lib.scdio_entry_size(handle, name.encode())
    if size < 0:
        raise KeyError(name)
    buf = ctypes.create_string_buffer(max(size, 1))
    if lib.scdio_read_entry(handle, name.encode(), buf) != 0:
        raise ValueError("{} does not inflate or fails its CRC".format(name))
    return buf.raw[:size]


def read_archive_native(path: str, threads: Optional[int] = None
                        ) -> Tuple[List[str], np.ndarray, np.ndarray,
                                   np.ndarray]:
    """``data/archive.read_archive``'s arrays, read by the host library
    on ``threads`` threads (default :func:`reader_threads`): ``(names,
    samples (N, H, W) float32, locs (N, MAXTAGLEN, 8) float32, counts
    (N,) int32)``, records beyond MAXTAGLEN dropped. Reads ZIP64
    archives. Raises ``ValueError`` for a file that is not a readable zip
    and for the first entry it cannot read (its index and name)."""
    lib = get_library()
    threads = reader_threads() if threads is None else int(threads)
    handle = lib.scdio_open(os.fsencode(path))
    if not handle:
        raise ValueError("{}: not a readable zip archive (no central "
                         "directory, or one that points outside the "
                         "file)".format(path))
    try:
        try:
            names = json.loads(_read_entry(lib, handle,
                                           "dataset.json"))["names"]
        except KeyError:
            raise ValueError("{}: no dataset.json".format(path)) from None
        n = len(names)
        if n == 0:
            return ([], np.zeros((0, 0, 0), np.float32),
                    np.zeros((0, MAXTAGLEN, 8), np.float32),
                    np.zeros(0, np.int32))
        # the clips' geometry from the first sample's npy header
        try:
            shape = _npy_shape(_read_entry(lib, handle,
                                           "samples/" + names[0]))
        except KeyError:
            shape = "missing"
        except ValueError as err:
            shape = str(err)
        if not (isinstance(shape, tuple) and len(shape) == 2):
            raise ValueError("{}: entry 0 ({}): its sample is not an (H, W) "
                             "npy array ({})".format(path, names[0], shape))
        h, w = shape
        samples = np.zeros((n, h, w), np.float32)
        locs = np.zeros((n, MAXTAGLEN, 8), np.float32)
        counts = np.zeros(n, np.int32)
        packed = b"\0".join(name.encode() for name in names) + b"\0"
        ret = lib.scdio_load_dataset(handle, packed, n, h * w, MAXTAGLEN,
                                     samples, locs, counts, threads)
        if ret != 0:
            i = -ret - 1
            raise ValueError("{}: entry {} ({}): {}".format(
                path, i, names[i], _diagnose(lib, handle, names[i], h, w)))
        return list(names), samples, locs, counts
    finally:
        lib.scdio_close(handle)


def _npy_shape(data: bytes) -> Tuple[int, ...]:
    """The shape in an npy v1 header."""
    stream = io.BytesIO(data)
    version = np.lib.format.read_magic(stream)
    if version != (1, 0):
        raise ValueError("npy format {} (the reader takes 1.0)".format(
            version))
    shape, _, _ = np.lib.format.read_array_header_1_0(stream)
    return tuple(shape)


def _diagnose(lib, handle, name: str, h: int, w: int) -> str:
    """Why the reader could not read clip ``name``."""
    for kind in ("samples", "locs"):
        entry = "{}/{}".format(kind, name)
        try:
            data = _read_entry(lib, handle, entry)
        except KeyError:
            return "{} is missing".format(entry)
        except ValueError as err:
            return str(err)
        try:
            array = np.load(io.BytesIO(data))
        except ValueError as err:
            return "{} is not an npy array ({})".format(entry, err)
        want = "(H, W) = ({}, {})".format(h, w) if kind == "samples" \
            else "(K, 8) or (0,)"
        ok_dtype = array.dtype.str in ("<f4", "<f8") \
            and not np.isfortran(array)
        ok_shape = array.shape == (h, w) if kind == "samples" else (
            (array.ndim == 2 and array.shape[1] == 8) or array.shape == (0,))
        if not (ok_dtype and ok_shape):
            return "{} is a {} array of shape {}{}; the reader takes C-order " \
                "<f4/<f8 of {}".format(entry, array.dtype.str, array.shape,
                                      " in Fortran order"
                                      if np.isfortran(array) else "", want)
    return "unreadable"


def gather_batch(samples: np.ndarray, indices: np.ndarray,
                 out: Optional[np.ndarray] = None) -> np.ndarray:
    """``out[b] = samples[indices[b]]`` for a C-contiguous float32
    ``samples`` (N, H, W), by the host library's memcpy; every index must
    lie in [0, N)."""
    if samples.dtype != np.float32 or samples.ndim != 3 \
            or not samples.flags.c_contiguous:
        raise TypeError("gather_batch packs C-contiguous float32 (N, H, W) "
                        "clips, not {} {}".format(samples.dtype,
                                                  samples.shape))
    idx = np.ascontiguousarray(indices, np.int64).reshape(-1)
    n, h, w = samples.shape
    if idx.size and (idx.min() < 0 or idx.max() >= n):
        raise IndexError("an index of {} is outside [0, {})".format(idx, n))
    if out is None:
        out = np.empty((idx.size, h, w), np.float32)
    elif out.shape != (idx.size, h, w) or out.dtype != np.float32 \
            or not out.flags.c_contiguous:
        raise TypeError("out must be C-contiguous float32 of shape "
                        "{}".format((idx.size, h, w)))
    get_library().scdio_gather_batch(samples, h * w, idx, idx.size, out)
    return out


def grayscale_u8(rgb: np.ndarray) -> np.ndarray:
    """The inference grayscale of a uint8 (..., 3) RGB array, in one pass
    (bit-equal to ``round(0.1140 R + 0.5870 G + 0.2989 B)`` in float64
    with numpy's rounding)."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim < 2 or rgb.shape[-1] != 3:
        raise TypeError("grayscale_u8 takes uint8 (..., 3) RGB, not {} "
                        "{}".format(rgb.dtype, rgb.shape))
    src = np.ascontiguousarray(rgb)
    out = np.empty(rgb.shape[:-1], np.uint8)
    get_library().scdio_grayscale_u8(src.reshape(-1), out.size,
                                     out.reshape(-1))
    return out
