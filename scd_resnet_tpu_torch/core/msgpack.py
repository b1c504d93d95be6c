"""A small msgpack decoder for the JAX package's checkpoints.

The JAX trainer writes its checkpoints with
``flax.serialization.to_bytes``: one msgpack map whose leaves are flax
extension types. The port reads them without the ``msgpack`` package,
which the card's machine is not known to have. It decodes maps, arrays,
str, bin, nil, bool, ints, float32/64 and ext, and flax's ext codes:

- 1, an ndarray: its payload is itself msgpack ``(shape, dtype name,
  bytes)``, C order; ``bfloat16`` is read as float32 (the 16 bits
  shifted up, exact);
- 2, a Python complex: ``(real, imag)``;
- 3, a numpy scalar: an ndarray payload of shape ().

Anything else raises ``ValueError`` naming what it found and where,
flax's chunked-array dicts (``__msgpack_chunked_array__``, arrays above
1 GiB) and a truncated input included.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

EXT_NDARRAY = 1
EXT_COMPLEX = 2
EXT_NPSCALAR = 3
CHUNKED_KEY = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("msgpack: truncated input: {} bytes wanted at "
                             "offset {} of {}".format(n, self.pos,
                                                      len(self.data)))
        out = self.data[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _read(r: _Reader) -> Any:
    tag = r.unpack(">B")
    if tag <= 0x7F:
        return tag
    if tag >= 0xE0:
        return tag - 0x100
    if 0x80 <= tag <= 0x8F:
        return _map(r, tag & 0x0F)
    if 0x90 <= tag <= 0x9F:
        return [_read(r) for _ in range(tag & 0x0F)]
    if 0xA0 <= tag <= 0xBF:
        return _str(r, tag & 0x1F)
    fixed = {0xC0: None, 0xC2: False, 0xC3: True}
    if tag in fixed:
        return fixed[tag]
    if tag in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
        return bytes(r.take(r.unpack((">B", ">H", ">I")[tag - 0xC4])))
    if tag in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
        n = r.unpack((">B", ">H", ">I")[tag - 0xC7])
        return _ext(r.unpack(">b"), bytes(r.take(n)))
    if tag == 0xCA:
        return r.unpack(">f")
    if tag == 0xCB:
        return r.unpack(">d")
    ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if tag in ints:
        return r.unpack(ints[tag])
    if tag in (0xD4, 0xD5, 0xD6, 0xD7, 0xD8):  # fixext 1/2/4/8/16
        code = r.unpack(">b")
        return _ext(code, bytes(r.take(1 << (tag - 0xD4))))
    if tag in (0xD9, 0xDA, 0xDB):  # str 8/16/32
        return _str(r, r.unpack((">B", ">H", ">I")[tag - 0xD9]))
    if tag in (0xDC, 0xDD):  # array 16/32
        return [_read(r) for _ in range(r.unpack((">H", ">I")[tag - 0xDC]))]
    if tag in (0xDE, 0xDF):  # map 16/32
        return _map(r, r.unpack((">H", ">I")[tag - 0xDE]))
    raise ValueError("msgpack: unknown type byte 0x{:02x} at offset {}".format(
        tag, r.pos - 1))


def _str(r: _Reader, n: int) -> str:
    return bytes(r.take(n)).decode("utf-8")


def _map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        key = _read(r)
        out[key] = _read(r)
    if CHUNKED_KEY in out:
        raise ValueError("msgpack: a flax chunked array (an array above "
                         "1 GiB, keys {}) is not supported".format(
                             sorted(map(str, out))))
    return out


def _ndarray(payload: bytes) -> np.ndarray:
    shape, name, buffer = unpackb(payload)
    if isinstance(name, bytes):
        name = name.decode("ascii")
    if name == "bfloat16":
        bits = np.frombuffer(buffer, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    # a copy: the payload is immutable bytes, and the caller's tensors
    # take the array as it is
    try:
        dtype = np.dtype(name)
    except TypeError as exc:
        raise ValueError("msgpack: ndarray of unknown dtype {!r}".format(
            name)) from exc
    return np.frombuffer(buffer, dtype=dtype).reshape(shape).copy()


def _ext(code: int, payload: bytes) -> Any:
    if code == EXT_NDARRAY:
        return _ndarray(payload)
    if code == EXT_NPSCALAR:
        return _ndarray(payload)[()]
    if code == EXT_COMPLEX:
        real, imag = unpackb(payload)
        return complex(real, imag)
    raise ValueError("msgpack: unknown ext code {} ({} bytes); flax writes "
                     "1 (ndarray), 2 (complex) and 3 (numpy scalar)".format(
                         code, len(payload)))


def unpackb(data: bytes) -> Any:
    """The one msgpack object in ``data``; trailing bytes raise."""
    r = _Reader(data)
    obj = _read(r)
    if r.pos != len(r.data):
        raise ValueError("msgpack: {} trailing bytes after the object".format(
            len(r.data) - r.pos))
    return obj


def is_msgpack_map(head: bytes) -> bool:
    """Whether ``head`` (a file's first bytes) opens a msgpack map."""
    return bool(head) and (0x80 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF))
