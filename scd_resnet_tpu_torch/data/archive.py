"""`.d` archive format: reader and writer.

Counterpart of ``scd_resnet_tpu/data/archive.py``. The archive is a zip
with the layout of the reference (scdx16p100.py:66-90):

    object-count.json          {"<img>.<id>": count, ...}
    dataset.json               {"names": ["<img>.<rep>.<id>.npy", ...]}
    samples/<name>.npy         (H, W) float image clip
    locs/<name>.npy            (K, 8) float [ctX, ctY, offX, offY,
                                             majX, majY, minL, halo]

Reading parses the npy payloads straight out of the zip into one
contiguous array, by one of two readers: ``"native"`` (the default), the
port's host library (``csrc/scdio.cpp`` through ``data/native_io``:
the zip memory-mapped, the payloads inflated by worker threads, ZIP64
archives read), or ``"numpy"``, the plain version (``zipfile`` and
``np.load``, one entry at a time). Both give the same arrays to the bit;
neither falls back to the other.
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Dict, List, Optional, Tuple

import numpy as np

MAXTAGLEN = 30  # fixed-shape object packing (scdx16p100.py:46)


class ArchiveWriter:
    """Streams clips into a `.d` zip."""

    def __init__(self, path: str):
        self._zip = zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED)
        self._names: List[str] = []
        self._counts: Dict[str, int] = {}

    def add_clip(self, image_name: str, rep: int, clip_id: int,
                 sample: np.ndarray, locs: np.ndarray) -> None:
        name = f"{image_name}.{rep}.{clip_id}"
        buf = io.BytesIO()
        np.save(buf, np.asarray(sample, np.float32))
        self._zip.writestr(f"samples/{name}.npy", buf.getvalue())
        buf = io.BytesIO()
        np.save(buf, np.asarray(locs, np.float32))
        self._zip.writestr(f"locs/{name}.npy", buf.getvalue())
        self._names.append(name + ".npy")
        # count key matches the reference's "{imageName}.{generalId}"
        self._counts[f"{image_name}.{clip_id}"] = int(len(locs))

    def close(self) -> None:
        self._zip.writestr("object-count.json", json.dumps(self._counts))
        self._zip.writestr("dataset.json", json.dumps({"names": self._names}))
        self._zip.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


READERS = ("native", "numpy")


def read_archive(path: str, reader: str = "native",
                 threads: Optional[int] = None
                 ) -> Tuple[List[str], np.ndarray, np.ndarray, np.ndarray]:
    """Load a `.d` archive into packed host arrays: ``(names, samples
    (N, H, W) float32, locs (N, MAXTAGLEN, 8) float32, counts (N,)
    int32)``. Objects beyond MAXTAGLEN are dropped (the reference's
    fixed-length packing, scdx16p100.py:346-351). ``reader``: ``"native"``
    (on ``threads`` threads, ``data/native_io.read_archive_native``) or
    ``"numpy"``."""
    if reader == "native":
        from scd_resnet_tpu_torch.data.native_io import read_archive_native

        return read_archive_native(path, threads)
    if reader != "numpy":
        raise ValueError("reader must be one of {}, not {!r}".format(
            READERS, reader))
    with zipfile.ZipFile(path) as zf:
        names = json.loads(zf.read("dataset.json"))["names"]
        samples = []
        locs = np.zeros((len(names), MAXTAGLEN, 8), np.float32)
        counts = np.zeros(len(names), np.int32)
        for i, name in enumerate(names):
            sample = np.load(io.BytesIO(zf.read(f"samples/{name}")))
            samples.append(np.asarray(sample, np.float32))
            loc = np.load(io.BytesIO(zf.read(f"locs/{name}")))
            loc = np.asarray(loc, np.float32).reshape(-1, 8)[:MAXTAGLEN]
            locs[i, : len(loc)] = loc
            counts[i] = len(loc)
    stack = (np.stack(samples, 0) if samples
             else np.zeros((0, 0, 0), np.float32))
    return names, stack, locs, counts
