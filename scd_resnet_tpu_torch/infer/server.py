"""Persistent slide-serving daemon (HTTP), on the port's analyzer.

Counterpart of ``scd_resnet_tpu/infer/server.py`` for the device-fused
path. One process owns the device and keeps one analyzer per slide
geometry (LRU-bounded); a new geometry is warmed up with one forward on
a blank slide, counted in ``compile_seconds`` and not in the serving
``busy_seconds``. HTTP contract:

    GET  /healthz   liveness + device + analyzer-cache info
    GET  /metrics   request/detection/latency counters (JSON)
    POST /warmup?width=W&height=H   prepare one geometry
    POST /analyse   body = image bytes (anything PIL reads), or
                    Content-Type: application/octet-stream with
                    X-Width/X-Height headers for a raw uint8 grayscale
                    buffer -> {"detections": [...], "contract", "count",
                    "latency_ms"}; fields per CONTRACT_FIELDS

``/analyse?dedupe=R`` overrides the tile-overlap suppression radius for
one request. Device work is serialised by a lock; the readback and host
stitch of a request run outside it. With ``mesh`` (a list of devices),
each slide's clips are sharded over them
(``infer/analyse.make_device_analyzer``), and ``/healthz`` reports the
mesh.
"""

from __future__ import annotations

import io
import json
import threading
import time
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from scd_resnet_tpu_torch.infer.analyse import (
    CONTRACT_FIELDS,
    dedupe_contract,
    make_device_analyzer,
    read_gray_u8,
    slide_geometry,
)

MAX_GEOMETRIES = 8  # analyzers kept, least recently used evicted first


class ClientError(ValueError):
    """Bad request input (HTTP 400, not counted as a server error)."""


class InferenceService:
    """Analyzer cache + stats around one decode wrapper
    (``infer/wrapper.make_wrapper``)."""

    def __init__(self, wrapper: Callable,
                 dedupe_radius: Optional[float] = None,
                 mesh: Optional[Sequence] = None):
        self.wrapper = wrapper
        self.mesh = None if mesh is None else [torch.device(d) for d in mesh]
        self.contract = wrapper.contract
        self.fields = CONTRACT_FIELDS[self.contract]
        self._dedupe = dedupe_radius
        self._analyzers: OrderedDict = OrderedDict()
        self._device_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._stats = {
            "requests": 0, "errors": 0, "detections": 0, "clips": 0,
            "warmups": 0, "compiles": 0, "compile_seconds": 0.0,
            "busy_seconds": 0.0, "started": time.time(),
        }

    # -- analysis ---------------------------------------------------------

    def _analyzer(self, width: int, height: int):
        """Get-or-build the analyzer for one geometry; call with the
        device lock held. A miss runs one forward on a blank slide so
        serving ``busy_seconds`` never includes first-call set-up (cuDNN
        algorithm choice, kernel build)."""
        key = (width, height)
        if key in self._analyzers:
            self._analyzers.move_to_end(key)
            return self._analyzers[key]
        t0 = time.perf_counter()
        analyzer = make_device_analyzer(self.wrapper, width, height,
                                        mesh=self.mesh)
        analyzer(np.zeros((height, width), np.uint8))
        elapsed = time.perf_counter() - t0
        with self._stats_lock:
            self._stats["compiles"] += 1
            self._stats["compile_seconds"] += elapsed
        self._analyzers[key] = analyzer
        while len(self._analyzers) > MAX_GEOMETRIES:
            self._analyzers.popitem(last=False)  # evict least-recent
        return analyzer

    def analyse_gray(self, gray: np.ndarray, dedupe: Optional[float] = None):
        """Detections for a uint8-range grayscale slide."""
        height, width = gray.shape
        with self._device_lock:
            analyzer = self._analyzer(width, height)
            t0 = time.perf_counter()
            rows = analyzer.dispatch(gray)
        detections = analyzer.finish(rows)
        elapsed = time.perf_counter() - t0
        radius = self._dedupe if dedupe is None else dedupe
        if radius is not None:
            detections = dedupe_contract(detections, radius, self.contract)
        clip_h, clip_v, _, _ = slide_geometry(width, height)
        with self._stats_lock:
            self._stats["requests"] += 1
            self._stats["detections"] += len(detections)
            self._stats["clips"] += clip_h * clip_v
            self._stats["busy_seconds"] += elapsed
        return detections

    def warmup(self, width: int, height: int) -> float:
        """Prepare the analyzer for one slide geometry; returns seconds
        spent (near 0 if already cached)."""
        t0 = time.perf_counter()
        with self._device_lock:
            self._analyzer(width, height)
        with self._stats_lock:
            self._stats["warmups"] += 1
        return time.perf_counter() - t0

    def analyse_raw(self, data: bytes, width: int, height: int,
                    dedupe: Optional[float] = None):
        """Raw uint8 grayscale intake (X-Width/X-Height + octet-stream)."""
        if width <= 0 or height <= 0:
            raise ClientError("bad raw geometry {}x{}".format(width, height))
        if len(data) != width * height:
            raise ClientError(
                "raw body is {} bytes, expected width*height = {}".format(
                    len(data), width * height))
        gray = np.frombuffer(data, np.uint8).reshape(height, width)
        return self.analyse_gray(gray, dedupe=dedupe)

    def analyse_bytes(self, data: bytes, dedupe: Optional[float] = None):
        from PIL import UnidentifiedImageError

        try:
            gray = read_gray_u8(io.BytesIO(data))
        except UnidentifiedImageError as exc:
            raise ClientError("unreadable image: {}".format(exc)) from exc
        except ValueError as exc:
            raise ClientError(str(exc)) from exc
        return self.analyse_gray(gray, dedupe=dedupe)

    def record_error(self):
        with self._stats_lock:
            self._stats["errors"] += 1

    # -- introspection ----------------------------------------------------

    def health(self) -> dict:
        def name(device):
            if device.type == "cuda":
                return "cuda:{} {}".format(device.index or 0,
                                           torch.cuda.get_device_name(device))
            return str(device)

        geometries = list(self._analyzers)  # atomic snapshot under the GIL
        return {
            "status": "ok",
            "mode": "device-fused",
            "devices": [name(d) for d in dict.fromkeys(
                self.mesh or [self.wrapper.device])],
            "mesh": None if self.mesh is None else str(
                {"data": len(self.mesh)}),
            "geometries": ["{}x{}".format(*k) for k in geometries],
        }

    def metrics(self) -> dict:
        with self._stats_lock:
            stats = dict(self._stats)
        stats["uptime_seconds"] = round(time.time() - stats.pop("started"), 1)
        busy = stats["busy_seconds"]
        stats["clips_per_second"] = stats["clips"] / busy if busy else 0.0
        return stats


def make_handler(service: InferenceService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet; the service keeps counters
            pass

        def _json(self, payload, code=200):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(service.health())
            elif self.path == "/metrics":
                self._json(service.metrics())
            else:
                self._json({"error": "not found"}, 404)

        def do_POST(self):
            from urllib.parse import parse_qs, urlparse

            url = urlparse(self.path)
            if url.path == "/warmup":
                try:
                    query = parse_qs(url.query)
                    width = int(query["width"][0])
                    height = int(query["height"][0])
                except (KeyError, ValueError) as exc:
                    self._json({"error": "bad warmup query: {}".format(exc)},
                               400)
                    return
                seconds = service.warmup(width, height)
                self._json({"compiled_seconds": seconds})
                return
            if url.path != "/analyse":
                self._json({"error": "not found"}, 404)
                return
            try:
                query = parse_qs(url.query)
                dedupe = (float(query["dedupe"][0])
                          if "dedupe" in query else None)
                length = int(self.headers.get("Content-Length", 0))
            except ValueError as exc:
                self._json({"error": "bad request: {}".format(exc)}, 400)
                return
            data = self.rfile.read(length)
            try:
                t0 = time.perf_counter()
                if (self.headers.get("Content-Type", "")
                        .startswith("application/octet-stream")):

                    def int_header(name):
                        value = self.headers.get(name, "0")
                        try:
                            return int(value)
                        except ValueError:
                            raise ClientError(
                                "bad {} header: {!r}".format(name, value))

                    detections = service.analyse_raw(
                        data, int_header("X-Width"), int_header("X-Height"),
                        dedupe=dedupe)
                else:
                    detections = service.analyse_bytes(data, dedupe=dedupe)
                self._json({
                    "detections": [dict(zip(service.fields, d))
                                   for d in detections],
                    "contract": service.contract,
                    "count": len(detections),
                    "latency_ms": (time.perf_counter() - t0) * 1000.0,
                })
            except ClientError as exc:  # bad input, not a server fault
                self._json({"error": str(exc)}, 400)
            except Exception as exc:  # report, keep serving
                service.record_error()
                self._json({"error": str(exc)}, 500)

    return Handler


def create_server(service: InferenceService, host: str = "127.0.0.1",
                  port: int = 8600) -> ThreadingHTTPServer:
    return ThreadingHTTPServer((host, port), make_handler(service))
