"""Load generator for the serving daemon.

    python -m scd_resnet_tpu_torch.serve -c model.pt --warmup 1546x1028 &
    python -m scd_resnet_tpu_torch.tools.loadtest --url http://127.0.0.1:8600 \\
        --width 1546 --height 1028 --requests 12 --concurrency 3

Counterpart of the root ``tools/loadtest.py``. After one priming request
(so the analyzer of the slide's geometry exists), it sends ``--requests``
concurrent ``POST /analyse`` requests, ``--concurrency`` at a time, and
prints one JSON line: latency percentiles by the client's clock
(nearest rank) and the clips per second the daemon analysed over the
run's wall time, from its own ``/metrics`` counters before and after.
The body is a slide file (``--image``), a PNG of seeded noise, or with
``--raw`` the noise as a raw uint8 buffer (``application/octet-stream``
with ``X-Width``/``X-Height``), which skips both sides' codecs.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import io
import json
import time
import urllib.request
from typing import Any, Dict, List, Optional

import numpy as np


def request_body(width: int, height: int, image: Optional[str] = None,
                 raw: bool = False):
    """``(payload, headers)`` of one /analyse request."""
    if raw:
        if image:
            raise SystemExit("--raw uses synthetic pixels; drop --image")
        rng = np.random.default_rng(0)
        payload = rng.integers(120, 255, (height, width), np.uint8).tobytes()
        return payload, {"Content-Type": "application/octet-stream",
                         "X-Width": str(width), "X-Height": str(height)}
    if image:
        with open(image, "rb") as f:
            return f.read(), {}
    from PIL import Image

    rng = np.random.default_rng(0)
    noise = rng.integers(120, 255, (height, width, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(noise).save(buf, format="PNG")
    return buf.getvalue(), {}


def load_test(url: str, payload: bytes, headers: Dict[str, str],
              requests: int, concurrency: int) -> Dict[str, Any]:
    """One priming request, then ``requests`` requests over
    ``concurrency`` threads; the summary the CLI prints."""
    if requests <= 0:
        raise SystemExit("no requests issued (--requests must be > 0)")

    def get(path):
        with urllib.request.urlopen(url + path, timeout=600) as resp:
            return json.loads(resp.read())

    def analyse():
        req = urllib.request.Request(url + "/analyse", data=payload,
                                     method="POST", headers=headers)
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as resp:
            body = json.loads(resp.read())
        return time.perf_counter() - t0, body["count"]

    analyse()
    before = get("/metrics")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(concurrency) as pool:
        latencies: List[float] = sorted(
            lat for lat, _ in pool.map(lambda _: analyse(), range(requests)))
    wall = time.perf_counter() - t0
    after = get("/metrics")

    def pct(p: int) -> float:  # nearest rank: ceil(p/100 * n) - 1
        return latencies[max(0, -(-p * len(latencies) // 100) - 1)]

    clips = after["clips"] - before["clips"]
    return {
        "requests": requests,
        "concurrency": concurrency,
        "wall_seconds": round(wall, 2),
        "requests_per_second": round(requests / wall, 2),
        "clips_per_second": round(clips / wall, 1),
        "latency_p50_ms": round(pct(50) * 1000, 1),
        "latency_p90_ms": round(pct(90) * 1000, 1),
        "latency_max_ms": round(latencies[-1] * 1000, 1),
        "server_errors": after["errors"] - before["errors"],
    }


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    parser = argparse.ArgumentParser(
        prog="python -m scd_resnet_tpu_torch.tools.loadtest",
        description="concurrent /analyse requests against the serving "
                    "daemon")
    parser.add_argument("--url", default="http://127.0.0.1:8600")
    parser.add_argument("--width", type=int, default=1546)
    parser.add_argument("--height", type=int, default=1028)
    parser.add_argument("--requests", type=int, default=12)
    parser.add_argument("--concurrency", type=int, default=3)
    parser.add_argument("--image", default=None,
                        help="slide file to send (default: synthetic noise "
                        "of --width x --height)")
    parser.add_argument("--raw", action="store_true",
                        help="send a raw uint8 grayscale buffer "
                        "(application/octet-stream + X-Width/X-Height) "
                        "instead of PNG: skips both sides' codec work")
    args = parser.parse_args(argv)
    payload, headers = request_body(args.width, args.height, args.image,
                                    args.raw)
    result = load_test(args.url, payload, headers, args.requests,
                       args.concurrency)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
