#!/usr/bin/env python3
"""chip_smoke.py — the quickest proof that the PyTorch port runs on a GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (on PATH or under ``CUDA_HOME``, default
``/usr/local/cuda``) and this checkout. It drives the port only
(``scd_resnet_tpu_torch``; nothing of JAX or of ``scd_resnet_tpu``):

1. prints the toolchain and the card (``nvidia-smi`` name and power
   limit);
2. builds the corner-pool kernel (``csrc/corner_pool.cu``) for sm_90a and
   holds it against its plain PyTorch version on the card in all four
   directions at the served shape (48, 128, 128, 128) float32, on random
   and on tie-heavy inputs: they must match exactly (a running max only
   returns input values). It times the kernel, the plain version and
   ``torch.cummax`` (a yardstick the port never calls), then checks the
   kernel at a few ragged shapes with NaN inputs;
3. serves ``cornerCPoolRes10`` and then ``centerOffsetRes10`` at full
   width through the port's own serve entry point (``serve.build_service``
   + the HTTP server), from seeded random weights whose heat heads are
   rescaled so that a few dozen peaks per clip pass the 0.3 threshold,
   and POSTs a seeded synthetic 3092x2056 slide (48 clips) four times:
   three raw uint8 bodies and one PNG. Launch counts are set to 0 just
   before each model's requests and read just after: every corner
   request must launch the kernel exactly four times (top and left in
   tl_head, bottom and right in br_head), the centerOffset requests never.
   Detections must be non-empty, inside the slide and the same on every
   request; two forwards of the slide's clips must agree bit for bit
   (serving is deterministic). Two of the clips then go through the same
   model on the CPU, and the card's decode rows must match the CPU's
   (tolerances at ``compare_rows``);
4. prints one ``{"kernels": [...]}`` line, the card's name and power
   limit, and as the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.

Any failed phase raises and the script exits non-zero without the last
line. It exits non-zero at once when ``torch.cuda.is_available()`` is
false. Everything it writes goes under ``build/`` in the checkout.
"""

from __future__ import annotations

import copy
import io
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import torch
from PIL import Image

from scd_resnet_tpu_torch import serve
from scd_resnet_tpu_torch.core import cuda_build
from scd_resnet_tpu_torch.core.checkpoint import save_checkpoint
from scd_resnet_tpu_torch.core.device import reproducible_float32
from scd_resnet_tpu_torch.infer.analyse import make_device_tiler
from scd_resnet_tpu_torch.infer.server import create_server
from scd_resnet_tpu_torch.infer.synthetic import seeded_model, synthetic_slide
from scd_resnet_tpu_torch.infer.wrapper import make_wrapper
from scd_resnet_tpu_torch.ops import corner_pool as cp
from scd_resnet_tpu_torch.profile_serve import device_ms

REPO = os.path.dirname(os.path.abspath(__file__))
SLIDE_W, SLIDE_H = 3092, 2056
POOL_SHAPE = (48, 128, 128, 128)  # what the served corner heads pool
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM data sheet, float32 outside tensor cores
REQUESTS = 4  # per model: three raw bodies, one PNG
DIRECTIONS = {"top": (2, True), "bottom": (2, False),
              "left": (3, True), "right": (3, False)}
EDGE_SHAPES = ((2, 3, 37, 45), (1, 2, 1, 33), (1, 2, 70, 1))


def log(msg: str) -> None:
    print(msg, flush=True)


def run(cmd) -> str:
    return subprocess.run(cmd, check=True, capture_output=True,
                          text=True).stdout.strip()


# -- 2. the kernel against its plain version --------------------------------

def time_ms(fn) -> float:
    """Mean device time of ``fn()`` over 20 calls after 2 warm-up calls.
    Each call reads and writes 402 MB, far beyond the 50 MB L2, so every
    call meets a cold cache."""
    return device_ms(fn, 20, warmup=2)


def check_corner_pool():
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = {
        "random": torch.randn(POOL_SHAPE, device="cuda", generator=gen),
        # ReLU'd small integers: long runs of ties and zeros
        "ties": torch.randint(-3, 4, POOL_SHAPE, device="cuda",
                              generator=gen).float().clamp_min_(0),
    }
    n_bytes = 2 * inputs["random"].numel() * 4
    bound_ms = max(n_bytes / HBM_BYTES_PER_S,
                   inputs["random"].numel() / FP32_OPS_PER_S) * 1e3
    results = {}
    for direction, (dim, reverse) in DIRECTIONS.items():
        err = 0.0
        for kind, x in inputs.items():
            got = cp.corner_pool(x, dim, reverse)
            torch.cuda.synchronize()
            ref = cp.corner_pool_plain(x, dim, reverse)
            if not torch.equal(got, ref):
                raise AssertionError("corner_pool {} on {} input differs "
                                     "from its plain version".format(
                                         direction, kind))
            err = max(err, (got - ref).abs().max().item())
        x = inputs["random"]
        results[direction] = {
            "max_abs_err": err,
            "ms": time_ms(lambda: cp.corner_pool(x, dim, reverse)),
            "plain_ms": time_ms(lambda: cp.corner_pool_plain(x, dim, reverse)),
            "library_ms": time_ms(lambda: torch.cummax(x, dim)),
        }
        log("corner_pool {:6s} exact on random and tie inputs: kernel "
            "{:.4f} ms, plain {:.4f} ms, torch.cummax {:.4f} ms, bound "
            "{:.4f} ms".format(direction, results[direction]["ms"],
                               results[direction]["plain_ms"],
                               results[direction]["library_ms"], bound_ms))
    del inputs
    torch.cuda.empty_cache()

    # ragged warp chunks, single rows and columns, NaN propagation
    for shape in EDGE_SHAPES:
        x = torch.randn(shape, device="cuda", generator=gen)
        x[x > 2.0] = float("nan")
        for direction, (dim, reverse) in DIRECTIONS.items():
            got = cp.corner_pool(x, dim, reverse)
            ref = cp.corner_pool_plain(x, dim, reverse)
            if not (torch.equal(got.isnan(), ref.isnan())
                    and torch.equal(got.nan_to_num(), ref.nan_to_num())):
                raise AssertionError("corner_pool {} at {} differs from its "
                                     "plain version".format(direction, shape))
    torch.cuda.synchronize()
    log("corner_pool exact at edge shapes {} with NaN inputs".format(
        list(EDGE_SHAPES)))
    return results, bound_ms


def kernel_line(results, bound_ms, launches):
    """One entry per __global__ kernel: corner_pool_h serves top/bottom,
    corner_pool_w left/right; times are the mean of its two directions,
    ``library_ms`` is torch.cummax in the forward direction."""
    entries = []
    for dim, name in sorted(cp.KERNEL_NAMES.items()):
        dirs = [d for d, (dd, _) in DIRECTIONS.items() if dd == dim]
        fwd = [d for d in dirs if not DIRECTIONS[d][1]][0]
        mean = lambda key: sum(results[d][key] for d in dirs) / len(dirs)  # noqa: E731
        entries.append({
            "name": name, "route": "cuda",
            "source": "scd_resnet_tpu_torch/csrc/corner_pool.cu",
            "replaces": "scd_resnet_tpu/ops/pallas_kernels.py:260",
            "launches": launches[name],
            "max_abs_err": max(results[d]["max_abs_err"] for d in dirs),
            "ms": mean("ms"), "kernel_ms": mean("ms"),
            "plain_ms": mean("plain_ms"),
            "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": results[fwd]["library_ms"],
            "library_call": "torch.cummax(x, {}) ({})".format(dim, fwd),
            "shape": list(POOL_SHAPE),
            "ms_by_direction": {d: results[d]["ms"] for d in dirs},
        })
    return {"kernels": entries}


# -- 3. serving ---------------------------------------------------------------

def compare_rows(family, gpu_rows, cpu_rows):
    """Card against CPU on the same clips, both in exact float32 (TF32
    off): scores within 1e-4 absolute; the top-K positions equal wherever
    the score is above 0.3 and at least 1e-4 from its neighbours in the
    ranking (closer scores may swap ranks under another summation order);
    the centerOffset regression rows at those positions within 1e-3
    relative to the row's largest value."""
    gpu, cpu = gpu_rows.double().cpu(), cpu_rows.double()
    blocks = range(3) if family == "corner" else range(1)
    checked = 0
    for b in blocks:
        s_gpu, s_cpu = gpu[4 * b], cpu[4 * b]
        err = (s_gpu - s_cpu).abs().max().item()
        if err > 1e-4:
            raise AssertionError("{} scores differ by {}".format(family, err))
        gaps = torch.full_like(s_cpu, float("inf"))
        diffs = (s_cpu[:, 1:] - s_cpu[:, :-1]).abs()
        gaps[:, 1:] = diffs
        gaps[:, :-1] = torch.minimum(gaps[:, :-1], diffs)
        firm = (s_cpu > 0.3) & (gaps > 1e-4)
        if not torch.equal(gpu[4 * b + 1][firm], cpu[4 * b + 1][firm]):
            raise AssertionError("{} top-K positions differ".format(family))
        checked += int(firm.sum())
        if family == "centerOffset":
            for r in range(4, 10):
                scale = max(1.0, cpu[r].abs().max().item())
                rerr = (gpu[r][firm] - cpu[r][firm]).abs().max().item()
                if rerr > 1e-3 * scale:
                    raise AssertionError("centerOffset row {} differs by {} "
                                         "(scale {})".format(r, rerr, scale))
    if checked == 0:
        raise AssertionError("no firm peaks to compare")
    return checked


def post(url, data, headers):
    req = urllib.request.Request(url, data=data, method="POST",
                                 headers=headers)
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


def serve_model(arch: str, seed: int, slide, build_dir, card: str,
                device: str = "cuda"):
    height, width = slide.shape
    tiler = make_device_tiler(width, height, torch.device(device))
    clips = tiler(torch.from_numpy(slide).to(device))
    model = seeded_model(arch, seed, clips)
    ckpt = save_checkpoint(os.path.join(build_dir, arch + ".pt"), arch,
                           model.state_dict())
    service = serve.build_service(serve.parse_args(
        ["-c", ckpt, "-a", arch, "--device", device,
         "--warmup", "{}x{}".format(width, height)]))
    server = create_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = "http://127.0.0.1:{}/analyse".format(server.server_address[1])
    png = io.BytesIO()
    Image.fromarray(slide).save(png, format="PNG")
    bodies = [(slide.tobytes(), {"Content-Type": "application/octet-stream",
                                 "X-Width": str(width),
                                 "X-Height": str(height)})] * (REQUESTS - 1)
    bodies.append((png.getvalue(), {}))
    family = service.contract
    # top and left pools in tl_head, bottom and right in br_head
    per_request = {name: 2 if family == "corner" else 0
                   for name in cp.KERNEL_NAMES.values()}
    latencies, counts = [], []
    try:
        cuda_build.reset_launches()
        for data, headers in bodies:
            before = dict(cuda_build.LAUNCHES)
            t0 = time.perf_counter()
            payload = post(url, data, headers)
            latencies.append((time.perf_counter() - t0) * 1e3)
            launched = {name: cuda_build.LAUNCHES[name] - before[name]
                        for name in per_request}
            if launched != per_request:
                raise AssertionError("{}: one request launched {}, expected "
                                     "{}".format(arch, launched, per_request))
            counts.append(payload["count"])
            dets = payload["detections"]
            if not dets:
                raise AssertionError("{}: no detections".format(arch))
            for d in dets:
                if not (0 <= d["x"] < width and 0 <= d["y"] < height):
                    raise AssertionError("{}: detection {} outside the "
                                         "slide".format(arch, d))
        launches = dict(cuda_build.LAUNCHES)
        metrics = service.metrics()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        if thread.is_alive():
            raise AssertionError("{}: server thread did not stop".format(arch))

    if len(set(counts)) != 1:
        raise AssertionError("{}: detection counts vary across identical "
                             "requests: {}".format(arch, counts))

    # two clips of the same slide through the same model on the CPU
    pick = [0, 2 * clips.shape[0] // 3]
    rows = service.wrapper(clips)
    if not torch.equal(rows, service.wrapper(clips)):
        raise AssertionError("{}: two forwards of the same clips differ "
                             "(serving must be deterministic)".format(arch))
    gpu_rows = rows[:, pick]
    cpu_wrapper = make_wrapper(copy.deepcopy(service.wrapper.model).cpu(),
                               family)
    cpu_rows = cpu_wrapper(clips[pick].cpu())
    firm = compare_rows(family, gpu_rows, cpu_rows)
    n_clips = clips.shape[0]
    log("{}: {} requests, {} detections each, launches {}; per-request "
        "latency ms {}; {:.1f} clips/s (best request) on {}; card rows "
        "match the CPU on clips {} ({} firm peaks)".format(
            arch, REQUESTS, counts[0], launches,
            ["{:.1f}".format(t) for t in latencies],
            n_clips / (min(latencies) / 1e3), card, pick, firm))
    return {"arch": arch, "clips": n_clips, "detections": counts[0],
            "latency_ms": latencies, "server_busy_s": metrics["busy_seconds"],
            "server_clips_per_s": metrics["clips_per_second"],
            "launches": launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    # 1. toolchain and card
    gpu_line = run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"])
    log("python {} | torch {} (CUDA {}) | {}".format(
        sys.version.split()[0], torch.__version__, torch.version.cuda,
        run([cuda_build.nvcc_path(), "--version"]).splitlines()[-1]))
    log("card: {}".format(gpu_line))
    reproducible_float32()

    # 2. build the kernel from the checkout's sources, hold it to plain
    t0 = time.perf_counter()
    cuda_build.load("corner_pool.cu")
    log("built csrc/corner_pool.cu in {:.1f}s; ptxas:\n{}".format(
        time.perf_counter() - t0, cuda_build.build_log("corner_pool.cu")))
    results, bound_ms = check_corner_pool()

    # 3. serve both models; each resets the counts just before its requests
    build_dir = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(build_dir, exist_ok=True)
    slide = synthetic_slide(SLIDE_H, SLIDE_W, seed=2056)
    served = [serve_model(arch, seed, slide, build_dir, gpu_line)
              for arch, seed in (("cornerCPoolRes10", 10),
                                 ("centerOffsetRes10", 11))]
    corner_launches = served[0]["launches"]

    # 4. results
    log(json.dumps({"serving": served, "card": gpu_line,
                    "seconds": time.perf_counter() - t_start}))
    log(json.dumps(kernel_line(results, bound_ms, corner_launches)))
    log(gpu_line)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
