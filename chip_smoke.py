#!/usr/bin/env python3
"""chip_smoke.py — the quickest proof that the PyTorch port runs on a GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (on PATH or under ``CUDA_HOME``, default
``/usr/local/cuda``) and this checkout. It drives the port only
(``scd_resnet_tpu_torch``; nothing of JAX or of ``scd_resnet_tpu``):

1. prints the toolchain and the card (``nvidia-smi`` name and power
   limit), builds every kernel (``csrc/*.cu``, one ``nvcc`` each, all
   started together) and starts writing the seeded synthetic 512x512
   training archive in a subprocess (cached under ``build/``);
2. holds the corner-pool kernel (``csrc/corner_pool.cu``) against its
   plain PyTorch version on the card in all four
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
4. holds the heatmap-render kernel (``csrc/render_heatmap.cu``) against
   its plain version at exp74's shape, 32 clips x 30 loc records ->
   128x128, on the archive's records plus edge cases (overlapping
   objects, invalid lanes, a clip with no objects, centers in (-1, 0) and
   at S - 1, zero-size objects), and at the validation pre-render's
   shape: max abs error <= 1e-6, the same pixels at exactly 1.0, every
   valid center a peak of 1.0. It times the kernel and the plain version;
   no single PyTorch call computes the render, so it has no library time;
5. trains ``centerOffsetRes10`` at exp74's widths (512x512 clips, batch
   32, bf16, Adam 1.25e-4) through ``python -m scd_resnet_tpu_torch.train``'s
   own entry function on the synthetic archive, with the cuts it prints
   (synthetic data, 40 iterations, validation every 20, a snapshot at
   40), then resumes from that snapshot to iteration 60. The launch
   counts are set to 0 just before and read just after: the render kernel
   must have launched once per train step plus once per validation
   pre-render chunk, exactly. Every loss must be finite, the mean focal
   loss of the last 10 steps below that of the first 10, the [It] lines
   must parse and the resumed run must start at iteration 41;
6. takes one float32 train step at full width on 2 clips, augmentation
   off, from the same weights on the card (render kernel) and on the CPU
   (plain render): heat targets within 1e-6, loss within 1e-4 relative,
   global gradient norm within 1e-3 relative (float32 convolutions sum
   in another order on the two devices);
7. prints one ``{"kernels": [...]}`` line, the card's name and power
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
import math
import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from PIL import Image

from scd_resnet_tpu_torch import serve
from scd_resnet_tpu_torch.core import cuda_build
from scd_resnet_tpu_torch.core.checkpoint import save_checkpoint
from scd_resnet_tpu_torch.core.config import Configuration
from scd_resnet_tpu_torch.core.device import reproducible_float32
from scd_resnet_tpu_torch.data.archive import read_archive
from scd_resnet_tpu_torch.data.dataset import VALIDATION_CHUNK, SCDDataset
from scd_resnet_tpu_torch.data.pipeline import THRESHOLD_IOU, identity_draws
from scd_resnet_tpu_torch.data.synthetic import make_archive
from scd_resnet_tpu_torch.infer.analyse import make_device_tiler
from scd_resnet_tpu_torch.infer.server import create_server
from scd_resnet_tpu_torch.infer.synthetic import seeded_model, synthetic_slide
from scd_resnet_tpu_torch.infer.wrapper import make_wrapper
from scd_resnet_tpu_torch.ops import corner_pool as cp
from scd_resnet_tpu_torch.ops import gaussian
from scd_resnet_tpu_torch.profile_serve import device_ms
from scd_resnet_tpu_torch.profile_train import EXP74_ARCHIVE, exp74_settings
from scd_resnet_tpu_torch.train import __main__ as train_cli
from scd_resnet_tpu_torch.train.factory import NetworkFactory, parse_metric_line

REPO = os.path.dirname(os.path.abspath(__file__))
SLIDE_W, SLIDE_H = 3092, 2056
POOL_SHAPE = (48, 128, 128, 128)  # what the served corner heads pool
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM data sheet, float32 outside tensor cores
REQUESTS = 4  # per model: three raw bodies, one PNG
DIRECTIONS = {"top": (2, True), "bottom": (2, False),
              "left": (3, True), "right": (3, False)}
EDGE_SHAPES = ((2, 3, 37, 45), (1, 2, 1, 33), (1, 2, 70, 1))
KERNEL_SOURCES = ("corner_pool.cu", "render_heatmap.cu")

CLIP, HEAT, BATCH = 512, 128, 32  # exp74: clip side, heatmap side, batch
TRAIN_ITERS, RESUME_ITERS, VALIDATE_EVERY = 40, 60, 20
# float32 operations of one (pixel, object) term inside an object's box:
# dx, dy, dx*dx, dy*dy, their sum, the division, exp, the accumulation
RENDER_OPS_PER_TERM = 8


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


def corner_pool_entries(results, bound_ms, launches):
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
    return entries


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


# -- 4. the render kernel against its plain version -----------------------------

def start_archive(path: str):
    """Write the synthetic training archive in a subprocess unless it is
    cached; returns the process, or None."""
    if os.path.exists(path):
        return None
    os.makedirs(os.path.dirname(path), exist_ok=True)
    spec = EXP74_ARCHIVE
    return subprocess.Popen(
        [sys.executable, "-m", "scd_resnet_tpu_torch.data.synthetic",
         path + ".tmp", "--images", str(spec["num_images"]),
         "--reps", str(spec["reps"]), "--clips", str(spec["clips_per_image"]),
         "--size", str(spec["size"]), "--seed", str(spec["seed"])],
        cwd=REPO, stdout=subprocess.DEVNULL)


def finish_archive(proc, path: str) -> None:
    if proc is None:
        return
    if proc.wait(timeout=900) != 0:
        raise RuntimeError("writing the synthetic archive failed ({})".format(
            proc.returncode))
    os.replace(path + ".tmp", path)


def render_edge_cases(locs: torch.Tensor, counts: torch.Tensor):
    """(B, K, 8) archive records and their counts -> (locs, valid) with
    the edge cases written into clips 0-4."""
    locs = locs.clone()
    k = locs.shape[1]
    valid = torch.arange(k)[None, :] < counts[:, None]
    first = locs[0, 0].clone()
    for i in range(6, 12):  # overlapping objects around clip 0's first
        locs[0, i] = first
        locs[0, i, :2] += 0.35 * (i - 6)
    valid[0, 6:12] = True
    valid[1] = False  # no objects, its records left in place
    edges = ((-0.4, 5.0), (6.0, -0.9), (HEAT - 1, HEAT - 1),
             (HEAT - 0.5, 3.0), (HEAT, 3.0), (-1.0, 3.0))
    for i, (x, y) in enumerate(edges):  # the last two are out of bounds
        locs[2, i] = first
        locs[2, i, 0], locs[2, i, 1] = x, y
    valid[2, :len(edges)] = True
    locs[3, :3, 4:7] = 0.0  # zero-size objects
    locs[3, 3, 6] = 0.0  # a zero minor axis
    valid[3, :4] = True
    locs[4, 8:] = torch.randn(locs[4, 8:].shape,
                              generator=torch.Generator().manual_seed(4)) * 50
    return locs, valid


def render_bound_ms(locs: torch.Tensor, valid: torch.Tensor, size: int):
    """The least time for the render on these inputs: locs, valid and the
    heatmap each cross memory once; the operations are those of the
    (pixel, object) terms inside a valid object's box, as this data needs
    them, plus one clamp per pixel. Returns (ms, "bytes"|"operations")."""
    cx, cy, ok, roi, _ = gaussian.object_geometry(locs, valid, size,
                                                  THRESHOLD_IOU)

    def span(c):
        return (torch.clamp(c + roi, max=size - 1)
                - torch.clamp(c - roi, min=0) + 1).clamp_min(0)

    terms = int((span(cx) * span(cy) * ok).sum().item())
    pixels = locs.shape[0] * size * size
    n_bytes = locs.numel() * 4 + valid.numel() + pixels * 4
    n_ops = terms * RENDER_OPS_PER_TERM + pixels
    byte_ms, op_ms = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / FP32_OPS_PER_S * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def compare_heat(got: torch.Tensor, ref: torch.Tensor, what: str) -> float:
    """max abs error <= 1e-6 and the same pixels at exactly 1.0."""
    err = (got - ref).abs().max().item() if got.numel() else 0.0
    if not err <= 1e-6:
        raise AssertionError("{}: heat differs by {}".format(what, err))
    if not torch.equal(got == 1.0, ref == 1.0):
        raise AssertionError("{}: the pixels at 1.0 differ".format(what))
    return err


def check_render(archive: str):
    """The render kernel against its plain version on the card at the
    train batch's shape (with the edge cases) and at the validation
    pre-render's; then its times and bound at the train shape."""
    _, _, all_locs, all_counts = read_archive(archive)
    all_locs, all_counts = (torch.from_numpy(all_locs),
                            torch.from_numpy(all_counts))
    locs, valid = render_edge_cases(all_locs[:BATCH], all_counts[:BATCH])
    n_val = min(VALIDATION_CHUNK, all_locs.shape[0])
    k = all_locs.shape[1]
    cases = {
        "train": (locs, valid),
        "validation": (all_locs[:n_val],
                       torch.arange(k)[None, :] < all_counts[:n_val, None]),
    }
    err = 0.0
    for name, (l, v) in cases.items():
        l, v = l.cuda(), v.cuda()
        got = gaussian.render_heatmap(l, v, HEAT, THRESHOLD_IOU)
        torch.cuda.synchronize()
        ref = gaussian.render_heatmap_plain(l, v, HEAT, THRESHOLD_IOU)
        err = max(err, compare_heat(got, ref, "render_heatmap " + name))
        cx, cy, ok, _, _ = gaussian.object_geometry(l, v, HEAT, THRESHOLD_IOU)
        b = torch.arange(l.shape[0], device="cuda")[:, None].expand_as(ok)
        peaks = got[b[ok], cy[ok].long(), cx[ok].long()]
        if not bool((peaks == 1.0).all()):
            raise AssertionError("render_heatmap {}: a valid center is not "
                                 "1.0".format(name))
        log("render_heatmap {}: {} -> {} matches its plain version (max abs "
            "{:.3g}), {} centers at exactly 1.0".format(
                name, tuple(l.shape), tuple(got.shape), err, int(ok.sum())))

    l, v = locs.cuda(), valid.cuda()
    v8 = v.to(torch.uint8)
    heat = torch.empty((BATCH, HEAT, HEAT), device="cuda")
    lib = gaussian.library()
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        """The C entry point alone: a Python wrapper call takes longer to
        issue than the kernel takes to run, so timing the wrapper in a
        loop would time the host."""
        return lib.render_heatmap_f32(l.data_ptr(), v8.data_ptr(),
                                      heat.data_ptr(), BATCH, l.shape[1],
                                      HEAT, THRESHOLD_IOU, stream)

    cuda_build.check(lib, launch(), "render_heatmap_f32")
    bound_ms, bound_by = render_bound_ms(l, v, HEAT)
    result = {
        "max_abs_err": err,
        "ms": device_ms(launch, 500, warmup=10),
        "wrapper_ms": device_ms(lambda: gaussian.render_heatmap(l, v, HEAT),
                                200, warmup=10),
        "plain_ms": device_ms(lambda: gaussian.render_heatmap_plain(
            l, v, HEAT, THRESHOLD_IOU), 20, warmup=2),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    if not torch.equal(heat, gaussian.render_heatmap(l, v, HEAT)):
        raise AssertionError("render_heatmap: direct launches differ")
    log("render_heatmap at {}: kernel {:.4f} ms (the wrapper, as the batch "
        "transform calls it, {:.4f} ms), plain {:.4f} ms, bound {:.6f} ms "
        "({})".format(
            tuple(locs.shape), result["ms"], result["wrapper_ms"],
            result["plain_ms"], bound_ms, bound_by))
    return result


def render_entry(result, launches):
    return {
        "name": gaussian.KERNEL_NAME, "route": "cuda",
        "source": "scd_resnet_tpu_torch/csrc/render_heatmap.cu",
        "replaces": "scd_resnet_tpu/ops/pallas_kernels.py:77",
        "launches": launches, "max_abs_err": result["max_abs_err"],
        "ms": result["ms"], "wrapper_ms": result["wrapper_ms"],
        "plain_ms": result["plain_ms"],
        "bound_ms": result["bound_ms"], "bound_by": result["bound_by"],
        "library_ms": None, "shape": [BATCH, 30, 8, HEAT],
    }


# -- 5. training exp74 ------------------------------------------------------------

def write_config(path: str, settings) -> str:
    with open(path, "w") as f:
        json.dump(settings, f, indent=1)
    return path


def train_exp74(data_dir: str, work: str, device: str = "cuda", **overrides):
    """Train exp74 with the smoke's cuts through the train entry point,
    then resume it; every check of phase 5 in the module docstring."""
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cuts = {"iterations": TRAIN_ITERS, "validation": VALIDATE_EVERY,
            "snapshot": TRAIN_ITERS, "bestSnapshotMetric": "mIoU"}
    cuts.update(overrides)
    settings = exp74_settings(data_dir, work, **cuts)
    spec = EXP74_ARCHIVE
    log("exp74 cuts: {} synthetic {}x{} clips (seed {}) for the "
        "scdx16p100 archive; {}; resumed to {}".format(
            spec["num_images"] * spec["reps"] * spec["clips_per_image"],
            spec["size"], spec["size"], spec["seed"], cuts, RESUME_ITERS))
    name = settings["trainName"]
    results = os.path.join(work, "results")

    cuda_build.reset_launches()
    first = train_cli.main([write_config(os.path.join(work, "first.json"),
                                         settings), "--device", device])
    evals = open(os.path.join(results, "evals.{}.txt".format(name))).read()
    it_lines = [line for line in evals.splitlines() if line.startswith("[It]")]
    if len(it_lines) != TRAIN_ITERS // VALIDATE_EVERY:
        raise AssertionError("expected {} [It] lines, got {}".format(
            TRAIN_ITERS // VALIDATE_EVERY, it_lines))
    for line in it_lines:
        for metric in ("mIoU", "AP50", "avgS"):
            if parse_metric_line(line, metric) is None:
                raise AssertionError("[It] line without {}: {}".format(
                    metric, line))
    second = train_cli.main([write_config(
        os.path.join(work, "resume.json"),
        dict(settings, currentIter=TRAIN_ITERS, iterations=RESUME_ITERS)),
        "--device", device])
    launches = cuda_build.LAUNCHES[gaussian.KERNEL_NAME]

    rows = [np.loadtxt(os.path.join(results, "losses.{}.{}.txt".format(
        name, it)), delimiter=",", ndmin=2) for it in (TRAIN_ITERS,
                                                        RESUME_ITERS)]
    if second["steps"] != RESUME_ITERS - TRAIN_ITERS or rows[1][0, 0] != \
            TRAIN_ITERS + 1:
        raise AssertionError("the resumed run did not start at iteration "
                             "{}: {}".format(TRAIN_ITERS + 1, rows[1][:1]))
    losses = np.concatenate(rows)
    if losses.shape != (RESUME_ITERS, 5) or not np.isfinite(losses).all():
        raise AssertionError("loss rows missing or not finite")
    focal = losses[:, 2]
    if not focal[-10:].mean() < focal[:10].mean():
        raise AssertionError("the focal loss did not fall: first 10 {}, last "
                             "10 {}".format(focal[:10], focal[-10:]))
    with open(os.path.join(data_dir, "scdx16p100.split.json")) as f:
        n_val = len(json.load(f)["validation"])
    # each run renders the validation set once, when it first validates
    expected = RESUME_ITERS + 2 * math.ceil(n_val / VALIDATION_CHUNK)
    log("exp74: {} + {} steps, losses finite, focal {:.4f} (first 10) -> "
        "{:.4f} (last 10); [It] at {}: mIoU {}; train clips/s {:.1f} and "
        "{:.1f} (validation, snapshots and cuDNN autotuning included); "
        "render launches {} (expected {})".format(
            first["steps"], second["steps"], focal[:10].mean(),
            focal[-10:].mean(), TRAIN_ITERS,
            parse_metric_line(it_lines[-1], "mIoU"), first["clips_per_s"],
            second["clips_per_s"], launches, expected))
    if launches != expected:
        raise AssertionError("render_heatmap launched {} times, expected {} "
                             "({} train steps + {} validation chunks)".format(
                                 launches, expected, RESUME_ITERS,
                                 expected - RESUME_ITERS))
    return {"steps": [first["steps"], second["steps"]],
            "clips_per_s": [first["clips_per_s"], second["clips_per_s"]],
            "seconds": [first["seconds"], second["seconds"]],
            "focal_first10": float(focal[:10].mean()),
            "focal_last10": float(focal[-10:].mean()),
            "it_line": it_lines[-1].strip(), "launches": launches}


# -- 6. one float32 step, card against CPU ------------------------------------------

def global_grad_norm(model) -> float:
    return math.sqrt(sum(float(p.grad.double().pow(2).sum())
                         for p in model.parameters() if p.grad is not None))


def step_card_vs_cpu(work: str):
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    path = make_archive(os.path.join(work, "scdx16p100.d"), num_images=1,
                        reps=1, clips_per_image=4, size=CLIP, seed=75)
    dataset = SCDDataset(path, None, test_set=2, storage_dtype="float32",
                         device="cpu")
    batch = (dataset.samples[:2], dataset.locs[:2], dataset.counts[:2])
    factories = {}
    for device in ("cuda", "cpu"):
        cfg = Configuration()
        cfg.update_config(exp74_settings(work, os.path.join(work, device),
                                         precision="float32", batchSize=2,
                                         residency="host"))
        factories[device] = NetworkFactory(cfg, dataset=dataset, device=device)
    card, cpu = factories["cuda"], factories["cpu"]
    for key, value in cpu.model.state_dict().items():
        if not torch.equal(card.model.state_dict()[key].cpu(), value):
            raise AssertionError("card and CPU start from other weights")
    out = {}
    for device, factory in factories.items():
        loss, _ = factory.train(*batch, draws=identity_draws(
            2, CLIP, factory.device))
        out[device] = (loss.item(), factory._last_batch[1][0].cpu(),
                       global_grad_norm(factory.model))
    heat_err = compare_heat(out["cuda"][1], out["cpu"][1], "train-step heat")
    loss_rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    norm_rel = abs(out["cuda"][2] - out["cpu"][2]) / out["cpu"][2]
    log("one float32 step of {} on 2 clips: heat max abs {:.3g}; loss card "
        "{:.6f} cpu {:.6f} (rel {:.2e}); gradient norm card {:.6f} cpu {:.6f} "
        "(rel {:.2e})".format(card.config.modelName, heat_err, out["cuda"][0], out["cpu"][0],
                              loss_rel, out["cuda"][2], out["cpu"][2],
                              norm_rel))
    if not (loss_rel <= 1e-4 and norm_rel <= 1e-3):
        raise AssertionError("the card's step differs from the CPU's")
    return {"heat_max_abs": heat_err, "loss_rel": loss_rel,
            "grad_norm_rel": norm_rel}


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
    build_dir = os.path.join(REPO, "build", "chip_smoke")
    data_dir = os.path.join(build_dir, "data")
    archive = os.path.join(data_dir, "scdx16p100.d")
    writer = start_archive(archive)
    try:
        # 1. build every kernel from the checkout's sources, in parallel
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
            list(pool.map(cuda_build.build, KERNEL_SOURCES))
        for source in KERNEL_SOURCES:
            cuda_build.load(source)
        log("built {} in {:.1f}s; ptxas:\n{}".format(
            ", ".join(KERNEL_SOURCES), time.perf_counter() - t0,
            "\n".join(cuda_build.build_log(s) for s in KERNEL_SOURCES)))

        # 2. the corner-pool kernel against its plain version
        results, bound_ms = check_corner_pool()

        # 3. serve both models; each resets the counts just before its
        # requests
        slide = synthetic_slide(SLIDE_H, SLIDE_W, seed=2056)
        served = [serve_model(arch, seed, slide, build_dir, gpu_line)
                  for arch, seed in (("cornerCPoolRes10", 10),
                                     ("centerOffsetRes10", 11))]
        corner_launches = served[0]["launches"]
        finish_archive(writer, archive)
    finally:
        if writer is not None and writer.poll() is None:
            writer.kill()
            writer.wait()

    # 4. the render kernel against its plain version
    render = check_render(archive)
    # 5. train exp74 and resume it; the counts are reset inside, just
    # before the first run
    trained = train_exp74(data_dir, os.path.join(build_dir, "train"))
    # 6. one float32 step on the card and on the CPU
    step = step_card_vs_cpu(os.path.join(build_dir, "step"))

    # 7. results
    log(json.dumps({"serving": served, "training": trained,
                    "step_card_vs_cpu": step, "card": gpu_line,
                    "seconds": time.perf_counter() - t_start}))
    log(json.dumps({"kernels": corner_pool_entries(results, bound_ms,
                                                   corner_launches)
                    + [render_entry(render, trained["launches"])]}))
    log(gpu_line)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
