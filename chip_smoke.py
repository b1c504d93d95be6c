#!/usr/bin/env python3
"""chip_smoke.py — the quickest proof that the PyTorch port runs on a GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (on PATH or under ``CUDA_HOME``, default
``/usr/local/cuda``) and this checkout. It drives the port only
(``scd_resnet_tpu_torch``; nothing of JAX or of ``scd_resnet_tpu``):

1. prints the toolchain and the card (``nvidia-smi`` name and power
   limit), builds every kernel source (``csrc/*.cu``, one ``nvcc`` each,
   all started together) and starts writing the seeded synthetic 512x512
   training archive in a subprocess (cached under ``build/``);
2. holds the corner-pool kernel (``csrc/corner_pool.cu``) against its
   plain PyTorch version on the card in all four directions at the
   served shape (48, 128, 128, 128) float32, on random and on tie-heavy
   inputs: they must match exactly (a running max only returns input
   values). It times the kernel, the plain version and ``torch.cummax``
   (a yardstick the port never calls), then checks the kernel at a few
   ragged shapes with NaN inputs;
3. holds the corner-pool backward kernel (same source) against its plain
   version at the training shape (32, 128, 128, 128) float32, in all four
   directions, on random and tie-heavy inputs: with a cotangent in [0.5,
   1.5) no segment sum can cancel to 0, so the zero patterns (the
   routing) must be equal, and the values agree within the float32
   summation bound 2 (n - 1) 2^-24 sum|g| of the line (the kernel sums g
   in another order than ``torch.cumsum``); values again for a signed
   normal cotangent; then ragged shapes with NaN inputs. It times the
   backward, its plain version and the forward at this shape;
4. holds the stem max-pool backward kernel (``csrc/max_pool_bwd.cu``)
   against its plain version at the stem's training shape (32, 64, 256,
   256), bfloat16 and float32, on random and ReLU'd tie-heavy inputs,
   then at odd and tiny shapes, shapes that cross the kernel's bands of
   output rows and its column tiles (read from the built library), and
   B C above 65,535, with -inf and NaN in x and NaN in dy: equal to the
   bit, NaN where the plain version has NaN (both add each pixel's
   windows in one order). It times the kernel (its C entry point
   launched back to back, and its wrapper), the plain version and, as a
   yardstick the port never calls, PyTorch's
   ``max_pool2d_with_indices_backward`` fed by its forward's indices;
5. holds the deformable gather (``csrc/dcn_gather.cu``, forward and
   backward) against its plain versions at the DCN's shapes, x (B, 16,
   16, 512) float32 and N = 16 * 16 * 9 = 2304 samples for B = 48
   (served), 32 (a train step) and 64 (a validation batch), on seeded
   positions that mix fractional samples inside the map, integers,
   samples in (-1, 0) and (size - 1, size), exactly -1 and size, and far
   out of range; then at ragged shapes (C = 5, 33; H != W; N not a
   multiple of the block's 8 samples; NaN in x; C = 100, not a multiple
   of the backward's 32-channel slices; a 120 x 120 map the backward
   cuts into bands of rows and a 3 x 500 one it cuts into tiles of
   columns). The forward must equal its plain version to the bit (both
   evaluate the lerp weights and add the four corners in one order, with
   no fused multiply-add). The backward sums in another order (dx with
   its buckets' samples added in no fixed order), so dx, dpy and dpx are
   held to the float32 summation bound 2 (m - 1) 2^-24 sum|terms| of
   each element's m terms (dpy, dpx: m = C + 8, for the products by the
   weights' derivatives), with a cotangent in [0.5, 1.5) dx's zero
   pattern must be equal, and two runs must give dpy and dpx equal to
   the bit. It times the kernels (launched
   back to back through their C entry points), their wrappers, their
   plain versions and, as a yardstick the port never calls,
   ``F.grid_sample(bilinear, zeros, align_corners=True)`` on the same
   positions (per-corner zero padding makes the outer cutoff redundant,
   so it computes the same function up to the rounding of the coordinate
   normalisation) and its backward, ``grid_sampler_2d_backward``;
6. serves ``cornerCPoolRes10``, ``centerOffsetRes10`` and
   ``centerOffsetRes10dcn`` at full width through the port's own serve
   entry point (``serve.build_service`` + the HTTP server), from seeded
   random weights whose heat heads are rescaled so that a few dozen
   peaks per clip pass the 0.3 threshold, and POSTs a seeded synthetic
   3092x2056 slide (48 clips) four times: three raw uint8 bodies and one
   PNG. Launch counts are set to 0 just before each model's requests and
   read just after: every corner request must launch the corner-pool
   kernel exactly four times (top and left in tl_head, bottom and right
   in br_head), every DCN request the gather's forward once (the 48
   clips are one batch), the plain centerOffset requests no kernel, and
   no request any other kernel. The DCN's seeded samples must include
   fractional ones inside the map and ones beyond the outer cutoff, and
   its masks must spread. Detections must be non-empty, inside the slide
   and the same on every request; two forwards of the slide's clips must
   agree bit for bit (serving is deterministic). Two of the clips then go
   through the same model on the CPU, and the card's decode rows must
   match the CPU's (tolerances at ``compare_rows``);
7. holds the heatmap-render kernel (``csrc/render_heatmap.cu``), one
   launch for every label map of a batch, against its plain version in
   each of its map sets: M = 1 (the center map), M = 3 (center, tl and
   br, the corners derived in the kernel) and one corner map at seeded
   arbitrary offsets. It does so at the train batch's shape, 32 clips x
   30 loc records -> 128x128, on the archive's records plus edge cases
   (overlapping objects, invalid lanes, a clip with no objects, centers
   in (-1, 0) and at S - 1, zero-size objects, corners in (-1, 0), at
   S - 1 and beyond S), at the validation pre-render's shape, and at
   sides 6, 8, 37 and 130 that cut its bands of rows unevenly or its
   4-pixel stores: the center map within 1e-6 with the same pixels at
   exactly 1.0, every valid center a peak of 1.0 and the same bits in
   M = 1 and M = 3; the corner maps and the offset map equal to the bit;
   a corner in (-1, 0) stamped at 0. At the train shape it times each map
   set by ``torch.profiler`` (the wrapper must launch the one kernel and
   nothing else), by CUDA events around C launches issued back to back
   from Python (host-issued time, labelled so), the plain version, the
   bound, and the floor: a one-element add's device time. No single
   PyTorch call computes the render, so it has no library time;
8. trains ``centerOffsetRes10`` at exp74's widths (512x512 clips, batch
   32, bf16, Adam 1.25e-4) through ``python -m scd_resnet_tpu_torch.train``'s
   own entry function on the synthetic archive, with the cuts it prints
   (synthetic data, 40 iterations, validation every 20, a snapshot at
   40), then resumes from that snapshot to iteration 60; then
   ``cornerCPoolRes10`` under ``configs/cpool_best.json`` and
   ``centerOffsetRes10dcn`` under ``configs/dcn_full.json`` the same way.
   The launch counts are set to 0 just before each model's first run and
   read just after its resumed one, and must be exact: every model
   launches the render once a train step and once per validation
   pre-render chunk (cpool_best's three maps in that one launch) and the
   max-pool backward once a step; cpool_best launches the corner-pool
   forward four times a step and four times in each validation forward
   ([Tr] included), the corner-pool backward four times a step; dcn_full
   launches what exp74 launches, plus the gather's forward once a step and once in each
   validation forward and its backward once a step; each run no other
   kernel. Every loss must be finite, the mean focal loss of the last 10
   steps below that of the first 10, the [It] lines must parse (mIoU,
   AP50 and avgS for exp74 and dcn_full; boxAP50 for cpool_best) and the
   resumed run must start at iteration 41;
9. takes one float32 train step at full width on 2 clips, augmentation
   off, from the same weights on the card (the kernels) and on the CPU
   (the plain versions), for ``centerOffsetRes10``, ``cornerCPoolRes10``
   and ``centerOffsetRes10dcn``: targets within 1e-6, loss within 1e-4
   relative, global gradient norm within 1e-3 relative (float32
   convolutions sum in another order on the two devices); a probe
   gradient must be non-zero and within 1e-3 relative too: for the
   corner model ``tl_head.pool_block.branch1.conv.weight``, which reaches
   the loss only through the corner pools; for the DCN model rows 0-17
   (the offsets) of ``deconv_dcn.conv_offset_mask.weight``, which reach
   it only through the gather's dpy and dpx, after that conv is drawn
   from a seed so that the samples sit between pixels. A third step, on
   the CPU with the clips moved by 1e-7 relative, shows how far the
   probe moves from float32 rounding alone;
10. prints one ``{"kernels": [...]}`` line (each kernel's ``launches``
   from the newest path that runs it, named in ``main_path``, and its
   counts on every path; the render once, its map sets' numbers under
   ``map_sets``), the card's name and power limit, and as the
   last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.

Any failed phase raises and the script exits non-zero without the last
line. It exits non-zero at once when ``torch.cuda.is_available()`` is
false. Everything it writes goes under ``build/`` in the checkout.
"""

from __future__ import annotations

import copy
import ctypes
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
import torch.nn.functional as F
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
from scd_resnet_tpu_torch.ops import dcn
from scd_resnet_tpu_torch.ops import gaussian
from scd_resnet_tpu_torch.ops import max_pool as mp
from scd_resnet_tpu_torch.ops.radius import corner_threshold_radius
from scd_resnet_tpu_torch.profile_kernels import device_kernels
from scd_resnet_tpu_torch.profile_serve import device_ms
from scd_resnet_tpu_torch.profile_train import (
    CPOOL_BEST,
    DCN_FULL,
    EXP74,
    RENDER_KERNEL,
    SYNTHETIC_ARCHIVE,
    settings,
)
from scd_resnet_tpu_torch.train import __main__ as train_cli
from scd_resnet_tpu_torch.train.factory import NetworkFactory, parse_metric_line
from scd_resnet_tpu_torch.train.registry import get_model_profile

REPO = os.path.dirname(os.path.abspath(__file__))
SLIDE_W, SLIDE_H = 3092, 2056
POOL_SHAPE = (48, 128, 128, 128)  # what the served corner heads pool
POOL_TRAIN_SHAPE = (32, 128, 128, 128)  # what cpool_best's heads pool
STEM_SHAPE = (32, 64, 256, 256)  # the stem pool's input in a train step
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM data sheet, float32 outside tensor cores
REQUESTS = 4  # per model: three raw bodies, one PNG
DIRECTIONS = {"top": (2, True), "bottom": (2, False),
              "left": (3, True), "right": (3, False)}
EDGE_SHAPES = ((2, 3, 37, 45), (1, 2, 1, 33), (1, 2, 70, 1))
# odd and tiny shapes, and B C above 65,535
STEM_EDGE_SHAPES = ((2, 3, 37, 45), (1, 2, 1, 1), (1, 2, 6, 7), (1, 1, 2, 3),
                    (2, 35000, 3, 5))
KERNEL_SOURCES = ("corner_pool.cu", "render_heatmap.cu", "max_pool_bwd.cu",
                  "dcn_gather.cu")
# the DCN's input at the S/32 map, (H, W, C), and its 3x3 taps
DCN_MAP, DCN_TAPS = (16, 16, 512), 9
DCN_BATCHES = {"served": 48, "train": 32, "validation": 64}
# (B, H, W, C, N): ragged channels, H != W, N not a multiple of 8, 1x1;
# C = 100 in three 32-channel slices and a 4-channel one; maps the
# backward cuts into bands of rows (120 x 120) and into tiles of columns
# (3 x 500)
DCN_EDGE_SHAPES = ((2, 7, 9, 5, 103), (3, 5, 11, 33, 77), (1, 1, 1, 1, 9),
                   (2, 16, 16, 512, 13), (2, 9, 13, 100, 300),
                   (1, 120, 120, 64, 5000), (1, 3, 500, 64, 700))

CLIP, HEAT, BATCH = 512, 128, 32  # exp74: clip side, heatmap side, batch
# relative move of the clips (about one float32 ulp of their values) in
# phase 9's sensitivity step
PROBE_NUDGE = 1e-7
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

def equal_nan_aware(got, ref) -> bool:
    """Equal, NaN where the other has NaN."""
    return torch.equal(got.isnan(), ref.isnan()) and \
        torch.equal(got.nan_to_num(), ref.nan_to_num())


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
            if not equal_nan_aware(cp.corner_pool(x, dim, reverse),
                                   cp.corner_pool_plain(x, dim, reverse)):
                raise AssertionError("corner_pool {} at {} differs from its "
                                     "plain version".format(direction, shape))
    torch.cuda.synchronize()
    log("corner_pool exact at edge shapes {} with NaN inputs".format(
        list(EDGE_SHAPES)))
    return results, bound_ms


def pool_entries(names, replaces, shape, results, bound_ms, library=None):
    """One entry per __global__ kernel of ``names`` (dim -> name): the H
    kernel serves top/bottom, the W kernel left/right; times are the mean
    of its two directions. ``library`` (the forward's ``torch.cummax``)
    gives ``library_ms`` in the forward direction."""
    entries = []
    for dim, name in sorted(names.items()):
        dirs = [d for d, (dd, _) in DIRECTIONS.items() if dd == dim]
        mean = lambda key: sum(results[d][key] for d in dirs) / len(dirs)  # noqa: E731
        entry = {
            "name": name, "route": "cuda",
            "source": "scd_resnet_tpu_torch/csrc/corner_pool.cu",
            "replaces": replaces,
            "max_abs_err": max(results[d]["max_abs_err"] for d in dirs),
            "ms": mean("ms"), "plain_ms": mean("plain_ms"),
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
            "shape": list(shape),
            "ms_by_direction": {d: results[d]["ms"] for d in dirs},
        }
        if library:
            fwd = [d for d in dirs if not DIRECTIONS[d][1]][0]
            entry["library_ms"] = results[fwd]["library_ms"]
            entry["library_call"] = "torch.cummax(x, {}) ({})".format(dim, fwd)
        else:
            entry["library_note"] = ("torch.cummax's backward routes ties "
                                     "to the last element: another function")
        entries.append(entry)
    return entries


# -- 3. the corner-pool backward against its plain version ----------------------

def summation_bound(g: torch.Tensor, dim: int) -> torch.Tensor:
    """How far two float32 suffix sums of ``g`` along ``dim`` in other
    orders may lie apart: each is within (n - 1) 2^-24 sum|g| of the exact
    sum (the recursive-summation bound)."""
    n = g.shape[dim]
    return 2 * (n - 1) * 2.0 ** -24 * g.abs().sum(dim, keepdim=True)


def compare_pool_bwd(x, g, dim, reverse, what, zero_pattern=True) -> float:
    got = cp.corner_pool_bwd(x, g, dim, reverse)
    torch.cuda.synchronize()
    ref = cp.corner_pool_bwd_plain(x, g, dim, reverse)
    if zero_pattern and not torch.equal(got == 0, ref == 0):
        raise AssertionError("corner_pool_bwd {}: the zero patterns (the "
                             "routing) differ".format(what))
    err = (got - ref).abs()
    if bool((err > summation_bound(g, dim)).any()) or \
            not torch.equal(got.isnan(), ref.isnan()):
        raise AssertionError("corner_pool_bwd {}: beyond the float32 "
                             "summation bound, max abs {}".format(
                                 what, err.nan_to_num().max().item()))
    return err.nan_to_num().max().item()


def check_corner_pool_bwd():
    """Phase 3: the backward kernel against its plain version; its times,
    and the forward's at the training shape."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    shape = POOL_TRAIN_SHAPE
    inputs = {
        "random": torch.randn(shape, device="cuda", generator=gen),
        "ties": torch.randint(-3, 4, shape, device="cuda",
                              generator=gen).float().clamp_min_(0),
    }
    # positive, at least 0.5: no segment sum cancels to 0
    g = torch.rand(shape, device="cuda", generator=gen).add_(0.5)
    g_signed = torch.randn(shape, device="cuda", generator=gen)
    numel = g.numel()
    bound_ms = max(3 * numel * 4 / HBM_BYTES_PER_S,
                   3 * numel / FP32_OPS_PER_S) * 1e3
    results = {}
    for direction, (dim, reverse) in DIRECTIONS.items():
        err = 0.0
        for kind, x in inputs.items():
            err = max(err, compare_pool_bwd(x, g, dim, reverse, "{} {}".format(
                direction, kind)))
            err = max(err, compare_pool_bwd(x, g_signed, dim, reverse,
                                            "{} {} signed g".format(
                                                direction, kind),
                                            zero_pattern=False))
        x = inputs["random"]
        results[direction] = {
            "max_abs_err": err,
            "ms": time_ms(lambda: cp.corner_pool_bwd(x, g, dim, reverse)),
            "plain_ms": time_ms(lambda: cp.corner_pool_bwd_plain(
                x, g, dim, reverse)),
            "forward_ms": time_ms(lambda: cp.corner_pool(x, dim, reverse)),
        }
        log("corner_pool_bwd {:6s} at {}: routing equal, max abs {:.3g}; "
            "kernel {:.4f} ms, plain {:.4f} ms, bound {:.4f} ms; forward "
            "kernel {:.4f} ms".format(
                direction, shape, err, results[direction]["ms"],
                results[direction]["plain_ms"], bound_ms,
                results[direction]["forward_ms"]))
    del inputs, g, g_signed
    torch.cuda.empty_cache()

    for shape in EDGE_SHAPES:
        x = torch.randint(-3, 4, shape, device="cuda",
                          generator=gen).float().clamp_min_(0)
        x[torch.rand(shape, device="cuda", generator=gen) > 0.97] = \
            float("nan")
        g = torch.rand(shape, device="cuda", generator=gen).add_(0.5)
        for direction, (dim, reverse) in DIRECTIONS.items():
            compare_pool_bwd(x, g, dim, reverse, "{} at {}".format(
                direction, shape))
    log("corner_pool_bwd routing equal at edge shapes {} with ties and NaN "
        "inputs".format(list(EDGE_SHAPES)))
    return results, bound_ms


# -- 4. the stem max-pool backward against its plain version -----------------------

def compare_stem_bwd(x, dy, what) -> None:
    got = mp.max_pool_3x3_s2_bwd(x, dy)
    torch.cuda.synchronize()
    if not equal_nan_aware(got, mp.max_pool_3x3_s2_bwd_plain(x, dy)):
        raise AssertionError("max_pool_3x3_s2_bwd {} differs from its plain "
                             "version".format(what))


def stem_edge_shapes():
    """``STEM_EDGE_SHAPES`` and shapes that cross the kernel's bands of
    output rows and its column tiles, from the sizes its library reports
    (rows 8 and 128 columns: (1, 2, 67, 300) in scalar bf16 and
    vectorised float32, (1, 2, 35, 304) vectorised in both, (1, 1, 17,
    9))."""
    lib = cuda_build.load(mp.KERNEL_SOURCE)
    rows = lib.max_pool_3x3_s2_bwd_band_rows()
    cols = lib.max_pool_3x3_s2_bwd_tile_cols()
    return STEM_EDGE_SHAPES + ((1, 2, 8 * rows + 3, 2 * cols + 44),
                               (1, 2, 4 * rows + 3, 2 * cols + 48),
                               (1, 1, 2 * rows + 1, 9))


def stem_direct_launch(x, dy, dx):
    """A back-to-back launch of the kernel's bf16 entry point (a Python
    wrapper call takes a good part of the kernel's time to issue)."""
    lib = mp._library(mp.ENTRY[torch.bfloat16])
    fn = lib.max_pool_3x3_s2_bwd_bf16
    fn.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    args = (x.data_ptr(), dy.data_ptr(), dx.data_ptr(), *x.shape, stream)
    cuda_build.check(lib, fn(*args), "max_pool_3x3_s2_bwd_bf16")
    return lambda: fn(*args)


def check_max_pool_bwd():
    """Phase 4: the stem pool's backward kernel against its plain version;
    the kernel's, the plain version's and PyTorch's times in bf16."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    b, c, h, w = STEM_SHAPE
    out_shape = (b, c, mp.output_size(h), mp.output_size(w))
    for dtype in (torch.bfloat16, torch.float32):
        dy = torch.randn(out_shape, device="cuda", generator=gen).to(dtype)
        for kind in ("random", "ties"):
            if kind == "random":
                x = torch.randn(STEM_SHAPE, device="cuda", generator=gen)
            else:  # ReLU'd small integers: ties and zeros everywhere
                x = torch.randint(-2, 3, STEM_SHAPE, device="cuda",
                                  generator=gen).float().clamp_min_(0)
            compare_stem_bwd(x.to(dtype), dy, "{} {}".format(dtype, kind))
            del x
        del dy
        torch.cuda.empty_cache()
    shapes = stem_edge_shapes()
    for shape in shapes:
        x = torch.randint(-2, 3, shape, device="cuda",
                          generator=gen).float().clamp_min_(0)
        u = torch.rand(shape, device="cuda", generator=gen)
        x[u > 0.97] = float("-inf")
        x[u < 0.02] = float("nan")
        x[0, 0] = float("-inf")  # a plane whose every maximum is -inf
        dy = torch.randn((*shape[:2], mp.output_size(shape[2]),
                          mp.output_size(shape[3])), device="cuda",
                         generator=gen)
        dy.view(-1)[::97] = float("nan")
        for dtype in (torch.bfloat16, torch.float32):
            compare_stem_bwd(x.to(dtype), dy.to(dtype), "at {}".format(shape))

    x = torch.randn(STEM_SHAPE, device="cuda", generator=gen).to(
        torch.bfloat16)
    dy = torch.randn(out_shape, device="cuda", generator=gen).to(
        torch.bfloat16)
    indices = torch.ops.aten.max_pool2d_with_indices(x, [3, 3], [2, 2],
                                                     [1, 1])[1]
    n_bytes = (2 * x.numel() + dy.numel()) * x.element_size()
    dx = torch.empty_like(x)
    launch = stem_direct_launch(x, dy, dx)
    result = {
        "max_abs_err": 0.0,
        "ms": time_ms(launch),
        "wrapper_ms": time_ms(lambda: mp.max_pool_3x3_s2_bwd(x, dy)),
        "plain_ms": time_ms(lambda: mp.max_pool_3x3_s2_bwd_plain(x, dy)),
        "library_ms": time_ms(
            lambda: torch.ops.aten.max_pool2d_with_indices_backward(
                dy, x, [3, 3], [2, 2], [1, 1], [1, 1], False, indices)),
        "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
    }
    log("max_pool_3x3_s2_bwd at {} bf16 and float32, on random and tie "
        "inputs, and at edge shapes {} with -inf and NaN: equal to its plain "
        "version; bf16 kernel {:.4f} ms (wrapper {:.4f} ms), plain {:.4f} "
        "ms, max_pool2d_with_indices_backward {:.4f} ms, bound {:.4f} "
        "ms".format(STEM_SHAPE, list(shapes), result["ms"],
                    result["wrapper_ms"],
                    result["plain_ms"], result["library_ms"],
                    result["bound_ms"]))
    del x, dy, dx, indices
    torch.cuda.empty_cache()
    return result


def max_pool_bwd_entry(result):
    entry = {
        "name": mp.KERNEL_NAME, "route": "cuda",
        "source": "scd_resnet_tpu_torch/csrc/max_pool_bwd.cu",
        "replaces": "tools/pool_bwd_pallas_probe.py:120",
        "library_call": "torch.ops.aten.max_pool2d_with_indices_backward "
                        "(bf16, indices from its forward)",
        "shape": list(STEM_SHAPE), "dtype": "bfloat16",
    }
    entry.update(result)
    return entry


# -- 5. the deformable gather against its plain versions ----------------------------

def dcn_positions(b: int, h: int, w: int, n: int, gen) -> tuple:
    """Seeded sampling positions (B, N) on the card: the 3x3 grid of a
    padded conv over an h x w map (every step-th sample where N is
    fewer, so that they spread over the map) moved by N(0, 1.5^2)
    offsets, with a share of the samples rewritten as integers, values
    in (-1, 0) and (size - 1, size), exactly -1 and size, and far out of
    range."""
    taps = torch.zeros((b, h, w, DCN_TAPS, 2), device="cuda")
    py, px = dcn.sampling_positions(taps, 3, 3, 1, 1, 1)
    step = max(1, h * w * DCN_TAPS // n)
    py = py.reshape(b, -1)[:, ::step][:, :n].contiguous()
    px = px.reshape(b, -1)[:, ::step][:, :n].contiguous()
    if py.shape[1] < n:  # a map smaller than N samples: tile it
        reps = -(-n // py.shape[1])
        py, px = (t.repeat(1, reps)[:, :n].contiguous() for t in (py, px))
    py += 1.5 * torch.randn(py.shape, device="cuda", generator=gen)
    px += 1.5 * torch.randn(px.shape, device="cuda", generator=gen)
    kind = torch.randint(0, 25, py.shape, device="cuda", generator=gen)
    u = torch.rand(py.shape, device="cuda", generator=gen)
    far = 20.0 + 80.0 * u
    py = torch.where(kind < 3, py.round(), py)
    px = torch.where(kind < 3, px.round(), px)
    py = torch.where(kind == 3, -u, py)
    px = torch.where(kind == 4, (w - 1) + u, px)
    py = torch.where(kind == 5, torch.full_like(py, -1.0), py)
    px = torch.where(kind == 6, torch.full_like(px, float(w)), px)
    py = torch.where(kind == 7, torch.full_like(py, float(h)), py)
    px = torch.where(kind == 8, torch.full_like(px, -1.0), px)
    py = torch.where(kind == 9, -far, py)
    px = torch.where(kind == 10, w + far, px)
    return py.contiguous(), px.contiguous()


def position_kinds(py, px, h: int, w: int):
    """How many samples fall in each category the checks need."""
    inside = (py > -1) & (py < h) & (px > -1) & (px < w)
    integer = (py == py.floor()) & (px == px.floor())
    return {"fractional_inside": int((inside & ~integer).sum()),
            "integer_inside": int((inside & integer).sum()),
            "in_(-1,0)": int(((py > -1) & (py < 0)).sum()),
            "in_(size-1,size)": int(((px > w - 1) & (px < w)).sum()),
            "exactly_-1_or_size": int(((py == -1) | (py == h) | (px == -1)
                                       | (px == w)).sum()),
            "beyond_cutoff": int((~inside).sum()),
            "far_out": int(((py.abs() > h + 10) | (px.abs() > w + 10))
                           .sum())}


def dcn_bwd_bounds(x, py, px, g):
    """The float32 summation bounds of the backward on these inputs (the
    module docstring): per dx element 2 (m - 1) 2^-24 sum|v w g| over its
    m terms; per dpy and dpx 2 (C + 8) 2^-24 sum_c v |d w_c| <|g|, |x_c|>."""
    b, h, w, c = x.shape
    flat = x.reshape(b, h * w, c).abs()
    base = (torch.arange(b, device=x.device) * (h * w))[:, None]
    sums = torch.zeros((b * h * w, c), device=x.device)
    terms = torch.zeros(b * h * w, device=x.device)
    abs_py = torch.zeros_like(py)
    abs_px = torch.zeros_like(px)
    for idx, valid, weight, d_py, d_px in dcn.bilinear_corners(py, px, h, w):
        v = valid.float()
        at = (idx + base).reshape(-1)
        sums.index_add_(0, at, (g.abs() * (weight * v)[..., None])
                        .reshape(-1, c))
        terms.index_add_(0, at, (v * (weight > 0)).reshape(-1))
        dot = (g.abs() * torch.gather(flat, 1, idx[..., None].expand(
            -1, -1, c))).sum(-1)
        abs_py += v * d_py.abs() * dot
        abs_px += v * d_px.abs() * dot
    u = 2.0 ** -24
    dx_bound = 2 * (terms - 1).clamp_min(0)[:, None] * u * sums
    return (dx_bound.reshape(b, h, w, c), 2 * (c + 8) * u * abs_py,
            2 * (c + 8) * u * abs_px)


def compare_dcn_bwd(x, py, px, g, what, zero_pattern=True) -> float:
    """The backward against its plain version within the summation
    bounds; a second run must give dpy and dpx equal to the bit."""
    got = dcn.dcn_gather_bwd(x, py, px, g)
    again = dcn.dcn_gather_bwd(x, py, px, g)
    torch.cuda.synchronize()
    if not (torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])):
        raise AssertionError("dcn_gather_bwd {}: two runs give other dpy or "
                             "dpx".format(what))
    ref = dcn.dcn_gather_bwd_plain(x, py, px, g)
    if zero_pattern and not torch.equal(got[0] == 0, ref[0] == 0):
        raise AssertionError("dcn_gather_bwd {}: the zero patterns of dx "
                             "differ".format(what))
    err = 0.0
    for name, a, r, bound in zip(("dx", "dpy", "dpx"), got, ref,
                                 dcn_bwd_bounds(x, py, px, g)):
        diff = (a - r).abs()
        if bool((diff > bound).any()) or not bool(torch.isfinite(a).all()):
            raise AssertionError("dcn_gather_bwd {}: {} beyond the float32 "
                                 "summation bound, max abs {}".format(
                                     what, name, diff.max().item()))
        err = max(err, diff.max().item())
    return err


def dcn_direct_launches(x, py, px, g):
    """Back-to-back launches of the two C entry points (a Python wrapper
    call takes about as long to issue as the kernel takes to run), with
    the backward's plan and scratch as its wrapper makes them."""
    b, h, w, c = x.shape
    n = py.shape[1]
    lib = dcn._library()
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty((b, n, c), device="cuda")
    dx = torch.empty_like(x)
    dpy, dpx = torch.empty_like(py), torch.empty_like(px)
    plan = dcn.bwd_plan(h, w, c)
    index, parts = dcn.bwd_scratch(b, h, w, c, n, plan, x.device)

    def forward():
        return lib.dcn_gather_f32(x.data_ptr(), py.data_ptr(), px.data_ptr(),
                                  out.data_ptr(), b, h, w, c, n, stream)

    def backward():
        return lib.dcn_gather_bwd_f32(
            x.data_ptr(), py.data_ptr(), px.data_ptr(), g.data_ptr(),
            dx.data_ptr(), dpy.data_ptr(), dpx.data_ptr(), index.data_ptr(),
            parts.data_ptr(), b, h, w, c, n, *plan, stream)

    for fn, name in ((forward, "dcn_gather_f32"),
                     (backward, "dcn_gather_bwd_f32")):
        cuda_build.check(lib, fn(), name)
    return forward, backward


def grid_sample_inputs(x, py, px):
    """x as (B, C, H, W) and the positions as grid_sample's normalised
    (B, 1, N, 2) grid (x first), align_corners=True."""
    _, h, w, _ = x.shape
    grid = torch.stack([px / (w - 1) * 2 - 1, py / (h - 1) * 2 - 1],
                       dim=-1)[:, None]
    return x.permute(0, 3, 1, 2).contiguous(), grid.contiguous()


def check_dcn_gather():
    """Phase 5: the gather's forward and backward against their plain
    versions; their times beside the plain versions', grid_sample's and
    the bounds, at the served, train and validation shapes."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    h, w, c = DCN_MAP
    n = h * w * DCN_TAPS
    fwd, bwd, kinds = {}, {}, None
    for what, b in DCN_BATCHES.items():
        x = torch.randn((b, h, w, c), device="cuda", generator=gen)
        py, px = dcn_positions(b, h, w, n, gen)
        if kinds is None:
            kinds = position_kinds(py, px, h, w)
            if min(kinds.values()) == 0:
                raise AssertionError("the seeded positions miss a category: "
                                     "{}".format(kinds))
        got = dcn.dcn_gather(x, py, px)
        torch.cuda.synchronize()
        if not torch.equal(got, dcn.dcn_gather_plain(x, py, px)):
            raise AssertionError("dcn_gather at {} differs from its plain "
                                 "version".format((b, h, w, c, n)))
        forward, backward = dcn_direct_launches(x, py, px, got)
        x_nchw, grid = grid_sample_inputs(x, py, px)
        library = F.grid_sample(x_nchw, grid, mode="bilinear",
                                padding_mode="zeros", align_corners=True)
        n_bytes = (x.numel() + py.numel() + px.numel() + got.numel()) * 4
        n_ops = got.numel() * 8  # four products, three adds, the cutoff
        fwd[what] = {
            "shape": [b, h, w, c, n], "max_abs_err": 0.0,
            "ms": device_ms(forward, 50, warmup=5),
            "wrapper_ms": time_ms(lambda: dcn.dcn_gather(x, py, px)),
            "plain_ms": time_ms(lambda: dcn.dcn_gather_plain(x, py, px)),
            "library_ms": time_ms(lambda: F.grid_sample(
                x_nchw, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True)),
            "library_max_abs_diff": (library[:, :, 0].transpose(1, 2)
                                     - got).abs().max().item(),
            "bound_ms": max(n_bytes / HBM_BYTES_PER_S,
                            n_ops / FP32_OPS_PER_S) * 1e3,
            "bound_by": "bytes" if n_bytes / HBM_BYTES_PER_S
            >= n_ops / FP32_OPS_PER_S else "operations",
        }
        log("dcn_gather at {} equal to its plain version to the bit: "
            "kernel {:.4f} ms (wrapper {:.4f} ms), plain {:.4f} ms, "
            "grid_sample {:.4f} ms (max abs diff {:.3g}), bound {:.4f} ms "
            "({})".format(tuple(fwd[what]["shape"]), fwd[what]["ms"],
                          fwd[what]["wrapper_ms"], fwd[what]["plain_ms"],
                          fwd[what]["library_ms"],
                          fwd[what]["library_max_abs_diff"],
                          fwd[what]["bound_ms"], fwd[what]["bound_by"]))
        if what == "train":
            # positive cotangent: no sum cancels, so zero patterns match
            g = torch.rand(got.shape, device="cuda", generator=gen).add_(0.5)
            g_signed = torch.randn(got.shape, device="cuda", generator=gen)
            err = max(compare_dcn_bwd(x, py, px, g, "train, g in [0.5, 1.5)"),
                      compare_dcn_bwd(x, py, px, g_signed, "train, signed g",
                                      zero_pattern=False))
            _, backward = dcn_direct_launches(x, py, px, g_signed)
            g_nchw = g_signed.transpose(1, 2)[:, :, None].contiguous()
            x_grad = x_nchw.detach().requires_grad_()
            grid_grad = grid.detach().requires_grad_()

            def library_fwd_bwd():
                F.grid_sample(x_grad, grid_grad, mode="bilinear",
                              padding_mode="zeros",
                              align_corners=True).backward(g_nchw)

            n_bytes = (g.numel() + 2 * x.numel() + 4 * py.numel()) * 4
            n_ops = g.numel() * 4 * 4  # per corner: dot, product, add, dx sum
            bwd = {
                "shape": [b, h, w, c, n], "max_abs_err": err,
                "plan": dcn.bwd_plan(h, w, c)._asdict(),
                "ms": device_ms(backward, 50, warmup=5),
                "wrapper_ms": time_ms(lambda: dcn.dcn_gather_bwd(
                    x, py, px, g_signed)),
                "plain_ms": time_ms(lambda: dcn.dcn_gather_bwd_plain(
                    x, py, px, g_signed)),
                "library_ms": time_ms(
                    lambda: torch.ops.aten.grid_sampler_2d_backward(
                        g_nchw, x_nchw, grid, 0, 0, True, [True, True])),
                "fwd_bwd_ms": time_ms(lambda: dcn.DCNGather.apply(
                    x.requires_grad_(), py.requires_grad_(),
                    px.requires_grad_()).backward(g_signed)),
                "library_fwd_bwd_ms": time_ms(library_fwd_bwd),
                "bound_ms": max(n_bytes / HBM_BYTES_PER_S,
                                n_ops / FP32_OPS_PER_S) * 1e3,
                "bound_by": "bytes" if n_bytes / HBM_BYTES_PER_S
                >= n_ops / FP32_OPS_PER_S else "operations",
            }
            x.requires_grad_(False)
            py.requires_grad_(False)
            px.requires_grad_(False)
            log("dcn_gather_bwd at {} (plan {}): dx zero pattern equal, "
                "within the summation bounds, dpy and dpx equal to the bit "
                "over two runs, max abs {:.3g}; kernel {:.4f} ms (wrapper "
                "{:.4f} ms), plain {:.4f} ms, grid_sampler_2d_backward "
                "{:.4f} ms, bound {:.4f} ms ({}); forward + backward: "
                "kernels {:.4f} ms, grid_sample {:.4f} ms".format(
                    tuple(bwd["shape"]), bwd["plan"], err, bwd["ms"],
                    bwd["wrapper_ms"], bwd["plain_ms"], bwd["library_ms"], bwd["bound_ms"],
                    bwd["bound_by"], bwd["fwd_bwd_ms"],
                    bwd["library_fwd_bwd_ms"]))
            del g, g_signed, g_nchw, x_grad, grid_grad
        del x, py, px, got, library, x_nchw, grid
        torch.cuda.empty_cache()

    for b, eh, ew, ec, en in DCN_EDGE_SHAPES:
        x = torch.randn((b, eh, ew, ec), device="cuda", generator=gen)
        py, px = dcn_positions(b, eh, ew, en, gen)
        got = dcn.dcn_gather(x, py, px)
        if not torch.equal(got, dcn.dcn_gather_plain(x, py, px)):
            raise AssertionError("dcn_gather at {} differs from its plain "
                                 "version".format((b, eh, ew, ec, en)))
        g = torch.rand(got.shape, device="cuda", generator=gen).add_(0.5)
        compare_dcn_bwd(x, py, px, g, "at {}".format((b, eh, ew, ec, en)))
        x[torch.rand(x.shape, device="cuda", generator=gen) > 0.9] = \
            float("nan")
        if not equal_nan_aware(dcn.dcn_gather(x, py, px),
                               dcn.dcn_gather_plain(x, py, px)):
            raise AssertionError("dcn_gather at {} with NaN inputs differs "
                                 "from its plain version".format(
                                     (b, eh, ew, ec, en)))
    torch.cuda.synchronize()
    log("dcn_gather and dcn_gather_bwd agree with their plain versions at "
        "edge shapes {} (backward plans {}; the forward with NaN inputs "
        "too); position kinds at the served shape {}".format(
            list(DCN_EDGE_SHAPES),
            [tuple(dcn.bwd_plan(*shape[1:4])) for shape in DCN_EDGE_SHAPES],
            kinds))
    return fwd, bwd, kinds


def dcn_entries(fwd, bwd, kinds):
    """The forward's entry at the train step's shape (its served and
    validation shapes beside it) and the backward's."""
    train = fwd["train"]
    source = "scd_resnet_tpu_torch/csrc/dcn_gather.cu"
    return [
        {"name": dcn.KERNEL_NAME, "route": "cuda", "source": source,
         "replaces": "scd_resnet_tpu/ops/pallas_kernels.py:190",
         "max_abs_err": 0.0, "ms": train["ms"],
         "wrapper_ms": train["wrapper_ms"], "plain_ms": train["plain_ms"],
         "bound_ms": train["bound_ms"], "bound_by": train["bound_by"],
         "library_ms": train["library_ms"],
         "library_call": "F.grid_sample(bilinear, zeros, align_corners=True)",
         "library_max_abs_diff": train["library_max_abs_diff"],
         "shape": train["shape"], "by_shape": fwd, "position_kinds": kinds},
        {"name": dcn.BWD_KERNEL_NAME, "route": "cuda", "source": source,
         "replaces": "scd_resnet_tpu/ops/pallas_kernels.py:206",
         "max_abs_err": bwd["max_abs_err"], "ms": bwd["ms"],
         "wrapper_ms": bwd["wrapper_ms"], "plain_ms": bwd["plain_ms"],
         "bound_ms": bwd["bound_ms"], "bound_by": bwd["bound_by"],
         "library_ms": bwd["library_ms"],
         "library_call": "torch.ops.aten.grid_sampler_2d_backward",
         "fwd_bwd_ms": bwd["fwd_bwd_ms"],
         "library_fwd_bwd_ms": bwd["library_fwd_bwd_ms"],
         "shape": bwd["shape"], "plan": bwd["plan"]},
    ]


# -- 6. serving ---------------------------------------------------------------

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
    # top and left pools in tl_head, bottom and right in br_head; the
    # DCN's gather once for the request's one batch; no other kernel
    per_request = {name: 0 for name in cuda_build.LAUNCHES}
    if family == "corner":
        per_request.update({name: 2 for name in cp.KERNEL_NAMES.values()})
    if is_dcn(arch):
        per_request[dcn.KERNEL_NAME] = 1
        samples = dcn_served_samples(model, clips)
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
    result = {"arch": arch, "clips": n_clips, "detections": counts[0],
              "latency_ms": latencies,
              "server_busy_s": metrics["busy_seconds"],
              "server_clips_per_s": metrics["clips_per_second"],
              "launches": launches}
    if is_dcn(arch):
        result["dcn_samples"] = samples
    return result


def is_dcn(arch: str) -> bool:
    return bool(get_model_profile(arch).model_params.get("dcn"))


def dcn_served_samples(model, clips):
    """Where the seeded DCN samples the served clips' S/32 map: the
    fractional samples inside the map and those beyond the outer cutoff
    must both be there, and the masks must spread around 0.5."""
    seen = {}
    hook = model.deconv_dcn.register_forward_hook(
        lambda m, args, out: seen.__setitem__("x", args[0]))
    try:
        with torch.inference_mode():
            model(clips)
            offset, mask = model.deconv_dcn.offsets_and_mask(seen["x"].float())
    finally:
        hook.remove()
    py, px = dcn.sampling_positions(offset, 3, 3, 1, 1, 1)
    kinds = position_kinds(py, px, *seen["x"].shape[2:])
    kinds["mask_min_max_std"] = [mask.min().item(), mask.max().item(),
                                 mask.std().item()]
    if not (kinds["fractional_inside"] > 0 and kinds["beyond_cutoff"] > 0
            and mask.std().item() > 0.05):
        raise AssertionError("the seeded DCN samples no fractional or no "
                             "out-of-range positions, or its masks do not "
                             "spread: {}".format(kinds))
    log("centerOffsetRes10dcn served samples: {}".format(kinds))
    return kinds


# -- 7. the render kernel against its plain version -----------------------------

def start_archive(path: str):
    """Write the synthetic training archive in a subprocess unless it is
    cached; returns the process, or None."""
    if os.path.exists(path):
        return None
    os.makedirs(os.path.dirname(path), exist_ok=True)
    spec = SYNTHETIC_ARCHIVE
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
    the edge cases written into clips 0-5: clip 5 holds objects whose
    corners fall in (-1, 0), at S - 1 and beyond S."""
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
    # center, major axis (x, y) and minor axis: the top-left corner at
    # center - (|maj|, minL), the bottom-right one at center + (|maj|, minL)
    corners = ((3.0, 4.0, 3.5, 0.0, 3.6),      # tl x -0.5, y 0.4
               (2.0, 2.5, 0.0, 2.6, 3.0),      # tl in (-1, 0) both ways
               (HEAT - 4.0, HEAT - 5.0, 3.0, 0.0, 4.0),  # br at S - 1
               (HEAT - 2.0, 60.0, 1.5, 1.5, 2.0),        # br beyond S
               (10.0, 10.0, 0.0, 0.0, 0.0))    # zero size
    for i, (x, y, mx, my, mn) in enumerate(corners):
        locs[5, i] = first
        locs[5, i, 0], locs[5, i, 1] = x, y
        locs[5, i, 4], locs[5, i, 5], locs[5, i, 6] = mx, my, mn
    valid[5, :len(corners)] = True
    return locs, valid


def map_geometries(locs: torch.Tensor, valid: torch.Tensor, size: int,
                   corner_targets: bool = False, position_offset=None):
    """What each map of a map set derives from the objects: the center
    map and the tl and br maps, or one corner map at the given offsets."""
    if position_offset is not None:
        return [gaussian.object_geometry(
            locs, valid, size, THRESHOLD_IOU, corner_threshold_radius,
            position_offset)]
    maps = [gaussian.object_geometry(locs, valid, size, THRESHOLD_IOU)]
    if corner_targets:
        maps += [gaussian.object_geometry(locs, valid, size, THRESHOLD_IOU,
                                          corner_threshold_radius, offset)
                 for offset in gaussian.corner_offsets(locs)]
    return maps


def render_bound_ms(locs: torch.Tensor, valid: torch.Tensor, size: int,
                    corner_targets: bool = False, position_offset=None):
    """The least time for one launch on these inputs: locs, valid (and
    the caller's offsets) and the M maps each cross memory once; the
    operations are those of the (pixel, object) terms inside a valid
    object's box on each map, as this data needs them, plus one clamp per
    pixel. Returns (ms, "bytes"|"operations")."""
    maps = map_geometries(locs, valid, size, corner_targets, position_offset)
    terms = 0
    for cx, cy, ok, roi, _ in maps:
        def span(c):
            return (torch.clamp(c + roi, max=size - 1)
                    - torch.clamp(c - roi, min=0) + 1).clamp_min(0)
        terms += int((span(cx) * span(cy) * ok).sum().item())
    pixels = len(maps) * locs.shape[0] * size * size
    n_bytes = locs.numel() * 4 + valid.numel() + pixels * 4
    if position_offset is not None:
        n_bytes += position_offset.numel() * 4
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


def render_map_sets(l, v, offset):
    """The kernel's three map sets on (l, v): name -> (wrapper call, its
    plain version, the C entry point's (offsets, M), the bound's
    arguments)."""
    def center():
        return gaussian.render_label_heatmaps(l, v, HEAT, False,
                                              THRESHOLD_IOU)

    def corners():
        return gaussian.render_label_heatmaps(l, v, HEAT, True, THRESHOLD_IOU)

    def offset_map():
        return gaussian.render_heatmap(l, v, HEAT, THRESHOLD_IOU,
                                       radius_fn=corner_threshold_radius,
                                       position_offset=offset)[None]

    return {
        "center": (center, lambda: gaussian.render_label_heatmaps_plain(
            l, v, HEAT, False, THRESHOLD_IOU), (None, 1), {}),
        "center+tl+br": (corners, lambda: gaussian.render_label_heatmaps_plain(
            l, v, HEAT, True, THRESHOLD_IOU), (None, 3),
            {"corner_targets": True}),
        "offset": (offset_map, lambda: gaussian.render_heatmap_plain(
            l, v, HEAT, THRESHOLD_IOU, radius_fn=corner_threshold_radius,
            position_offset=offset)[None], (offset, 1),
            {"position_offset": offset}),
    }


def check_render_maps(name, l, v, offset):
    """Every map set of the kernel against its plain version on (l, v):
    the center map within 1e-6 with the same pixels at 1.0 and every
    valid center a peak of 1.0, the same bits in M = 1 and M = 3; the
    corner maps and the offset map equal to the bit. Returns the center
    map's max abs error."""
    got = {}
    for set_name, (fn, plain, _, _) in render_map_sets(l, v,
                                                       offset).items():
        got[set_name] = fn()
        torch.cuda.synchronize()
        ref = plain()
        if set_name == "offset":
            if not torch.equal(got[set_name], ref):
                raise AssertionError("render {} offset map differs from its "
                                     "plain version by {}".format(
                                         name, (got[set_name] - ref).abs()
                                         .max().item()))
            continue
        err = compare_heat(got[set_name][0], ref[0],
                           "render {} {} map 0".format(name, set_name))
        for m in range(1, ref.shape[0]):
            if not torch.equal(got[set_name][m], ref[m]):
                raise AssertionError("render {} corner map {} differs from "
                                     "its plain version by {}".format(
                                         name, m, (got[set_name][m] - ref[m])
                                         .abs().max().item()))
    center, three = got["center"][0], got["center+tl+br"]
    if not torch.equal(three[0], center):
        raise AssertionError("render {}: the center map of M = 3 differs from "
                             "M = 1's".format(name))
    if not torch.equal(gaussian.render_heatmap(l, v, HEAT, THRESHOLD_IOU),
                       center):
        raise AssertionError("render {}: render_heatmap differs from the "
                             "M = 1 launch".format(name))
    cx, cy, ok, _, _ = gaussian.object_geometry(l, v, HEAT, THRESHOLD_IOU)
    b = torch.arange(l.shape[0], device="cuda")[:, None].expand_as(ok)
    if not bool((center[b[ok], cy[ok].long(), cx[ok].long()] == 1.0).all()):
        raise AssertionError("render {}: a valid center is not 1.0".format(
            name))
    log("render {}: {} -> M = 1 and M = 3 match their plain versions (center "
        "map max abs {:.3g}, {} centers at exactly 1.0; {} tl and {} br "
        "pixels at 1.0, equal to the bit), the offset map equal to the "
        "bit".format(name, tuple(l.shape), err, int(ok.sum()),
                     int((three[1] == 1.0).sum()),
                     int((three[2] == 1.0).sum())))
    return err, three


def time_render(l, v, offset):
    """For each map set at these inputs: the kernel's device time by
    ``torch.profiler`` (the wrapper as the batch transform calls it), the
    C entry point launched back to back from Python and timed by CUDA
    events (host-issued: a launch may take longer to issue than to run),
    the plain version's time and the bound; and the floor, the device
    time of a one-element add."""
    lib = gaussian.library()
    stream = torch.cuda.current_stream().cuda_stream
    result = {}
    for set_name, (fn, plain, (offsets, maps), bound_args) in \
            render_map_sets(l, v, offset).items():
        heat = torch.empty((maps, l.shape[0], HEAT, HEAT), device="cuda")
        offset_ptr = None if offsets is None else offsets.data_ptr()

        def launch():
            return lib.render_heatmaps_f32(
                l.data_ptr(), v.data_ptr(), offset_ptr, heat.data_ptr(),
                l.shape[0], l.shape[1], HEAT, maps, THRESHOLD_IOU, stream)

        cuda_build.check(lib, launch(), "render_heatmaps_f32")
        kernels = device_kernels(fn, 50)["kernels"]
        names = [n for n in kernels if RENDER_KERNEL in n]
        if len(kernels) != 1 or len(names) != 1 or \
                kernels[names[0]]["launches"] != 1:
            raise AssertionError("render {}: the wrapper launched {}, not "
                                 "one render kernel".format(set_name,
                                                            kernels))
        bound_ms, bound_by = render_bound_ms(l, v, HEAT, **bound_args)
        result[set_name] = {
            "maps": maps, "ms": kernels[names[0]]["ms"],
            "host_issued_event_ms": device_ms(launch, 500, warmup=10),
            "plain_ms": device_ms(plain, 20, warmup=2),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        if not torch.equal(heat, fn()):
            raise AssertionError("render {}: direct launches differ".format(
                set_name))
    one = torch.ones(1, device="cuda")
    floor = device_kernels(lambda: torch.add(one, one), 50)["ms"]
    for set_name, r in result.items():
        log("render {} (M = {}) at {}: kernel {:.5f} ms by the profiler "
            "(host-issued event time of back-to-back C launches {:.5f} ms), "
            "plain {:.4f} ms, bound {:.6f} ms ({}), floor (a one-element "
            "add) {:.5f} ms".format(set_name, r["maps"], tuple(l.shape),
                                    r["ms"], r["host_issued_event_ms"],
                                    r["plain_ms"], r["bound_ms"],
                                    r["bound_by"], floor))
    return result, floor


def render_tile_edges(locs: torch.Tensor, valid: torch.Tensor) -> float:
    """The kernel at sides that cut its blocks' bands of rows, its warps'
    tiles of 8 rows x 16 pixels and its 4-pixel stores unevenly: S = 6
    (blocks with no rows), 8 (one row a block), 37 (scalar stores, short
    tiles) and 130 (a one-row tile, a ragged tile column); the records
    scaled onto the map, all three map sets against their plain
    versions."""
    err = 0.0
    gen = torch.Generator().manual_seed(6)
    for size in (6, 8, 37, 130):
        l = locs.clone()
        l[..., :2] *= size / HEAT
        l[..., 4:7] *= size / HEAT
        l, v = l.cuda(), valid.cuda()
        offset = ((torch.rand((*l.shape[:2], 2), generator=gen) - 0.5)
                  * size / 4).cuda()
        three = gaussian.render_label_heatmaps(l, v, size, True, THRESHOLD_IOU)
        one = gaussian.render_heatmap(l, v, size, THRESHOLD_IOU,
                                      radius_fn=corner_threshold_radius,
                                      position_offset=offset)
        torch.cuda.synchronize()
        ref = gaussian.render_label_heatmaps_plain(l, v, size, True,
                                                   THRESHOLD_IOU)
        err = max(err, compare_heat(three[0], ref[0],
                                    "render at S = {}".format(size)))
        if not (torch.equal(three[1:], ref[1:]) and torch.equal(
                one, gaussian.render_heatmap_plain(
                    l, v, size, THRESHOLD_IOU,
                    radius_fn=corner_threshold_radius,
                    position_offset=offset))):
            raise AssertionError("render at S = {}: a corner or offset map "
                                 "differs from its plain version".format(size))
    log("render at S = 6, 8, 37, 130: every map set matches its plain "
        "version (center max abs {:.3g})".format(err))
    return err


def check_render(archive: str):
    """Phase 7: the render kernel's map sets against their plain versions
    on the card at the train batch's shape (with the edge cases), at the
    validation pre-render's and at sides that cut its row bands
    unevenly; then their times and bounds at the train shape."""
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
    gen = torch.Generator().manual_seed(7)
    err = 0.0
    for name, (l, v) in cases.items():
        offset = ((torch.rand((*l.shape[:2], 2), generator=gen) - 0.5)
                  * 24).cuda()
        case_err, three = check_render_maps(name, l.cuda(), v.cuda(), offset)
        err = max(err, case_err)
        if name == "train" and not bool(three[1, 5, 0, 0] == 1.0):
            raise AssertionError("render: a corner in (-1, 0) is not "
                                 "stamped at 0")
    err = max(err, render_tile_edges(locs, valid))
    l, v = locs.cuda(), valid.cuda()
    _, offset = gaussian.corner_offsets(l)
    result, floor = time_render(l, v, offset.contiguous())
    return {"map_sets": result, "floor_ms": floor, "max_abs_err": err}


def render_entry(render):
    """K1's line: its numbers are the center map set's (M = 1, what the
    newest path that runs it launches), each map set's under
    ``map_sets``."""
    center = render["map_sets"]["center"]
    return {
        "name": gaussian.KERNEL_NAME, "route": "cuda",
        "source": "scd_resnet_tpu_torch/csrc/render_heatmap.cu",
        "replaces": "scd_resnet_tpu/ops/pallas_kernels.py:77",
        "max_abs_err": render["max_abs_err"],
        "ms": center["ms"], "plain_ms": center["plain_ms"],
        "bound_ms": center["bound_ms"], "bound_by": center["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call renders the heatmap",
        "floor_ms": render["floor_ms"],
        "map_sets": render["map_sets"],
        "shape": [BATCH, 30, 8, HEAT],
    }


# -- 8. training exp74, cpool_best and dcn_full -----------------------------------------

def write_config(path: str, values) -> str:
    with open(path, "w") as f:
        json.dump(values, f, indent=1)
    return path


def expected_launches(config, steps: int, n_val: int):
    """What the train runs of ``config`` (a first run and its resume, each
    rendering the validation set once) must launch, kernel by kernel."""
    chunks = 2 * math.ceil(n_val / VALIDATION_CHUNK)
    expected = {name: 0 for name in cuda_build.LAUNCHES}
    expected[gaussian.KERNEL_NAME] = steps + chunks  # every map set at once
    expected[mp.KERNEL_NAME] = steps
    batch = config["validationBatchSize"]
    per_validation = 1 + (1 if n_val <= batch else n_val // batch)
    forwards = steps + steps // config["validation"] * per_validation
    if is_dcn(config["modelName"]):
        expected[dcn.KERNEL_NAME] = forwards
        expected[dcn.BWD_KERNEL_NAME] = steps
    if config["modelName"].startswith("cornerCPool"):
        for dim in cp.KERNEL_NAMES:
            expected[cp.KERNEL_NAMES[dim]] = 2 * forwards
            expected[cp.BWD_KERNEL_NAMES[dim]] = 2 * steps
    return expected


def train_config(config: str, data_dir: str, work: str, metrics,
                 device: str = "cuda", **overrides):
    """Train ``config`` with the smoke's cuts through the train entry
    point, then resume it; every check of phase 7 in the module
    docstring."""
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cuts = {"iterations": TRAIN_ITERS, "validation": VALIDATE_EVERY,
            "snapshot": TRAIN_ITERS, "bestSnapshotMetric": metrics[0]}
    cuts.update(overrides)
    values = settings(config, data_dir, work, **cuts)
    spec = SYNTHETIC_ARCHIVE
    arch = values["modelName"]
    log("{} cuts: {} synthetic {}x{} clips (seed {}) for the scdx16p100 "
        "archive; {}; resumed to {}".format(
            arch, spec["num_images"] * spec["reps"] * spec["clips_per_image"],
            spec["size"], spec["size"], spec["seed"], cuts, RESUME_ITERS))
    name = values["trainName"]
    results = os.path.join(work, "results")

    cuda_build.reset_launches()
    first = train_cli.main([write_config(os.path.join(work, "first.json"),
                                         values), "--device", device])
    evals = open(os.path.join(results, "evals.{}.txt".format(name))).read()
    it_lines = [line for line in evals.splitlines() if line.startswith("[It]")]
    if len(it_lines) != TRAIN_ITERS // VALIDATE_EVERY:
        raise AssertionError("expected {} [It] lines, got {}".format(
            TRAIN_ITERS // VALIDATE_EVERY, it_lines))
    for line in it_lines:
        for metric in metrics:
            if parse_metric_line(line, metric) is None:
                raise AssertionError("[It] line without {}: {}".format(
                    metric, line))
    second = train_cli.main([write_config(
        os.path.join(work, "resume.json"),
        dict(values, currentIter=TRAIN_ITERS, iterations=RESUME_ITERS)),
        "--device", device])
    launches = dict(cuda_build.LAUNCHES)

    rows = [np.loadtxt(os.path.join(results, "losses.{}.{}.txt".format(
        name, it)), delimiter=",", ndmin=2) for it in (TRAIN_ITERS,
                                                        RESUME_ITERS)]
    if second["steps"] != RESUME_ITERS - TRAIN_ITERS or rows[1][0, 0] != \
            TRAIN_ITERS + 1:
        raise AssertionError("the resumed run did not start at iteration "
                             "{}: {}".format(TRAIN_ITERS + 1, rows[1][:1]))
    losses = np.concatenate(rows)
    if losses.shape[0] != RESUME_ITERS or not np.isfinite(losses).all():
        raise AssertionError("loss rows missing or not finite")
    focal = losses[:, 2]
    if not focal[-10:].mean() < focal[:10].mean():
        raise AssertionError("the focal loss did not fall: first 10 {}, last "
                             "10 {}".format(focal[:10], focal[-10:]))
    with open(os.path.join(data_dir, "scdx16p100.split.json")) as f:
        n_val = len(json.load(f)["validation"])
    expected = expected_launches(values, RESUME_ITERS, n_val)
    log("{}: {} + {} steps, losses finite, focal {:.4f} (first 10) -> "
        "{:.4f} (last 10); [It] at {}: {} {}; train clips/s {:.1f} and "
        "{:.1f} (validation, snapshots and cuDNN autotuning included); "
        "launches {} (expected {})".format(
            arch, first["steps"], second["steps"], focal[:10].mean(),
            focal[-10:].mean(), TRAIN_ITERS, metrics[0],
            parse_metric_line(it_lines[-1], metrics[0]),
            first["clips_per_s"], second["clips_per_s"], launches, expected))
    if launches != expected:
        raise AssertionError("{}: the kernels launched {}, expected {} ({} "
                             "train steps, {} validation clips)".format(
                                 arch, launches, expected, RESUME_ITERS,
                                 n_val))
    return {"arch": arch, "steps": [first["steps"], second["steps"]],
            "clips_per_s": [first["clips_per_s"], second["clips_per_s"]],
            "seconds": [first["seconds"], second["seconds"]],
            "focal_first10": float(focal[:10].mean()),
            "focal_last10": float(focal[-10:].mean()),
            "it_line": it_lines[-1].strip(), "launches": launches}


# -- 9. one float32 step, card against CPU ------------------------------------------

def global_grad_norm(model) -> float:
    return math.sqrt(sum(float(p.grad.double().pow(2).sum())
                         for p in model.parameters() if p.grad is not None))


def fractional_offsets(model) -> None:
    """Draw the DCN's offset conv N(0, 0.01 / fan_in) from a seed: offsets
    of a fraction of a pixel, so that the samples sit between pixels and
    a few beyond the map (a fresh DCN samples the integer grid). With
    offsets ten times larger the float32 step is worse conditioned: the
    gradients below the DCN (the probe, the DCN's kernel, layer4's) then
    move by more than 1e-3 when the clips move by one float32 ulp, on the
    CPU alone. Phase 9 measures that sensitivity at this scale beside the
    card's difference (``PROBE_NUDGE``)."""
    conv = model.deconv_dcn.conv_offset_mask
    gen = torch.Generator().manual_seed(19)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen)
                          * (0.1 / math.sqrt(conv.weight[0].numel())))
        conv.bias.zero_()


def step_card_vs_cpu(config: str, work: str, probe=None, prepare=None):
    """One float32 step of ``config``'s model on 2 clips, card against
    CPU; ``probe`` is (parameter name, rows) whose gradient must be
    non-zero and agree too; ``prepare`` changes both models' weights
    alike before the step. With a probe, a third step on the CPU takes
    the clips moved by ``PROBE_NUDGE`` relative: how far the probe moves
    then is the float32 step's own sensitivity, reported beside the
    card's difference."""
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    path = make_archive(os.path.join(work, "scdx16p100.d"), num_images=1,
                        reps=1, clips_per_image=4, size=CLIP, seed=75)
    dataset = SCDDataset(path, None, test_set=2, storage_dtype="float32",
                         device="cpu")
    batch = (dataset.samples[:2], dataset.locs[:2], dataset.counts[:2])
    # run -> device; "nudged" takes the clips moved by PROBE_NUDGE
    runs = {"cuda": "cuda", "cpu": "cpu"}
    if probe:
        runs["nudged"] = "cpu"
    factories = {}
    for run, device in runs.items():
        cfg = Configuration()
        cfg.update_config(settings(config, work, os.path.join(work, run),
                                   precision="float32", batchSize=2,
                                   residency="host"))
        factories[run] = NetworkFactory(cfg, dataset=dataset, device=device)
        if prepare is not None:
            prepare(factories[run].model)
    card, cpu = factories["cuda"], factories["cpu"]
    for key, value in cpu.model.state_dict().items():
        if not torch.equal(card.model.state_dict()[key].cpu(), value):
            raise AssertionError("card and CPU start from other weights")
    out = {}
    for run, factory in factories.items():
        samples = batch[0]
        if run == "nudged":
            noise = np.random.default_rng(20).standard_normal(samples.shape)
            samples = (samples * (1 + PROBE_NUDGE * noise)).astype(np.float32)
        loss, _ = factory.train(samples, *batch[1:], draws=identity_draws(
            2, CLIP, factory.device))
        grad = factory.model.get_parameter(probe[0]).grad[probe[1]].cpu() \
            if probe else None
        out[run] = (loss.item(), factory._last_batch[1],
                    global_grad_norm(factory.model), grad)
    targets = [0, 4, 5] if card.profile.corner_targets else [0]
    heat_err = max(compare_heat(out["cuda"][1][i].cpu(), out["cpu"][1][i],
                                "train-step target {}".format(i))
                   for i in targets)
    loss_rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    norm_rel = abs(out["cuda"][2] - out["cpu"][2]) / out["cpu"][2]
    result = {"arch": card.config.modelName, "heat_max_abs": heat_err,
              "loss_rel": loss_rel, "grad_norm_rel": norm_rel}
    if probe:
        g_card, g_cpu = out["cuda"][3], out["cpu"][3]
        result["probe_grad_norm"] = float(g_card.norm())
        result["probe_grad_rel"] = float((g_card - g_cpu).norm()
                                         / g_cpu.norm())
        result["probe_nudged_cpu_rel"] = float(
            (out["nudged"][3] - g_cpu).norm() / g_cpu.norm())
    log("one float32 step of {} on 2 clips: targets max abs {:.3g}; loss "
        "card {:.6f} cpu {:.6f} (rel {:.2e}); gradient norm card {:.6f} cpu "
        "{:.6f} (rel {:.2e}){}".format(
            card.config.modelName, heat_err, out["cuda"][0], out["cpu"][0],
            loss_rel, out["cuda"][2], out["cpu"][2], norm_rel,
            "; {} rows {}:{} gradient norm {:.6g} (rel {:.2e}; the CPU's "
            "own moves by {:.2e} when the clips move by {:g})".format(
                probe[0], probe[1].start or 0, probe[1].stop or "",
                result["probe_grad_norm"],
                result["probe_grad_rel"], result["probe_nudged_cpu_rel"],
                PROBE_NUDGE)
            if probe else ""))
    if not (loss_rel <= 1e-4 and norm_rel <= 1e-3):
        raise AssertionError("the card's step differs from the CPU's")
    if probe and not (result["probe_grad_norm"] > 0
                      and result["probe_grad_rel"] <= 1e-3):
        raise AssertionError("the gradient of {} on the card is zero or "
                             "differs from the CPU's".format(probe[0]))
    return result


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
    phases = {}

    def mark(name, t0):
        phases[name] = time.perf_counter() - t0
        return time.perf_counter()

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
        t0 = mark("build", t0)

        # 2-5. the corner-pool kernels, the stem pool's backward and the
        # deformable gather against their plain versions
        pool_results, pool_bound = check_corner_pool()
        bwd_results, bwd_bound = check_corner_pool_bwd()
        stem = check_max_pool_bwd()
        dcn_fwd, dcn_bwd, dcn_kinds = check_dcn_gather()
        t0 = mark("kernel_checks", t0)

        # 6. serve the three models; each resets the counts just before
        # its requests
        slide = synthetic_slide(SLIDE_H, SLIDE_W, seed=2056)
        served = [serve_model(arch, seed, slide, build_dir, gpu_line)
                  for arch, seed in (("cornerCPoolRes10", 10),
                                     ("centerOffsetRes10", 11),
                                     ("centerOffsetRes10dcn", 12))]
        t0 = mark("serving", t0)
        finish_archive(writer, archive)
    finally:
        if writer is not None and writer.poll() is None:
            writer.kill()
            writer.wait()

    # 7. the render kernel's map sets against their plain versions
    render = check_render(archive)
    t0 = mark("render_check", t0)
    # 8. train exp74, cpool_best and dcn_full and resume each; the counts
    # are reset inside, just before each first run
    trained = [train_config(EXP74, data_dir, os.path.join(build_dir, "exp74"),
                            ("mIoU", "AP50", "avgS")),
               train_config(CPOOL_BEST, data_dir,
                            os.path.join(build_dir, "cpool_best"),
                            ("boxAP50",)),
               train_config(DCN_FULL, data_dir,
                            os.path.join(build_dir, "dcn_full"),
                            ("mIoU", "AP50", "avgS"))]
    t0 = mark("training", t0)
    # 9. one float32 step on the card and on the CPU, for each model
    steps = [step_card_vs_cpu(EXP74, os.path.join(build_dir, "step_exp74")),
             step_card_vs_cpu(CPOOL_BEST, os.path.join(build_dir,
                                                       "step_cpool"),
                              probe=("tl_head.pool_block.branch1.conv.weight",
                                     slice(None))),
             step_card_vs_cpu(DCN_FULL, os.path.join(build_dir, "step_dcn"),
                              probe=("deconv_dcn.conv_offset_mask.weight",
                                     slice(0, 2 * 9)),
                              prepare=fractional_offsets)]
    mark("step_card_vs_cpu", t0)

    # 10. results: every path's counts, oldest first; each kernel's
    # launches are those of the newest path that runs it
    paths = {"serve_cornerCPoolRes10": served[0]["launches"],
             "serve_centerOffsetRes10dcn": served[2]["launches"],
             "train_exp74": trained[0]["launches"],
             "train_cpool_best": trained[1]["launches"],
             "train_dcn_full": trained[2]["launches"]}
    kernels = ([render_entry(render)]
               + pool_entries(cp.KERNEL_NAMES,
                              "scd_resnet_tpu/ops/pallas_kernels.py:260",
                              POOL_SHAPE, pool_results, pool_bound,
                              library=True)
               + pool_entries(cp.BWD_KERNEL_NAMES,
                              "scd_resnet_tpu/ops/pallas_kernels.py:344",
                              POOL_TRAIN_SHAPE, bwd_results, bwd_bound)
               + [max_pool_bwd_entry(stem)]
               + dcn_entries(dcn_fwd, dcn_bwd, dcn_kinds))
    for entry in kernels:
        entry["launches_by_path"] = {path: counts[entry["name"]]
                                     for path, counts in paths.items()}
        runs = [path for path, counts in paths.items()
                if counts[entry["name"]] > 0]
        if not runs:
            raise AssertionError("no path launched {}".format(entry["name"]))
        entry["main_path"] = runs[-1]
        entry["launches"] = paths[runs[-1]][entry["name"]]
    for entry in kernels:
        if entry["name"] in cp.KERNEL_NAMES.values():
            direction = [d for d, (dd, _) in DIRECTIONS.items()
                         if cp.KERNEL_NAMES[dd] == entry["name"]]
            entry["ms_train_shape"] = sum(
                bwd_results[d]["forward_ms"] for d in direction) / len(
                    direction)
    phases["total"] = time.perf_counter() - t_start
    log(json.dumps({"serving": served, "training": trained,
                    "step_card_vs_cpu": steps, "card": gpu_line,
                    "seconds": phases}))
    log(json.dumps({"kernels": kernels}))
    log(gpu_line)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
