#!/usr/bin/env python3
"""chip_smoke.py — the quickest proof that the PyTorch port runs on a GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (on PATH or under ``CUDA_HOME``, default
``/usr/local/cuda``) and this checkout. It drives the port only
(``scd_resnet_tpu_torch``; nothing of JAX or of ``scd_resnet_tpu``):

1. prints the toolchain, the card (``nvidia-smi`` name and power
   limit) and the build cache's directory and fingerprint
   (``core/compile_cache``), builds every kernel source (``csrc/*.cu``,
   one ``nvcc`` each) and the host library (``csrc/scdio.cpp``, ``g++``),
   all started together, and starts writing the seeded synthetic 512x512
   training archive in a subprocess (cached under ``build/``), phase
   10's slides in another and phase 12's (its gen stage) in a third;
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
6. serves ``cornerCPoolRes10``, ``centerOffsetRes10``,
   ``centerOffsetRes10dcn``, ``centerOffsetHourglass2``,
   ``cornerLegacyHourglass``, ``centerRes10`` (whose seeded size head
   is random: its sizes may be negative) and ``cornerNetHourglass104``
   at full width through the port's own serve
   entry point (``serve.build_service`` + the HTTP server), from seeded
   random weights whose heat heads are rescaled so that a few dozen
   peaks per clip pass the 0.3 threshold, and POSTs a seeded synthetic
   3092x2056 slide (48 clips) four times: three raw uint8 bodies and one
   PNG. Launch counts are set to 0 just before each model's requests and
   read just after: every corner request must launch the corner-pool
   kernel exactly four times (top and left in tl_head, bottom and right
   in br_head), every legacy request eight times (the same in each of
   its two stacks), every DCN request the gather's forward once (the 48
   clips are one batch), the plain centerOffset and hourglass requests
   no kernel, and no request any other kernel. The DCN's seeded samples must include
   fractional ones inside the map and ones beyond the outer cutoff, and
   its masks must spread. Detections must be non-empty, inside the slide
   and the same on every request; two forwards of the slide's clips must
   agree bit for bit (serving is deterministic). Two of the clips then go
   through the same model on the CPU, and the card's decode rows must
   match the CPU's (tolerances at ``compare_rows``; the legacy contract's
   paired boxes at ``compare_legacy_rows``). Then, from the served
   checkpoints: ``cornerCPoolRes10`` streamed with
   ``max_resident_clips=12`` (4 bands of 2 columns, each run padded to
   the batch of 24) must give the monolithic request's detections
   exactly and launch the corner-pool kernel 4 times a band, 16 in all,
   and nothing else (counts set to 0 just before the request), with both
   requests' time and peak memory printed; ``analyse.many`` over three
   slides must equal ``analyse`` slide by slide; ``python -m
   scd_resnet_tpu_torch.trace`` exports ``cornerCPoolRes10`` and
   ``centerOffsetRes10dcn`` at (24, 1, 512, 512), each bundle serves a
   PNG of the slide through ``python -m scd_resnet_tpu_torch.test -m`` in
   a fresh process (its detections equal to the host-tiled path's with
   the bundle here), and loaded here its rows on 24 clips must equal the
   live wrapper's (else the largest difference is printed and held to
   ``compare_rows``), launching the corner-pool kernel 4 times or the
   gather once and nothing else; ``python -m scd_resnet_tpu_torch.test
   -c`` on the ``centerOffsetRes10`` checkpoint with ``--pipelined
   --fit`` over three PNGs must give the live analyzer's detections and
   a fit. The inference grayscale of a seeded 3092x2056 uint8 RGB slide
   through the host library must equal numpy's to the bit (both times
   printed). A fresh ``test -m`` process on the ``cornerCPoolRes10``
   bundle and an RGB PNG of the slide, with the build cache warm, must
   build nothing (every file under the cache keeps its modification
   time, none is added), and one with ``SCD_NO_COMPILE_CACHE=1`` (every
   library built again) must give the same detections; each process's
   seconds to its result are printed;
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
   a corner in (-1, 0) stamped at 0; and the legacy batch transform's
   targets (two launches of the offset set) equal to their plain
   versions on the card to the bit, and to the CPU's (heatmaps within
   1e-6). At the train shape it times each map set (the offset set at the
   legacy targets' br corners and masks) by ``torch.profiler`` (the wrapper must launch the one kernel and
   nothing else), by CUDA events around C launches issued back to back
   from Python (host-issued time, labelled so), the plain version, the
   bound, and the floor: a one-element add's device time. No single
   PyTorch call computes the render, so it has no library time;
8. trains ``centerOffsetRes10`` at exp74's widths (512x512 clips, batch
   32, bf16, Adam 1.25e-4) through ``python -m scd_resnet_tpu_torch.train``'s
   own entry function on the synthetic archive, with the cuts it prints
   (synthetic data, 40 iterations, validation every 20, a snapshot at
   40), then resumes from that snapshot to iteration 60; then
   ``cornerCPoolRes10`` under ``configs/cpool_best.json``,
   ``centerOffsetRes10dcn`` under ``configs/dcn_full.json``,
   ``centerOffsetHourglass2`` under ``configs/hourglass2_best.json`` and
   ``cornerLegacyHourglass`` under ``configs/legacy_full.json`` (remat)
   and ``centerRes10`` under ``configs/centersize_full.json`` the same
   way.
   The launch counts are set to 0 just before each model's first run and
   read just after its resumed one, and must be exact: every model
   launches the render once a train step and once per validation
   pre-render chunk (cpool_best's three maps in that one launch) and the
   max-pool backward once a step; cpool_best launches the corner-pool
   forward four times a step and four times in each validation forward
   ([Tr] included), the corner-pool backward four times a step; dcn_full
   launches what exp74 launches, plus the gather's forward once a step and once in each
   validation forward and its backward once a step; hourglass2_best only
   the render (no stem pool); legacy_full the render twice a step and a
   chunk (its offset set, tl and br), the corner-pool forward eight
   times a forward and eight more a step in the remat recompute, its
   backward eight times a step; each run no other kernel. It prints each
   run's peak memory. Every loss must be finite, the mean focal loss of the last 10
   steps below that of the first 10, the [It] lines must parse (mIoU,
   AP50 and avgS for exp74, dcn_full and hourglass2_best; boxAP50 for
   cpool_best; AP50 and mIoU for legacy_full; peakAP50 and mIoU for
   centersize_full) and the resumed run must
   start at iteration 41. Then exp74 and cpool_best take one bfloat16
   step each on the archive's rows held on the card, after three warm
   steps, under ``torch.profiler`` (``check_layout``): the model is
   channels-last, so cuDNN's ``nchwToNhwc`` and ``nhwcToNchw`` kernels
   may run only inside its engines for the one-channel stem and tiny
   weight gradients (at most 3 launches and 0.5 ms a step) and BatchNorm
   must run its ``channels_last`` kernels; the
   tensors converted at the hand kernels' NCHW boundary
   (``cuda_build.LAYOUT_COPIES``) must be K5's three and, on cpool_best,
   each corner-pool kernel's four. It prints them, each BatchNorm and
   copy kernel's name and ms a step, and the transposes left
   (``python3 chip_smoke.py --layout`` runs this check alone, after the
   build and the archive). Last, ``check_feed`` runs resident bfloat16
   steps of exp74 (30), cpool_best (12) and legacy_full (4) back to back
   under ``torch.cuda.set_sync_debug_mode("error")``, so a synchronise
   anywhere in a step fails, and the host must feed at least 0.9 of
   exp74's steps while the card still runs the previous one
   (``cuda_build.FEED``); ``--feed`` runs it alone;
9. takes one float32 train step at full width on 2 clips, augmentation
   off, from the same weights on the card (the kernels) and on the CPU
   (the plain versions), for ``centerOffsetRes10``, ``cornerCPoolRes10``,
   ``centerOffsetRes10dcn``, ``centerOffsetHourglass2``,
   ``cornerLegacyHourglass`` (remat) and ``centerRes10``: targets within
   1e-6, loss within
   1e-4 relative, global gradient norm within 1e-3 relative (float32
   convolutions sum in another order on the two devices); a probe
   gradient must be non-zero and within 1e-3 relative too: for the
   corner models ``tl_head.pool_block.branch1.conv.weight`` and
   ``tl.0.pool_block.branch1.conv.weight``, which reach the loss only
   through the corner pools; for the DCN model rows 0-17
   (the offsets) of ``deconv_dcn.conv_offset_mask.weight``, which reach
   it only through the gather's dpy and dpx, after that conv is drawn
   from a seed so that the samples sit between pixels. A third step, on
   the CPU with the clips moved by 1e-7 relative, shows how far the
   probe moves from float32 rounding alone. Each BatchNorm's running
   statistics must have moved once on both devices (``num_batches_tracked``
   1: a remat recompute adds nothing) and agree within 1e-4 relative
   (1e-5 absolute);
10. preprocesses two seeded 3092x2056 slides with their label files
   (``data/synthetic.make_slide_and_annotation``, written by a
   subprocess started in phase 1) through ``python -m
   scd_resnet_tpu_torch.preprocess -s 512 -m '244 252 248 252' -v`` on
   the card: 3584x2560 padded slides, 16 rotations each in one batch, 560
   clips a slide. It prints each slide's rotation batch in ms (CUDA
   events; the first includes the process's CUDA start), the writes in
   s, clips/s and the peak device memory, and checks the clip count and
   the overlays. Slide 1's batch rotated again on the card and on the
   CPU through the same helper must agree within
   ``ops/augment.rotation_tolerance`` (the archive's first clip equal to
   the card's to the bit), and its records within 8 float32 ulps of their
   largest coordinate. The archive is read by the host library's
   threaded reader and by the numpy reader: the same names and arrays to
   the bit, each reader's seconds, its threads and the cores printed.
   Then exp74's widths train from that archive
   (560 training rows, 560 validation clips) for 20 steps, validated
   at 10 and 20, with ``debug`` and ``SCD_PROFILE_*`` around steps 12-13:
   the overlays must be there, the trace must name the render's and the
   stem pool backward's kernels, the losses be finite and falling, and
   the launch counts (set to 0 just before the run, read just after) be
   exactly K1 20 + 3 chunks and K5 20, nothing else. Then 10 steps of
   exp74 streamed from the host (``residency: host``, each batch packed
   by the host library), validated at step 10, through the train entry
   point: losses finite, K1 10 + 3 chunks and K5 10 exactly, nothing
   else: the newest path of both. Last, ``DCNPooling`` forward and
   backward at x (2, 392, 128, 128) with 256 ROIs, pooled 7 with 4 x 4
   samples, on the card against the CPU within the float32 bounds that
   ``check_psroi`` derives;
11. the parallel layer, on the one card (its ranks and stages share
   ``cuda:0``, which checks correctness, not scaling). (a) exp74 under
   ``torchrun --nproc_per_node 1`` on NCCL (this script re-run with
   ``--rank-job``): a float32 step on the first batch of 32 with seeded
   draws equal to the single-process step to the bit (loss, gradients,
   BatchNorm statistics), then 20 bf16 steps through the train entry
   point with K1 21 and K5 20 exactly, and a timed window of 10 steps;
   (b) two ranks on ``cuda:0`` over gloo, ``meshShape [2]`` and ``[1,
   2]`` data x model: one float32 step each against the single-process
   step within ``STEP_*`` (the step's own sensitivity, the same step on
   clips moved by ``PROBE_NUDGE``, printed beside), and the number of
   sharded parameters; (c) hourglass2_best with ``meshShape [1, 2]``
   data x pipe, both stages on ``cuda:0``: one microbatch's float32 step
   equal to the plain step to the bit, four microbatches' heads equal
   to ``sequential_apply``'s and their gradients within 1e-5, then 10
   bf16 steps through the train entry point (K1 11 exactly, step ms,
   peak memory); (d) ``cornerCPoolRes10`` and ``centerOffsetRes10``
   served through ``make_device_analyzer(mesh=["cuda:0", "cuda:0"])``
   on the slide: 24 + 24 clips, the monolithic detections exactly, K2 8
   launches a corner request, the latency printed; (e) the same two
   models on slides of 6, 20 and 35 clips (``check_small_slides``): the
   monolithic analyzer (a slide padded to a multiple of 24 clips) and
   ``mesh=["cuda:0", "cuda:0"]`` give the same rows to the bit and the
   same detections, the host-tiled path rows within ``compare_rows``'
   bounds; each path's ms, and the unpadded forward's ms and rows;
12. runs the north-star F1 pipeline (``python -m
   scd_resnet_tpu_torch.tools.f1_pipeline``) at a reduced scale through
   the port's CLIs, each stage its own process on the card: 2 train
   slides x 40 objects and 6 held-out slides x 10 (1200x800, seeds 100
   and 5000; the gen stage runs from phase 1 on), preprocessed with -s
   512, ``centerOffsetRes10`` at full width trained for 200 iterations
   (batch 32, bf16), served live
   (``test -c --pipelined --fit``) and traced (``trace`` + ``test
   -m``), scored. Every stage must exit 0, traced and live must be at
   least 99.5 % identical, the train stage's process (its counts start
   at 0; it reports them in its summary) must launch K1 exactly once a
   step and a validation pre-render chunk and K5 once a step and
   nothing else, and its ``StepProfiler`` trace must name both kernels.
   It prints P/R/F1 at every dedupe radius and each stage's seconds.
   Then ``python -m scd_resnet_tpu_torch.serve`` on the snapshot and
   ``python -m scd_resnet_tpu_torch.tools.loadtest`` against it: 6
   requests of a held-out slide, 3 at a time, no server error; p50, p90
   and clips/s printed;
13. prints one ``{"kernels": [...]}`` line (each kernel's ``launches``
   from the newest path that runs it, named in ``main_path``, and its
   counts on every path; the render once, with its center set's numbers,
   and every map set's numbers and launches on the path that runs it
   under ``map_sets``), the card's name and power limit, and as the
   last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.

``python3 chip_smoke.py --cards`` runs the parallel layer across four
cards instead (``cards_main``: two and four NCCL ranks, the pipeline's
stages on two cards, mesh serving over four, and exp74 streamed from
the host on two torchrun nodes of two cards each, every rank's rows its
block of its node's batch); ``--cards nodes`` runs that last job
alone.

``cornerNetHourglass104`` (the published CornerNet, 200,941,456
parameters) is served in phase 6 like ``cornerLegacyHourglass`` and
trained and resumed in phase 8 under ``configs/hourglass104_full.json``
(bfloat16, remat); phase 8 then takes one bfloat16 step of it on rows
held on the card (``hourglass104_step``): its parameter count, its
launches (K2 8 a direction, K3 4, the render 2) and its boundary copies
(``LAYOUT_COPIES``) must be exact. ``python3 chip_smoke.py
--hourglass104`` runs these alone, after the build and the archive.

Any failed phase raises and the script exits non-zero without the last
line. It exits non-zero at once when ``torch.cuda.is_available()`` is
false. Everything it writes goes under ``build/`` in the checkout.
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import faulthandler
import hashlib
import io
import json
import math
import os
import shutil
import socket
import subprocess
import sys
import threading
import time
import urllib.request
import zipfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from scd_resnet_tpu_torch import serve
from scd_resnet_tpu_torch.core import compile_cache, cuda_build
from scd_resnet_tpu_torch.core.checkpoint import save_checkpoint
from scd_resnet_tpu_torch.core.config import Configuration
from scd_resnet_tpu_torch.core.device import (
    reproducible_float32,
    training_backends,
)
from scd_resnet_tpu_torch.data import native_io
from scd_resnet_tpu_torch.data.archive import read_archive
from scd_resnet_tpu_torch.data.dataset import VALIDATION_CHUNK, SCDDataset
from scd_resnet_tpu_torch.data.preprocess import (
    REPEAT_GEN,
    _replicate_mirrors,
    decode_annotations,
    rotate_coords_batch,
    rotate_images_batch,
)
from scd_resnet_tpu_torch.data.pipeline import (
    THRESHOLD_IOU,
    augment_and_render_batch,
    draw,
    identity_draws,
    legacy_corners,
    legacy_targets,
)
from scd_resnet_tpu_torch.data.synthetic import make_archive
from scd_resnet_tpu_torch.infer.analyse import (
    BATCH_SIZE,
    CONTRACT_FIELDS,
    _batch_axis,
    _batched_rows,
    analyse_grayscale,
    analyse_images,
    band_plan,
    make_device_analyzer,
    make_device_tiler,
    read_gray_u8,
    slide_geometry,
    tile_slide,
)
from scd_resnet_tpu_torch.infer.server import create_server
from scd_resnet_tpu_torch.infer.synthetic import seeded_model, synthetic_slide
from scd_resnet_tpu_torch.infer.wrapper import (
    load_traced,
    load_wrapper,
    make_wrapper,
)
from scd_resnet_tpu_torch.models.deformable import DCNPooling
from scd_resnet_tpu_torch.models.hourglass import StackHourglass
from scd_resnet_tpu_torch.ops import corner_pool as cp
from scd_resnet_tpu_torch.ops import dcn
from scd_resnet_tpu_torch.ops import gaussian
from scd_resnet_tpu_torch.ops import max_pool as mp
from scd_resnet_tpu_torch.ops.augment import rotation_tolerance
from scd_resnet_tpu_torch.ops.dcn import deform_psroi_pooling
from scd_resnet_tpu_torch.ops.image import (
    grayscale_inference_u8,
    grayscale_inference_u8_plain,
    grayscale_preprocess,
)
from scd_resnet_tpu_torch.ops.radius import corner_threshold_radius
from scd_resnet_tpu_torch.parallel.mesh import (
    TIMEOUT_S,
    full_gradients,
    init_distributed,
    node_layout,
    stage_devices,
)
from scd_resnet_tpu_torch.parallel.pipeline import (
    StackStage,
    pipeline_apply,
    sequential_apply,
)
from scd_resnet_tpu_torch.profile_kernels import device_kernels, device_ms
from scd_resnet_tpu_torch.tools import f1_pipeline
from scd_resnet_tpu_torch.train import __main__ as train_cli
from scd_resnet_tpu_torch.train.factory import NetworkFactory, parse_metric_line
from scd_resnet_tpu_torch.train.registry import get_model_profile

REPO = os.path.dirname(os.path.abspath(__file__))
EXP74 = os.path.join(REPO, "configs", "exp74.json")
CPOOL_BEST = os.path.join(REPO, "configs", "cpool_best.json")
DCN_FULL = os.path.join(REPO, "configs", "dcn_full.json")
HOURGLASS2_BEST = os.path.join(REPO, "configs", "hourglass2_best.json")
LEGACY_FULL = os.path.join(REPO, "configs", "legacy_full.json")
HOURGLASS104_FULL = os.path.join(REPO, "configs", "hourglass104_full.json")
CENTERSIZE_FULL = os.path.join(REPO, "configs", "centersize_full.json")
# the synthetic stand-in for the scdx16p100 archive of the configurations
# (``make_archive``'s arguments): 2 x 128 clips of 512^2, half of them
# validation
SYNTHETIC_ARCHIVE = {"num_images": 2, "reps": 1, "clips_per_image": 128,
                     "size": 512, "seed": 74}
RENDER_KERNEL = "render_heatmaps_kernel"
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
BUILD_SOURCES = KERNEL_SOURCES + (native_io.SOURCE,)  # and the host library
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
# phase 10: two slides of the lab's size with their labels (seeded), cut
# with -s 512 and these margins into 3584 x 2560 padded slides (7 x 5
# clips x 16 rotations each); exp74 trained from the archive for
# PRE_STEPS steps, validated every PRE_VALIDATE_EVERY, traced over
# PRE_PROFILE = (first step, steps), the trace holding these kernels
PRE_SLIDES, PRE_OBJECTS, PRE_SEED = 2, 24, 3092
PRE_MARGIN = "244 252 248 252"
PRE_STEPS, PRE_VALIDATE_EVERY, PRE_PROFILE = 20, 10, (12, 2)
PRE_TRACE_KERNELS = ("render_heatmaps_kernel", "max_pool_bwd_kernel")
# phase 10: exp74 streamed from the host, HOST_STEPS steps; phase 6: the
# grayscale of a seeded RGB slide, timed over GRAY_ROUNDS rounds
HOST_STEPS, GRAY_SEED, GRAY_ROUNDS = 10, 2060, 3
# phase 12: the F1 pipeline (tools/f1_pipeline) cut to F1_TRAIN_SLIDES
# train and F1_TEST_SLIDES held-out slides and F1_ITERS iterations, its
# train stage traced over F1_PROFILE = (first step, steps); then
# F1_REQUESTS /analyse requests to the serving daemon, F1_CONCURRENCY at a
# time (tools/loadtest)
F1_TRAIN_SLIDES, F1_TEST_SLIDES, F1_ITERS = 2, 6, 200
F1_PROFILE = (150, 2)
F1_REQUESTS, F1_CONCURRENCY = 6, 3
# DCNPooling on the card: x (batch, output_dim group^2, size, size), rois
PSROI = {"batch": 2, "output_dim": 8, "group": 7, "pooled": 7, "size": 128,
         "rois": 256, "samples": 4}
# float32 operations of one (pixel, object) term inside an object's box:
# dx, dy, dx*dx, dy*dy, their sum, the division, exp, the accumulation
RENDER_OPS_PER_TERM = 8


def log(msg: str) -> None:
    print(msg, flush=True)


def run(cmd) -> str:
    return subprocess.run(cmd, check=True, capture_output=True,
                          text=True).stdout.strip()


def settings(config: str, data_dir: str, work: str, **overrides) -> dict:
    """The configuration file ``config`` with its archive in ``data_dir``,
    its outputs under ``work`` and ``overrides`` on top."""
    with open(config) as f:
        values = json.load(f)
    values.update(dirDataset=data_dir + "/", dirTemp=work + "/temp/",
                  dirResult=work + "/results/", **overrides)
    return values


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


def sync(devices) -> None:
    """Wait for every card among ``devices``."""
    for device in {torch.device(d) for d in devices}:
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def card_overlap(fn, devices, rounds: int = 3):
    """What the cards among ``devices`` did during one call of ``fn``, by
    ``torch.profiler``: each card's busy ms (its kernels' and copies'
    intervals merged) and the part of it in NCCL's kernels (which also
    spin while they wait for a peer), the window from the first record to
    the last, and the ms in which two or more of the cards
    (``overlap_ms``) and all of them (``all_ms``) were busy at once. A trace with no record of some card
    is taken again (CUPTI has returned empty rounds,
    ``profile_kernels.device_kernels``), at most ``rounds`` times."""
    cards = sorted({torch.cuda.current_device() if torch.device(d).index
                    is None else torch.device(d).index for d in devices})
    for _ in range(rounds):
        sync(devices)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            sync(devices)
        spans = {c: [] for c in cards}
        nccl = {c: 0.0 for c in cards}
        for evt in prof.events():
            if (evt.device_type == torch.autograd.DeviceType.CUDA
                    and evt.device_index in spans):
                spans[evt.device_index].append((evt.time_range.start,
                                                evt.time_range.end))
                if "nccl" in evt.name.lower():
                    nccl[evt.device_index] += evt.time_range.elapsed_us()
        if all(spans.values()):
            break
    else:
        raise AssertionError("the profiler recorded nothing on some of the "
                             "cards {}".format(cards))
    merged = {}
    for card, intervals in spans.items():
        out = []
        for a, b in sorted(intervals):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        merged[card] = out
    edges = sorted([(a, 1) for m in merged.values() for a, _ in m]
                   + [(b, -1) for m in merged.values() for _, b in m])
    overlap = every = 0.0
    active, last = 0, edges[0][0]
    for t, step in edges:
        if active >= 2:
            overlap += t - last
        if active == len(cards):
            every += t - last
        active, last = active + step, t
    return {"busy_ms": {"cuda:{}".format(c): sum(b - a for a, b in m) / 1e3
                        for c, m in merged.items()},
            "nccl_ms": {"cuda:{}".format(c): us / 1e3
                        for c, us in nccl.items()},
            "window_ms": (edges[-1][0] - edges[0][0]) / 1e3,
            "overlap_ms": overlap / 1e3, "all_ms": every / 1e3}


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

def summation_bound_of(total_abs: torch.Tensor, terms: int) -> torch.Tensor:
    """How far two float32 sums of ``terms`` terms in other orders may lie
    apart: each is within (terms - 1) 2^-24 times the sum of the terms'
    magnitudes of the exact sum (the recursive-summation bound)."""
    return 2 * (terms - 1) * 2.0 ** -24 * total_abs


def summation_bound(g: torch.Tensor, dim: int) -> torch.Tensor:
    """:func:`summation_bound_of` for suffix sums of ``g`` along ``dim``."""
    return summation_bound_of(g.abs().sum(dim, keepdim=True), g.shape[dim])


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
    the centerOffset regression rows and the centerSize size rows at those
    positions within 1e-3 relative to the row's largest value. The
    cornerLegacy contract's
    paired boxes (B, 1000, 8): ``compare_legacy_rows``."""
    if family == "cornerLegacy":
        return compare_legacy_rows(gpu_rows, cpu_rows)
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
        if family in ("centerOffset", "centerSize"):
            for r in range(4, len(cpu)):
                scale = max(1.0, cpu[r].abs().max().item())
                rerr = (gpu[r][firm] - cpu[r][firm]).abs().max().item()
                if rerr > 1e-3 * scale:
                    raise AssertionError("{} row {} differs by {} (scale "
                                         "{})".format(family, r, rerr, scale))
    if checked == 0:
        raise AssertionError("no firm peaks to compare")
    return checked


def compare_legacy_rows(gpu_rows, cpu_rows):
    """Paired boxes (B, 1000, 8), card against CPU: every pair above the
    0.3 threshold by more than 1e-4 on one side has a pair on the other
    with its score, tlScore and brScore within 1e-4, its category equal
    and its box within 1e-3 relative to the clip's largest coordinate
    (pairs closer than 1e-4 may swap ranks, and one at the threshold may
    fall on either side, under another summation order). Returns the
    number of pairs matched."""
    gpu, cpu = gpu_rows.double().cpu(), cpu_rows.double()
    checked = 0
    for clip in range(cpu.shape[0]):
        scale = max(1.0, cpu[clip, :, 0:4].abs().max().item())
        for a, b in ((cpu[clip], gpu[clip]), (gpu[clip], cpu[clip])):
            want = a[a[:, 4] > 0.3 + 1e-4]
            pool = b[b[:, 4] > 0.3 - 1e-4]
            if len(want) == 0:
                continue
            near = (((want[:, None, 4:7] - pool[None, :, 4:7]).abs()
                     <= 1e-4).all(-1)
                    & (want[:, None, 7] == pool[None, :, 7])
                    & (((want[:, None, 0:4] - pool[None, :, 0:4]).abs()
                        <= 1e-3 * scale).all(-1)))
            if not bool(near.any(dim=1).all()):
                raise AssertionError("cornerLegacy: {} of {} pairs above the "
                                     "threshold have no match on the other "
                                     "device".format(
                                         int((~near.any(dim=1)).sum()),
                                         len(want)))
            checked += len(want)
    if checked == 0:
        raise AssertionError("no pairs above the threshold to compare")
    return checked // 2


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
    # top and left pools in each tl head, bottom and right in each br
    # head; the DCN's gather once for the request's one batch; no other
    # kernel
    per_request = {name: 0 for name in cuda_build.LAUNCHES}
    per_request.update({name: pool_launches_per_forward(arch)
                        for name in cp.KERNEL_NAMES.values()})
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
                x, y = ((d["tlx"] + d["brx"]) / 2, (d["tly"] + d["bry"]) / 2) \
                    if family == "cornerLegacy" else (d["x"], d["y"])
                if not (0 <= x < width and 0 <= y < height):
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
    # the legacy contract is batch-major, the others row-major
    gpu_rows = rows[pick] if family == "cornerLegacy" else rows[:, pick]
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


def pool_launches_per_forward(arch: str) -> int:
    """Each corner-pool forward kernel's launches in one forward of
    ``arch``: the H walk for the top and bottom pools, the W scan for the
    left and right pools, of each pair of corner heads (one pair in
    ``cornerCPoolRes*``, one a stack in the legacy CornerNet)."""
    profile = get_model_profile(arch)
    if profile.family == "cornerLegacy":
        return 2 * profile.model_params["stacks"]
    return 2 if arch.startswith("cornerCPool") else 0


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


# -- 6, continued: streaming, analyse.many, traced bundles, test -c ---------------

def k2_launches(counts) -> int:
    """The corner-pool forward kernel's launches, both walks, in ``counts``."""
    return sum(counts[name] for name in cp.KERNEL_NAMES.values())


def only(counts, expected):
    """``counts`` must hold ``expected`` and 0 for every other kernel."""
    want = {name: 0 for name in cuda_build.LAUNCHES}
    want.update(expected)
    if dict(counts) != want:
        raise AssertionError("the kernels launched {}, expected {}".format(
            dict(counts), want))


def check_streaming(slide, build_dir):
    """``cornerCPoolRes10`` (the served checkpoint) with
    ``max_resident_clips=12``: 4 bands of 2 columns (12 clips, run padded
    to the batch of 24); detections equal to the monolithic analyzer's
    and K2 launched 4 times a band. Each request warmed up once; its
    time and peak memory printed."""
    wrapper = load_wrapper(os.path.join(build_dir, "cornerCPoolRes10.pt"),
                           "cornerCPoolRes10")
    analyzers = {"monolithic": make_device_analyzer(wrapper, SLIDE_W,
                                                    SLIDE_H),
                 "banded": make_device_analyzer(wrapper, SLIDE_W, SLIDE_H,
                                                max_resident_clips=12)}
    out = {}
    for mode, analyse in analyzers.items():
        analyse(slide)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_build.reset_launches()
        t0 = time.perf_counter()
        detections = analyse(slide)
        ms = (time.perf_counter() - t0) * 1e3
        out[mode] = {"detections": detections, "ms": ms,
                     "launches": dict(cuda_build.LAUNCHES),
                     "peak_memory_gb": torch.cuda.max_memory_allocated()
                     / 1024 ** 3}
    bands = len(band_plan(*slide_geometry(SLIDE_W, SLIDE_H)[:2], 12))
    only(out["banded"]["launches"], {
        name: 2 * bands for name in cp.KERNEL_NAMES.values()})
    if not out["monolithic"]["detections"] or \
            out["banded"]["detections"] != out["monolithic"]["detections"]:
        raise AssertionError("streamed detections ({}) differ from the "
                             "monolithic ones ({})".format(
                                 len(out["banded"]["detections"]),
                                 len(out["monolithic"]["detections"])))
    log("cornerCPoolRes10 streamed in {} bands of 12 clips: {} detections, "
        "equal to the monolithic request's; K2 {} launches; ms {:.1f} "
        "(banded) and {:.1f} (monolithic); peak memory {:.3f} and {:.3f} "
        "GB".format(bands, len(out["banded"]["detections"]),
                    k2_launches(out["banded"]["launches"]),
                    out["banded"]["ms"], out["monolithic"]["ms"],
                    out["banded"]["peak_memory_gb"],
                    out["monolithic"]["peak_memory_gb"]))
    # three slides through analyse.many, each equal to its own analyse
    slides = [slide, np.ascontiguousarray(slide[:, ::-1]),
              synthetic_slide(SLIDE_H, SLIDE_W, seed=2057)]
    single = [analyzers["monolithic"](g) for g in slides]
    t0 = time.perf_counter()
    many = analyzers["monolithic"].many(iter(slides))
    many_ms = (time.perf_counter() - t0) * 1e3
    if many != single or not all(single):
        raise AssertionError("analyse.many differs from analyse slide by "
                             "slide")
    log("analyse.many over 3 slides: {:.1f} ms, each slide's detections "
        "equal to its own analyse ({})".format(
            many_ms, [len(d) for d in single]))
    return {mode: {k: v for k, v in r.items() if k != "detections"}
            for mode, r in out.items()} | {
        "bands": bands, "detections": len(out["banded"]["detections"]),
        "many_ms": many_ms}, out["banded"]["launches"]


def write_pngs(slide, build_dir):
    """The slide, its mirror image and a second seeded slide as PNGs."""
    paths = []
    for i, image in enumerate((slide, np.ascontiguousarray(slide[:, ::-1]),
                               synthetic_slide(SLIDE_H, SLIDE_W,
                                               seed=2057))):
        path = os.path.join(build_dir, "slide{}.png".format(i))
        Image.fromarray(image).save(path)
        paths.append(path)
    return paths


def port_cli(module: str, *args) -> str:
    """``python -m scd_resnet_tpu_torch.<module> args`` in a fresh
    process; its output, or its error output in the raised error."""
    proc = subprocess.run([sys.executable, "-m",
                           "scd_resnet_tpu_torch." + module, *args],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    if proc.returncode != 0:
        raise AssertionError("{} {} failed ({}):\n{}".format(
            module, args, proc.returncode, proc.stderr[-4000:]))
    return proc.stdout


def check_bundle(arch, slide, png, build_dir):
    """Trace ``arch``'s served checkpoint at (24, 1, 512, 512) through
    ``python -m scd_resnet_tpu_torch.trace``, serve a PNG of the slide
    with it through ``python -m scd_resnet_tpu_torch.test -m`` in a fresh
    process, and in this one: the bundle's rows on a batch of 24 clips
    against the live wrapper's (bit for bit expected; else the largest
    difference, held to ``compare_rows``), its launches on that batch
    (K2 4, K4 1), both batches' times, and the CLI's detections against
    the host-tiled path's with the same bundle here."""
    ckpt = os.path.join(build_dir, arch + ".pt")
    bundle = os.path.join(build_dir, arch + ".pt2")
    t0 = time.perf_counter()
    port_cli("trace", bundle, "-a", arch, "-m", ckpt, "-s", "24 1 512 512")
    trace_s = time.perf_counter() - t0
    out_json = os.path.join(build_dir, arch + ".test.json")
    t0 = time.perf_counter()
    port_cli("test", png, "-m", bundle, "-o", out_json)
    test_s = time.perf_counter() - t0
    with open(out_json) as f:
        served = json.load(f)

    fn, shape = load_traced(bundle)
    live = load_wrapper(ckpt, arch)
    clips = make_device_tiler(SLIDE_W, SLIDE_H, fn.device)(
        torch.from_numpy(slide).to(fn.device))[:shape[0]].contiguous()
    cuda_build.reset_launches()
    rows = fn(clips)
    torch.cuda.synchronize()
    launches = dict(cuda_build.LAUNCHES)
    expected = {dcn.KERNEL_NAME: 1} if is_dcn(arch) else {
        name: pool_launches_per_forward(arch)
        for name in cp.KERNEL_NAMES.values()}
    only(launches, expected)
    want = live(clips)
    exact = torch.equal(rows, want)
    max_diff = (rows - want).abs().max().item()
    if not exact:
        compare_rows(live.contract, rows, want.cpu())
    bundle_ms = device_ms(lambda: fn(clips), 5, warmup=1)
    live_ms = device_ms(lambda: live(clips), 5, warmup=1)
    host = analyse_images(fn, png, batch_size=shape[0])
    got = [[d[k] for k in CONTRACT_FIELDS[served["contract"]]]
           for d in served["detections"]]
    if served["contract"] != live.contract or not got or got != host:
        raise AssertionError("{}: test -m served {} detections ({}), the "
                             "host path here {}".format(
                                 arch, len(got), served["contract"],
                                 len(host)))
    log("{} bundle {} ({} bytes): rows on a batch of {} {} the live "
        "wrapper's (largest difference {:.3g}); launches {}; batch ms "
        "{:.2f} (bundle) and {:.2f} (live); trace {:.1f} s, test -m {:.1f} "
        "s, {} detections equal to the host path's".format(
            arch, bundle, os.path.getsize(bundle), shape[0],
            "equal to" if exact else "within compare_rows of", max_diff,
            {k: v for k, v in launches.items() if v}, bundle_ms, live_ms,
            trace_s, test_s, len(got)))
    return {"arch": arch, "rows_equal": exact, "max_diff": max_diff,
            "bundle_batch_ms": bundle_ms, "live_batch_ms": live_ms,
            "trace_s": trace_s, "test_s": test_s,
            "detections": len(got)}, launches


def check_test_checkpoint(pngs, build_dir):
    """``python -m scd_resnet_tpu_torch.test -c`` on the served
    ``centerOffsetRes10`` checkpoint with ``--pipelined --fit`` over three
    PNGs: the detections equal the live analyzer's here, slide by slide,
    and the fit is there."""
    ckpt = os.path.join(build_dir, "centerOffsetRes10.pt")
    out_json = os.path.join(build_dir, "test_c.json")
    t0 = time.perf_counter()
    port_cli("test", *pngs, "-c", ckpt, "-a", "centerOffsetRes10",
             "--pipelined", "--fit", "-o", out_json)
    seconds = time.perf_counter() - t0
    with open(out_json) as f:
        served = json.load(f)
    live = load_wrapper(ckpt, "centerOffsetRes10")
    analyse = make_device_analyzer(live, SLIDE_W, SLIDE_H)
    want = [[png, *det] for png in pngs
            for det in analyse(read_gray_u8(png))]
    got = [[d["image"], d["x"], d["y"], d["rhr"]]
           for d in served["detections"]]
    if served["images"] != pngs or got != want or not got \
            or set(served.get("gauss2") or {}) != {"a1", "m1", "s1", "a2",
                                                 "m2", "s2"}:
        raise AssertionError("test -c --pipelined --fit: {} detections, the "
                             "live analyzer {}; keys {}".format(
                                 len(got), len(want), sorted(served)))
    log("test -c --pipelined --fit over {} slides: {:.1f} s, {} detections "
        "equal to the live analyzer's; gauss2 {}".format(
            len(pngs), seconds, len(got), served["gauss2"]))
    return {"seconds": seconds, "detections": len(got),
            "gauss2": served["gauss2"]}


def check_grayscale():
    """Phase 6: the inference grayscale of a seeded 3092x2056 uint8 RGB
    slide through the host library and through numpy: equal to the bit;
    each one's time (best of ``GRAY_ROUNDS``, host clock)."""
    rgb = np.random.default_rng(GRAY_SEED).integers(
        0, 256, (SLIDE_H, SLIDE_W, 3), dtype=np.uint8)
    times = {}
    for name, fn in (("native", grayscale_inference_u8),
                     ("numpy", grayscale_inference_u8_plain)):
        best = float("inf")
        for _ in range(GRAY_ROUNDS):
            t0 = time.perf_counter()
            out = fn(rgb)
            best = min(best, time.perf_counter() - t0)
        times[name] = (best * 1e3, out)
    equal = times["native"][1].tobytes() == times["numpy"][1].tobytes()
    log("grayscale of a seeded {}x{} RGB slide: host library {:.3f} ms, "
        "numpy {:.3f} ms (best of {}), equal to the bit: {}".format(
            SLIDE_W, SLIDE_H, times["native"][0], times["numpy"][0],
            GRAY_ROUNDS, equal))
    if not equal:
        raise AssertionError("the host library's grayscale differs from "
                             "numpy's")
    return {"native_ms": times["native"][0], "numpy_ms": times["numpy"][0],
            "pixels": SLIDE_W * SLIDE_H}


def library_times(root: str):
    """Every file under the build cache's root, by its modification
    time."""
    return {os.path.join(d, f): os.stat(os.path.join(d, f)).st_mtime_ns
            for d, _, files in os.walk(root) for f in files}


def check_build_cache(slide, build_dir, cache_dir, device: str = "cuda"):
    """Phase 6: ``python -m scd_resnet_tpu_torch.test -m`` on the
    ``cornerCPoolRes10`` bundle and an RGB PNG of the slide (the host
    library's grayscale and the corner-pool kernels), in a fresh process
    with the build cache warm: it must build nothing (every file under
    the cache's root keeps its modification time and none is added).
    Then the same with ``SCD_NO_COMPILE_CACHE=1`` (a fresh build
    directory, every library built again): the same detections. Each
    process's seconds to its result, start-up included."""
    png = os.path.join(build_dir, "slide_rgb.png")
    tint = np.random.default_rng(GRAY_SEED).integers(
        0, 24, (SLIDE_H, SLIDE_W, 3), dtype=np.uint8)
    Image.fromarray(np.clip(slide[..., None].astype(np.int16) + tint, 0,
                            255).astype(np.uint8)).save(png)
    bundle = os.path.join(build_dir, "cornerCPoolRes10.pt2")
    before = library_times(cache_dir)
    runs = {}
    for name, env in (("warm", {}), ("uncached",
                                     {compile_cache.NO_CACHE_ENV: "1"})):
        out_json = os.path.join(build_dir, "cache_{}.json".format(name))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "scd_resnet_tpu_torch.test", png, "-m",
             bundle, "-o", out_json, "--device", device], cwd=REPO,
            capture_output=True,
            text=True, timeout=600, env=dict(os.environ, **env))
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError("test -m ({}) failed:\n{}".format(
                name, proc.stderr[-4000:]))
        with open(out_json) as f:
            runs[name] = (seconds, json.load(f)["detections"])
        if name == "warm" and library_times(cache_dir) != before:
            raise AssertionError("a process with the build cache warm "
                                 "built again: {} -> {}".format(
                                     before, library_times(cache_dir)))
    same = runs["warm"][1] == runs["uncached"][1] and runs["warm"][1]
    log("build cache {} (fingerprint {}): {} libraries kept; test -m on an "
        "RGB PNG in a fresh process {:.2f} s warm (nothing built), {:.2f} s "
        "with SCD_NO_COMPILE_CACHE=1; {} detections, the same: {}".format(
            cache_dir, os.path.basename(cache_dir),
            sum(name.endswith(".so") for name in before), runs["warm"][0],
            runs["uncached"][0], len(runs["warm"][1]), bool(same)))
    if not same:
        raise AssertionError("the uncached process found other detections")
    return {"cache_dir": cache_dir, "warm_s": runs["warm"][0],
            "uncached_s": runs["uncached"][0],
            "detections": len(runs["warm"][1])}


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


def render_map_sets(l, v, offset, offset_valid=None):
    """The kernel's three map sets on (l, v): name -> (wrapper call, its
    plain version, the C entry point's (valid, offsets, M), the bound's
    arguments); the offset set takes ``offset_valid`` (default ``v``)."""
    ov = v if offset_valid is None else offset_valid

    def center():
        return gaussian.render_label_heatmaps(l, v, HEAT, False,
                                              THRESHOLD_IOU)

    def corners():
        return gaussian.render_label_heatmaps(l, v, HEAT, True, THRESHOLD_IOU)

    def offset_map():
        return gaussian.render_heatmap(l, ov, HEAT, THRESHOLD_IOU,
                                       radius_fn=corner_threshold_radius,
                                       position_offset=offset)[None]

    return {
        "center": (center, lambda: gaussian.render_label_heatmaps_plain(
            l, v, HEAT, False, THRESHOLD_IOU), (v, None, 1), {"valid": v}),
        "center+tl+br": (corners, lambda: gaussian.render_label_heatmaps_plain(
            l, v, HEAT, True, THRESHOLD_IOU), (v, None, 3),
            {"valid": v, "corner_targets": True}),
        "offset": (offset_map, lambda: gaussian.render_heatmap_plain(
            l, ov, HEAT, THRESHOLD_IOU, radius_fn=corner_threshold_radius,
            position_offset=offset)[None], (ov, offset, 1),
            {"valid": ov, "position_offset": offset}),
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


def time_render(l, v, offset, offset_valid):
    """For each map set at these inputs (the offset set with
    ``offset_valid``): the kernel's device time by
    ``torch.profiler`` (the wrapper as the batch transform calls it), the
    C entry point launched back to back from Python and timed by CUDA
    events (host-issued: a launch may take longer to issue than to run),
    the plain version's time and the bound; and the floor, the device
    time of a one-element add."""
    lib = gaussian.library()
    stream = torch.cuda.current_stream().cuda_stream
    result = {}
    for set_name, (fn, plain, (valid, offsets, maps), bound_args) in \
            render_map_sets(l, v, offset, offset_valid).items():
        heat = torch.empty((maps, l.shape[0], HEAT, HEAT), device="cuda")
        offset_ptr = None if offsets is None else offsets.data_ptr()
        valid_ptr = valid.data_ptr()

        def launch():
            return lib.render_heatmaps_f32(
                l.data_ptr(), valid_ptr, offset_ptr, heat.data_ptr(),
                l.shape[0], l.shape[1], HEAT, maps, THRESHOLD_IOU, stream)

        cuda_build.check(lib, launch(), "render_heatmaps_f32")
        kernels = device_kernels(fn, 50)["kernels"]
        names = [n for n in kernels if RENDER_KERNEL in n]
        if len(kernels) != 1 or len(names) != 1 or \
                kernels[names[0]]["launches"] != 1:
            raise AssertionError("render {}: the wrapper launched {}, not "
                                 "one render kernel".format(set_name,
                                                            kernels))
        bound_ms, bound_by = render_bound_ms(l, size=HEAT, **bound_args)
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
    check_legacy_targets(locs, valid)
    l, v = locs.cuda(), valid.cuda()
    # the offset set at the legacy targets' br corner, as a legacy batch
    # transform launches it
    true, _, cmask = legacy_corners(l, v, HEAT)[1]
    result, floor = time_render(l, v, (true - l[:, :, 0:2]).contiguous(),
                                cmask)
    return {"map_sets": result, "floor_ms": floor, "max_abs_err": err}


def check_legacy_targets(locs: torch.Tensor, valid: torch.Tensor) -> None:
    """The legacy batch transform's targets (two launches of the offset
    map set, at the legacy corners with their floor-based masks) on the
    card: each heatmap equal to the bit to its plain version on the same
    card tensors, and within 1e-6 of the CPU's with the same pixels at
    1.0 (CUDA's and the CPU's exp round a last bit apart); the masks,
    indices and offsets equal to the CPU's to the bit."""
    l, v = locs.cuda(), valid.cuda()
    got = legacy_targets(l, v, HEAT)
    want = legacy_targets(locs, valid, HEAT)
    for i in range(2, 7):
        if not torch.equal(got[i].cpu(), want[i]):
            raise AssertionError("legacy target {} differs from the CPU's"
                                 .format(i))
    for i, (true, _, mask) in enumerate(legacy_corners(l, v, HEAT)):
        plain = gaussian.render_heatmap_plain(
            l, mask, HEAT, THRESHOLD_IOU, radius_fn=corner_threshold_radius,
            position_offset=true - l[:, :, 0:2])
        if not torch.equal(got[i][:, 0], plain):
            raise AssertionError("legacy heatmap {} differs from its plain "
                                 "version on the card".format(i))
        compare_heat(got[i][:, 0].cpu(), want[i][:, 0],
                     "legacy heatmap {}".format(i))
    log("render: the legacy targets at {} equal their plain versions to the "
        "bit ({} objects paired, {} tl and {} br pixels at 1.0)".format(
            tuple(locs.shape), int(want[2].sum()),
            int((want[0] == 1.0).sum()), int((want[1] == 1.0).sum())))


def render_entry(render):
    """K1's line: its numbers are the center map set's (M = 1, what the
    newest path that runs it, exp74 trained from the preprocessed
    archive, launches), each map set's under ``map_sets``."""
    main = render["map_sets"]["center"]
    return {
        "name": gaussian.KERNEL_NAME, "route": "cuda",
        "source": "scd_resnet_tpu_torch/csrc/render_heatmap.cu",
        "replaces": "scd_resnet_tpu/ops/pallas_kernels.py:77",
        "max_abs_err": render["max_abs_err"],
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call renders the heatmap",
        "floor_ms": render["floor_ms"],
        "map_sets": render["map_sets"],
        "shape": [BATCH, 30, 8, HEAT],
    }


# -- 8. training exp74, cpool_best, dcn_full, hourglass2_best, legacy_full ----------

def write_config(path: str, values) -> str:
    with open(path, "w") as f:
        json.dump(values, f, indent=1)
    return path


def expected_launches(config, steps: int, n_val: int, runs: int = 2):
    """What the train runs of ``config`` (``runs`` of them, a first run and
    its resume by default, each rendering the validation set once) must
    launch, kernel by kernel: the
    render once a step and a validation chunk (the legacy targets twice);
    the stem pool's backward once a step in a ResNet (the hourglass has
    no stem pool); a corner-pool model's pools in every forward, again in
    each step's recompute under remat (validation forwards record no
    gradient and recompute nothing), and their backward once a step; the
    DCN's gather likewise and its backward once a step."""
    chunks = runs * math.ceil(n_val / VALIDATION_CHUNK)
    arch = config["modelName"]
    profile = get_model_profile(arch)
    expected = {name: 0 for name in cuda_build.LAUNCHES}
    expected[gaussian.KERNEL_NAME] = (steps + chunks) * (
        2 if profile.corner_targets == "legacy" else 1)
    if not issubclass(profile.model_cls, StackHourglass):
        expected[mp.KERNEL_NAME] = steps
    batch = config["validationBatchSize"]
    per_validation = 1 + (1 if n_val <= batch else n_val // batch)
    forwards = steps + steps // config["validation"] * per_validation
    recomputes = steps if config.get("remat") else 0
    if is_dcn(arch):
        expected[dcn.KERNEL_NAME] = forwards + recomputes
        expected[dcn.BWD_KERNEL_NAME] = steps
    pools = pool_launches_per_forward(arch)
    for dim in cp.KERNEL_NAMES:
        expected[cp.KERNEL_NAMES[dim]] = pools * (forwards + recomputes)
        expected[cp.BWD_KERNEL_NAMES[dim]] = pools * steps
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
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
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
    peak_gb = torch.cuda.max_memory_allocated() / 1024 ** 3 \
        if device == "cuda" else None

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
        "{:.1f}, {:.1f} ms a step in the resumed run (validation, "
        "snapshots and cuDNN autotuning included); peak memory {} GB; "
        "launches {} (expected {}); layout copies {}; feed_ahead_share {} "
        "and {}".format(
            arch, first["steps"], second["steps"], focal[:10].mean(),
            focal[-10:].mean(), TRAIN_ITERS, metrics[0],
            parse_metric_line(it_lines[-1], metrics[0]),
            first["clips_per_s"], second["clips_per_s"],
            second["seconds"] * 1e3 / max(second["steps"], 1), peak_gb,
            launches, expected, {k: v for k, v in second[
                "layout_copies"].items() if v}, first["feed_ahead_share"],
            second["feed_ahead_share"]))
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
            "it_line": it_lines[-1].strip(), "launches": launches,
            "peak_memory_gb": peak_gb,
            "feed_ahead_share": [first["feed_ahead_share"],
                                 second["feed_ahead_share"]]}


LAYOUT_TRANSPOSES = ("nchwToNhwc", "nhwcToNchw")  # cuDNN's kernels' names
# what a channels-last step keeps of them, inside cuDNN's engines (measured
# on an H100): the stem's wgrad pads its one-channel input (0.36 ms) and two
# weight gradients of one-channel or 1x1 filters turn (2 us each)
LAYOUT_TRANSPOSE_RESIDUE = {"launches": 3, "ms": 0.5}
# PyTorch's BatchNorm kernels for NCHW tensors, one block a channel
NCHW_BATCH_NORM = ("batch_norm_collect_statistics_kernel",
                   "batch_norm_transform_input_kernel",
                   "batch_norm_backward_kernel",
                   "batch_norm_backward_reduce_kernel",
                   "batch_norm_backward_elemt_kernel")
# tensors a bfloat16 step converts at the hand kernels' NCHW boundary
LAYOUT_COPIES = {
    "centerOffsetRes10": {mp.KERNEL_NAME: 3},
    "cornerCPoolRes10": {mp.KERNEL_NAME: 3, **{name: 4 for name in (
        *cp.KERNEL_NAMES.values(), *cp.BWD_KERNEL_NAMES.values())}},
    # the published CornerNet: each of a forward's eight pools (four a
    # kernel) converts its input and output, again in the remat
    # recompute, and each pool's backward its two gradients
    "cornerNetHourglass104": {
        **{name: 16 for name in cp.KERNEL_NAMES.values()},
        **{name: 8 for name in cp.BWD_KERNEL_NAMES.values()}}}


@contextlib.contextmanager
def training_tf32():
    """cuDNN's TF32 on, as a bfloat16 training process (the train CLI's,
    the benchmark's) keeps it; main() turned it off for serving, and
    without it the float32 heads' convolutions take NCHW engines: 9 more
    transposes, 1.0 ms a step on exp74 (measured on an H100)."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def check_layout(data_dir: str, work: str, device: str = "cuda"):
    """One profiled bfloat16 step of exp74 and of cpool_best (phase 8's
    end): cuDNN's layout transposes only as far as its engines keep them
    (``LAYOUT_TRANSPOSE_RESIDUE``), BatchNorm's channels-last kernels,
    the expected boundary copies. Returns each configuration's copies,
    BatchNorm, copy and transpose kernels (ms a step)."""
    with training_tf32():
        return {values["modelName"]: layout_step(values, device)
                for values in (settings(config, data_dir, work,
                                        residency="device")
                               for config in (EXP74, CPOOL_BEST))}


def layout_step(values, device: str):
    """``check_layout`` for one configuration's ``settings``."""
    cfg = Configuration()
    cfg.update_config(values)
    with training_backends(values["precision"]):
        factory = NetworkFactory(cfg, device=device)
        feed = iter(factory.dataset.epoch_local_indices(
            cfg.batchSize, 0, local_train=factory._local_train))
        for _ in range(3):
            factory.train_resident(next(feed))
        idx = next(feed)
        cuda_build.reset_launches()
        factory.train_resident(idx)
        copies = {k: v for k, v in cuda_build.LAYOUT_COPIES.items() if v}
        kernels = device_kernels(lambda: factory.train_resident(idx),
                                 calls=2)["kernels"]
    arch = values["modelName"]
    transposes = {k: v for k, v in kernels.items()
                  if any(t in k for t in LAYOUT_TRANSPOSES)}
    batch_norm = {k: round(v["ms"], 4) for k, v in kernels.items()
                  if "batch_norm" in k}
    copies_ms = {k: round(v["ms"], 4) for k, v in kernels.items()
                 if "copy" in k}
    stem = factory.model.state_dict()[[
        k for k in factory.model.state_dict()
        if k.endswith("preprocess.0.weight")][0]]
    log("{}: bf16 step, stem filter strides {}, {:.3f} device ms, "
        "layout copies {}, BatchNorm kernels (ms a step) {}, copy "
        "kernels (ms a step) {}, cuDNN transposes {}".format(
            arch, stem.stride(), sum(v["ms"] for v in kernels.values()),
            copies, batch_norm, copies_ms, transposes))
    if (sum(v["launches"] for v in transposes.values())
            > LAYOUT_TRANSPOSE_RESIDUE["launches"]
            or sum(v["ms"] for v in transposes.values())
            > LAYOUT_TRANSPOSE_RESIDUE["ms"]):
        raise AssertionError("{}: cuDNN still transposes: {}".format(
            arch, transposes))
    nchw_batch_norm = [k for k in batch_norm if any(
        name in k for name in NCHW_BATCH_NORM)]
    if nchw_batch_norm or not any("channels_last" in k for k in batch_norm):
        raise AssertionError("{}: BatchNorm kernels {}, not channels-last"
                             "".format(arch, sorted(batch_norm)))
    want = LAYOUT_COPIES[values["modelName"]]
    if copies != want:
        raise AssertionError("{}: layout copies {}, expected {}".format(
            arch, copies, want))
    return {"layout_copies": copies, "batch_norm_ms": batch_norm,
            "copy_ms": copies_ms, "transposes": transposes,
            "device_ms": sum(v["ms"] for v in kernels.values())}


def hourglass104_step(data_dir: str, work: str, device: str = "cuda"):
    """One bfloat16 step of ``cornerNetHourglass104`` (the published
    CornerNet, 200,941,456 parameters) on the archive's rows held on the
    card, after three warm steps: its boundary copies must be
    ``LAYOUT_COPIES``' and its kernels K2 8 a direction (a forward's four
    pools a kernel and the remat recompute's), K3 4 a direction and the
    render 2 (tl and br), exactly."""
    values = settings(HOURGLASS104_FULL, data_dir, work, residency="device")
    cfg = Configuration()
    cfg.update_config(values)
    with training_tf32(), training_backends(values["precision"]):
        factory = NetworkFactory(cfg, device=device)
        feed = iter(factory.dataset.epoch_local_indices(
            cfg.batchSize, 0, local_train=factory._local_train))
        for _ in range(3):
            factory.train_resident(next(feed))
        cuda_build.reset_launches()
        factory.train_resident(next(feed))
        copies = {k: v for k, v in cuda_build.LAYOUT_COPIES.items() if v}
        launches = {k: v for k, v in cuda_build.LAUNCHES.items() if v}
        params = factory.parameter_count
    want = {gaussian.KERNEL_NAME: 2,
            **{name: 8 for name in cp.KERNEL_NAMES.values()},
            **{name: 4 for name in cp.BWD_KERNEL_NAMES.values()}}
    log("cornerNetHourglass104: {} parameters; a bf16 step with remat "
        "launches {} (expected {}), layout copies {} (expected {})".format(
            params, launches, want, copies,
            LAYOUT_COPIES["cornerNetHourglass104"]))
    if params != 200_941_456:
        raise AssertionError("cornerNetHourglass104 has {} parameters, not "
                             "the paper's 200,941,456".format(params))
    if launches != want or copies != LAYOUT_COPIES["cornerNetHourglass104"]:
        raise AssertionError("cornerNetHourglass104: launches {}, layout "
                             "copies {} a step".format(launches, copies))
    return {"parameters": params, "launches": launches,
            "layout_copies": copies}


# steps of each configuration run back to back by check_feed after
# FEED_WARM warm steps, and the least share of exp74's that must be fed
# while the card still runs the previous step
FEED_STEPS = {EXP74: 30, CPOOL_BEST: 12, LEGACY_FULL: 4}
FEED_WARM, FEED_AHEAD_MIN = 3, 0.9


def check_feed(data_dir: str, work: str, device: str = "cuda"):
    """Resident bfloat16 steps of exp74, cpool_best and legacy_full
    (``FEED_STEPS``) back to back, untraced, under
    ``torch.cuda.set_sync_debug_mode("error")``: a synchronise anywhere
    in a step raises. The host must feed at least ``FEED_AHEAD_MIN`` of
    exp74's steps while the card still runs the previous one
    (``cuda_build.FEED``; the first step follows a synchronise, so it
    cannot). Returns each configuration's ms a step and share."""
    out = {}
    for config, steps in FEED_STEPS.items():
        values = settings(config, data_dir, work, residency="device")
        cfg = Configuration()
        cfg.update_config(values)
        with training_tf32(), training_backends(values["precision"]):
            factory = NetworkFactory(cfg, device=device)
            feed = resident_feed(factory, FEED_WARM + steps)
            for idx in feed[:FEED_WARM]:
                factory.train_resident(idx)
            torch.cuda.synchronize()
            cuda_build.reset_launches()
            t0 = time.perf_counter()
            torch.cuda.set_sync_debug_mode("error")
            try:
                for idx in feed[FEED_WARM:]:
                    factory.train_resident(idx)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / steps
        fed = dict(cuda_build.FEED)
        arch = values["modelName"]
        share = fed.get("ahead", 0) / max(fed.get("steps", 0), 1)
        log("{}: {} bf16 steps with no synchronise, {:.2f} ms a step, fed "
            "ahead of the card {} of {} ({:.3f})".format(
                arch, steps, ms, fed.get("ahead", 0), fed.get("steps", 0),
                share))
        if fed.get("steps") != steps:
            raise AssertionError("{}: the feed counted {} of {} steps".format(
                arch, fed.get("steps"), steps))
        if config == EXP74 and share < FEED_AHEAD_MIN:
            raise AssertionError("{}: the host fed {:.3f} of the steps ahead "
                                 "of the card, under {}".format(
                                     arch, share, FEED_AHEAD_MIN))
        out[arch] = {"steps": steps, "step_ms": ms, "feed_ahead_share": share}
    return out


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
        stats = {k: v.detach().cpu() for k, v in
                 factory.model.state_dict().items()
                 if k.endswith(("running_mean", "running_var",
                                "num_batches_tracked"))}
        out[run] = (loss.item(), factory._last_batch[1],
                    global_grad_norm(factory.model), grad, stats)
    targets = {True: [0, 4, 5], "legacy": [0, 1]}.get(
        card.profile.corner_targets, [0])
    heat_err = max(compare_heat(out["cuda"][1][i].cpu(), out["cpu"][1][i],
                                "train-step target {}".format(i))
                   for i in targets)
    # each BatchNorm moved once, as much on the card as on the CPU: a
    # remat recompute must not update the statistics a second time
    for key, want in out["cpu"][4].items():
        got = out["cuda"][4][key]
        if key.endswith("num_batches_tracked"):
            if not (int(got) == int(want) == 1):
                raise AssertionError("{}: {} is {} on the card, {} on the "
                                     "CPU".format(config, key, int(got),
                                                  int(want)))
        elif not torch.allclose(got, want, rtol=1e-4, atol=1e-5):
            raise AssertionError("{}: BatchNorm statistic {} differs by {}"
                                 .format(config, key,
                                         (got - want).abs().max().item()))
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


# -- 10. preprocess slides on the card, then train from the archive ---------------

def start_slides(slide_dir: str):
    """Write phase 10's seeded 3092x2056 slides and their label files
    (``data/synthetic.make_slide_and_annotation``) in a subprocess."""
    shutil.rmtree(slide_dir, ignore_errors=True)
    script = ("import sys\n"
              "from scd_resnet_tpu_torch.data.synthetic import "
              "make_slide_and_annotation\n"
              "for i in range(1, {n} + 1):\n"
              "    make_slide_and_annotation(sys.argv[1] + '/imgs', "
              "sys.argv[1] + '/ann', i, width={w}, height={h}, "
              "objects={o}, seed={seed})\n").format(
                  n=PRE_SLIDES, w=SLIDE_W, h=SLIDE_H, o=PRE_OBJECTS,
                  seed=PRE_SEED)
    return subprocess.Popen([sys.executable, "-c", script, slide_dir],
                            cwd=REPO, stdout=subprocess.DEVNULL)


def padded_slide(slide_dir: str, index: int) -> np.ndarray:
    """Slide ``index``'s grayscale reflect-padded by PRE_MARGIN, as
    ``generate_archive`` pads it."""
    left, top, right, bottom = (int(v) for v in PRE_MARGIN.split())
    rgb = np.asarray(Image.open(os.path.join(slide_dir, "imgs",
                                             "{}.png".format(index))))
    return np.pad(grayscale_preprocess(rgb), ((top, bottom), (left, right)),
                  mode="reflect").astype(np.float32)


def check_preprocess(slide_dir: str, work: str, gpu_line: str,
                     device: str = "cuda"):
    """Phase 10's preprocessing: the CLI on the card, then one slide's
    rotation batch on the card against the CPU (``device="cpu"``
    rehearses it on the CPU alone)."""
    shutil.rmtree(work, ignore_errors=True)
    archive = os.path.join(work, "data", "scdx16p100.d")
    os.makedirs(os.path.dirname(archive))
    out = port_cli("preprocess", archive, "-i", os.path.join(slide_dir,
                                                             "imgs"),
                   "-a", os.path.join(slide_dir, "ann"), "-s", str(CLIP),
                   "-m", PRE_MARGIN, "-v", "--device", device)
    summary = json.loads(out.strip().splitlines()[-1])
    pad_h, pad_w = padded_slide(slide_dir, 1).shape
    clips = REPEAT_GEN * (pad_h // CLIP) * (pad_w // CLIP)
    if summary["slides"] != PRE_SLIDES or summary["clips"] != \
            PRE_SLIDES * clips or summary["device"] != device:
        raise AssertionError("preprocessing wrote {}".format(summary))
    overlays = os.listdir(archive + ".debug")
    if len(overlays) != PRE_SLIDES * clips // REPEAT_GEN:
        raise AssertionError("{} overlays, expected {}".format(
            len(overlays), PRE_SLIDES * clips // REPEAT_GEN))
    log("preprocessing on {} ({}): {} slides {}x{} padded to {}x{} "
        "-> {} clips in {:.2f} s ({:.1f} clips/s); rotation batches (upload "
        "+ {} rotations, CUDA events) {} ms; writes {} s; peak device "
        "memory {} GB; {} overlays".format(
            device, gpu_line, summary["slides"], SLIDE_W, SLIDE_H, pad_w,
            pad_h,
            summary["clips"], summary["seconds"], summary["clips_per_s"],
            REPEAT_GEN, [round(s["rotation_ms"], 3)
                         for s in summary["per_slide"]],
            [round(s["write_s"], 3) for s in summary["per_slide"]],
            summary["peak_device_memory_gb"], len(overlays)))

    # slide 1's batch through the same helpers on the card and on the CPU
    padded = padded_slide(slide_dir, 1)
    angles = np.random.default_rng(42).uniform(0.0, 1.0, REPEAT_GEN) \
        * 30.0 - 15.0
    card = rotate_images_batch(padded, angles, torch.device(device))
    t0 = time.perf_counter()
    cpu = rotate_images_batch(padded, angles, torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    err = float((card.cpu() - cpu).abs().max())
    bound = rotation_tolerance(torch.from_numpy(padded), 15.0)
    with zipfile.ZipFile(archive) as zf:
        first = np.load(io.BytesIO(zf.read("samples/1.0.1.npy")))
    same_as_archive = np.array_equal(first, card[0, :CLIP, :CLIP].cpu()
                                     .numpy())
    locs = np.asarray(_replicate_mirrors(
        decode_annotations(os.path.join(slide_dir, "ann"), "1.png"),
        SLIDE_W, SLIDE_H), np.float32)
    card_locs, cpu_locs = (
        rotate_coords_batch(locs, pad_w / 8.0, pad_h / 8.0, angles,
                            torch.device(dev)) for dev in (device, "cpu"))
    loc_err = float(np.abs(card_locs - cpu_locs).max())
    # CUDA's float32 sin and cos are within 2 ulps, the CPU's within 1:
    # each product of a coordinate (up to M cells) by them may move by 3
    # ulps of M, and the sums around them round once each
    loc_bound = 8 * float(np.spacing(np.abs(cpu_locs).max()))
    log("slide 1's {} rotations, card against CPU ({:.1f} s there): max "
        "abs {:.6g} (bound {:.6g}, rotation_tolerance); the archive's first "
        "clip equals the card's rotation: {}; {} loc records, max abs "
        "{:.3g} cells (bound {:.3g}: 8 ulps of the largest, {:.1f})".format(
            REPEAT_GEN, cpu_s, err, bound, same_as_archive, len(locs),
            loc_err, loc_bound, float(np.abs(cpu_locs).max())))
    if not (err <= bound and loc_err <= loc_bound and same_as_archive):
        raise AssertionError("the card's preprocessing differs from the "
                             "CPU's")
    summary.update(rotation_card_vs_cpu_max_abs=err,
                   rotation_bound=bound, locs_card_vs_cpu_max_abs=loc_err,
                   locs_bound=loc_bound, cpu_rotation_s=cpu_s)
    return archive, summary


def train_preprocessed(archive: str, work: str, device: str = "cuda",
                       **overrides):
    """Phase 10's training: exp74's widths for PRE_STEPS steps from the
    archive the card wrote, with ``debug`` and a StepProfiler window; the
    counts are set to 0 just before the run and read just after (on the
    CPU, with ``overrides`` such as a small model, it rehearses the phase
    up to the launch counts)."""
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    data_dir = os.path.dirname(archive)
    trace_dir = os.path.join(work, "trace")
    values = settings(EXP74, data_dir, work, iterations=PRE_STEPS,
                      validation=PRE_VALIDATE_EVERY, snapshot=PRE_STEPS,
                      debug=True, **overrides)
    start, steps = PRE_PROFILE
    env = {"SCD_PROFILE_DIR": trace_dir, "SCD_PROFILE_START": str(start),
           "SCD_PROFILE_STEPS": str(steps)}
    os.environ.update(env)
    cuda_build.reset_launches()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    try:
        summary = train_cli.main([write_config(os.path.join(
            work, "config.json"), values), "--device", device])
    finally:
        for key in env:
            del os.environ[key]
    launches = dict(cuda_build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1024 ** 3 \
        if device == "cuda" else float("nan")
    with open(os.path.join(data_dir, "scdx16p100.split.json")) as f:
        split = json.load(f)
    n_val, n_train = len(split["validation"]), len(split["train16p100"])
    expected = expected_launches(values, PRE_STEPS, n_val, runs=1)

    name = values["trainName"]
    results = os.path.join(work, "results")
    losses = np.loadtxt(os.path.join(results, "losses.{}.{}.txt".format(
        name, PRE_STEPS)), delimiter=",", ndmin=2)
    evals = open(os.path.join(results, "evals.{}.txt".format(name))).read()
    it_lines = [line for line in evals.splitlines() if line.startswith("[It]")]
    overlays = sorted(os.listdir(os.path.join(results, "debug." + name)))
    want_overlays = sorted("it{:06d}.clip{}.png".format(it, j)
                           for it in range(PRE_VALIDATE_EVERY, PRE_STEPS + 1,
                                           PRE_VALIDATE_EVERY)
                           for j in range(4))
    traces = os.listdir(trace_dir)
    with open(os.path.join(trace_dir, traces[0])) as f:
        trace_names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    trace_kernels = {kernel: sorted(n for n in trace_names if kernel in n)
                     for kernel in PRE_TRACE_KERNELS}
    focal = losses[:, 2]
    log("exp74 from the preprocessed archive ({} training rows, {} "
        "validation clips): {} steps, {:.1f} clips/s ({:.1f} ms a step, "
        "validation, overlays and the trace included); focal {:.4f} (first "
        "5) -> {:.4f} (last 5); [It] {}; peak memory {:.2f} GB; overlays {};"
        " trace {} with {}; launches {} (expected {})".format(
            n_train, n_val,
            summary["steps"], summary["clips_per_s"],
            summary["seconds"] * 1e3 / max(summary["steps"], 1),
            focal[:5].mean(), focal[-5:].mean(),
            it_lines[-1].strip() if it_lines else None, peak_gb, overlays,
            traces, trace_kernels, launches, expected))
    if losses.shape[0] != PRE_STEPS or not np.isfinite(losses).all():
        raise AssertionError("loss rows missing or not finite")
    if not focal[-5:].mean() < focal[:5].mean():
        raise AssertionError("the focal loss did not fall")
    if len(it_lines) != PRE_STEPS // PRE_VALIDATE_EVERY or any(
            parse_metric_line(it_lines[-1], m) is None
            for m in ("mIoU", "AP50", "avgS")):
        raise AssertionError("[It] lines: {}".format(it_lines))
    if overlays != want_overlays:
        raise AssertionError("overlays {}, expected {}".format(
            overlays, want_overlays))
    if traces != ["trace.{}-{}.json".format(start, start + steps - 1)] or \
            not all(trace_kernels.values()):
        raise AssertionError("trace {} lacks a kernel: {}".format(
            traces, trace_kernels))
    if launches != expected:
        raise AssertionError("exp74 from the preprocessed archive launched "
                             "{}, expected {}".format(launches, expected))
    return {"arch": values["modelName"], "steps": summary["steps"],
            "clips_per_s": summary["clips_per_s"],
            "seconds": summary["seconds"], "validation_clips": n_val,
            "focal_first5": float(focal[:5].mean()),
            "focal_last5": float(focal[-5:].mean()),
            "it_line": it_lines[-1].strip(), "overlays": overlays,
            "trace": traces[0], "trace_kernels": trace_kernels,
            "launches": launches, "peak_memory_gb": peak_gb}


def check_archive_readers(archive: str):
    """Phase 10: the preprocessed archive through the host library's
    threaded reader and through the numpy reader: the same names and
    arrays to the bit; each reader's seconds (the archive was just
    written, so its pages are warm), the threads and the cores."""
    threads = native_io.reader_threads()
    got = {}
    for reader in ("native", "numpy"):
        t0 = time.perf_counter()
        arrays = read_archive(archive, reader, threads)
        got[reader] = (time.perf_counter() - t0, arrays)
    native, plain = got["native"][1], got["numpy"][1]
    equal = native[0] == plain[0] and all(
        a.dtype == b.dtype and a.shape == b.shape
        and a.tobytes() == b.tobytes() for a, b in zip(native[1:], plain[1:]))
    clips = len(native[0])
    out = {"clips": clips, "archive_mb": os.path.getsize(archive) / 1e6,
           "native_s": got["native"][0], "numpy_s": got["numpy"][0],
           "native_clips_per_s": clips / got["native"][0],
           "numpy_clips_per_s": clips / got["numpy"][0],
           "threads": threads, "cores": os.cpu_count()}
    log("archive readers on {} ({} clips of {}x{}, {:.1f} MB): host library "
        "{:.3f} s on {} threads ({:.0f} clips/s), numpy {:.3f} s ({:.0f} "
        "clips/s); {} cores; equal to the bit: {}".format(
            archive, clips, *native[1].shape[1:], out["archive_mb"],
            out["native_s"], threads, out["native_clips_per_s"],
            out["numpy_s"], out["numpy_clips_per_s"], out["cores"], equal))
    if not equal:
        raise AssertionError("the two readers read different arrays")
    return out


def train_host_streamed(archive: str, work: str, device: str = "cuda",
                        **overrides):
    """Phase 10: exp74's widths for HOST_STEPS steps from the archive the
    card wrote, read by the host library and streamed from the host
    (``residency: host``, each batch packed by its memcpy), validated at
    the last step, through the train entry point: losses finite, and the
    launch counts (set to 0 just before the run, read just after) exactly
    K1 HOST_STEPS + the validation chunks and K5 HOST_STEPS."""
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    data_dir = os.path.dirname(archive)
    values = settings(EXP74, data_dir, work, iterations=HOST_STEPS,
                      validation=HOST_STEPS, snapshot=HOST_STEPS,
                      residency="host", **overrides)
    cuda_build.reset_launches()
    summary = train_cli.main([write_config(os.path.join(
        work, "config.json"), values), "--device", device])
    launches = dict(cuda_build.LAUNCHES)
    with open(os.path.join(data_dir, "scdx16p100.split.json")) as f:
        n_val = len(json.load(f)["validation"])
    expected = expected_launches(values, HOST_STEPS, n_val, runs=1)
    losses = np.loadtxt(os.path.join(work, "results", "losses.{}.{}.txt"
                                     .format(values["trainName"],
                                             HOST_STEPS)),
                        delimiter=",", ndmin=2)
    log("exp74 streamed from the host ({} steps, batches packed by the "
        "host library): {:.1f} clips/s ({:.1f} ms a step, the validation "
        "included); losses finite: {}; launches {} (expected {})".format(
            summary["steps"], summary["clips_per_s"],
            summary["seconds"] * 1e3 / max(summary["steps"], 1),
            bool(np.isfinite(losses).all()), launches, expected))
    if losses.shape[0] != HOST_STEPS or not np.isfinite(losses).all():
        raise AssertionError("loss rows missing or not finite")
    if launches != expected:
        raise AssertionError("exp74 streamed from the host launched {}, "
                             "expected {}".format(launches, expected))
    return {"steps": summary["steps"], "clips_per_s": summary["clips_per_s"],
            "seconds": summary["seconds"], "launches": launches}


def check_psroi(gpu_line: str, device: str = "cuda"):
    """DCNPooling forward and backward on the card against the CPU, at
    x (2, 392, 128, 128) (an S/4 map of 512^2 clips, 8 channels x 7^2
    groups) and 256 ROIs, pooled 7 with 4 x 4 samples a bin.

    The pooling op (``ops/dcn.deform_psroi_pooling``) is held to float32
    summation bounds with the same displacements on both (the op computes
    its sample positions in the same float32 operations on both devices,
    so only the order of its sums differs): a bin sums at most 16 samples
    x 4 corners (the sum of magnitudes is the op on |x|, its weights
    being non-negative); an element of dx sums at most one term a (ROI,
    sample, corner), their magnitudes summing to dx of |g| at |x|; an
    element of dtrans one a (channel, sample, corner), their magnitudes
    summing to at most 4 max|x| roi_w trans_std sum_c |g| (a sample's
    corner weights change with its position at slopes summing to 2, and
    a bin divides by its count of samples). The module's displacements pass
    through three float32 matrix products (TF32 off): their error
    propagates as |W| e + 2 (K - 1) 2^-24 (|W| |h| + |b|) through each
    layer (ReLU does not widen it), and moves each sample by at most
    trans_std roi_w e, so a bin by at most 2 D that (D: x's largest
    neighbour difference)."""
    gen = torch.Generator().manual_seed(392)
    b, size, n = PSROI["batch"], PSROI["size"], PSROI["rois"]
    out_dim, g, p, spp = (PSROI[k] for k in ("output_dim", "group", "pooled",
                                             "samples"))
    x = torch.randn((b, out_dim * g * g, size, size), generator=gen)
    corner = torch.rand((n, 2), generator=gen) * (4 * size - 64)
    extent = 16 + torch.rand((n, 2), generator=gen) * 240
    rois = torch.cat([torch.randint(0, b, (n, 1), generator=gen).float(),
                      corner, corner + extent], 1)
    rois[:8, 1:] -= 48  # a few reach past the map's top-left
    ct = torch.randn((n, out_dim, p, p), generator=gen)
    module = DCNPooling(out_dim, pooled_size=p, group_size=g,
                        spatial_scale=0.25, sample_per_part=spp)
    with torch.no_grad():
        module.fc[4].weight.normal_(0, 0.01, generator=gen)
    pool_args = module.pool_args
    runs = {}
    for run, dev in (("card", device), ("cpu", "cpu")):
        rd, ctd = rois.to(dev), ct.to(dev)
        timer = None
        # on the card a first call loads the kernels; the second is timed
        for attempt in range(2 if dev == "cuda" else 1):
            mod = copy.deepcopy(module).to(dev)
            xd = x.detach().to(dev).requires_grad_(True)
            if attempt:
                torch.cuda.synchronize()
                timer = [torch.cuda.Event(enable_timing=True)
                         for _ in range(2)]
                timer[0].record()
            out = mod(xd, rd)
            out.backward(ctd)
            if timer:
                timer[1].record()
                torch.cuda.synchronize()
        base = deform_psroi_pooling(xd.detach(), rd, None, no_trans=True,
                                    **pool_args)
        trans = mod.fc(base.permute(0, 2, 3, 1).reshape(n, -1)).reshape(
            n, p, p, 2).permute(0, 3, 1, 2).detach()
        runs[run] = {
            "out": out.detach().cpu(), "dx": xd.grad.cpu(),
            "base": base.cpu(), "trans": trans.cpu(),
            "ms": timer[0].elapsed_time(timer[1]) if timer else None}
    # the op alone with the CPU's displacements, forward and backward
    shared = runs["cpu"]["trans"]
    op = {}
    for run, dev in (("card", device), ("cpu", "cpu")):
        xd = x.detach().to(dev).requires_grad_(True)
        td = shared.detach().to(dev).requires_grad_(True)
        out = deform_psroi_pooling(xd, rois.to(dev), td, **pool_args)
        out.backward(ct.to(dev))
        op[run] = (out.detach().cpu(), xd.grad.cpu(), td.grad.cpu())
    # the bounds, from the CPU's float32 quantities
    abs_pool = deform_psroi_pooling(x.abs(), rois, shared, **pool_args)
    # a bin's mean adds one rounding, its division, to its sum's
    fwd_bound = summation_bound_of(abs_pool, 4 * spp * spp + 1)
    xa = x.abs().requires_grad_(True)
    deform_psroi_pooling(xa, rois, shared, **pool_args).backward(ct.abs())
    dx_bound = summation_bound_of(xa.grad, n * 4 * spp * spp)
    roi_wh = torch.maximum(rois[:, 3] - rois[:, 1], rois[:, 4] - rois[:, 2]
                           ) * 0.25 + 0.25
    per_bin = 4 * x.abs().max() * roi_wh[:, None, None] * \
        pool_args["trans_std"] * ct.abs().sum(1)
    dtrans_bound = summation_bound_of(per_bin, out_dim * 4 * spp * spp)[
        :, None]
    # the displacement branch's propagated error
    h = runs["cpu"]["base"].permute(0, 2, 3, 1).reshape(n, -1).double()
    err = summation_bound_of(
        deform_psroi_pooling(x.abs(), rois, None, no_trans=True, **pool_args),
        4 * spp * spp + 1).permute(0, 2, 3, 1).reshape(n, -1).double()
    for layer in (module.fc[0], module.fc[2], module.fc[4]):
        w = layer.weight.detach().double()
        k = w.shape[1]
        err = err @ w.abs().T + summation_bound_of(
            h.abs() @ w.abs().T + layer.bias.detach().double().abs(), k)
        h = torch.relu(h @ w.T + layer.bias.detach().double())
    trans_bound = err.reshape(n, p, p, 2).permute(0, 3, 1, 2).float()
    d = max(float((x[..., 1:, :] - x[..., :-1, :]).abs().max()),
            float((x[..., :, 1:] - x[..., :, :-1]).abs().max()))
    move = (2 * d * pool_args["trans_std"] * roi_wh[:, None, None]
            * trans_bound.amax(1))[:, None]
    out_bound = fwd_bound + move

    def worst(got, want, bound):
        excess = ((got - want).abs() - bound).max().item()
        return float((got - want).abs().max()), excess

    checks = {
        "op_forward": worst(op["card"][0], op["cpu"][0], fwd_bound),
        "op_dx": worst(op["card"][1], op["cpu"][1], dx_bound),
        "op_dtrans": worst(op["card"][2], op["cpu"][2], dtrans_bound),
        "trans": worst(runs["card"]["trans"], runs["cpu"]["trans"],
                       trans_bound),
        "module_forward": worst(runs["card"]["out"], runs["cpu"]["out"],
                                out_bound)}
    moved = float((runs["cpu"]["out"] - runs["cpu"]["base"]).abs().max())
    log("DCNPooling x {} ROIs {} pooled {} x {} samples on the card ({}): "
        "forward + backward {} ms (CUDA events, after a first call); card "
        "against CPU, (max abs, max excess over the bound): {}; the "
        "displacements move the output by up to {:.4g}".format(
            tuple(x.shape), n, p, spp, gpu_line, runs["card"]["ms"], checks,
            moved))
    if not all(excess <= 0 for _, excess in checks.values()) or \
            not moved > 0 or not torch.isfinite(runs["card"]["dx"]).all():
        raise AssertionError("DCNPooling on the card differs from the CPU "
                             "beyond its bounds: {}".format(checks))
    return {"x": list(x.shape), "rois": n, "ms": runs["card"]["ms"],
            "max_abs": {k: v[0] for k, v in checks.items()},
            "output_moved_by_trans": moved}


# -- 11. the parallel layer: torchrun ranks, the model axis, the pipeline, mesh serving

MESH_TIMEOUT_S = 600  # one torchrun launch, start-up and every rank included
# --cards: a launch of three jobs took 49.4 s on two cards (NVIDIA H100
# 80GB HBM3, 700 W); a hung collective fails after 90 s
CARDS, CARDS_TIMEOUT_S, CARDS_COLLECTIVE_TIMEOUT_S = 4, 240, 90
NODE_STEPS = 4  # the two-node job's steps
STEP_SEED = 11  # the draws of phase 11's float32 steps
PIPE_STEPS, TORCHRUN_STEPS, TIMED_STEPS = 10, 20, 10
# one float32 exp74 step of two ranks on one card against one process:
# the loss and the BatchNorm statistics within phase 9's bounds for card
# against CPU (the same terms summed in another order); the gradients,
# |g_mesh - g| / |g| over all parameters, within 1e-2. The float32 step
# is that sensitive: the same step with its clips moved by PROBE_NUDGE
# relative moves the gradients by 1.7e-3 (the deconvolutions' weights
# most), as much as two ranks or two model shards do (1.6e-3, both on an
# NVIDIA H100 80GB HBM3 at 700 W, where a bound of 1e-3 failed); phase 11
# prints that probe beside the meshes' differences
STEP_LOSS_REL, STEP_GRAD_REL, STEP_STAT_RTOL, STEP_STAT_ATOL = \
    1e-4, 1e-2, 1e-4, 1e-5
# the pipelined hourglass2's float32 gradients against another order of
# the same sums (sequential_apply; the plain step, across cards), relative
# over all parameters
PIPE_GRAD_REL = 1e-5


def step_draws(device, batch: int, size: int):
    gen = torch.Generator(device=device).manual_seed(STEP_SEED)
    return draw(gen, batch, size, torch.device(device))


def one_step(values, device: str, nudge: float = 0.0):
    """One float32 step of the configuration ``values`` on the first
    global batch of epoch 0 with seeded draws (on a mesh: this rank's
    rows of them): the loss, the gradients in the plain layout and the
    BatchNorm statistics, on the host. ``nudge`` moves the clips by that
    much relative (seeded), as phase 9's probe does."""
    cfg = Configuration()
    cfg.update_config(values)
    with training_backends("float32"):
        factory = NetworkFactory(cfg, device=device)
        batch = next(factory.dataset.epoch_batches(cfg.batchSize, 0))
        if nudge:
            noise = np.random.default_rng(20).standard_normal(
                batch[0].shape)
            batch = ((batch[0] * (1 + nudge * noise)).astype(np.float32),
                     *batch[1:])
        cuda_build.reset_launches()
        loss, _ = factory.train(*batch, draws=step_draws(
            factory.device, cfg.batchSize, factory.sample_size))
        grads = full_gradients(factory.model, factory.sharded, factory.mesh)
    return {"loss": loss.item(),
            "grads": {k: g.cpu() for k, g in grads.items()},
            "stats": {k: v.cpu() for k, v in factory.model.state_dict().items()
                      if k.endswith(("running_mean", "running_var"))},
            "sharded": len(factory.sharded),
            "parameters": len(list(factory.model.parameters())),
            "placement": {k: str(p.device)
                          for k, p in factory.model.named_parameters()},
            "launches": dict(cuda_build.LAUNCHES)}


def resident_feed(factory, steps: int):
    """The first ``steps`` index vectors of the factory's resident
    epochs, as many epochs as that takes."""
    feed, epoch = [], 0
    while len(feed) < steps:
        feed += list(factory.dataset.epoch_local_indices(
            factory.config.batchSize, epoch,
            num_shards=factory.mesh.size("data") if factory.mesh else 1,
            local_train=factory._local_train))
        epoch += 1
    return feed[:steps]


def timed_steps(values, device: str, warm: int = 3, steps: int = TIMED_STEPS,
                overlap: bool = False):
    """``{"step_ms": ...}``: ms a step of ``values`` (residency device)
    over ``steps`` steps after ``warm``, host clock around steps ending
    in a synchronise of every card of the rank's stages. ``overlap``
    adds one more step's ``card_overlap`` of those cards."""
    cfg = Configuration()
    cfg.update_config(dict(values, residency="device"))
    with training_backends(values.get("precision", "float32")):
        factory = NetworkFactory(cfg, device=device)
        cards = factory.mesh.devices if factory.mesh else [factory.device]
        feed = resident_feed(factory, warm + steps + 1)
        for idx in feed[:warm]:
            factory.train_resident(idx)
        sync(cards)
        t0 = time.perf_counter()
        for idx in feed[warm:warm + steps]:
            factory.train_resident(idx)
        sync(cards)
        out = {"step_ms": (time.perf_counter() - t0) * 1e3 / steps}
        if overlap:
            out["overlap"] = card_overlap(
                lambda: factory.train_resident(feed[warm + steps]), cards)
    return out


def row_digests(samples, locs, counts):
    """One digest a row of a host batch: its clip's, records' and
    count's bytes."""
    return [hashlib.sha1(s.tobytes() + l.tobytes() + c.tobytes()).hexdigest()
            for s, l, c in zip(samples, locs, counts)]


def node_rows(values, device: str, backend: str, out: str):
    """A rank of the two-node job: the train entry point on ``values``
    (streamed from the host), recording the rows of each step it trains,
    and the rows its data-axis block of its node's batch must hold, by
    the plain rule from the dataset's order: node n of N reads
    ``order[n::N]`` of each (seed, 7919, epoch)-keyed shuffle, and every
    node takes as many batches as the smallest shard yields."""
    got, seen = [], {}
    train_rows = NetworkFactory.train_rows

    def recording(self, samples, locs, counts, draws=None):
        seen["factory"] = self
        got.append(row_digests(samples, locs, counts))
        return train_rows(self, samples, locs, counts, draws)

    NetworkFactory.train_rows = recording
    try:
        summary = train_cli.main([write_config(out + ".json", values),
                                  "--device", device, "--backend", backend])
    finally:
        NetworkFactory.train_rows = train_rows
    factory = seen["factory"]
    ds, batch = factory.dataset, factory.config.batchSize
    nodes, node = node_layout()
    per_epoch = len(ds.order) // nodes // batch
    per_rank = batch // factory._data_size
    first = factory._data_index * per_rank
    want = []
    for step in range(len(got)):
        epoch, k = divmod(step, per_epoch)
        order = np.asarray(ds.order)[np.random.default_rng(
            (ds._seed, 7919, epoch)).permutation(len(ds.order))]
        idx = order[node::nodes][k * batch:(k + 1) * batch][
            first:first + per_rank]
        want.append(row_digests(ds.samples[idx], ds.locs[idx],
                                ds.counts[idx]))
    return {"rank": factory.rank, "node": node, "nodes": nodes,
            "data_index": factory._data_index, "device": str(factory.device),
            "got": got, "want": want, "summary": summary}


def rank_job(spec_path: str) -> int:
    """A ``torchrun`` rank of phase 11 and ``--cards`` (``chip_smoke.py
    --rank-job spec.json``): joins the process group and runs the spec's
    jobs, a float32 ``one_step``, a timed window, a run of the train
    entry point with its launch counts, peak memory and a timed window,
    or the two-node job's rows (``node_rows``, which every rank writes,
    as ``<out>.rank<r>``); rank 0 writes each job's result. A job still running after the
    collective timeout prints every thread's stack (a hung collective
    raises on the rank that waits only after it), and so does a rank
    that aborts (NCCL's watchdog ends a rank whose collective timed
    out)."""
    with open(spec_path) as f:
        spec = json.load(f)
    faulthandler.enable()
    rank, _, _ = init_distributed(spec["device"], spec["backend"],
                                  spec["timeout_s"])
    try:
        for job in spec["jobs"]:
            print("[rank{}] job {}".format(rank, os.path.basename(
                job["out"])), flush=True)
            faulthandler.dump_traceback_later(spec["timeout_s"])
            if job["kind"] == "step":
                result = one_step(job["values"], spec["device"])
            elif job["kind"] == "timed":
                result = timed_steps(job["values"], spec["device"])
            elif job["kind"] == "rows":
                result = node_rows(job["values"], spec["device"],
                                   spec["backend"], job["out"] + ".rank{}"
                                   .format(rank))
                torch.save(result, job["out"] + ".rank{}".format(rank))
            else:
                path = write_config(job["out"] + ".json", job["values"])
                torch.cuda.reset_peak_memory_stats()
                cuda_build.reset_launches()
                summary = train_cli.main([path, "--device", spec["device"],
                                          "--backend", spec["backend"]])
                result = {"summary": summary,
                          "launches": dict(cuda_build.LAUNCHES),
                          "peak_memory_gb":
                              torch.cuda.max_memory_allocated() / 1024 ** 3}
                result.update(timed_steps(job["values"], spec["device"],
                                          overlap=job.get("overlap", False)))
            faulthandler.cancel_dump_traceback_later()
            if rank == 0:
                torch.save(result, job["out"])
    finally:
        torch.distributed.destroy_process_group()
    return 0


def torchrun(ranks: int, device: str, backend: str, jobs, work: str,
             timeout_s: float = MESH_TIMEOUT_S,
             collective_timeout_s: float = TIMEOUT_S, nodes: int = 1):
    """``jobs`` on ``ranks`` ranks started by ``torchrun`` (this script
    with ``--rank-job``); rank 0's results, one a job. The launch fails
    after ``timeout_s``, a collective after ``collective_timeout_s``.
    With ``nodes`` > 1, one ``torchrun`` agent a node (c10d rendezvous on
    this machine), each on its own cards (``CUDA_VISIBLE_DEVICES``) with
    ``ranks / nodes`` ranks."""
    spec = write_config(os.path.join(work, "ranks.json"), {
        "device": device, "backend": backend, "jobs": jobs,
        "timeout_s": collective_timeout_s})
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    # ranks that share a card with this process get the memory its
    # allocator caches from the earlier phases
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        log("torchrun: {} rank(s); {:.1f} of {:.1f} GB free on this "
            "process's card".format(ranks, free / 1024 ** 3,
                                    total / 1024 ** 3))
    per_node = ranks // nodes
    if nodes == 1:
        agents = [([sys.executable, "-m", "torch.distributed.run",
                    "--nnodes", "1", "--nproc_per_node", str(ranks),
                    "--master_addr", "127.0.0.1", "--master_port", str(port),
                    os.path.abspath(__file__), "--rank-job", spec], {})]
    else:
        agents = [([sys.executable, "-m", "torch.distributed.run",
                    "--nnodes", str(nodes), "--node-rank", str(n),
                    "--nproc-per-node", str(per_node), "--rdzv-backend",
                    "c10d", "--rdzv-endpoint", "127.0.0.1:{}".format(port),
                    "--rdzv-id", "chip_smoke", os.path.abspath(__file__),
                    "--rank-job", spec],
                   {"CUDA_VISIBLE_DEVICES": ",".join(
                       str(c) for c in range(n * per_node,
                                             (n + 1) * per_node))}
                   if device.startswith("cuda") else {})
                  for n in range(nodes)]
    logs = [os.path.join(work, "torchrun{}.log".format(n) if nodes > 1
                         else "torchrun.log") for n in range(nodes)]
    t0 = time.perf_counter()
    procs = []
    try:
        for (cmd, env), path in zip(agents, logs):
            with open(path, "w") as out:
                procs.append(subprocess.Popen(
                    cmd, stdout=out, stderr=subprocess.STDOUT,
                    start_new_session=True, env=dict(os.environ, **env)))
        deadline = time.monotonic() + timeout_s
        codes = []
        for proc in procs:
            try:
                codes.append(proc.wait(timeout=max(
                    deadline - time.monotonic(), 0.1)))
            except subprocess.TimeoutExpired:
                codes.append("timed out after {} s".format(timeout_s))
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.wait()
    code = next((c for c in codes if c != 0), 0) \
        if len(codes) == nodes else "an agent did not start"
    if code != 0:  # each rank's last lines: the first to fail is the cause
        lines = []
        for path in logs:
            with open(path) as f:
                lines += f.read().splitlines()
        tails = ["\n".join(line for line in lines
                           if line.startswith("[rank{}]".format(r)))[-2500:]
                 for r in range(ranks)]
        raise RuntimeError("torchrun ({} ranks, {}) failed ({}):\n{}\n{}".format(
            ranks, backend, code, "\n".join(tails),
            "\n".join(lines)[-6000:]))
    log("torchrun: {} rank(s) on {} over {} in {:.1f}s".format(
        ranks, device, backend, time.perf_counter() - t0))
    return [torch.load(job["out"], weights_only=False) for job in jobs]


def compare_steps(got, want, what: str, exact: bool = False,
                  bounded: bool = True):
    """A mesh's float32 step against the single-process step: to the bit,
    within the ``STEP_*`` bounds, or (not ``bounded``) measured only."""
    num = math.sqrt(sum(float((got["grads"][k].double()
                               - g.double()).pow(2).sum())
                        for k, g in want["grads"].items()))
    den = math.sqrt(sum(float(g.double().pow(2).sum())
                        for g in want["grads"].values()))
    loss_rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    stat_err = max(float((got["stats"][k] - v).abs().max())
                   for k, v in want["stats"].items())
    out = {"loss": got["loss"], "loss_single": want["loss"],
           "loss_rel": loss_rel, "grad_rel": num / den,
           "stats_max_abs": stat_err}
    if exact:
        same = (got["loss"] == want["loss"] and all(
            torch.equal(got["grads"][k], g) for k, g in want["grads"].items())
            and all(torch.equal(got["stats"][k], v)
                    for k, v in want["stats"].items()))
        if not same:
            raise AssertionError("{}: not bit-equal to the single-process "
                                 "step: {}".format(what, out))
    elif bounded:
        for k, v in want["stats"].items():
            if not torch.allclose(got["stats"][k], v, rtol=STEP_STAT_RTOL,
                                  atol=STEP_STAT_ATOL):
                raise AssertionError("{}: BatchNorm statistic {} differs "
                                     "beyond the bound".format(what, k))
        if not (loss_rel <= STEP_LOSS_REL and num / den <= STEP_GRAD_REL):
            raise AssertionError("{}: beyond the bound: {}".format(what, out))
    kind = "bit-equal" if exact else "measured" if not bounded else \
        "bounds: loss {}, gradients {}".format(STEP_LOSS_REL, STEP_GRAD_REL)
    log("{}: loss {!r} against {!r} (rel {:.2e}), gradients rel {:.2e}, "
        "BatchNorm statistics max abs {:.2e} ({})".format(
            what, got["loss"], want["loss"], loss_rel, num / den, stat_err,
            kind))
    return out


def check_torchrun(data_dir: str, work: str, n_val: int):
    """11 (a), (b): exp74 under torchrun. One rank on NCCL: a float32 step
    equal to the single-process step to the bit, then 20 bf16 steps
    through the train entry point (K1 and K5 exact). Two ranks sharing
    cuda:0 over gloo: ``meshShape [2]`` and ``[1, 2]`` (data x model),
    one float32 step each within the ``STEP_*`` bounds."""
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    step_values = settings(EXP74, data_dir, os.path.join(work, "single"),
                           precision="float32", residency="host")
    single = one_step(step_values, "cuda")
    nudged = compare_steps(one_step(step_values, "cuda", nudge=PROBE_NUDGE),
                           single, "exp74, one process, float32 step on "
                           "the clips moved by {:g}".format(PROBE_NUDGE),
                           bounded=False)
    one_rank = torchrun(1, "cuda", "nccl", [
        {"kind": "step", "values": dict(step_values, dirTemp=os.path.join(
            work, "nccl_step/")), "out": os.path.join(work, "nccl_step.pt")},
        {"kind": "train", "values": settings(
            EXP74, data_dir, os.path.join(work, "nccl_train"),
            iterations=TORCHRUN_STEPS, validation=TORCHRUN_STEPS,
            snapshot=TORCHRUN_STEPS),
         "out": os.path.join(work, "nccl_train.pt")}], work)
    nccl_step = compare_steps(one_rank[0], single, "exp74, torchrun 1 rank "
                              "(NCCL), float32 step", exact=True)
    train = one_rank[1]
    expected = expected_launches(dict(settings(EXP74, data_dir, work),
                                      validation=TORCHRUN_STEPS),
                                 TORCHRUN_STEPS, n_val, runs=1)
    if train["launches"] != expected:
        raise AssertionError("exp74 under torchrun launched {}, expected "
                             "{}".format(train["launches"], expected))
    log("exp74, torchrun 1 rank (NCCL), {} bf16 steps: {:.2f} ms a step "
        "({} steps timed after 3), {:.1f} clips/s over the run with its "
        "validation, peak memory {:.2f} GB; launches {} (expected)".format(
            TORCHRUN_STEPS, train["step_ms"], TIMED_STEPS,
            train["summary"]["clips_per_s"], train["peak_memory_gb"],
            train["launches"]))
    two = torchrun(2, "cuda:0", "gloo", [
        {"kind": "step", "values": dict(step_values, meshShape=[2],
                                        dirTemp=os.path.join(work, "dp/")),
         "out": os.path.join(work, "dp_step.pt")},
        {"kind": "step", "values": dict(step_values, meshShape=[1, 2],
                                        meshAxes=["data", "model"],
                                        dirTemp=os.path.join(work, "tp/")),
         "out": os.path.join(work, "tp_step.pt")}], work)
    dp = compare_steps(two[0], single, "exp74, 2 ranks on cuda:0 (gloo), "
                       "meshShape [2], float32 step", exact=False)
    tp = compare_steps(two[1], single, "exp74, 2 ranks on cuda:0 (gloo), "
                       "meshShape [1, 2] data x model, float32 step",
                       exact=False)
    log("the model axis sharded {} of {} parameters over 2 ranks".format(
        two[1]["sharded"], two[1]["parameters"]))
    if not two[1]["sharded"]:
        raise AssertionError("the model axis sharded no parameter")
    return ({"nudged_step": nudged, "nccl_step": nccl_step,
             "nccl_train": {
                k: train[k] for k in ("summary", "step_ms", "peak_memory_gb")},
             "dp_step": dp, "tp_step": tp, "tp_sharded": two[1]["sharded"],
             "parameters": two[1]["parameters"]},
            train["launches"], two[0]["launches"])


def check_pipeline(data_dir: str, work: str, n_val: int,
                   device: str = "cuda:0"):
    """11 (c), and ``--cards`` with ``device="cuda"``: hourglass2_best
    with ``meshShape [1, 2]`` (data x pipe), batch 32, its stages on
    ``stage_devices(device, 2, 0)`` (both on cuda:0, or cuda:0 and
    cuda:1): one float32 step with one microbatch against the plain step
    on cuda:0, equal to the bit on one card; four microbatches against
    ``sequential_apply`` (heads to the bit, gradients within
    ``PIPE_GRAD_REL``); then 10 bf16 steps through the train entry point
    (K1 exact), a timed window, each card's peak memory and, across
    cards, one step's ``card_overlap``.

    Across cards the one-microbatch step's forward (loss, BatchNorm
    statistics) must still equal the plain step's to the bit, and its
    gradients lie within ``PIPE_GRAD_REL``: autograd runs each card's
    part of the backward on that card's own thread, so a tensor read by
    stage 0's heads and by the stage-1 path sums its gradients in the
    order they arrive, not in the single thread's order. It prints how
    many gradient tensors of each card's stage differ and whether a
    second run repeats the first to the bit."""
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    pipe = {"meshShape": [1, 2], "meshAxes": ["data", "pipe"]}
    cards = sorted({str(d) for d in stage_devices(device, 2, 0)})
    where = " and ".join(cards)
    values = settings(HOURGLASS2_BEST, data_dir, os.path.join(work, "step"),
                      precision="float32", residency="host")
    plain = one_step(values, "cuda:0")
    m1_values = dict(values, pipelineMicrobatches=1, **pipe)
    piped = one_step(m1_values, device)
    what = "hourglass2_best, data x pipe [1, 2] on {}, 1 microbatch, " \
        "float32 step".format(where)
    m1 = compare_steps(piped, plain, what, exact=len(cards) == 1,
                       bounded=False)
    if len(cards) > 1:
        again = one_step(m1_values, device)
        m1["repeats_to_the_bit"] = all(
            torch.equal(again["grads"][k], g)
            for k, g in piped["grads"].items())
        m1["differing_gradients"] = {card: [0, 0] for card in cards}
        for name, card in piped["placement"].items():
            m1["differing_gradients"][card][1] += 1
            if not torch.equal(piped["grads"][name], plain["grads"][name]):
                m1["differing_gradients"][card][0] += 1
        log("{}: gradient tensors differing from the plain step's, of each "
            "card's stage: {}; a second run repeats the first to the bit: "
            "{}".format(what, m1["differing_gradients"],
                        m1["repeats_to_the_bit"]))
        if not (piped["loss"] == plain["loss"] and all(
                torch.equal(piped["stats"][k], v)
                for k, v in plain["stats"].items())
                and m1["grad_rel"] <= PIPE_GRAD_REL):
            raise AssertionError("{}: beyond its bounds: {}".format(what, m1))
    # four microbatches against the sequential loop, on one batch
    cfg = Configuration()
    cfg.update_config(dict(values, pipelineMicrobatches=4, **pipe))
    with training_backends("float32"):
        factory = NetworkFactory(cfg, device=device)
        model, devices = factory.model, factory.mesh.devices
        batch = cfg.batchSize
        samples, locs, counts = next(factory.dataset.epoch_batches(batch, 0))
        xs, _ = augment_and_render_batch(
            *(torch.as_tensor(a).to(devices[0]) for a in (samples, locs,
                                                          counts)),
            factory.heat_size, draws=step_draws(devices[0], batch,
                                                factory.sample_size))
        stages = [StackStage(model, s) for s in range(model.stacks)]
        runs = {}
        for name in ("pipeline", "sequential"):
            model.zero_grad(set_to_none=True)
            inter = model.preprocess(xs)
            mbs = inter.reshape((4, batch // 4) + tuple(inter.shape[1:]))
            heads = pipeline_apply(stages, mbs, devices) \
                if name == "pipeline" else sequential_apply(stages, mbs,
                                                            devices)
            sum((h.double() ** 2).sum() for h in heads.values()).backward()
            runs[name] = ({k: v.detach() for k, v in heads.items()},
                          {n: p.grad.clone() for n, p in
                           model.named_parameters()})
        sync(devices)
    (h_p, g_p), (h_s, g_s) = runs["pipeline"], runs["sequential"]
    num = math.sqrt(sum(float((g_p[k].double() - g.double()).pow(2).sum())
                        for k, g in g_s.items()))
    den = math.sqrt(sum(float(g.double().pow(2).sum()) for g in g_s.values()))
    heads_equal = all(torch.equal(h_p[k], h_s[k]) for k in h_s)
    log("hourglass2_best, 4 microbatches of 8 on {}: heads {} to "
        "sequential_apply's, gradients rel {:.2e}".format(
            where, "bit-equal" if heads_equal else "NOT equal", num / den))
    if not (heads_equal and num / den <= PIPE_GRAD_REL):
        raise AssertionError("the pipeline differs from sequential_apply")
    del factory, model, runs
    # 10 bf16 steps through the train entry point
    run_values = settings(HOURGLASS2_BEST, data_dir, os.path.join(work, "run"),
                          iterations=PIPE_STEPS, validation=PIPE_STEPS,
                          snapshot=PIPE_STEPS, pipelineMicrobatches=4, **pipe)
    for card in cards:
        torch.cuda.reset_peak_memory_stats(card)
    cuda_build.reset_launches()
    summary = train_cli.main([write_config(os.path.join(work, "run.json"),
                                           run_values), "--device", device])
    launches = dict(cuda_build.LAUNCHES)
    peak = {card: torch.cuda.max_memory_allocated(card) / 1024 ** 3
            for card in cards}
    expected = expected_launches(run_values, PIPE_STEPS, n_val, runs=1)
    if launches != expected:
        raise AssertionError("the pipelined hourglass2 launched {}, expected "
                             "{}".format(launches, expected))
    timed = timed_steps(run_values, device, overlap=len(cards) > 1)
    log("hourglass2_best, data x pipe [1, 2] on {}, 4 microbatches, {} "
        "bf16 steps: {:.2f} ms a step ({} timed after 3), {:.1f} clips/s "
        "over the run with its validation, peak memory {} GB; launches "
        "{} (expected){}".format(
            where, PIPE_STEPS, timed["step_ms"], TIMED_STEPS,
            summary["clips_per_s"],
            {card: round(gb, 2) for card, gb in peak.items()}, launches,
            "; one step's cards: {}".format(timed["overlap"])
            if "overlap" in timed else ""))
    return (dict(timed, m1_step=m1, m4_grad_rel=num / den,
                 clips_per_s=summary["clips_per_s"], peak_memory_gb=peak),
            launches)


def check_mesh_serving(slide, build_dir):
    """11 (d): ``cornerCPoolRes10`` and ``centerOffsetRes10`` (the served
    checkpoints) through ``make_device_analyzer(mesh=["cuda:0",
    "cuda:0"])``: 24 + 24 clips, detections equal to the monolithic
    analyzer's, K2 8 launches a corner request."""
    out, corner_launches = {}, None
    for arch in ("cornerCPoolRes10", "centerOffsetRes10"):
        wrapper = load_wrapper(os.path.join(build_dir, arch + ".pt"), arch)
        mono = make_device_analyzer(wrapper, SLIDE_W, SLIDE_H)
        mesh = make_device_analyzer(wrapper, SLIDE_W, SLIDE_H,
                                    mesh=["cuda:0", "cuda:0"])
        want = mono(slide)
        mesh(slide)  # first call: cuDNN's algorithm choice
        torch.cuda.synchronize()
        cuda_build.reset_launches()
        t0 = time.perf_counter()
        got = mesh(slide)
        ms = (time.perf_counter() - t0) * 1e3
        launches = dict(cuda_build.LAUNCHES)
        per_forward = pool_launches_per_forward(arch)
        only(launches, {name: 2 * per_forward
                        for name in cp.KERNEL_NAMES.values()})
        if not want or got != want:
            raise AssertionError("{}: mesh detections ({}) differ from the "
                                 "monolithic ones ({})".format(
                                     arch, len(got), len(want)))
        log("{} over mesh [cuda:0, cuda:0]: {} detections, equal to the "
            "monolithic analyzer's; {:.1f} ms a request; K2 {} "
            "launches".format(arch, len(got), ms, k2_launches(launches)))
        out[arch] = {"detections": len(got), "ms": ms}
        if per_forward:
            corner_launches = launches
    return out, corner_launches


# 11 (e): slides of 6, 20 and 35 clips (width, height): under the batch of
# 24, and above it by a number that no batch or shard of 24 divides
SMALL_SLIDES = ((1024, 768), (2048, 1536), (2560, 1792))


def rows_of(inflight, n_clips: int, axis: int) -> torch.Tensor:
    """The host rows of an analyzer's ``dispatch`` (a mesh's shards
    concatenated and cut to the slide's clips)."""
    rows = inflight[0]
    if isinstance(rows, list):
        rows = torch.cat([r.cpu() for r in rows], axis).narrow(axis, 0,
                                                              n_clips)
    return rows.cpu()


def check_small_slides(build_dir, device: str = "cuda:0",
                       archs=("cornerCPoolRes10", "centerOffsetRes10")):
    """11 (e): ``cornerCPoolRes10`` and ``centerOffsetRes10`` (the served
    checkpoints) on the ``SMALL_SLIDES``: the monolithic analyzer's rows
    (the slide padded to a multiple of 24 clips) equal to the bit to
    those of ``mesh=["cuda:0", "cuda:0"]`` (each shard padded alike) and
    its detections equal; the host-tiled ``analyse_grayscale`` (fixed
    batch of 24; the host standardises its clips within 1e-4 of the
    card's) within ``compare_rows``' bounds of them. Each path's ms a
    request (after one request), and for a clip count off a multiple of
    24 the forward's ms padded and unpadded and the largest difference
    of the unpadded rows from the padded ones. Every comparison is made
    and printed before a failed one raises."""
    out, failed = {}, []
    device = torch.device(device)
    for arch in archs:
        wrapper = load_wrapper(os.path.join(build_dir, arch + ".pt"), arch,
                               device)
        family, axis = wrapper.contract, _batch_axis(wrapper.contract)
        for width, height in SMALL_SLIDES:
            slide = synthetic_slide(height, width, seed=width + height)
            clip_h, clip_v = slide_geometry(width, height)[:2]
            n = clip_h * clip_v
            name = "{} {}x{} ({} clips)".format(arch, width, height, n)
            res = {"clips": n}
            rows, found = {}, {}
            for path, analyse in (
                    ("monolithic", make_device_analyzer(wrapper, width,
                                                        height)),
                    ("mesh", make_device_analyzer(
                        wrapper, width, height, mesh=[device, device]))):
                analyse(slide)  # first request: cuDNN's algorithm choice
                sync([device])
                t0 = time.perf_counter()
                inflight = analyse.dispatch(slide)
                found[path] = analyse.finish(inflight)
                res[path + "_ms"] = (time.perf_counter() - t0) * 1e3
                rows[path] = rows_of(inflight, n, axis)
            gray = slide.astype(np.float32)
            t0 = time.perf_counter()
            found["host"] = analyse_grayscale(wrapper, gray,
                                              batch_size=BATCH_SIZE,
                                              bounds="slide")
            res["host_ms"] = (time.perf_counter() - t0) * 1e3
            with torch.inference_mode():
                rows["host"] = torch.from_numpy(np.concatenate(
                    _batched_rows(wrapper, tile_slide(gray)[0], BATCH_SIZE,
                                  axis), axis))
            res["detections"] = {k: len(v) for k, v in found.items()}
            res["mesh_rows_equal"] = torch.equal(rows["mesh"],
                                                 rows["monolithic"])
            res["mesh_detections_equal"] = found["mesh"] == found["monolithic"]
            res["host_detections_equal"] = found["host"] == found["monolithic"]
            res["host_positions_equal"] = [d[:2] for d in found["host"]] == \
                [d[:2] for d in found["monolithic"]]
            res["host_rows_max_abs"] = float(
                (rows["host"].double() - rows["monolithic"].double())
                .abs().max())
            try:
                res["host_rows_checked"] = compare_rows(
                    family, rows["monolithic"], rows["host"])
            except AssertionError as err:
                res["host_rows_checked"] = str(err)
                failed.append("{}: host-tiled rows: {}".format(name, err))
            if not (res["mesh_rows_equal"] and res["mesh_detections_equal"]
                    and found["monolithic"]):
                failed.append("{}: the mesh's rows or detections differ "
                              "from the monolithic ones".format(name))
            if n % BATCH_SIZE:
                with torch.inference_mode():
                    clips = make_device_tiler(width, height, device)(
                        torch.from_numpy(slide).to(device))
                    padded = torch.cat([clips, clips.new_zeros(
                        (-n % BATCH_SIZE, *clips.shape[1:]))])
                    for key, batch in (("padded", padded),
                                       ("unpadded", clips)):
                        wrapper(batch)
                        sync([device])
                        t0 = time.perf_counter()
                        got = wrapper(batch)
                        sync([device])
                        res[key + "_forward_ms"] = \
                            (time.perf_counter() - t0) * 1e3
                        if key == "unpadded":
                            diff = (got.double() - rows["monolithic"].to(
                                device).double()).abs().max()
                            res["unpadded_rows_max_abs"] = float(diff)
            log("{}: {}".format(name, json.dumps(res)))
            out[name] = res
    if failed:
        raise AssertionError("\n".join(failed))
    return out


# -- 12. the F1 pipeline through the port's CLIs, and the load test -------------

def log_tail(path: str, chars: int = 6000) -> str:
    with open(path) as f:
        return f.read()[-chars:]


def f1_pipeline_cmd(work: str, stage: str, device: str = "cuda"):
    """One stage of phase 12's cut of ``tools/f1_pipeline``."""
    return [sys.executable, "-m", "scd_resnet_tpu_torch.tools.f1_pipeline",
            "--root", os.path.join(work, "f1_smoke"), "--stage", stage,
            "--device", device, "--train-slides", str(F1_TRAIN_SLIDES),
            "--test-slides", str(F1_TEST_SLIDES), "--iters", str(F1_ITERS)]


def start_f1_gen(work: str):
    """Phase 12's gen stage (slides and label files, on the host) in a
    subprocess, started in phase 1 beside the other writers."""
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    with open(os.path.join(work, "gen.log"), "w") as out:
        return subprocess.Popen(f1_pipeline_cmd(work, "gen"), cwd=REPO,
                                stdout=out, stderr=subprocess.STDOUT)


def check_f1_pipeline(work: str, gen, device: str = "cuda"):
    """Phase 12: ``python -m scd_resnet_tpu_torch.tools.f1_pipeline`` at
    the reduced scale, its gen stage started in phase 1 (``gen``, from
    :func:`start_f1_gen`) and each later stage an invocation of its own,
    every stage a port CLI in its own process on ``device``, with a
    ``StepProfiler`` window over the train stage. The train stage's
    process starts with every count at 0 and reports its counts in its
    summary (``stages.json``), which must be exactly K1 once a step and a
    validation pre-render chunk and K5 once a step, and nothing else;
    its trace must name both kernels. Returns the phase's record and
    those counts."""
    root = os.path.join(work, "f1_smoke")
    trace_dir = os.path.join(work, "trace")
    start, steps = F1_PROFILE
    env = dict(os.environ, SCD_PROFILE_DIR=trace_dir,
               SCD_PROFILE_START=str(start), SCD_PROFILE_STEPS=str(steps))
    log("F1 pipeline cuts: {} train slides x 40 objects (seed 100), {} "
        "held-out x 10 (seed 5000), {} iterations (the full run: 16, 60, "
        "3000)".format(F1_TRAIN_SLIDES, F1_TEST_SLIDES, F1_ITERS))
    t0 = time.perf_counter()
    if gen.wait(timeout=900) != 0:
        raise AssertionError("the F1 pipeline's gen stage exited {}:\n{}"
                             .format(gen.returncode, log_tail(os.path.join(
                                 work, "gen.log"))))
    if device == "cuda":  # the stages' processes share this card
        torch.cuda.empty_cache()
    for stage in ("preprocess", "train", "serve", "eval"):
        log_path = os.path.join(work, stage + ".log")
        with open(log_path, "w") as out:
            code = subprocess.run(f1_pipeline_cmd(work, stage, device),
                                  cwd=REPO, env=env, stdout=out,
                                  stderr=subprocess.STDOUT,
                                  timeout=900).returncode
        if code != 0:
            raise AssertionError("the F1 pipeline's {} stage exited {}; its "
                                 "log ends:\n{}".format(stage, code,
                                                        log_tail(log_path)))
    seconds = time.perf_counter() - t0
    with open(os.path.join(root, "stages.json")) as f:
        stages = json.load(f)
    with open(os.path.join(root, "report.json")) as f:
        report = json.load(f)
    with open(os.path.join(root, "f1.json")) as f:
        values = json.load(f)
    with open(os.path.join(root, "data", "scdx16p100.split.json")) as f:
        n_val = len(json.load(f)["validation"])
    train = stages["train"]["summary"]
    expected = expected_launches(values, F1_ITERS, n_val, runs=1)
    launches = {name: train["launches"].get(name, 0) for name in expected}
    extra = {name: count for name, count in train["launches"].items()
             if name not in expected and count}
    traces = os.listdir(trace_dir)
    with open(os.path.join(trace_dir, traces[0])) as f:
        trace_names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    trace_kernels = {kernel: sorted(n for n in trace_names if kernel in n)
                     for kernel in PRE_TRACE_KERNELS}
    stage_seconds = {stage: stages[stage]["seconds"]
                     for stage in f1_pipeline.STAGES}
    for row in report["table"]:
        log("F1 dedupe {dedupe:g} px, {path}: TP {tp} FP {fp} FN {fn} "
            "P {precision} R {recall} F1 {f1}".format(**row))
    log("F1 pipeline in {:.1f} s after gen: stages {} s (serve: {}); "
        "traced against live {:.3%} identical, max Rhr deviation {}; train "
        "{} steps, {:.1f} clips/s; {} validation clips; trace {} with {}; "
        "launches {} (expected {})".format(
            seconds, stage_seconds, stages["serve"]["commands_seconds"],
            report["equality_rate"], report["max_rhr_deviation"],
            train["steps"], train["clips_per_s"], n_val, traces,
            trace_kernels, launches, expected))
    if report["equality_rate"] < f1_pipeline.EQUALITY_MIN:
        raise AssertionError("traced and live agree on {:.3%} of detections"
                             .format(report["equality_rate"]))
    if train["steps"] != F1_ITERS:
        raise AssertionError("the train stage ran {} steps".format(
            train["steps"]))
    if traces != ["trace.{}-{}.json".format(start, start + steps - 1)] or \
            not all(trace_kernels.values()):
        raise AssertionError("trace {} lacks a kernel: {}".format(
            traces, trace_kernels))
    if launches != expected or extra:
        raise AssertionError("the F1 train stage launched {} (and {}), "
                             "expected {}".format(launches, extra, expected))
    load = check_loadtest(root, work, device)
    return {"seconds": seconds, "stages_seconds": stage_seconds,
            "serve_commands_seconds": stages["serve"]["commands_seconds"],
            "preprocess": stages["preprocess"]["summary"],
            "train": {k: train[k] for k in ("steps", "seconds",
                                            "clips_per_s")},
            "validation_clips": n_val, "report": report,
            "trace_kernels": trace_kernels, "loadtest": load}, launches


def check_loadtest(root: str, work: str, device: str = "cuda"):
    """``python -m scd_resnet_tpu_torch.serve`` on the F1 pipeline's
    snapshot (warmed up at the held-out slides' size), then ``python -m
    scd_resnet_tpu_torch.tools.loadtest`` against it with held-out slide
    1: F1_REQUESTS requests, F1_CONCURRENCY at a time, no server error.
    The daemon is stopped whatever happens."""
    args = f1_pipeline.parse_args(["--root", root, "--iters", str(F1_ITERS)])
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    url = "http://127.0.0.1:{}".format(port)
    width, height = f1_pipeline.SLIDE_SIZE
    t0 = time.perf_counter()
    with open(os.path.join(work, "serve.log"), "w") as out:
        daemon = subprocess.Popen(
            [sys.executable, "-m", "scd_resnet_tpu_torch.serve", "-c",
             f1_pipeline.snapshot_path(args), "-a", args.arch, "--device",
             device, "--port", str(port), "--warmup",
             "{}x{}".format(width, height)],
            cwd=REPO, stdout=out, stderr=subprocess.STDOUT)
        try:
            while True:
                if daemon.poll() is not None:
                    raise AssertionError("the daemon exited {}:\n{}".format(
                        daemon.returncode,
                        log_tail(os.path.join(work, "serve.log"))))
                try:
                    with urllib.request.urlopen(url + "/healthz",
                                                timeout=5) as resp:
                        resp.read()
                    break
                except OSError:
                    if time.perf_counter() - t0 > 300:
                        raise
                    time.sleep(0.5)
            ready = time.perf_counter() - t0
            proc = subprocess.run(
                [sys.executable, "-m", "scd_resnet_tpu_torch.tools.loadtest",
                 "--url", url, "--image",
                 os.path.join(root, "test_imgs", "1.png"),
                 "--requests", str(F1_REQUESTS),
                 "--concurrency", str(F1_CONCURRENCY)],
                cwd=REPO, capture_output=True, text=True, timeout=600)
        finally:
            daemon.terminate()
            try:
                daemon.wait(timeout=30)
            except subprocess.TimeoutExpired:
                daemon.kill()
                daemon.wait()
    if proc.returncode != 0:
        raise AssertionError("loadtest failed ({}):\n{}".format(
            proc.returncode, proc.stderr[-4000:]))
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    log("loadtest on the F1 snapshot ({}x{} PNG, {} requests, {} at a time; "
        "daemon ready in {:.1f} s): p50 {} ms, p90 {} ms, max {} ms, {} "
        "clips/s, {} requests/s, server errors {}".format(
            width, height, F1_REQUESTS, F1_CONCURRENCY, ready,
            result["latency_p50_ms"], result["latency_p90_ms"],
            result["latency_max_ms"], result["clips_per_second"],
            result["requests_per_second"], result["server_errors"]))
    if result["server_errors"] != 0 or result["requests"] != F1_REQUESTS:
        raise AssertionError("loadtest: {}".format(result))
    return dict(result, daemon_ready_seconds=ready)


def served_checkpoints(slide, build_dir):
    """``cornerCPoolRes10`` and ``centerOffsetRes10`` with the seeded
    weights phase 6 serves (seeds 10 and 11 on ``slide``), written as
    ``build_dir/{arch}.pt``."""
    clips = make_device_tiler(slide.shape[1], slide.shape[0],
                              torch.device("cuda:0"))(
        torch.from_numpy(slide).to("cuda:0"))
    for arch, seed in (("cornerCPoolRes10", 10), ("centerOffsetRes10", 11)):
        save_checkpoint(os.path.join(build_dir, arch + ".pt"), arch,
                        seeded_model(arch, seed, clips).state_dict())


def cards_steps(ranks: int, shapes, data_dir: str, work: str, single):
    """exp74 on ``ranks`` NCCL ranks, a card each: a float32 step on each
    mesh of ``shapes`` against the single-process step within the
    ``STEP_*`` bounds, then 4 bf16 steps of the train entry point on
    ``[ranks]`` (a validation at step 4, its rows gathered, and a
    snapshot) and its timed window at the global batch of 32."""
    jobs = [{"kind": "step", "values": dict(
        single["values"], meshShape=shape, dirTemp=os.path.join(
            work, "{}x{}/".format(ranks, k))),
        "out": os.path.join(work, "step_{}x{}.pt".format(ranks, k))}
        for k, shape in enumerate(shapes)]
    jobs.append({"kind": "train", "values": dict(settings(
        EXP74, data_dir, os.path.join(work, "train{}".format(ranks)),
        iterations=4, validation=4, snapshot=4), meshShape=[ranks]),
        "out": os.path.join(work, "train{}.pt".format(ranks)),
        "overlap": True})
    got = torchrun(ranks, "cuda", "nccl", jobs, work,
                   timeout_s=CARDS_TIMEOUT_S,
                   collective_timeout_s=CARDS_COLLECTIVE_TIMEOUT_S)
    steps = {}
    for shape, result in zip(shapes, got):
        name = "meshShape {} on {} cards (NCCL)".format(shape, ranks)
        steps[name] = compare_steps(result, single["result"],
                                    "exp74, " + name + ", float32 step")
        steps[name]["sharded"] = result["sharded"]
    train = got[-1]
    if train["summary"]["last_iteration"] != 4:
        raise AssertionError("the train entry point on {} ranks stopped at "
                             "{}".format(ranks, train["summary"]))
    log("exp74, train entry point on meshShape [{}]: {}; peak memory "
        "{:.2f} GB on rank 0; {:.2f} ms a bf16 step at the global batch of "
        "32; rank 0's card in one step: {}".format(
            ranks, train["summary"], train["peak_memory_gb"],
            train["step_ms"], train["overlap"]))
    return steps, train


def check_two_nodes(data_dir: str, work: str, device: str = "cuda",
                    backend: str = "nccl", **overrides):
    """``--cards``: exp74 streamed from the host on two torchrun nodes of
    two ranks each (two agents on this machine, cards 0-1 and 2-3, a
    data axis of four), NODE_STEPS steps of the train entry point: every
    rank must finish, and each step's rows on each rank must be its
    data-axis block of its node's batch (``node_rows``), the two nodes'
    rows of a step apart. ``device="cpu"``, ``backend="gloo"`` with a small model
    in ``overrides`` rehearses it on the CPU."""
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    out = os.path.join(work, "rows.pt")
    values = settings(EXP74, data_dir, work, iterations=NODE_STEPS,
                      validation=10 * NODE_STEPS, snapshot=NODE_STEPS,
                      residency="host", **overrides)
    t0 = time.perf_counter()
    torchrun(4, device, backend, [{"kind": "rows", "values": values,
                                   "out": out}], work,
             timeout_s=CARDS_TIMEOUT_S,
             collective_timeout_s=CARDS_COLLECTIVE_TIMEOUT_S, nodes=2)
    seconds = time.perf_counter() - t0
    ranks = [torch.load(out + ".rank{}".format(r), weights_only=False)
             for r in range(4)]
    for r, result in enumerate(ranks):
        if (result["rank"] != r or result["nodes"] != 2
                or result["summary"]["steps"] != NODE_STEPS
                or result["got"] != result["want"]):
            raise AssertionError("rank {} of the two-node job: node {} of "
                                 "{}, {} steps, rows as the plain rule: "
                                 "{}".format(r, result["node"],
                                             result["nodes"],
                                             result["summary"]["steps"],
                                             result["got"] == result["want"]))
    # an epoch's shards are apart, so the nodes' rows of a step are too
    by_node = [[{row for result in ranks if result["node"] == n
                 for row in result["got"][step]} for n in (0, 1)]
               for step in range(NODE_STEPS)]
    if {result["node"] for result in ranks} != {0, 1} or any(
            rows0 & rows1 for rows0, rows1 in by_node):
        raise AssertionError("the two nodes' rows are not apart: "
                             "{}".format([(r["rank"], r["node"])
                                          for r in ranks]))
    placement = [(r["rank"], r["node"], r["data_index"], r["device"])
                 for r in ranks]
    log("two nodes x two ranks ({} over {}): {} steps each, every rank's "
        "rows its block of its node's batch; (rank, node, data index, "
        "device) {}; {:.1f} s".format(device, backend, NODE_STEPS,
                                      placement, seconds))
    return {"placement": placement, "steps": NODE_STEPS,
            "seconds": seconds, "rows_equal": True}


def cards_serving(slide, build_dir, cards: int):
    """``cornerCPoolRes10`` and ``centerOffsetRes10`` over a mesh of
    ``cards`` cards: the detections of the monolithic analyzer on cuda:0,
    K2 ``pool_launches_per_forward`` a walk and a shard, one card's and
    the mesh's ms a request (each after one request), and one mesh
    request's ``card_overlap``."""
    devices = ["cuda:{}".format(i) for i in range(cards)]
    out = {}
    for arch in ("cornerCPoolRes10", "centerOffsetRes10"):
        wrapper = load_wrapper(os.path.join(build_dir, arch + ".pt"), arch)
        times = {}
        for name, analyse in (
                ("1 card", make_device_analyzer(wrapper, SLIDE_W, SLIDE_H)),
                ("{} cards".format(cards), make_device_analyzer(
                    wrapper, SLIDE_W, SLIDE_H, mesh=devices))):
            want = analyse(slide)  # first call: cuDNN's algorithm choice
            sync(devices)
            cuda_build.reset_launches()
            t0 = time.perf_counter()
            got = analyse(slide)
            times[name] = (time.perf_counter() - t0) * 1e3
            launches = dict(cuda_build.LAUNCHES)
            if name == "1 card":
                mono = got
            elif not mono or got != mono or want != mono:
                raise AssertionError("{}: detections over {} ({}) differ "
                                     "from the monolithic ones ({})".format(
                                         arch, devices, len(got), len(mono)))
            else:
                only(launches, {k: cards * pool_launches_per_forward(arch)
                                for k in cp.KERNEL_NAMES.values()})
                overlap = card_overlap(lambda: analyse(slide), devices)
        log("{} over mesh {}: {} detections, equal to the monolithic "
            "analyzer's; ms a request {}; K2 {} launches; one request's "
            "cards: {}".format(arch, devices, len(mono), times,
                               k2_launches(launches), overlap))
        out[arch] = {"detections": len(mono), "ms": times,
                     "k2_launches": k2_launches(launches),
                     "overlap": overlap}
    return out


def cards_main(only_nodes: bool = False) -> int:
    """``chip_smoke.py --cards``: the parallel layer across four cards, one
    NCCL rank a card (the collectives' all-gather path). Every collective
    of a launch, on every process group, fails after
    ``CARDS_COLLECTIVE_TIMEOUT_S``; a rank job still running then prints
    every thread's stack.

    1. two ranks: exp74's float32 step on ``meshShape [2]`` and ``[1,
       2]`` (data x model) against the single-process step within the
       ``STEP_*`` bounds; 4 bf16 steps of the train entry point on
       ``[2]`` (a validation at step 4, the rows gathered, and a
       snapshot), then its timed window (10 steps after 3);
    2. four ranks: the same on ``[4]`` and ``[2, 2]``, and the train
       entry point on ``[4]``; bf16 exp74 at the global batch of 32 is
       timed on one card, ``[2]`` and ``[4]``;
    3. ``cornerCPoolRes10`` and ``centerOffsetRes10`` served over a mesh
       of the four cards (``cards_serving``);
    4. hourglass2_best pipelined, ``meshShape [1, 2]`` data x pipe with
       its stages on cuda:0 and cuda:1 (``check_pipeline``);
    5. exp74 streamed from the host on two nodes of two ranks
       (``check_two_nodes``; alone with ``--cards nodes``).

    Prints a results line, the card line and the last line of ``main``
    (with the count of cards)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < CARDS:
        print("chip_smoke --cards: needs {} CUDA cards".format(CARDS),
              file=sys.stderr)
        return 1
    os.environ.setdefault("NCCL_DEBUG", "WARN")  # the ranks' NCCL warnings
    gpu_line = run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"])
    log("cards: {}\n{}".format(torch.cuda.device_count(), gpu_line))
    log("build cache: {}".format(compile_cache.enable_compilation_cache()))
    reproducible_float32()
    t_start = time.perf_counter()
    build_dir = os.path.join(REPO, "build", "chip_smoke_cards")
    data_dir = os.path.join(build_dir, "data")
    work = os.path.join(build_dir, "torchrun")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    archive = os.path.join(data_dir, "scdx16p100.d")
    writer = start_archive(archive)
    try:
        with ThreadPoolExecutor(len(BUILD_SOURCES)) as pool:
            list(pool.map(cuda_build.build, BUILD_SOURCES))
        for source in BUILD_SOURCES:
            cuda_build.load(source)
        finish_archive(writer, archive)
    finally:
        if writer is not None and writer.poll() is None:
            writer.kill()
            writer.wait()
    out = {"card": gpu_line, "steps": {}, "seconds": {}}
    if only_nodes:
        out["two_nodes"] = check_two_nodes(data_dir,
                                           os.path.join(build_dir, "nodes"))
        return cards_end(out, gpu_line, t_start)
    step_values = settings(EXP74, data_dir, os.path.join(work, "single"),
                           precision="float32", residency="host")
    single = {"values": step_values,
              "result": one_step(step_values, "cuda")}
    with open(os.path.join(data_dir, "scdx16p100.split.json")) as f:
        n_val = len(json.load(f)["validation"])
    one_card = timed_steps(settings(EXP74, data_dir, os.path.join(
        work, "timed")), "cuda", overlap=True)
    log("exp74, one card: {:.2f} ms a bf16 step at the batch of 32; the "
        "card in one step: {}".format(one_card["step_ms"],
                                      one_card["overlap"]))
    out.update(step_ms={"1 card": one_card["step_ms"]},
               one_card_step=one_card["overlap"])
    for ranks, shapes in ((2, [[2], [1, 2]]), (4, [[4], [2, 2]])):
        t0 = time.perf_counter()
        steps, train = cards_steps(ranks, shapes, data_dir, work, single)
        out["steps"].update(steps)
        out["step_ms"]["meshShape [{}]".format(ranks)] = train["step_ms"]
        out["train_{}".format(ranks)] = {
            k: train[k] for k in ("summary", "peak_memory_gb", "launches",
                                  "overlap")}
        out["seconds"]["{} ranks".format(ranks)] = time.perf_counter() - t0
    log("exp74 bf16 step, global batch 32: {} ms".format(out["step_ms"]))
    t0 = time.perf_counter()
    slide = synthetic_slide(SLIDE_H, SLIDE_W, seed=2056)
    served_checkpoints(slide, build_dir)
    out["mesh_serving"] = cards_serving(slide, build_dir, CARDS)
    out["seconds"]["mesh_serving"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["pipeline"], out["pipeline_launches"] = check_pipeline(
        data_dir, os.path.join(build_dir, "pipeline"), n_val, device="cuda")
    out["seconds"]["pipeline"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["two_nodes"] = check_two_nodes(data_dir,
                                       os.path.join(build_dir, "nodes"))
    out["seconds"]["two_nodes"] = time.perf_counter() - t0
    return cards_end(out, gpu_line, t_start)


def cards_end(out, gpu_line: str, t_start: float) -> int:
    """``--cards``' last three lines: its results, the card line and the
    last line of ``main`` with the count of cards."""
    out["seconds"]["total"] = time.perf_counter() - t_start
    log(json.dumps(out))
    log(gpu_line)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def check_main(name: str, check) -> int:
    """``--layout`` and ``--feed``: the kernels built and the synthetic
    archive written, then phase 8's ``check_layout`` or ``check_feed``
    alone, its result under ``name``."""
    gpu_line = run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"])
    log("card: {} | torch {}".format(gpu_line, torch.__version__))
    compile_cache.enable_compilation_cache()
    build_dir = os.path.join(REPO, "build", "chip_smoke")
    data_dir = os.path.join(build_dir, "data")
    archive = os.path.join(data_dir, "scdx16p100.d")
    writer = start_archive(archive)
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        list(pool.map(cuda_build.build, KERNEL_SOURCES))
    finish_archive(writer, archive)
    result = check(data_dir, os.path.join(build_dir, name))
    log(json.dumps({"ok": True, name: result, "card": gpu_line}))
    return 0


def hourglass104_main() -> int:
    """``--hourglass104``: the kernels built and the synthetic archive
    written, then ``cornerNetHourglass104`` alone through phases 6 and 8:
    served over HTTP (one 3092x2056 slide's latency and paired boxes),
    trained under ``configs/hourglass104_full.json`` and resumed with
    exact launches, and one step's boundary copies."""
    gpu_line = run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"])
    log("card: {} | torch {}".format(gpu_line, torch.__version__))
    t_start = time.perf_counter()
    compile_cache.enable_compilation_cache()
    build_dir = os.path.join(REPO, "build", "chip_smoke")
    data_dir = os.path.join(build_dir, "data")
    archive = os.path.join(data_dir, "scdx16p100.d")
    writer = start_archive(archive)
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        list(pool.map(cuda_build.build, KERNEL_SOURCES))
    reproducible_float32()
    slide = synthetic_slide(SLIDE_H, SLIDE_W, seed=2056)
    served = serve_model("cornerNetHourglass104", 16, slide, build_dir,
                         gpu_line)
    finish_archive(writer, archive)
    trained = train_config(HOURGLASS104_FULL, data_dir,
                           os.path.join(build_dir, "hourglass104_full"),
                           ("AP50", "mIoU"))
    step = hourglass104_step(data_dir, os.path.join(build_dir,
                                                    "hourglass104_step"))
    log(json.dumps({"serving": served, "training": trained, "step": step,
                    "seconds": time.perf_counter() - t_start,
                    "card": gpu_line}))
    log(json.dumps({"ok": True, "card": gpu_line}))
    return 0


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
    cache_dir = compile_cache.enable_compilation_cache()
    log("build cache: {} (fingerprint {})".format(
        cache_dir, os.path.basename(cache_dir)))
    reproducible_float32()
    build_dir = os.path.join(REPO, "build", "chip_smoke")
    data_dir = os.path.join(build_dir, "data")
    archive = os.path.join(data_dir, "scdx16p100.d")
    writer = start_archive(archive)
    slide_dir = os.path.join(build_dir, "slides")
    slides_proc = start_slides(slide_dir)
    f1_gen = start_f1_gen(os.path.join(build_dir, "f1"))
    try:
        phases = {}

        def mark(name, t0):
            phases[name] = time.perf_counter() - t0
            return time.perf_counter()

        try:
            # 1. build every kernel and the host library from the
            # checkout's sources, in parallel
            t0 = time.perf_counter()
            with ThreadPoolExecutor(len(BUILD_SOURCES)) as pool:
                list(pool.map(cuda_build.build, BUILD_SOURCES))
            for source in BUILD_SOURCES:
                cuda_build.load(source)
            native_io.get_library()
            log("built {} in {:.1f}s; compilers' output:\n{}".format(
                ", ".join(BUILD_SOURCES), time.perf_counter() - t0,
                "\n".join(cuda_build.build_log(s) for s in BUILD_SOURCES)))
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
                                         ("centerOffsetRes10dcn", 12),
                                         ("centerOffsetHourglass2", 13),
                                         ("cornerLegacyHourglass", 14),
                                         ("centerRes10", 15),
                                         ("cornerNetHourglass104", 16))]
            gray = check_grayscale()
            t0 = mark("serving", t0)
            # 6, continued: the served checkpoints streamed, pipelined, traced
            # and served by the test CLI
            streamed, stream_counts = check_streaming(slide, build_dir)
            t0 = mark("streaming_and_many", t0)
            pngs = write_pngs(slide, build_dir)
            bundles = [check_bundle(arch, slide, pngs[0], build_dir)
                       for arch in ("cornerCPoolRes10", "centerOffsetRes10dcn")]
            t0 = mark("bundles", t0)
            build_cache = check_build_cache(slide, build_dir, cache_dir)
            t0 = mark("build_cache", t0)
            test_c = check_test_checkpoint(pngs, build_dir)
            t0 = mark("test_checkpoint", t0)
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
                                ("mIoU", "AP50", "avgS")),
                   train_config(HOURGLASS2_BEST, data_dir,
                                os.path.join(build_dir, "hourglass2_best"),
                                ("mIoU", "AP50", "avgS")),
                   train_config(LEGACY_FULL, data_dir,
                                os.path.join(build_dir, "legacy_full"),
                                ("AP50", "mIoU")),
                   train_config(CENTERSIZE_FULL, data_dir,
                                os.path.join(build_dir, "centersize_full"),
                                ("peakAP50", "mIoU")),
                   train_config(HOURGLASS104_FULL, data_dir,
                                os.path.join(build_dir, "hourglass104_full"),
                                ("AP50", "mIoU"))]
        layout = check_layout(data_dir, os.path.join(build_dir, "layout"))
        layout["cornerNetHourglass104"] = hourglass104_step(
            data_dir, os.path.join(build_dir, "hourglass104_step"))
        feed = check_feed(data_dir, os.path.join(build_dir, "feed"))
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
                                  prepare=fractional_offsets),
                 step_card_vs_cpu(HOURGLASS2_BEST,
                                  os.path.join(build_dir, "step_hourglass2")),
                 step_card_vs_cpu(LEGACY_FULL, os.path.join(build_dir,
                                                            "step_legacy"),
                                  probe=("tl.0.pool_block.branch1.conv.weight",
                                         slice(None))),
                 step_card_vs_cpu(CENTERSIZE_FULL,
                                  os.path.join(build_dir, "step_centersize"))]
        t0 = mark("step_card_vs_cpu", t0)
        # 10. preprocess the slides on the card, train exp74 from the archive,
        # and DCNPooling on the card
        if slides_proc.wait(timeout=900) != 0:
            raise RuntimeError("writing the slides failed ({})".format(
                slides_proc.returncode))
        pre_archive, preprocessed = check_preprocess(
            slide_dir, os.path.join(build_dir, "preprocess"), gpu_line)
        t0 = mark("preprocess", t0)
        readers = check_archive_readers(pre_archive)
        t0 = mark("archive_readers", t0)
        pre_trained = train_preprocessed(pre_archive, os.path.join(
            build_dir, "train_preprocessed"))
        t0 = mark("train_preprocessed", t0)
        host_streamed = train_host_streamed(pre_archive, os.path.join(
            build_dir, "train_host_streamed"))
        t0 = mark("train_host_streamed", t0)
        psroi = check_psroi(gpu_line)
        t0 = mark("psroi", t0)
        # 11. the parallel layer: torchrun ranks on NCCL and on gloo, the
        # model axis, the pipelined hourglass, mesh serving
        with open(os.path.join(data_dir, "scdx16p100.split.json")) as f:
            n_val = len(json.load(f)["validation"])
        ranks, torchrun_counts, two_rank_counts = check_torchrun(
            data_dir, os.path.join(build_dir, "torchrun"), n_val)
        t0 = mark("torchrun", t0)
        piped, pipe_counts = check_pipeline(
            data_dir, os.path.join(build_dir, "pipeline"), n_val)
        t0 = mark("pipeline", t0)
        mesh_served, mesh_counts = check_mesh_serving(slide, build_dir)
        t0 = mark("mesh_serving", t0)
        small = check_small_slides(build_dir)
        t0 = mark("small_slides", t0)
        # 12. the F1 pipeline through the port's CLIs, and the load test
        f1, f1_counts = check_f1_pipeline(os.path.join(build_dir, "f1"),
                                          f1_gen)
        mark("f1_pipeline", t0)

        # 13. results: every path's counts, the serving paths (oldest first)
        # before the training paths (oldest first), then the F1 pipeline's
        # train stage and exp74 streamed from the natively read archive;
        # each kernel's launches are those of the newest path that runs it
        paths = {"serve_cornerCPoolRes10": served[0]["launches"],
                 "serve_centerOffsetRes10dcn": served[2]["launches"],
                 "serve_cornerLegacyHourglass": served[4]["launches"],
                 "serve_centerRes10": served[5]["launches"],
                 "stream_cornerCPoolRes10": stream_counts,
                 "bundle_cornerCPoolRes10": bundles[0][1],
                 "bundle_centerOffsetRes10dcn": bundles[1][1],
                 "train_exp74": trained[0]["launches"],
                 "train_cpool_best": trained[1]["launches"],
                 "train_dcn_full": trained[2]["launches"],
                 "train_hourglass2_best": trained[3]["launches"],
                 "train_legacy_full": trained[4]["launches"],
                 "serve_cornerNetHourglass104": served[6]["launches"],
                 "train_hourglass104_full": trained[6]["launches"],
                 "train_centersize_full": trained[5]["launches"],
                 "train_preprocessed_exp74": pre_trained["launches"],
                 "train_exp74_two_ranks": two_rank_counts,
                 "train_exp74_torchrun": torchrun_counts,
                 "train_hourglass2_pipe": pipe_counts,
                 "serve_mesh_cornerCPoolRes10": mesh_counts,
                 "f1_pipeline_train": {name: f1_counts.get(name, 0)
                                       for name in cuda_build.LAUNCHES},
                 "train_host_streamed_exp74": host_streamed["launches"]}
        # the render's map sets by the paths that launch them: M = 1 center
        # (exp74, dcn_full, hourglass2_best, centersize_full, exp74 from the
        # preprocessed archive, resident and streamed from the host, and
        # under torchrun, the pipelined hourglass2, the F1 pipeline's train
        # stage), M = 3 (cpool_best), the offset set twice a batch
        # transform (legacy_full)
        for set_name, path in (("center", "train_host_streamed_exp74"),
                               ("center+tl+br", "train_cpool_best"),
                               ("offset", "train_legacy_full")):
            render["map_sets"][set_name]["main_path"] = path
            render["map_sets"][set_name]["launches"] = \
                paths[path][gaussian.KERNEL_NAME]
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
        log(json.dumps({"serving": served, "streaming": streamed,
                        "bundles": [b[0] for b in bundles],
                        "test_checkpoint": test_c, "training": trained,
                        "layout": layout, "feed": feed,
                        "step_card_vs_cpu": steps, "preprocess": preprocessed,
                        "train_preprocessed": pre_trained, "psroi": psroi,
                        "grayscale": gray, "build_cache": build_cache,
                        "archive_readers": readers,
                        "train_host_streamed": host_streamed,
                        "torchrun": ranks, "pipeline": piped,
                        "mesh_serving": mesh_served, "small_slides": small,
                        "f1_pipeline": f1,
                        "card": gpu_line,
                        "seconds": phases}))
        log(json.dumps({"kernels": kernels}))
        log(gpu_line)
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    finally:
        for proc in (slides_proc, f1_gen):
            if proc.poll() is None:
                proc.kill()
                proc.wait()


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--rank-job":
        sys.exit(rank_job(sys.argv[2]))
    if sys.argv[1:] == ["--cards"]:
        sys.exit(cards_main())
    if sys.argv[1:] == ["--layout"]:
        sys.exit(check_main("layout", check_layout))
    if sys.argv[1:] == ["--hourglass104"]:
        sys.exit(hourglass104_main())
    if sys.argv[1:] == ["--feed"]:
        sys.exit(check_main("feed", check_feed))
    if sys.argv[1:] == ["--cards", "nodes"]:
        sys.exit(cards_main(only_nodes=True))
    sys.exit(main())
