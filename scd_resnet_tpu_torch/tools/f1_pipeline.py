"""The north-star F1 validation, end to end through the port's CLIs.

    python -m scd_resnet_tpu_torch.tools.f1_pipeline [--root workspace/f1_torch]
        [--stage gen|preprocess|train|serve|eval|all] [--device cuda|cpu]
        [--iters 3000] [--train-slides 16] [--test-slides 60]

Counterpart of the root ``tools/f1_pipeline.py``, with the same stages,
defaults, files and report. Each stage after ``gen`` runs a port CLI in
a subprocess (``python -m scd_resnet_tpu_torch.<cli>``, from the root of
this checkout) on ``--device``:

1. ``gen``: seeded synthetic slides with their label files
   (``data/synthetic.make_slide_and_annotation``, 1200x800): the train
   set (seed 100, 40 objects a slide) and the held-out set (seed 5000,
   10 objects a slide);
2. ``preprocess``: the train slides -> ``data/scdx16p100.d`` (``-s 512
   -m "168 112 168 112"``: 16 mirrors and rotations of each slide);
3. ``train``: ``centerOffsetRes10``, batch 32, validation batch 64,
   ``--iters`` iterations in bfloat16, validated at half way,
   a snapshot at the end, Adam at 2.5e-4 divided by 10 at 85 %;
4. ``serve``: the snapshot through ``test -c --pipelined --fit`` (the
   live, device-tiled path) -> ``live.json``, and through ``trace -s "24
   1 512 512"`` then ``test -m`` (the traced bundle on the host-tiled
   path) -> ``traced.json``, on the same held-out slides;
5. ``eval``: live against traced (positions within 1 px, Rhr within
   5e-3; at least 99.5 % of detections identical), then precision,
   recall and F1 of both paths at dedupe radii 0/8/16/24/32 px with a
   ``--match-radius`` of 24 px -> ``report.json`` and ``report.md``.

Every stage is rerunnable alone (``--stage eval`` rescores). The run
stops at the first stage that fails, and a missing snapshot, bundle or
detections file fails its stage. ``stages.json`` in the root records
each stage's seconds, and the preprocessing and train CLIs' summaries
(the train summary carries the kernel launches of the run).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from scd_resnet_tpu_torch.core.compile_cache import enable_compilation_cache

REPO = Path(__file__).resolve().parents[2]
SLIDE_SIZE = (1200, 800)  # width, height of every generated slide
CLIP = 512  # the archive's clip side
MARGINS = "168 112 168 112"  # pads 1200x800 slides to multiples of 512
TRAIN_NAME = "f1-torch"
DEDUPE_RADII = (None, 8.0, 16.0, 24.0, 32.0)
EQUALITY_MIN = 0.995  # traced and live must agree on this share
STAGES = ["gen", "preprocess", "train", "serve", "eval"]


def run(module: str, *args: str) -> Optional[Dict[str, Any]]:
    """``python -m <module> <args>`` from the checkout's root, its
    standard output echoed; raises ``CalledProcessError`` when it exits
    non-zero. Returns the last line of its output that is a JSON object
    (the summary the preprocessing and train CLIs print), if any."""
    cmd = [sys.executable, "-m", module, *args]
    print("+ " + " ".join(cmd), flush=True)
    last = None
    with subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                          text=True) as proc:
        for line in proc.stdout:
            sys.stdout.write(line)
            sys.stdout.flush()
            if line.startswith("{"):
                try:
                    last = json.loads(line)
                except ValueError:
                    pass
    if proc.returncode != 0:
        raise subprocess.CalledProcessError(proc.returncode, cmd)
    return last


def _path(args, *parts: str) -> str:
    return os.path.join(args.root, *parts)


def stage_gen(args):
    from scd_resnet_tpu_torch.data.synthetic import make_slide_and_annotation

    for i in range(args.train_slides):
        make_slide_and_annotation(_path(args, "train_imgs"),
                                  _path(args, "train_annots"), i + 1,
                                  *SLIDE_SIZE, objects=args.train_objects,
                                  seed=100)
    for i in range(args.test_slides):
        make_slide_and_annotation(_path(args, "test_imgs"),
                                  _path(args, "test_annots"), i + 1,
                                  *SLIDE_SIZE, objects=args.test_objects,
                                  seed=5000)
    print("gen: {} train / {} held-out slides".format(args.train_slides,
                                                      args.test_slides))
    return {}


def stage_preprocess(args):
    os.makedirs(_path(args, "data"), exist_ok=True)
    summary = run("scd_resnet_tpu_torch.preprocess",
                  _path(args, "data", "scdx16p100.d"),
                  "-i", _path(args, "train_imgs"),
                  "-a", _path(args, "train_annots"),
                  "-s", str(CLIP), "-m", MARGINS, "--device", args.device)
    return {"summary": summary}


def train_settings(args) -> Dict[str, Any]:
    """The train stage's experiment configuration."""
    return {
        "datasetName": "scdx16p100",
        "modelName": args.arch,
        "trainName": TRAIN_NAME,
        "batchSize": 32,
        "validationBatchSize": 64,
        "iterations": args.iters,
        "validation": args.iters // 2,
        "snapshot": args.iters,
        "learningRate": 0.00025,
        "learningRateDecay": [int(args.iters * 0.85)],
        "learningRateDecayRate": [10],
        "precision": "bfloat16",
        "dirTemp": _path(args, "temp") + "/",
        "dirResult": _path(args, "results") + "/",
        "dirDataset": _path(args, "data") + "/",
    }


def stage_train(args):
    cfg_path = _path(args, "f1.json")
    with open(cfg_path, "w") as f:
        json.dump(train_settings(args), f, indent=2)
    summary = run("scd_resnet_tpu_torch.train", cfg_path,
                  "--device", args.device)
    return {"summary": summary}


def snapshot_path(args) -> str:
    """The train stage's last snapshot, named by the configuration's own
    ``naming`` in its ``dirTemp``."""
    from scd_resnet_tpu_torch.core.config import Configuration

    cfg = Configuration()
    cfg.update_config(train_settings(args))
    cfg.update_iteration(args.iters)
    return os.path.join(cfg.config["dirTemp"], cfg.naming)


def _slides(args) -> List[str]:
    img_dir = _path(args, "test_imgs")
    return [os.path.join(img_dir, n) for n in sorted(
        os.listdir(img_dir), key=lambda n: int(os.path.splitext(n)[0]))]


def stage_serve(args):
    slides = _slides(args)
    ckpt = snapshot_path(args)
    bundle = _path(args, TRAIN_NAME + ".pt2")
    live, traced = _path(args, "live.json"), _path(args, "traced.json")
    for stale in (live, traced, bundle):  # a failed run leaves none behind
        if os.path.exists(stale):
            os.remove(stale)
    seconds = {}
    t0 = time.perf_counter()
    # the live device-tiled path, without dedupe: eval applies each radius
    run("scd_resnet_tpu_torch.test", "-c", ckpt, "-a", args.arch,
        "--pipelined", "--fit", "-o", live, "--device", args.device, *slides)
    seconds["live"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run("scd_resnet_tpu_torch.trace", bundle, "-a", args.arch, "-m", ckpt,
        "-s", "24 1 512 512", "--device", args.device)
    seconds["trace"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run("scd_resnet_tpu_torch.test", "-m", bundle, "-o", traced,
        "--device", args.device, *slides)
    seconds["traced"] = time.perf_counter() - t0
    return {"commands_seconds": seconds}


def _by_image(path: str):
    from scd_resnet_tpu_torch.tools.f1_eval import group_detections

    with open(path) as f:
        return group_detections(json.load(f), with_rhr=True)


def compare_paths(live, traced):
    """``(detections, mismatched, max Rhr deviation)`` of the traced path
    against the live one: per slide, sorted rows must agree in count,
    position within 1 px and Rhr within 5e-3 (half a histogram bin: the
    two paths run the same weights in other batches)."""
    if set(live) != set(traced):
        raise RuntimeError("live and traced analysed different slides: "
                           "{} against {}".format(sorted(live),
                                                  sorted(traced)))
    total = mismatched = 0
    max_rhr_dev = 0.0
    for image in live:
        a = sorted(live[image])
        b = sorted(traced[image])
        total += max(len(a), len(b))
        if len(a) != len(b):
            mismatched += abs(len(a) - len(b))
            a, b = a[: len(b)], b[: len(a)]
        for pa, pb in zip(a, b):
            if abs(pa[0] - pb[0]) > 1 or abs(pa[1] - pb[1]) > 1 \
                    or abs(pa[2] - pb[2]) > 5e-3:
                mismatched += 1
            max_rhr_dev = max(max_rhr_dev, abs(pa[2] - pb[2]))
    return total, mismatched, max_rhr_dev


def score_rows(paths, gt, match_radius: float) -> List[Dict[str, Any]]:
    """P/R/F1 of each path at each dedupe radius."""
    from scd_resnet_tpu_torch.infer.analyse import dedupe_detections
    from scd_resnet_tpu_torch.tools.f1_eval import match_f1

    rows = []
    for radius in DEDUPE_RADII:
        for name, dets in paths:
            tp = fp = fn = 0
            for image, pred in dets.items():
                if radius is not None:
                    pred = dedupe_detections([list(p) for p in pred], radius)
                xy = np.asarray([p[:2] for p in pred],
                                np.float64).reshape(-1, 2)
                t, p_, n_, *_ = match_f1(xy, gt[image], match_radius)
                tp, fp, fn = tp + t, fp + p_, fn + n_
            precision = tp / max(tp + fp, 1)
            recall = tp / max(tp + fn, 1)
            f1 = 2 * precision * recall / max(precision + recall, 1e-9)
            rows.append({"dedupe": radius or 0, "path": name, "tp": tp,
                         "fp": fp, "fn": fn, "precision": round(precision, 4),
                         "recall": round(recall, 4), "f1": round(f1, 4)})
    return rows


def stage_eval(args):
    from scd_resnet_tpu_torch.tools.f1_eval import annotated_centers

    live = _by_image(_path(args, "live.json"))
    traced = _by_image(_path(args, "traced.json"))
    total, mismatched, max_rhr_dev = compare_paths(live, traced)
    eq_rate = 1.0 - mismatched / max(total, 1)
    print("traced-vs-live: {} detections, {} mismatched ({:.3%} identical, "
          "max Rhr deviation {:.2e})".format(total, mismatched, eq_rate,
                                             max_rhr_dev))

    annot_dir = _path(args, "test_annots")
    gt = {image: annotated_centers(annot_dir, image, required=True)
          for image in live}
    n_objects = int(sum(len(g) for g in gt.values()))
    rows = score_rows((("live", live), ("traced", traced)), gt,
                      args.match_radius)

    report = {
        "slides": len(live), "objects": n_objects,
        "equality_rate": round(eq_rate, 5),
        "max_rhr_deviation": round(max_rhr_dev, 6),
        "match_radius": args.match_radius,
        "table": rows,
    }
    with open(_path(args, "report.json"), "w") as f:
        json.dump(report, f, indent=2)

    lines = [
        "# Scaled F1 validation ({})".format(
            os.path.basename(args.root.rstrip("/"))), "",
        "{} held-out slides, {} objects; greedy one-to-one matching at "
        "radius {} px; traced-vs-live identical rate {:.3%}.".format(
            len(live), n_objects, args.match_radius, eq_rate), "",
        "| dedupe px | path | TP | FP | FN | P | R | F1 |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append("| {dedupe:g} | {path} | {tp} | {fp} | {fn} | "
                     "{precision:.3f} | {recall:.3f} | {f1:.3f} |".format(**r))
    with open(_path(args, "report.md"), "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines))
    if eq_rate < EQUALITY_MIN:
        raise RuntimeError("traced and live paths disagree on {:.3%} of "
                           "detections (at most {:.1%} allowed)".format(
                               1.0 - eq_rate, 1.0 - EQUALITY_MIN))
    return {"equality_rate": report["equality_rate"]}


STAGE_FUNCTIONS = {"gen": stage_gen, "preprocess": stage_preprocess,
                   "train": stage_train, "serve": stage_serve,
                   "eval": stage_eval}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="python -m scd_resnet_tpu_torch.tools.f1_pipeline",
        description="the F1 validation through the port's CLIs")
    parser.add_argument("--root", default="workspace/f1_torch")
    parser.add_argument("--stage", default="all", choices=STAGES + ["all"])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="the device of every stage's CLI")
    parser.add_argument("--arch", default="centerOffsetRes10")
    parser.add_argument("--train-slides", type=int, default=16)
    parser.add_argument("--train-objects", type=int, default=40)
    parser.add_argument("--test-slides", type=int, default=60)
    parser.add_argument("--test-objects", type=int, default=10)
    parser.add_argument("--iters", type=int, default=3000)
    parser.add_argument("--match-radius", type=float, default=24.0)
    args = parser.parse_args(argv)
    args.root = os.path.abspath(args.root)
    return args


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Run the stages the command line names; returns ``stages.json``'s
    record."""
    args = parse_args(argv)
    enable_compilation_cache()
    os.makedirs(args.root, exist_ok=True)
    record_path = _path(args, "stages.json")
    record: Dict[str, Any] = {}
    if os.path.exists(record_path):
        with open(record_path) as f:
            record = json.load(f)
    record["arguments"] = {k: v for k, v in vars(args).items()
                           if k not in ("root", "stage")}
    for stage in (STAGES if args.stage == "all" else [args.stage]):
        print("==== stage: {} ====".format(stage), flush=True)
        t0 = time.perf_counter()
        out = STAGE_FUNCTIONS[stage](args)
        record[stage] = dict(seconds=time.perf_counter() - t0, **out)
        with open(record_path, "w") as f:
            json.dump(record, f, indent=2)
    return record


if __name__ == "__main__":
    main()
