"""Cut whole-slide images and their label files into a `.d` training archive.

    python -m scd_resnet_tpu_torch.preprocess out.d -i imgs/ -a annots/ \\
        -s 512 -m 'l t r b' [-v] [-p profile] [--device cuda|cpu]

Counterpart of the root ``preprocess.py`` (reference preprocess.py:42-109),
with its flags. The slides are read in the order of the number their
names start with, and the profile, a module with
``generateArchieve(settings, imageFileNames, zipArchive)``, fills one
``ZIP_DEFLATED`` archive. The default profile is
``scd_resnet_tpu_torch.data.preprocess``, and the reference's name
``datasets.preprocessor.scdManual`` stands for it. The rotations run on
the CUDA card unless ``--device cpu`` is given; without a card the
command refuses to start. It ends with one JSON line: the slides, the
clips, the seconds, clips per second, each slide's rotation and write
times, and on a card its peak device memory.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import pprint
import re
import time
import zipfile
from typing import Any, Dict, List, Optional

import torch

from scd_resnet_tpu_torch.core.compile_cache import enable_compilation_cache
from scd_resnet_tpu_torch.core.device import resolve_device
from scd_resnet_tpu_torch.core.logging import Logger

DEFAULT_PROFILE = "scd_resnet_tpu_torch.data.preprocess"
_PROFILE_ALIASES = {"datasets.preprocessor.scdManual": DEFAULT_PROFILE}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="python -m scd_resnet_tpu_torch.preprocess",
        description="clip whole-slide images and decode annotations into "
        "heatmap training archives")
    parser.add_argument("outputZipPath", type=str,
                        help="location of the output zipped samples")
    parser.add_argument("-i", dest="inputImage", type=str,
                        help="input image folder")
    parser.add_argument("-a", dest="annotation", type=str,
                        help="input annotation folder")
    parser.add_argument("-s", dest="destinationSize", default=512, type=int,
                        help="destination clip size")
    parser.add_argument("-t", dest="iouThreshold", default=0.7, type=float,
                        help="accepted for the reference CLI; unused (the "
                        "decode ignores it, scdManual.py:58-106; the "
                        "heatmap radii are rendered in training)")
    parser.add_argument("-v", dest="verbal", const=True, default=False,
                        action="store_const",
                        help="write an overlay PNG of every clip of the "
                        "first rotation to <output>.debug/")
    parser.add_argument("-m", dest="margin", default="0 0 0 0", type=str,
                        help="border margins: 'left top right bottom'")
    parser.add_argument("-p", dest="profile", type=str,
                        default=DEFAULT_PROFILE,
                        help="preprocess profile module")
    parser.add_argument("-gpu", dest="useGPU", const=True, default=False,
                        action="store_const",
                        help="accepted for the JAX CLI; changes nothing "
                        "(--device chooses where the rotations run)")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the rotations run (default: the CUDA "
                        "card)")
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Write the archive the command line asks for; returns the summary
    it prints."""
    args = parse_args(argv)
    enable_compilation_cache()
    device = resolve_device(args.device)
    Logger.info(":: preprocess :: generate samples from whole slide images "
                "on {} ::".format(device))
    settings = {
        "outputPath": args.outputZipPath,
        "inputImage": args.inputImage,
        "annotation": args.annotation,
        "destinationSize": args.destinationSize,
        "margin": [int(i) for i in args.margin.split(" ")],
        "iouThreshold": args.iouThreshold,
        "verbal": bool(args.verbal),
        "profile": args.profile,
        "device": device.type,
    }
    pprint.pprint(settings, indent=4)
    image_file_names = sorted(
        os.listdir(settings["inputImage"]),
        key=lambda name: int(re.match(r"(\d+)", name).group()))
    profile = importlib.import_module(
        _PROFILE_ALIASES.get(settings["profile"], settings["profile"]))

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    with zipfile.ZipFile(settings["outputPath"], "w",
                         zipfile.ZIP_DEFLATED) as zf:
        slides = profile.generateArchieve(settings, image_file_names, zf)
    seconds = time.perf_counter() - t0
    clips = sum(s["clips"] for s in slides or [])
    summary = {
        "slides": len(slides or []), "clips": clips, "seconds": seconds,
        "clips_per_s": clips / seconds if seconds > 0 else 0.0,
        "per_slide": slides, "device": str(device),
        "peak_device_memory_gb": torch.cuda.max_memory_allocated(device)
        / 1024 ** 3 if device.type == "cuda" else None}
    Logger.info(":: preprocess :: task completed successfully")
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
