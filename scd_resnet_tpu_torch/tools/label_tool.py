"""Inspect, validate and overlay annotation files.

    python -m scd_resnet_tpu_torch.tools.label_tool validate annots/ [-i imgs/]
    python -m scd_resnet_tpu_torch.tools.label_tool overlay imgs/3.png \
        annots/3.txt out.png
    python -m scd_resnet_tpu_torch.tools.label_tool stats annots/

Counterpart of the root ``tools/label_tool.py``, the review half of the
reference's labeling GUI (scd-label/): it reads the one-``.txt``-per-
image marker format through ``data/labels`` and renders overlays for
visual review.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np

from scd_resnet_tpu_torch.data.labels import (
    load_markers,
    render_overlay,
    validate_markers,
)


def cmd_validate(args):
    total = 0
    bad = 0
    for name in sorted(os.listdir(args.annotations)):
        if not name.endswith(".txt"):
            continue
        markers = load_markers(os.path.join(args.annotations, name))
        size = None
        if args.images:
            from PIL import Image

            for ext in (".png", ".jpg", ".tif", ".bmp"):
                candidate = os.path.join(
                    args.images, os.path.splitext(name)[0] + ext)
                if os.path.exists(candidate):
                    with Image.open(candidate) as im:
                        size = im.size
                    break
        problems = validate_markers(
            markers, *(size if size else (None, None)))
        total += 1
        if problems:
            bad += 1
            print(f"{name}: {len(markers)} markers")
            for p in problems:
                print("  !", p)
    print(f"checked {total} files, {bad} with problems")


def cmd_overlay(args):
    from PIL import Image

    image = np.asarray(Image.open(args.image))
    markers = load_markers(args.annotation)
    out = render_overlay(image, markers)
    Image.fromarray(out).save(args.output)
    print(f"wrote {args.output} ({len(markers)} markers)")


def cmd_stats(args):
    rhrs, majors, widths, halos = [], [], [], []
    for name in sorted(os.listdir(args.annotations)):
        if not name.endswith(".txt"):
            continue
        for m in load_markers(os.path.join(args.annotations, name)):
            rhrs.append(m.rhr)
            majors.append(m.major_length)
            widths.append(m.width)
            halos.append(m.halo_radius)
    if not rhrs:
        print("no markers found")
        return
    for label, vals in (("Rhr", rhrs), ("major half-length", majors),
                        ("minor width", widths), ("halo radius", halos)):
        arr = np.asarray(vals)
        print(f"{label}: n={len(arr)} mean={arr.mean():.3f} "
              f"std={arr.std():.3f} min={arr.min():.3f} max={arr.max():.3f}")


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        prog="python -m scd_resnet_tpu_torch.tools.label_tool",
        description="inspect, validate and overlay annotation files")
    sub = parser.add_subparsers(dest="command", required=True)

    v = sub.add_parser("validate", help="sanity-check annotation files")
    v.add_argument("annotations")
    v.add_argument("-i", dest="images", default=None)
    v.set_defaults(fn=cmd_validate)

    o = sub.add_parser("overlay", help="render markers over an image")
    o.add_argument("image")
    o.add_argument("annotation")
    o.add_argument("output")
    o.set_defaults(fn=cmd_overlay)

    s = sub.add_parser("stats", help="marker statistics across a folder")
    s.add_argument("annotations")
    s.set_defaults(fn=cmd_stats)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
