"""Synthetic SCD clips, slides and `.d` archives, made from a seed.

Counterpart of ``synth_clip``, ``make_archive`` and
``make_slide_and_annotation`` in ``scd_resnet_tpu/data/synthetic.py``,
draw for draw, so one seed gives the same archive, slide and label file
in both packages. Each clip or slide is a bright noisy field with dark
elliptic "nuclei" and brighter "halo" rings. A clip's loc records are in
the decoded 8-field layout at heatmap scale (scdManual.py:96-106); a
slide's labels are in the label-file format
``head.x;head.y;tail.x;tail.y;minorWidth;haloRadius`` (scd-label
FormMain.cs:392-399 / scdManual.py:72-74).

    python -m scd_resnet_tpu_torch.data.synthetic out.d --images 2 --size 512
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from scd_resnet_tpu_torch.data.archive import ArchiveWriter


def synth_clip(rng: np.random.Generator, size: int = 512,
               heat_size: int = 128, max_objects: int = 6
               ) -> Tuple[np.ndarray, np.ndarray]:
    """One clip plus its (K, 8) loc records in heatmap coordinates."""
    img = rng.normal(180.0, 8.0, (size, size)).astype(np.float32)
    n = int(rng.integers(1, max_objects + 1))
    locs = np.zeros((n, 8), np.float32)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    margin = min(40, size // 4)
    for i in range(n):
        cx = rng.uniform(margin, size - margin)
        cy = rng.uniform(margin, size - margin)
        angle = rng.uniform(0, np.pi)
        maj = rng.uniform(10, 24)     # full-res semi-major
        minor = rng.uniform(6, maj)   # full-res semi-minor
        halo = rng.uniform(minor + 4, minor + 30)
        ca, sa = np.cos(angle), np.sin(angle)
        dx = xx - cx
        dy = yy - cy
        u = (dx * ca + dy * sa) / maj
        v = (-dx * sa + dy * ca) / minor
        r2 = u * u + v * v
        img -= 90.0 * np.exp(-r2 * 2.0)                       # dark nucleus
        hr = (dx * dx + dy * dy) / (halo * halo)
        img += 35.0 * np.exp(-((hr - 0.7) ** 2) * 8.0)        # halo ring
        # loc record in /4 heatmap coordinates (scdManual.py:96-106)
        ct = np.array([cx, cy]) / 4.0
        ct_int = np.floor(ct)
        off = (np.array([cx, cy]) - ct_int * 4.0)
        locs[i] = [
            ct_int[0], ct_int[1], off[0], off[1],
            maj * ca / 4.0, maj * sa / 4.0, minor / 4.0, halo / 4.0,
        ]
    return img, locs


def make_archive(path: str, num_images: int = 2, reps: int = 2,
                 clips_per_image: int = 4, size: int = 512,
                 seed: int = 0) -> str:
    """Write a small synthetic `.d` archive with the reference naming."""
    rng = np.random.default_rng(seed)
    with ArchiveWriter(path) as writer:
        for img_idx in range(1, num_images + 1):
            for rep in range(reps):
                for clip_id in range(1, clips_per_image + 1):
                    sample, locs = synth_clip(rng, size)
                    writer.add_clip(str(img_idx), rep, clip_id, sample, locs)
    return path


def make_slide_and_annotation(img_dir: str, annot_dir: str, index: int,
                              width: int = 1200, height: int = 800,
                              objects: int = 10, seed: int = 0) -> None:
    """One fake RGB slide ``{img_dir}/{index}.png`` and its label file
    ``{annot_dir}/{index}.txt``, from the numpy seed ``seed + index``, for
    the preprocessing CLI."""
    from PIL import Image

    rng = np.random.default_rng(seed + index)
    img = rng.normal(180.0, 8.0, (height, width)).astype(np.float32)
    lines: List[str] = []
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    for _ in range(objects):
        cx = rng.uniform(60, width - 60)
        cy = rng.uniform(60, height - 60)
        angle = rng.uniform(0, np.pi)
        maj = rng.uniform(12, 26)
        minor = rng.uniform(6, maj)
        halo = rng.uniform(minor + 6, minor + 30)
        ca, sa = np.cos(angle), np.sin(angle)
        head = (cx - maj * ca, cy - maj * sa)
        tail = (cx + maj * ca, cy + maj * sa)
        dx, dy = xx - cx, yy - cy
        u = (dx * ca + dy * sa) / maj
        v = (-dx * sa + dy * ca) / minor
        img -= 90.0 * np.exp(-(u * u + v * v) * 2.0)
        hr = (dx * dx + dy * dy) / (halo * halo)
        img += 35.0 * np.exp(-((hr - 0.7) ** 2) * 8.0)
        lines.append("{:.2f};{:.2f};{:.2f};{:.2f};{:.2f};{:.2f}".format(
            head[0], head[1], tail[0], tail[1], 2 * minor, halo))
    rgb = np.clip(img, 0, 255).astype(np.uint8)
    rgb = np.stack([rgb, rgb, rgb], -1)
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(annot_dir, exist_ok=True)
    Image.fromarray(rgb).save(os.path.join(img_dir, f"{index}.png"))
    with open(os.path.join(annot_dir, f"{index}.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(
        description="write a synthetic .d archive")
    parser.add_argument("output", type=str)
    parser.add_argument("--images", type=int, default=2)
    parser.add_argument("--reps", type=int, default=2)
    parser.add_argument("--clips", type=int, default=4)
    parser.add_argument("--size", type=int, default=512)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    make_archive(args.output, args.images, args.reps, args.clips, args.size,
                 args.seed)
    print("wrote", args.output)
