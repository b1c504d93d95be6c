"""Offline preprocessing: whole-slide images + label files -> `.d` archive.

Counterpart of ``scd_resnet_tpu/data/preprocess.py`` (reference
datasets/preprocessor/scdManual.py), on a device:

- decode each label line ``head.x;head.y;tail.x;tail.y;minorWidth;
  haloRadius`` into an 8-field loc record in /4 heatmap coordinates
  ``[ctX, ctY, offX, offY, majX, majY, minL, halo]`` (58-106);
- reflect-pad the slide's grayscale to the margins and replicate every
  record into its 8 mirrors (142-155);
- rotate the padded slide by ``REPEAT_GEN`` angles drawn from
  U(-15, 15) degrees (129, 166-177), all of them in one batch on the
  device, and the records by the same angles in another, both in
  float32 (the JAX package runs both through XLA);
- cut every rotation into ``destinationSize`` clips, each with the
  records whose centre falls inside it (182-199), and write samples and
  locs as npy files, ``object-count.json`` and ``dataset.json`` into the
  zip (204-230).

The JAX function's quirks are kept: ``margin[0] // 4`` is added to both
coordinates' pads as in it (l.183-184), the mirrors use ``width // 2``
in /4 units (l.86-96), the image and the records rotate about the padded
slide's centre, and a margin that does not tile the destination size is
a ``ValueError``. The angles are numpy's, from
``np.random.default_rng(settings["seed"])`` (42 by default), the same
bits as JAX's. The rotated pixels agree with JAX's within
``ops/augment.rotation_tolerance``, not to the bit: XLA's and PyTorch's
float32 ``sin``/``cos`` differ in the last bit for some angles.
"""

from __future__ import annotations

import io
import json
import math
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from scd_resnet_tpu_torch.core.device import resolve_device
from scd_resnet_tpu_torch.core.logging import Logger
from scd_resnet_tpu_torch.ops.augment import rotate, rotate_coordinates
from scd_resnet_tpu_torch.ops.image import grayscale_preprocess

REPEAT_GEN = 16  # scdManual.py:128


def decode_annotations(path: str, image_name: str
                       ) -> Optional[List[List[float]]]:
    """One label file as 8-field /4-coordinate loc records, or None when
    the slide has no label file (scdManual.py:58-106)."""
    attempt = os.path.join(path, os.path.splitext(image_name)[0] + ".txt")
    if not os.path.exists(attempt):
        return None
    locations: List[List[float]] = []
    with open(attempt) as f:
        for line in f.readlines():
            if len(line) <= 5:
                continue
            positions = [float(v) for v in line.split(";")]
            head = positions[0:2]
            tail = positions[2:4]
            minor_axis_length = positions[4]
            halo_radius = positions[5]

            center_raw = [(head[0] + tail[0]) / 2, (head[1] + tail[1]) / 2]
            center_int = [center_raw[0] // 4, center_raw[1] // 4]
            center_off = [center_raw[0] - center_int[0] * 4,
                          center_raw[1] - center_int[1] * 4]
            major_axis = [(tail[0] - head[0]) / 8, (tail[1] - head[1]) / 8]
            major_mod = math.sqrt(major_axis[0] ** 2 + major_axis[1] ** 2)
            minor_mod = minor_axis_length / 8
            locations.append([center_int[0], center_int[1],
                              center_off[0], center_off[1],
                              major_axis[0], major_axis[1],
                              minor_mod, halo_radius / 4])
    return locations


def _replicate_mirrors(locations: List[List[float]], width: int,
                       height: int) -> List[List[float]]:
    """The records and their 8 mirrors for the reflect-padded slide
    (scdManual.py:142-155); coordinates /4, width and height in pixels."""
    replicated = list(locations)
    for b in locations:
        x, y, ox, oy, mx, my, mn, hl = b
        w2 = width // 2
        h2 = height // 2
        replicated += [
            [x, -y, ox, -oy, mx, -my, mn, hl],
            [x, h2 - y - 2, ox, -oy, mx, -my, mn, hl],
            [-x, y, -ox, oy, -mx, my, mn, hl],
            [w2 - x - 2, y, -ox, oy, -mx, my, mn, hl],
            [w2 - x - 2, -y, -ox, -oy, -mx, -my, mn, hl],
            [-x, -y, -ox, -oy, -mx, -my, mn, hl],
            [w2 - x - 2, h2 - y - 2, -ox, -oy, -mx, -my, mn, hl],
            [-x, h2 - y - 2, -ox, -oy, -mx, -my, mn, hl],
        ]
    return replicated


def rotate_images_batch(padded: np.ndarray, angles: np.ndarray,
                        device: torch.device) -> torch.Tensor:
    """All rotations of one padded slide as one batch on ``device``:
    (A, H, W) float32 there."""
    image = torch.from_numpy(np.ascontiguousarray(padded, np.float32))
    return rotate(image.to(device),
                  torch.from_numpy(np.asarray(angles, np.float32)))


def rotate_coords_batch(locs: np.ndarray, center_x4: float,
                        center_y4: float, angles: np.ndarray,
                        device: torch.device) -> np.ndarray:
    """(K, 8) records rotated by every angle, one batch on ``device``:
    (A, K, 8) float32 on the host."""
    out = rotate_coordinates(torch.from_numpy(locs).to(device), center_x4,
                             center_y4,
                             torch.from_numpy(np.asarray(angles, np.float32)))
    return out.cpu().numpy()


def _debug_overlay(output_path: str, name: str, clip: np.ndarray,
                   locs: np.ndarray) -> None:
    """One overlay PNG in ``{output_path}.debug/``: the clip with its
    records' centres and major axes, to inspect the geometry."""
    from PIL import Image, ImageDraw

    debug_dir = output_path + ".debug"
    os.makedirs(debug_dir, exist_ok=True)
    img = Image.fromarray(np.clip(clip, 0, 255).astype(np.uint8)).convert(
        "RGB")
    draw = ImageDraw.Draw(img)
    for loc in locs:
        cx = (loc[0] + 0.0) * 4 + loc[2]
        cy = (loc[1] + 0.0) * 4 + loc[3]
        draw.ellipse([cx - 3, cy - 3, cx + 3, cy + 3], outline=(255, 64, 64),
                     width=2)
        draw.line([(cx - loc[4] * 4, cy - loc[5] * 4),
                   (cx + loc[4] * 4, cy + loc[5] * 4)], fill=(64, 255, 64))
    img.save(os.path.join(debug_dir, name + ".png"))


def generate_archive(settings: Dict, image_file_names: List[str],
                     zip_archive, device=None) -> List[Dict[str, Any]]:
    """Fill ``zip_archive`` with samples/, locs/, object-count.json and
    dataset.json from the slides ``image_file_names`` (the profile
    contract of the preprocessing CLI). The rotations run on ``device``,
    else on ``settings["device"]``, else on the CUDA card; without one
    this raises.

    Returns one line a slide: its clips, the upload and rotation of its
    batch in ms (CUDA events on the card, the host clock on the CPU) and
    the seconds that writing its clips took (the copy to the host, the
    cut, the npy encoding and the deflate)."""
    device = resolve_device(device or settings.get("device", "cuda"))
    stats: List[Dict[str, Any]] = []
    count_dict: Dict[str, int] = {}
    names: List[str] = []
    rng = np.random.default_rng(settings.get("seed", 42))
    dest = settings["destinationSize"]
    margin = settings["margin"]

    for image_file in image_file_names:
        from PIL import Image

        full_path = os.path.join(settings["inputImage"], image_file)
        gray = grayscale_preprocess(np.asarray(Image.open(full_path)))
        image_name = os.path.splitext(image_file)[0]
        height, width = gray.shape

        pad_width = width + margin[0] + margin[2]
        pad_height = height + margin[1] + margin[3]
        if pad_width % dest != 0 or pad_height % dest != 0:
            raise ValueError(
                "padding cannot fit the destination size: image {}x{} + "
                "margins {} gives {}x{}, not a multiple of {}".format(
                    width, height, list(margin), pad_width, pad_height, dest))

        locations = decode_annotations(settings["annotation"], image_file)
        if locations is None:
            continue

        padded = np.pad(gray, ((margin[1], margin[3]), (margin[0], margin[2])),
                        mode="reflect").astype(np.float32)
        base_locs = np.asarray(_replicate_mirrors(locations, width, height),
                               np.float32)
        base_locs[:, 0] += margin[0] // 4
        base_locs[:, 1] += margin[1] // 4

        angles = rng.uniform(0.0, 1.0, REPEAT_GEN) * 30.0 - 15.0
        timer = _Timer(device)
        rotated = rotate_images_batch(padded, angles, device)
        rotation_ms = timer.ms()
        t_write = time.perf_counter()
        rotated = rotated.cpu().numpy()
        if len(base_locs) > 0:
            rotated_locs = rotate_coords_batch(base_locs, pad_width / 8.0,
                                               pad_height / 8.0, angles,
                                               device)
        clips_before = len(names)

        general_id = 1
        for rep in range(REPEAT_GEN):
            locs = rotated_locs[rep] if len(base_locs) > 0 else base_locs
            image = rotated[rep]
            for x in range(pad_width // dest):
                for y in range(pad_height // dest):
                    clip = image[y * dest:(y + 1) * dest,
                                 x * dest:(x + 1) * dest]
                    key = "{}.{}".format(image_name, general_id)
                    if len(locs) > 0:
                        full_x = locs[:, 0] * 4 + locs[:, 2]
                        full_y = locs[:, 1] * 4 + locs[:, 3]
                        inside = ((full_x >= x * dest)
                                  & (full_x < (x + 1) * dest)
                                  & (full_y >= y * dest)
                                  & (full_y < (y + 1) * dest))
                        bs = locs[inside].copy()
                        bs[:, 0] -= x * dest // 4
                        bs[:, 1] -= y * dest // 4
                    else:
                        bs = np.zeros((0, 8), np.float32)

                    count_dict[key] = len(bs)
                    name = "{}.{}.{}".format(image_name, rep, general_id)
                    for sub, payload in (("locs", bs.astype(np.float32)),
                                         ("samples", clip.astype(np.float32))):
                        buf = io.BytesIO()
                        np.save(buf, payload)
                        zip_archive.writestr("{}/{}.npy".format(sub, name),
                                             buf.getvalue())
                    names.append(name + ".npy")
                    # -v: an overlay of the first rotation's clips
                    if settings.get("verbal") and rep == 0:
                        _debug_overlay(settings["outputPath"], name, clip, bs)
                    general_id += 1
        stats.append({"slide": image_file, "clips": len(names) - clips_before,
                      "rotation_ms": rotation_ms,
                      "write_s": time.perf_counter() - t_write})
        Logger.log("preprocessed {} ({} clips so far): {}".format(
            image_file, len(names), stats[-1]))

    zip_archive.writestr("object-count.json", json.dumps(count_dict))
    zip_archive.writestr("dataset.json", json.dumps({"names": names}))
    return stats


class _Timer:
    """Milliseconds since construction: CUDA events on a card, the host
    clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
            self.start.record()
        else:
            self.t0 = time.perf_counter()

    def ms(self) -> float:
        if not self.cuda:
            return (time.perf_counter() - self.t0) * 1e3
        self.end.record()
        self.end.synchronize()
        return self.start.elapsed_time(self.end)


# the reference profile's name for the entry point (preprocess.py:103-104)
generateArchieve = generate_archive
