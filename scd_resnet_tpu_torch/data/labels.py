"""Annotation files: one ``.txt`` per image, one marker per line.

Counterpart of ``scd_resnet_tpu/data/labels.py``. A line is
``tail.x;tail.y;head.x;head.y;minorWidth;haloRadius`` as "F2"-rounded
floats, the reference labeling GUI's format (scd-label
FormMain.cs:392-399) and the preprocessing CLI's input. The reference's
preprocessor reads the first pair as the head (scdManual.py:85-89); the
two ends are symmetric for the center and the axis, so this module keeps
the positional order on a round trip and either convention survives.

Provides ``Marker`` (with its center, major half-length, Rhr and the
head/tail swap), ``load_markers``/``save_markers``, ``validate_markers``
and ``render_overlay`` for visual review (the GUI's draw loop).
``data/preprocess.decode_annotations`` reads the same files for the
archive writer.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Marker:
    """One labeled sperm: axis endpoints, minor width, halo radius
    (scd-label's Marker class, FormMain.cs:373-516)."""

    tail_x: float
    tail_y: float
    head_x: float
    head_y: float
    width: float        # full minor-axis width (the GUI's Width)
    halo_radius: float  # the GUI's Disperation

    @property
    def center(self) -> Tuple[float, float]:
        return ((self.head_x + self.tail_x) / 2,
                (self.head_y + self.tail_y) / 2)

    @property
    def major_length(self) -> float:
        return 0.5 * math.hypot(self.tail_x - self.head_x,
                                self.tail_y - self.head_y)

    @property
    def rhr(self) -> float:
        """Relative halo radius, (halo - minor) / (2 minor) with minor the
        half-width: what the served contract reports (test.py:124)."""
        minor = self.width / 2
        return (self.halo_radius - minor) / (2 * minor) if minor > 0 else 0.0

    def swap_ends(self) -> "Marker":
        """Head/tail swap (FormMain.cs:407)."""
        return dataclasses.replace(
            self, tail_x=self.head_x, tail_y=self.head_y,
            head_x=self.tail_x, head_y=self.tail_y)


def load_markers(path: str) -> List[Marker]:
    """Parse one label file (FormMain.cs:614-631); lines of five
    characters or fewer are skipped."""
    markers = []
    with open(path) as f:
        for line in f:
            if len(line.strip()) <= 5:
                continue
            vals = [float(v) for v in line.split(";")]
            markers.append(Marker(*vals[:6]))
    return markers


def save_markers(path: str, markers: List[Marker]) -> None:
    """Write with the GUI's "F2" two-decimal format (FormMain.cs:392-399)."""
    with open(path, "w") as f:
        for m in markers:
            f.write("{:.2f};{:.2f};{:.2f};{:.2f};{:.2f};{:.2f}\n".format(
                m.tail_x, m.tail_y, m.head_x, m.head_y, m.width,
                m.halo_radius))


def validate_markers(markers: List[Marker], width: Optional[int] = None,
                     height: Optional[int] = None) -> List[str]:
    """Problems found: degenerate axes, non-positive widths or halos, and
    with an image size, endpoints outside it."""
    problems = []
    for i, m in enumerate(markers):
        if m.major_length <= 0:
            problems.append(f"marker {i}: zero-length major axis")
        if m.width <= 0:
            problems.append(f"marker {i}: non-positive width {m.width}")
        if m.halo_radius <= 0:
            problems.append(f"marker {i}: non-positive halo {m.halo_radius}")
        if width is not None and height is not None:
            for name, (px, py) in (("head", (m.head_x, m.head_y)),
                                   ("tail", (m.tail_x, m.tail_y))):
                if not (0 <= px < width and 0 <= py < height):
                    problems.append(
                        f"marker {i}: {name} ({px:.1f}, {py:.1f}) outside "
                        f"{width}x{height}")
    return problems


def render_overlay(image: np.ndarray, markers: List[Marker]) -> np.ndarray:
    """An RGB uint8 overlay: each marker's major axis, minor-width circle
    and halo circle over ``image`` (grayscale or RGB)."""
    from PIL import Image, ImageDraw

    base = np.stack([image] * 3, -1) if image.ndim == 2 else image
    img = Image.fromarray(np.clip(base, 0, 255).astype(np.uint8))
    draw = ImageDraw.Draw(img)
    for m in markers:
        cx, cy = m.center
        draw.line([(m.tail_x, m.tail_y), (m.head_x, m.head_y)],
                  fill=(255, 64, 64), width=2)
        r = m.halo_radius
        draw.ellipse([cx - r, cy - r, cx + r, cy + r], outline=(64, 160, 255),
                     width=2)
        w = m.width / 2
        draw.ellipse([cx - w, cy - w, cx + w, cy + w], outline=(64, 255, 64),
                     width=1)
    return np.asarray(img)
