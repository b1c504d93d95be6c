"""Grayscale conversion and reflect padding for served slides.

Counterpart of ``scd_resnet_tpu/ops/image.py`` (the port keeps its own
copy). Preprocessing's grayscale is ``0.30 R + 0.59 G + 0.11 B``
unrounded (reference scdManual.py:46-56). The inference grayscale is
``round(0.1140 R + 0.5870 G + 0.2989 B)`` — BGR-ordered weights applied
to RGB channels, rounded (reference test.py:21-33). Its served pad is
symmetric on x (edge repeated, cv2 BORDER_REFLECT) and reflect101 on y
(edge not repeated, torch 'reflect').

``reflect_index`` builds either pad as an index gather, which works the
same on host arrays and device tensors; PyTorch's ``F.pad`` has no
symmetric mode.
"""

from __future__ import annotations

import numpy as np


def grayscale_preprocess(rgb: np.ndarray) -> np.ndarray:
    """The grayscale of training archives, ``0.30 R + 0.59 G + 0.11 B``
    unrounded, as float32 (reference scdManual.py:46-56)."""
    rgb = np.asarray(rgb)
    return (0.30 * rgb[..., 0] + 0.59 * rgb[..., 1]
            + 0.11 * rgb[..., 2]).astype(np.float32)


def grayscale_inference_u8(rgb: np.ndarray) -> np.ndarray:
    """Inference grayscale of an (..., 3) RGB array as uint8 (the rounded
    formula's range is [0, 255]; numpy rounds half to even). uint8 RGB
    takes the host library's single pass (``data/native_io.grayscale_u8``,
    bit-equal to :func:`grayscale_inference_u8_plain`); anything else
    takes the plain version."""
    rgb = np.asarray(rgb)
    if rgb.dtype == np.uint8 and rgb.ndim >= 2 and rgb.shape[-1] == 3:
        from scd_resnet_tpu_torch.data.native_io import grayscale_u8

        return grayscale_u8(rgb)
    return grayscale_inference_u8_plain(rgb)


def grayscale_inference_u8_plain(rgb: np.ndarray) -> np.ndarray:
    """The inference grayscale in numpy: float64 products summed left to
    right, rounded, cast to uint8."""
    rgb = np.asarray(rgb)
    gray = np.round(0.1140 * rgb[..., 0] + 0.5870 * rgb[..., 1]
                    + 0.2989 * rgb[..., 2])
    return gray.astype(np.uint8)


def reflect_index(n: int, before: int, after: int, mode: str) -> np.ndarray:
    """Source indices of an axis of length ``n`` padded by
    ``(before, after)``, as ``np.pad`` computes them for ``mode``
    ``"reflect101"`` (numpy 'reflect'), ``"symmetric"`` or ``"edge"``,
    any pad width."""
    i = np.arange(-before, n + after)
    if mode == "edge":
        return np.clip(i, 0, n - 1)
    if mode == "reflect101":
        if n == 1:
            return np.zeros_like(i)
        period = 2 * (n - 1)
        i = np.mod(i, period)
        return np.where(i >= n, period - i, i)
    if mode == "symmetric":
        period = 2 * n
        i = np.mod(i, period)
        return np.where(i >= n, period - 1 - i, i)
    raise ValueError("unknown pad mode {!r}".format(mode))


def pad_reflect_hybrid(image: np.ndarray, pad_lr: int, pad_tb: int
                       ) -> np.ndarray:
    """Reflect-pad an (H, W) image: symmetric on x, reflect101 on y; in
    C order, as ``np.pad`` returns it (numpy sums a clip cut from it in
    an order that follows the layout)."""
    image = np.asarray(image)
    h, w = image.shape
    rows = reflect_index(h, pad_tb, pad_tb, "reflect101")
    cols = reflect_index(w, pad_lr, pad_lr, "symmetric")
    return np.ascontiguousarray(image[rows][:, cols])
