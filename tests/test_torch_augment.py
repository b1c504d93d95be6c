"""The port's augmentation (``scd_resnet_tpu_torch/ops/augment.py``)
against the JAX package's (``scd_resnet_tpu/ops/augment.py``) on the
same numpy inputs.

Tolerances:
- Rotations: ``ops/augment.rotation_tolerance``, derived in its
  docstring from one ulp of float32 cos and sin (XLA's and PyTorch's
  differ in the last bit for some angles) times the destination offsets,
  one rounding step of each source-coordinate operation at the padded
  frame's size, and the image's largest neighbour difference. Nearest
  may take a neighbour where a coordinate rounds the other way; at most
  1 % of its pixels may differ, each by at most that difference.
- ``rotate_coordinates``: 1e-5 relative to the records' magnitude
  (float32 cos/sin an ulp apart, times coordinates of a few tens).
- Flips: exact (they move values).
- Noise: shapes, determinism under one ``torch.Generator``, and moments
  within 5 standard errors of their distributions' on 2^16 draws.
"""

import jax
import numpy as np
import pytest
import torch

from scd_resnet_tpu.ops import augment as jaug
from scd_resnet_tpu_torch.ops import augment as taug

import torch_port_common  # noqa: F401  (the CPU-thread rule)

ANGLES = np.asarray(np.random.default_rng(5).uniform(-15, 15, 6), np.float32)


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(0).uniform(0, 255, (40, 64)).astype(
        np.float32)


def _jax_batch(fn, image, angles):
    return np.asarray(jax.vmap(lambda a: fn(image, a))(angles))


@pytest.mark.parametrize("resample", ["nearest", "bilinear", "bicubic"])
@pytest.mark.parametrize("pad_mode", ["reflect", "edge", "constant"])
@pytest.mark.parametrize("clip", [True, False])
def test_rotation_matches_jax(image, pad_mode, resample, clip):
    jfn = jaug.rotate if clip else (
        lambda *a, **k: jaug.rotate_non_clip(*a, **k)[0])
    want = _jax_batch(lambda im, a: jfn(im, a, pad_mode, 7.0, resample),
                      image, ANGLES)
    if clip:
        got = taug.rotate(torch.from_numpy(image), torch.from_numpy(ANGLES),
                          pad_mode, 7.0, resample).numpy()
    else:
        got, pl, pt = taug.rotate_non_clip(
            torch.from_numpy(image), torch.from_numpy(ANGLES), pad_mode,
            7.0, resample)
        got = got.numpy()
        _, jpl, jpt = jaug.rotate_non_clip(image, 1.0)
        assert (pl, pt) == (jpl, jpt)
    assert got.shape == want.shape
    bound = taug.rotation_tolerance(torch.from_numpy(image), ANGLES,
                                    pad_mode, 7.0, resample, clip=clip)
    err = np.abs(got - want)
    assert err.max() <= bound, (err.max(), bound)
    if resample == "nearest":
        assert (err > 0).mean() <= 0.01


def test_rotation_of_one_angle_and_of_a_batch_of_images(image):
    """A number rotates one image; a stack of images and a stack of
    angles pair up, as ``jax.vmap`` over both would."""
    single = taug.rotate(torch.from_numpy(image), float(ANGLES[1]))
    batch = taug.rotate(torch.from_numpy(image), torch.from_numpy(ANGLES))
    assert single.shape == image.shape
    assert torch.equal(single, batch[1])
    stack = np.stack([image, image[::-1].copy()])
    pairs = taug.rotate(torch.from_numpy(stack), torch.from_numpy(ANGLES[:2]))
    assert torch.equal(pairs[0], batch[0])
    assert torch.equal(pairs[1], taug.rotate(torch.from_numpy(stack[1]),
                                             float(ANGLES[1])))


def test_thin_image_reflects_as_often_as_numpy():
    """A 3-row image needs reflect pads wider than itself, which F.pad
    refuses; jnp.pad (and the port's index gather) reflect again."""
    thin = np.random.default_rng(1).uniform(0, 1, (3, 41)).astype(np.float32)
    for mode in ("reflect", "edge"):
        got = taug.rotate(torch.from_numpy(thin), 12.0, mode).numpy()
        want = np.asarray(jaug.rotate(thin, 12.0, mode))
        bound = taug.rotation_tolerance(torch.from_numpy(thin), 12.0, mode)
        assert np.abs(got - want).max() <= bound


def test_rotate_coordinates_matches_jax():
    rng = np.random.default_rng(2)
    locs = rng.normal(0, 4, (9, 8)).astype(np.float32)
    locs[:, :2] += 24
    locs[3, 2:4] = 0.0  # a zero offset stays zero
    got = taug.rotate_coordinates(torch.from_numpy(locs), 25.0, 19.5,
                                  torch.from_numpy(ANGLES)).numpy()
    want = np.stack([np.asarray(jaug.rotate_coordinates(locs, 25.0, 19.5,
                                                        float(a)))
                     for a in ANGLES])
    assert got.shape == (len(ANGLES), 9, 8)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert (got[:, 3, 2:4] == 0).all()
    np.testing.assert_array_equal(got[..., 6:], want[..., 6:])
    one = taug.rotate_coordinates(torch.from_numpy(locs), 25.0, 19.5,
                                  float(ANGLES[0])).numpy()
    np.testing.assert_array_equal(one, got[0])


def test_rotated_dot_lands_on_its_rotated_record():
    """tests/test_rotation_consistency.py and test_augment_surface.py's
    invariants on the port: a bright dot rotated with the image sits
    within 1.6 px of its record rotated by the same angle, in the
    cropped and in the padded frame."""
    size = 128
    for angle in (7.0, -12.5, 30.0):
        for px, py in ((40.0, 32.0), (90.0, 80.0), (64.0, 20.0)):
            img = np.zeros((size, size), np.float32)
            img[int(py), int(px)] = 100.0
            rotated = taug.rotate(torch.from_numpy(img), angle).numpy()
            locs = np.zeros((1, 8), np.float32)
            locs[0, :2] = px / 4.0, py / 4.0
            locs[0, 4] = 1.0
            out = taug.rotate_coordinates(torch.from_numpy(locs), size / 8.0,
                                          size / 8.0, angle).numpy()
            fy, fx = np.unravel_index(rotated.argmax(), rotated.shape)
            assert abs(fx - out[0, 0] * 4) < 1.6
            assert abs(fy - out[0, 1] * 4) < 1.6
    # the padded frame, at test_augment_surface.py's case (the reflect pad
    # mirrors the dot; here the first maximum in raster order is the dot)
    size, px, py = 96, 70.0, 30.0
    img = np.zeros((size, size), np.float32)
    img[int(py), int(px)] = 100.0
    for angle in (10.0, 37.5):
        framed, pl, pt = taug.rotate_non_clip(torch.from_numpy(img), angle)
        assert framed.shape == (size + 2 * pt, size + 2 * pl)
        cy = (framed.shape[0] - 1) / 2.0
        cx = (framed.shape[1] - 1) / 2.0
        a = np.deg2rad(-angle)
        dx, dy = px + pl - cx, py + pt - cy
        fy, fx = np.unravel_index(framed.numpy().argmax(), framed.shape)
        assert abs(fx - (np.cos(a) * dx - np.sin(a) * dy + cx)) < 1.6
        assert abs(fy - (np.sin(a) * dx + np.cos(a) * dy + cy)) < 1.6


def test_vectors_keep_their_norm():
    locs = np.zeros((3, 8), np.float32)
    locs[:, 4] = [3.0, 0.0, 1.0]
    locs[:, 5] = [0.0, 2.0, 1.0]
    out = taug.rotate_coordinates(torch.from_numpy(locs), 16.0, 16.0,
                                  33.0).numpy()
    np.testing.assert_allclose(np.hypot(out[:, 4], out[:, 5]),
                               np.hypot(locs[:, 4], locs[:, 5]), atol=1e-5)


def test_flips_match_jax_exactly():
    rng = np.random.default_rng(3)
    img = rng.normal(size=(2, 5, 7)).astype(np.float32)
    t = torch.from_numpy(img)
    np.testing.assert_array_equal(taug.horizontal_flip(t).numpy(),
                                  np.asarray(jaug.horizontal_flip(img)))
    np.testing.assert_array_equal(taug.vertical_flip(t).numpy(),
                                  np.asarray(jaug.vertical_flip(img)))
    for fn in ("horizontal_flip_numpy", "vertical_flip_numpy"):
        np.testing.assert_array_equal(getattr(taug, fn)(img[0]),
                                      getattr(jaug, fn)(img[0]))
    np.testing.assert_array_equal(
        taug.random_flip_numpy(img[0], np.random.default_rng(4)),
        jaug.random_flip_numpy(img[0], np.random.default_rng(4)))
    locs = rng.normal(size=(3, 8)).astype(np.float32)
    for fn in ("flip_locs_horizontal", "flip_locs_vertical"):
        np.testing.assert_array_equal(
            getattr(taug, fn)(torch.from_numpy(locs), 32).numpy(),
            np.asarray(getattr(jaug, fn)(locs, 32)))


def test_flipped_dot_lands_on_its_flipped_record():
    """test_augment_surface.py's flip invariant on the port: the image
    flips on the pixel grid, the record on the heatmap grid, and the
    vectors' x (or y) components change sign."""
    size, heat, px, py = 128, 32, 40, 88
    img = torch.zeros(size, size)
    img[py, px] = 100.0
    locs = torch.tensor([[px / 4.0, py / 4.0, 0.5, -0.25, 2.0, 1.0, 0, 0]])
    fy, fx = divmod(int(taug.horizontal_flip(img).argmax()), size)
    out = taug.flip_locs_horizontal(locs, heat)[0].tolist()
    assert (fx, fy) == (size - 1 - px, py)
    assert out[:6] == [heat - 1 - px / 4.0, py / 4.0, -0.5, -0.25, -2.0, 1.0]
    fy, fx = divmod(int(taug.vertical_flip(img).argmax()), size)
    out = taug.flip_locs_vertical(locs, heat)[0].tolist()
    assert (fx, fy) == (px, size - 1 - py)
    assert out[:6] == [px / 4.0, heat - 1 - py / 4.0, 0.5, 0.25, 2.0, -1.0]


def test_random_flip_reports_its_flips():
    img = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    seen = set()
    for seed in range(16):
        out, flip_h, flip_v = taug.random_flip(
            torch.Generator().manual_seed(seed), img)
        want = img
        if flip_h:
            want = want.flip(-1)
        if flip_v:
            want = want.flip(-2)
        assert torch.equal(out, want)
        seen.add((bool(flip_h), bool(flip_v)))
    assert len(seen) >= 3


@pytest.mark.parametrize("name,mean,std", [
    ("uniform_noise", 0.0, 0.05 * 12 / np.sqrt(12)),
    ("gaussian_noise", 0.0, 0.05),
])
def test_noise_moments_and_determinism(name, mean, std):
    fn = getattr(taug, name)
    img = torch.full((256, 256), 3.0)
    a = fn(torch.Generator().manual_seed(9), img)
    b = fn(torch.Generator().manual_seed(9), img)
    assert a.shape == img.shape and torch.equal(a, b)
    noise = (a - img).double()
    n = noise.numel()
    assert abs(noise.mean().item() - mean) < 5 * std / np.sqrt(n)
    assert abs(noise.std().item() - std) < 5 * std / np.sqrt(2 * n)


def test_variance_jitter_scales_the_whole_image():
    img = torch.linspace(1, 2, 100).reshape(10, 10)
    factors = []
    for seed in range(2000):
        out = taug.variance_jitter(torch.Generator().manual_seed(seed), img)
        ratio = out / img
        assert torch.allclose(ratio, ratio[0, 0].expand_as(ratio))
        factors.append(ratio[0, 0].item())
    factors = np.asarray(factors)
    assert abs(factors.mean() - 1) < 5 * 0.05 / np.sqrt(len(factors))
    assert abs(factors.std() - 0.05) < 5 * 0.05 / np.sqrt(2 * len(factors))


def test_random_rotate_returns_its_angle(image):
    out, angle = taug.random_rotate(torch.Generator().manual_seed(3),
                                    torch.from_numpy(image))
    assert 0.0 <= float(angle) <= 90.0
    assert torch.equal(out, taug.rotate(torch.from_numpy(image), angle))


def test_enum_modes_are_accepted(image):
    t = torch.from_numpy(image)
    a = taug.rotate(t, 15.0, taug.PaddingMode.ConstantPadding,
                    resample=taug.ResampleMode.NearestNeighbour)
    b = taug.rotate(t, 15.0, "constant", resample="nearest")
    assert torch.equal(a, b)
    # bicubic interpolates exactly on the integer grid (angle 0)
    c = taug.rotate(t, 0.0, taug.PaddingMode.MirrorPadding,
                    resample=taug.ResampleMode.Bicubic)
    np.testing.assert_allclose(c.numpy(), image, atol=1e-3)
    assert {m.value for m in taug.PaddingMode} == {
        m.value for m in jaug.PaddingMode}
    assert {m.value for m in taug.ResampleMode} == {
        m.value for m in jaug.ResampleMode}
