"""The label render of the batch transform (K1) on the CPU: the plain
version of the one-launch render against the JAX package, the CPU
wrappers, the batch transform against the per-map route it replaced, and
what the wrappers refuse.

Tolerances, each with its reason:

- against the JAX package, heatmaps within 1e-6 absolute, the same
  pixels at exactly 1.0 except where JAX's unclamped sum lies within
  1e-6 of 1.0: every term is exp of the same float32 argument, which the
  two CPU libraries round a last bit apart, and XLA sums the objects in
  another order;
- within the port, equal to the bit: the batch transform, the one-map
  wrapper and the label-map wrapper all end in ``render_heatmap_plain``
  on the same float32 inputs.

The kernel itself runs only on the card (``chip_smoke.py`` phase 7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scd_resnet_tpu.data.pipeline import (
    augment_and_render_batch as jax_augment_and_render,
)
from scd_resnet_tpu.ops.pallas_kernels import render_heatmap_pallas
from scd_resnet_tpu_torch.core import cuda_build
from scd_resnet_tpu_torch.data.pipeline import (
    THRESHOLD_IOU,
    augment_and_render_batch,
    draw,
)
from scd_resnet_tpu_torch.ops import gaussian
from scd_resnet_tpu_torch.ops.augment import (
    flip_locs_horizontal,
    flip_locs_vertical,
)
from scd_resnet_tpu_torch.ops.radius import (
    center_threshold_radius,
    corner_threshold_radius,
)


def _batch(seed: int, size: int, clips: int = 4, k: int = 30):
    """Raw clips, loc records and counts of ``clips`` clips with
    ``size``-square heatmaps: the synthetic archive's objects plus edge
    cases in clips 0-2 (overlapping objects; centers and corners in
    (-1, 0), at S - 1 and beyond S; zero-size objects) and a clip with
    no objects."""
    rng = np.random.default_rng(seed)
    locs = np.zeros((clips, k, 8), np.float32)
    locs[..., 0:2] = np.floor(rng.uniform(2, size - 2, (clips, k, 2)))
    locs[..., 2:4] = rng.uniform(0, 4, (clips, k, 2))
    major = rng.uniform(10, 24, (clips, k)) / 4 * size / 128
    angle = rng.uniform(0, np.pi, (clips, k))
    locs[..., 4] = major * np.cos(angle)
    locs[..., 5] = major * np.sin(angle)
    locs[..., 6] = rng.uniform(0.4, 1.0, (clips, k)) * major
    locs[..., 7] = locs[..., 6] + 1
    locs[0, :6, 0:2] = 7.3 + rng.uniform(0, 1.5, (6, 2))  # overlapping
    edges = ((-0.4, 5.0, 2.5, 0.0, 3.4), (1.0, 1.5, 0.0, 1.8, 2.2),
             (size - 1, size - 1, 1.0, 1.0, 1.0),
             (size - 3.0, size - 4.0, 2.0, 0.0, 3.0), (size, 3.0, 1, 1, 1),
             (-1.0, 3.0, 1, 1, 1))
    for i, (x, y, mx, my, mn) in enumerate(edges):
        locs[1, i, [0, 1, 4, 5, 6]] = (x, y, mx, my, mn)
    locs[2, :3, 4:7] = 0.0  # zero-size objects
    counts = rng.integers(k // 2, k + 1, clips).astype(np.int32)
    counts[0], counts[1], counts[3] = k, len(edges) + 4, 0
    samples = rng.normal(180.0, 20.0, (clips, 4 * size, 4 * size)).astype(
        np.float32)
    return samples, locs, counts


def _present(locs, counts):
    return torch.arange(locs.shape[1])[None, :] < torch.as_tensor(
        counts)[:, None]


def _assert_heat_close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    differ = (got == 1.0) != (want == 1.0)
    assert not (differ & (np.abs(want - 1.0) > 1e-6)).any()


@pytest.mark.parametrize("size", [32, 64])
def test_label_maps_plain_match_jax_corner_targets(size):
    samples, locs, counts = _batch(size, size)
    got = gaussian.render_label_heatmaps_plain(
        torch.from_numpy(locs), _present(locs, counts), size, True,
        THRESHOLD_IOU).numpy()
    _, jys = jax_augment_and_render(jax.random.PRNGKey(0), samples, locs,
                                    counts, size, augment=False,
                                    corner_targets=True)
    assert got.shape == (3, 4, size, size)
    for m, j in enumerate((0, 4, 5)):  # heat, tl, br
        _assert_heat_close(got[m], np.asarray(jys[j])[..., 0])
    assert (got[1][1, 0, 0] == 1.0) and (got[:, 3] == 0).all()


@pytest.mark.parametrize("size", [32, 64])
def test_label_map_zero_matches_interpret_mode_pallas(size):
    _, locs, counts = _batch(size + 1, size)
    present = _present(locs, counts)
    got = gaussian.render_label_heatmaps_plain(
        torch.from_numpy(locs), present, size, False, THRESHOLD_IOU)
    assert got.shape == (1, 4, size, size)
    want = np.asarray(render_heatmap_pallas(
        jnp.asarray(locs), jnp.asarray(present.numpy()), size,
        THRESHOLD_IOU, interpret=True))
    _assert_heat_close(got[0].numpy(), want)
    cx, cy, mask, _, _ = gaussian.object_geometry(torch.from_numpy(locs),
                                                  present, size)
    clip = torch.arange(4)[:, None].expand_as(mask)
    assert int(mask.sum()) >= 40  # every valid center on the map is a peak
    assert (got[0][clip[mask], cy[mask].long(), cx[mask].long()] == 1.0).all()


@pytest.mark.parametrize("corner_targets", [False, True])
def test_label_wrapper_on_cpu_is_the_plain_version(corner_targets):
    _, locs, counts = _batch(2, 32)
    args = (torch.from_numpy(locs), _present(locs, counts), 32,
            corner_targets, THRESHOLD_IOU)
    before = dict(cuda_build.LAUNCHES)
    got = gaussian.render_label_heatmaps(*args)
    assert cuda_build.LAUNCHES == before  # CPU tensors launch nothing
    assert torch.equal(got, gaussian.render_label_heatmaps_plain(*args))
    assert got.shape == (3 if corner_targets else 1, 4, 32, 32)


@pytest.mark.parametrize("augment", [False, True])
def test_batch_transform_equals_the_per_map_route(augment):
    """``ys`` to the bit as the batch transform built them before it made
    one render call: each map by ``render_heatmap_plain``, the corners
    at ``corner_offsets``, on the (flipped) loc records."""
    samples, locs, counts = _batch(3, 32)
    draws = draw(torch.Generator().manual_seed(5), 4, samples.shape[1],
                 torch.device("cpu")) if augment else None
    _, ys = augment_and_render_batch(
        torch.from_numpy(samples), torch.from_numpy(locs),
        torch.from_numpy(counts), 32, augment=augment, draws=draws,
        corner_targets=True)
    _, center = augment_and_render_batch(
        torch.from_numpy(samples), torch.from_numpy(locs),
        torch.from_numpy(counts), 32, augment=augment, draws=draws)
    assert len(ys) == 6 and len(center) == 4
    flipped = torch.from_numpy(locs)
    if augment:  # the maps are rendered from the flipped records
        h, v = draws.flip_h[:, None, None], draws.flip_v[:, None, None]
        assert 0 < int(draws.flip_h.sum()) < 4 \
            or 0 < int(draws.flip_v.sum()) < 4
        flipped = torch.where(h, flip_locs_horizontal(flipped, 32), flipped)
        flipped = torch.where(v, flip_locs_vertical(flipped, 32), flipped)
    present = _present(locs, counts)
    want = [gaussian.render_heatmap_plain(flipped, present, 32,
                                          THRESHOLD_IOU)]
    for offset in gaussian.corner_offsets(flipped):
        want.append(gaussian.render_heatmap_plain(
            flipped, present, 32, THRESHOLD_IOU,
            radius_fn=corner_threshold_radius, position_offset=offset))
    for got, ref in zip((ys[0], ys[4], ys[5]), want):
        assert got.shape == (4, 1, 32, 32) and got.dtype == torch.float32
        assert torch.equal(got[:, 0], ref)
    for got, ref in zip(ys[:4], center):
        assert torch.equal(got, ref)
    assert ys[1].dtype == torch.bool and ys[3].dtype == torch.int64


def test_offset_map_is_the_plain_version_and_the_corner_maps():
    """One corner map at arbitrary offsets, through the kernel's one-map
    set, is ``render_heatmap_plain`` with ``position_offset``; at the
    batch transform's corner offsets it is the tl or br label map."""
    _, locs, counts = _batch(4, 64)
    locs_t, present = torch.from_numpy(locs), _present(locs, counts)
    offset = torch.from_numpy(np.random.default_rng(9).uniform(
        -6, 6, locs.shape[:2] + (2,)).astype(np.float32))
    got = gaussian.render_heatmap(locs_t, present, 64, THRESHOLD_IOU,
                                  radius_fn=corner_threshold_radius,
                                  position_offset=offset)
    assert torch.equal(got, gaussian.render_heatmap_plain(
        locs_t, present, 64, THRESHOLD_IOU, radius_fn=corner_threshold_radius,
        position_offset=offset))
    maps = gaussian.render_label_heatmaps(locs_t, present, 64, True)
    for m, corner in zip((1, 2), gaussian.corner_offsets(locs_t)):
        assert torch.equal(maps[m], gaussian.render_heatmap(
            locs_t, present, 64, THRESHOLD_IOU,
            radius_fn=corner_threshold_radius, position_offset=corner))
    assert torch.equal(maps[0], gaussian.render_heatmap(
        locs_t, present, 64, radius_fn=center_threshold_radius))


def test_wrappers_refuse_what_the_kernel_cannot_take():
    _, locs, counts = _batch(5, 32)
    locs_t, present = torch.from_numpy(locs), _present(locs, counts)
    k = gaussian.MAX_OBJECTS + 1
    too_many = torch.zeros((1, k, 8)), torch.zeros((1, k), dtype=torch.bool)
    with pytest.raises(ValueError, match="at most"):
        gaussian.render_label_heatmaps(*too_many, 32)
    with pytest.raises(ValueError, match="at most"):
        gaussian.render_heatmap(*too_many, 32)
    for fn in (gaussian.render_label_heatmaps, gaussian.render_heatmap):
        with pytest.raises(TypeError, match="float32"):
            fn(locs_t.double(), present, 32)
        with pytest.raises(TypeError, match="bool or uint8"):
            fn(locs_t, present.float(), 32)
        with pytest.raises(ValueError, match="one cuda or cpu device"):
            fn(locs_t, present.to("meta"), 32)
        with pytest.raises(ValueError, match=r"\(B, K\)"):
            fn(locs_t, present[:, :3], 32)
    for bad in ("legacy", 3, None):
        with pytest.raises(ValueError, match="corner_targets"):
            gaussian.render_label_heatmaps(locs_t, present, 32, bad)
    with pytest.raises(ValueError, match="center radius"):
        gaussian.render_heatmap(locs_t, present, 32,
                                position_offset=torch.zeros((4, 30, 2)))
    with pytest.raises(ValueError, match="center radius"):
        gaussian.render_heatmap(locs_t, present, 32,
                                radius_fn=lambda w, h, t: w)
    with pytest.raises(ValueError, match="position_offset"):
        gaussian.render_heatmap(locs_t, present, 32,
                                radius_fn=corner_threshold_radius,
                                position_offset=torch.zeros((4, 30, 3)))
    with pytest.raises(ValueError, match="one cuda or cpu device"):
        gaussian.render_heatmap(locs_t, present, 32,
                                radius_fn=corner_threshold_radius,
                                position_offset=torch.zeros((4, 30, 2),
                                                            device="meta"))
