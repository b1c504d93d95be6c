"""The whole serving slice against the JAX package: the same seeded
weights and the same synthetic grayscale slide (about 700x600, 2x2 clips
of 512^2) through the JAX ``InferenceService`` and the port's, for the
centerOffset and corner contracts.

Detections must agree in number, order and position exactly; scores
within 1e-4 absolute (float32 convolutions sum in another order on each
side). Rhr = (rad - minL) / (2 minL) is held within 1e-4 absolute plus
1e-3 relative: an absolute error e in the regressed lengths becomes
e / (2 minL) in Rhr, and random weights regress minL near 0 at some
peaks, where Rhr runs to the hundreds. The Rhr histogram and its
two-Gaussian fit run on both sides' values.

The host helpers (slide geometry, grayscale coercion, stitch, dedupe)
take the same inputs on both sides and must agree exactly."""

import numpy as np
import pytest
import torch

from torch_port_common import FAMILIES, calibrated_variables, port_model

from scd_resnet_tpu.infer.analyse import fit_rhr as jax_fit_rhr
from scd_resnet_tpu.infer.server import InferenceService as JaxService
from scd_resnet_tpu.infer.wrapper import make_wrapper as jax_make_wrapper
from scd_resnet_tpu_torch.core import cuda_build
from scd_resnet_tpu_torch.infer import analyse
from scd_resnet_tpu_torch.infer.analyse import fit_rhr, rhr_histogram
from scd_resnet_tpu_torch.infer.server import InferenceService
from scd_resnet_tpu_torch.infer.synthetic import synthetic_slide
from scd_resnet_tpu_torch.infer.wrapper import make_wrapper

SLIDE = synthetic_slide(600, 700, seed=21)


@pytest.fixture(autouse=True)
def slide_batch(monkeypatch):
    """The slide's 4 clips run as one batch of 4: the analyzer pads a
    slide of fewer than ``BATCH_SIZE`` clips to that batch, which on the
    CPU only adds blank clips' forwards (``test_torch_mesh_serving.py``
    holds the padding)."""
    monkeypatch.setattr(analyse, "BATCH_SIZE", 4)


def _clips():
    from scd_resnet_tpu_torch.infer.analyse import make_device_tiler

    tiler = make_device_tiler(SLIDE.shape[1], SLIDE.shape[0],
                              torch.device("cpu"))
    return tiler(torch.from_numpy(SLIDE))


def _serve_both(family):
    jax_model = FAMILIES[family][0]()
    params, stats = calibrated_variables(family, 13, _clips())
    jax_wrapper = jax_make_wrapper(jax_model, params, stats, family=family)
    jax_wrapper.contract = family
    ref = JaxService(wrapper=jax_wrapper).analyse_gray(SLIDE)
    port = InferenceService(make_wrapper(port_model(family, params, stats),
                                         family))
    before = dict(cuda_build.LAUNCHES)
    got = port.analyse_gray(SLIDE)
    assert cuda_build.LAUNCHES == before  # the CPU path launches nothing
    return got, ref


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_slice_matches_jax(family):
    got, ref = _serve_both(family)
    assert len(got) == len(ref)
    got_xy = [d[:2] for d in got]
    assert got_xy == [d[:2] for d in ref]
    if family == "centerOffset":
        assert len(got) >= 40
        got_rhr = np.array([d[2] for d in got])
        ref_rhr = np.array([d[2] for d in ref])
        finite = np.isfinite(ref_rhr)
        np.testing.assert_array_equal(np.isfinite(got_rhr), finite)
        np.testing.assert_allclose(got_rhr[finite], ref_rhr[finite],
                                   rtol=1e-3, atol=1e-4)
        np.testing.assert_array_equal(rhr_histogram(got_rhr[finite])[1] > 0,
                                      rhr_histogram(ref_rhr[finite])[1] > 0)
        np.testing.assert_allclose(fit_rhr(got_rhr[finite]),
                                   jax_fit_rhr(ref_rhr[finite]),
                                   rtol=0, atol=1e-3)
    else:
        for head in ("ct", "tl", "br"):
            assert sum(d[3] == head for d in ref) >= 40, head
        assert [d[3] for d in got] == [d[3] for d in ref]
        np.testing.assert_allclose([d[2] for d in got], [d[2] for d in ref],
                                   rtol=0, atol=1e-4)
    for x, y in got_xy:
        assert 0 <= x < SLIDE.shape[1] and 0 <= y < SLIDE.shape[0]


def test_device_tiler_matches_host_tiling():
    """The port's on-device tiler (index-gather pad, unfold, per-clip
    standardisation) against the JAX package's host ``tile_slide``."""
    from scd_resnet_tpu.infer.analyse import tile_slide

    ref, clip_h, clip_v, _, _ = tile_slide(SLIDE.astype(np.float32))
    got = _clips().numpy()
    assert got.shape == (clip_h * clip_v, 1, 512, 512)
    np.testing.assert_allclose(got[:, 0], ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("width,height", [(3092, 2056), (700, 600),
                                          (512, 512), (1001, 389)])
def test_slide_geometry_matches_jax(width, height):
    from scd_resnet_tpu.infer.analyse import slide_geometry as jax_geometry
    from scd_resnet_tpu_torch.infer.analyse import slide_geometry

    assert slide_geometry(width, height) == jax_geometry(width, height)


@pytest.mark.parametrize("kind", ["uint8", "uint16", "float", "bright_float"])
def test_coerce_gray_u8_matches_jax(kind):
    from scd_resnet_tpu.infer.analyse import coerce_gray_u8 as jax_coerce
    from scd_resnet_tpu_torch.infer.analyse import coerce_gray_u8

    rng = np.random.default_rng(8)
    gray = {"uint8": lambda: rng.integers(0, 256, (31, 47), np.uint8),
            "uint16": lambda: rng.integers(0, 65536, (31, 47), np.uint16),
            "float": lambda: rng.uniform(-9, 260, (31, 47)),
            "bright_float": lambda: rng.uniform(0, 4000, (31, 47))}[kind]()
    got = coerce_gray_u8(gray)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, jax_coerce(gray))


@pytest.mark.parametrize("contract", ["centerOffset", "corner"])
def test_stitch_and_dedupe_match_jax(contract):
    """Host stitch (clip -> slide pixels, threshold, bounds) and the
    tile-overlap dedupe on the same random decode rows, exactly."""
    from scd_resnet_tpu.infer.analyse import (
        dedupe_contract as jax_dedupe,
        stitch_any as jax_stitch,
    )
    from scd_resnet_tpu_torch.infer.analyse import (
        dedupe_contract,
        slide_geometry,
        stitch_any,
    )

    width, height = 1001, 789
    geometry = slide_geometry(width, height)
    n_clips, k = geometry[0] * geometry[1], 30
    rng = np.random.default_rng(9)
    n_rows = 10 if contract == "centerOffset" else 12
    rows = rng.uniform(0, 128, (n_rows, n_clips, k))
    for score_row in range(0, n_rows if contract == "corner" else 1, 4):
        rows[score_row] = rng.uniform(0, 1, (n_clips, k))
    if contract == "centerOffset":
        rows[4:8] = rng.uniform(0.5, 30, (4, n_clips, k))  # regr lengths
        rows[8:10] = rng.uniform(0, 1, (2, n_clips, k))  # offsets
    got = stitch_any(rows, contract, *geometry, (width, height))
    ref = jax_stitch(rows, contract, *geometry, (width, height))
    assert len(got) > 50 and got == ref
    assert dedupe_contract(got, 16.0, contract) == jax_dedupe(ref, 16.0,
                                                             contract)
