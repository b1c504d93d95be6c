"""The port's ops against the JAX package on the same numpy inputs (CPU):
corner pools (plain path of the kernel wrapper) against the interpret-
mode Pallas kernel and the JAX pools, exactly; slide grayscale, reflect
padding and per-clip standardisation; NMS, top-K and gather."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_common import nchw, nhwc

from scd_resnet_tpu.ops import corner_pool as jax_pool
from scd_resnet_tpu.ops.augment import normalize as jax_normalize
from scd_resnet_tpu.ops.decode import (
    extract_topk as jax_extract_topk,
    non_maximum_suppression as jax_nms,
    reshape_gather_features as jax_gather,
)
from scd_resnet_tpu.ops.image import (
    grayscale_inference_u8 as jax_grayscale_u8,
    pad_reflect_hybrid as jax_pad_reflect_hybrid,
)
from scd_resnet_tpu.ops.pallas_kernels import corner_pool_pallas
from scd_resnet_tpu_torch.core import cuda_build
from scd_resnet_tpu_torch.ops import corner_pool as port_pool
from scd_resnet_tpu_torch.ops.augment import normalize
from scd_resnet_tpu_torch.ops.decode import (
    clamp_sigmoid,
    extract_topk,
    non_maximum_suppression,
    reshape_gather_features,
)
from scd_resnet_tpu_torch.ops.image import grayscale_inference_u8, pad_reflect_hybrid

# name -> (JAX NHWC axis, reverse); the port's NCHW dim is axis + 1
DIRECTIONS = {"top": (1, True), "bottom": (1, False),
              "left": (2, True), "right": (2, False)}


def _pool_input(kind: str) -> np.ndarray:
    rng = np.random.default_rng(0 if kind == "random" else 1)
    shape = (2, 12, 10, 8)  # NHWC
    if kind == "random":
        return rng.normal(size=shape).astype(np.float32)
    # ReLU'd small integers: long runs of equal values and zeros
    return np.maximum(rng.integers(-3, 4, shape), 0).astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("direction", sorted(DIRECTIONS))
def test_corner_pool_matches_jax(direction, kind):
    axis, reverse = DIRECTIONS[direction]
    x = _pool_input(kind)
    before = dict(cuda_build.LAUNCHES)
    got = nhwc(getattr(port_pool, direction + "_pool")(nchw(x)))
    assert cuda_build.LAUNCHES == before  # CPU tensors launch nothing
    pallas = np.asarray(corner_pool_pallas(jnp.asarray(x), axis, reverse,
                                           interpret=True))
    ref = np.asarray(getattr(jax_pool, direction + "_pool")(jnp.asarray(x)))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        nhwc(port_pool.corner_pool_plain(nchw(x), axis + 1, reverse)), ref)


def test_corner_pool_upcasts_half_precision_exactly():
    x = torch.from_numpy(_pool_input("random")).to(torch.bfloat16)
    got = port_pool.top_pool(x)
    assert got.dtype == torch.bfloat16
    ref = port_pool.corner_pool_plain(x.float(), 2, True).to(torch.bfloat16)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("direction", sorted(DIRECTIONS))
def test_corner_pool_channels_last_equals_nchw(direction, kind, dtype):
    """A channels-last input (a bfloat16 training step's) gives the NCHW
    input's values and gradient, in its own layout and type; the pool's
    input and output and their gradients each cross the kernels' NCHW
    boundary once."""
    x = nchw(_pool_input(kind)).to(getattr(torch, dtype))
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(3)
                    ).to(x.dtype)
    pool = getattr(port_pool, direction + "_pool")
    results = []
    for fmt in (torch.contiguous_format, torch.channels_last):
        leaf = x.contiguous(memory_format=fmt).requires_grad_(True)
        cuda_build.reset_launches()
        out = pool(leaf)
        out.backward(g.contiguous(memory_format=fmt))
        copies = sum(cuda_build.LAYOUT_COPIES.values())
        results.append((out, leaf.grad, copies))
    (out, grad, copies), (out_cl, grad_cl, copies_cl) = results
    assert copies == 0 and copies_cl == 4
    for t in (out_cl, grad_cl):
        assert t.dtype == x.dtype
        assert t.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(out_cl, out) and torch.equal(grad_cl, grad)


@pytest.mark.parametrize("bad", ["rank", "dim", "dtype"])
def test_corner_pool_wrapper_rejects_bad_input(bad):
    x = torch.zeros(1, 2, 3, 4)
    args = {"rank": (x[0], 2, False), "dim": (x, 1, False),
            "dtype": (x.double(), 2, False)}[bad]
    with pytest.raises((ValueError, TypeError)):
        port_pool.corner_pool(*args)


def test_grayscale_matches_jax():
    rgb = np.random.default_rng(2).integers(0, 256, (37, 53, 3), np.uint8)
    got = grayscale_inference_u8(rgb)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, jax_grayscale_u8(rgb))


@pytest.mark.parametrize("shape,pads", [((2056, 3092), (54, 20)),
                                        ((600, 700), (34, 84)),
                                        ((5, 4), (7, 9)),
                                        ((1, 3), (2, 2))])
def test_pad_reflect_hybrid_matches_jax(shape, pads):
    image = np.random.default_rng(3).integers(0, 256, shape, np.uint8)
    np.testing.assert_array_equal(pad_reflect_hybrid(image, *pads),
                                  jax_pad_reflect_hybrid(image, *pads))


def test_normalize_matches_jax():
    rng = np.random.default_rng(4)
    clips = rng.integers(0, 256, (3, 64, 48)).astype(np.float32)
    clips[1] = 17.0  # a constant clip maps to zeros, not NaN
    got = normalize(torch.from_numpy(clips)).numpy()
    for i in range(len(clips)):
        ref = np.asarray(jax_normalize(jnp.asarray(clips[i])))
        np.testing.assert_allclose(got[i], ref, rtol=0, atol=1e-5)
    assert not got[1].any()


def test_nms_topk_gather_match_jax():
    """NMS, top-K and gather on an NCHW map against the JAX NHWC ops:
    scores within 1e-6, indices equal where the score is above 0."""
    rng = np.random.default_rng(5)
    heat = rng.uniform(size=(2, 16, 16, 3)).astype(np.float32)
    feat = rng.normal(size=(2, 16, 16, 4)).astype(np.float32)
    got_heat = non_maximum_suppression(nchw(heat))
    ref_heat = np.asarray(jax_nms(jnp.asarray(heat)))
    np.testing.assert_array_equal(nhwc(got_heat), ref_heat)
    got = extract_topk(got_heat, 40)
    ref = jax_extract_topk(jnp.asarray(ref_heat), 40)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-6)
    live = np.asarray(ref[0]) > 0
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(g.numpy()[live], np.asarray(r)[live])
    gathered = reshape_gather_features(nchw(feat), got[1])
    np.testing.assert_array_equal(
        gathered.numpy(), np.asarray(jax_gather(jnp.asarray(feat), ref[1])))
    s = clamp_sigmoid(torch.tensor([-20.0, 0.0, 20.0]))
    assert s.tolist() == pytest.approx([1e-4, 0.5, 1 - 1e-4])
