"""The corner training slice's kernels' plain versions against the JAX
package on the same numpy inputs (CPU): the corner-pool backward (K3's
plain version) against JAX's scan VJP and the interpret-mode Pallas
kernel, the pools' gradient through ``CornerPool`` against ``jax.vjp``,
and the stem max-pool backward (K5's plain version) against ``jax.grad``
of the JAX stem pool and the interpret-mode Pallas probe.

Tolerances, each with its reason:

- corner-pool backward: the zero pattern (which element takes a
  gradient: the routing) equal, values within 1e-5 absolute on inputs
  of magnitude 1: both sides take a suffix cumsum of g in float32 in
  their own order; bf16 gradients within one bf16 ulp, since a float32
  sum that differs in its last bits may round to the neighbouring bf16
  value;
- max-pool backward in float32: within 1e-6 of the largest gradient,
  the zero patterns equal: each pixel adds at most four window
  gradients, in another order than XLA's SelectAndScatter; against the
  Pallas probe in bf16, within one bf16 ulp (it accumulates in float32
  and rounds once, as the plain version does).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from scd_resnet_tpu.models.layers import max_pool_3x3_s2 as jax_max_pool
from scd_resnet_tpu.ops import corner_pool as jax_pool
from scd_resnet_tpu.ops.pallas_kernels import corner_pool_bwd_pallas
from scd_resnet_tpu_torch.core import cuda_build
from scd_resnet_tpu_torch.models.layers import stem
from scd_resnet_tpu_torch.ops import corner_pool as port_pool
from scd_resnet_tpu_torch.ops import max_pool as port_max_pool

from torch_port_common import nchw, nhwc

# name -> (JAX NHWC axis, reverse); the port's NCHW dim is axis + 1
DIRECTIONS = {"top": (1, True), "bottom": (1, False),
              "left": (2, True), "right": (2, False)}


def _pool_inputs(kind: str, shape=(2, 12, 10, 8)):
    """(x, g) NHWC float32: normal x, or ReLU'd small integers (long runs
    of ties and zeros, as after a ReLU), and a normal cotangent."""
    rng = np.random.default_rng({"random": 0, "ties": 1}[kind])
    if kind == "random":
        x = rng.normal(size=shape)
    else:
        x = np.maximum(rng.integers(-3, 4, shape), 0)
    return x.astype(np.float32), rng.normal(size=shape).astype(np.float32)


def _jax_bwd(x, g, axis, reverse):
    return np.asarray(jax_pool._pool_bwd(axis, reverse, jnp.asarray(x),
                                         jnp.asarray(g))[0])


def _assert_routed_alike(got, want, atol=1e-5):
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("direction", sorted(DIRECTIONS))
def test_corner_pool_bwd_plain_matches_jax(direction, kind):
    axis, reverse = DIRECTIONS[direction]
    x, g = _pool_inputs(kind)
    before = dict(cuda_build.LAUNCHES)
    got = nhwc(port_pool.corner_pool_bwd(nchw(x), nchw(g), axis + 1,
                                         reverse))
    assert cuda_build.LAUNCHES == before  # CPU tensors launch nothing
    _assert_routed_alike(got, _jax_bwd(x, g, axis, reverse))
    pallas = np.asarray(corner_pool_bwd_pallas(
        jnp.asarray(x), jnp.asarray(g), axis, reverse, interpret=True))
    _assert_routed_alike(got, pallas)


def _cummax_autograd(x, g, dim, reverse):
    """torch.cummax's own gradient: a tie goes to the last tied element."""
    x = x.clone().requires_grad_(True)
    out = port_pool.corner_pool_plain(x, dim, reverse)
    out.backward(g)
    return x.grad


def test_corner_pool_bwd_routes_ties_to_the_first():
    """bottom_pool on x = [1, 3, 3, 2, 3, 5] along H with cotangent 1..6:
    the tied 3s give their gradient to the first 3, as the JAX package and
    the reference's C++ pools do; torch.cummax's autograd gives
    [1, 2, 7, 0, 5, 6], and fails the check a real backward passes."""
    x = torch.tensor([1.0, 3, 3, 2, 3, 5]).view(1, 1, 6, 1)
    g = torch.arange(1.0, 7.0).view(1, 1, 6, 1)
    want = [1.0, 14.0, 0.0, 0.0, 0.0, 6.0]
    assert port_pool.corner_pool_bwd_plain(x, g, 2, False).flatten() \
        .tolist() == want
    leaf = x.clone().requires_grad_(True)
    port_pool.bottom_pool(leaf).backward(g)
    assert leaf.grad.flatten().tolist() == want
    assert _jax_bwd(nhwc(x), nhwc(g), 1, False).flatten().tolist() == want
    assert _cummax_autograd(x, g, 2, False).flatten().tolist() == \
        [1.0, 2.0, 7.0, 0.0, 5.0, 6.0]
    # the planted fault on the tie-heavy inputs fails the check
    xs, gs = _pool_inputs("ties")
    for direction, (axis, reverse) in DIRECTIONS.items():
        with pytest.raises(AssertionError):
            _assert_routed_alike(nhwc(_cummax_autograd(
                nchw(xs), nchw(gs), axis + 1, reverse)),
                _jax_bwd(xs, gs, axis, reverse))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_gradients_match_jax_vjp(dtype):
    """Every pool's gradient through ``CornerPool`` (the casts outside it,
    as the JAX ``_pool``) against ``jax.vjp`` of the JAX pool."""
    x, g = _pool_inputs("ties")
    x = x + np.random.default_rng(2).choice([0.0, 0.5], x.shape)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    for direction in DIRECTIONS:
        jax_fn = getattr(jax_pool, direction + "_pool")
        out, vjp = jax.vjp(jax_fn, jnp.asarray(x, jdt))
        (want,) = vjp(jnp.asarray(g, jdt))
        leaf = nchw(x).to(tdt).requires_grad_(True)
        got = getattr(port_pool, direction + "_pool")(leaf)
        assert got.dtype == tdt
        np.testing.assert_array_equal(
            nhwc(got.float()), np.asarray(out, np.float32))
        got.backward(nchw(g).to(tdt))
        assert leaf.grad.dtype == tdt
        got_g = nhwc(leaf.grad.float())
        want_g = np.asarray(want, np.float32)
        atol = 1e-5 if dtype == "float32" else \
            2.0 ** (np.floor(np.log2(np.abs(want_g).max())) - 7)
        _assert_routed_alike(got_g, want_g, atol=atol)


def test_corner_pool_bwd_wrapper_rejects_bad_input():
    x = torch.zeros(1, 2, 3, 4)
    with pytest.raises(ValueError):
        port_pool.corner_pool_bwd(x, torch.zeros(1, 2, 3, 5), 2, False)
    with pytest.raises(TypeError):
        port_pool.corner_pool_bwd(x.double(), x.double(), 2, False)
    with pytest.raises(ValueError):
        port_pool.corner_pool_bwd(x, x, 1, False)


def _stem_input(kind: str, shape):
    rng = np.random.default_rng({"random": 3, "ties": 4}[kind])
    if kind == "random":
        x = rng.normal(size=shape)
    else:  # ReLU'd small integers: windows with tied maxima and zeros
        x = np.maximum(rng.integers(-2, 3, shape), 0)
    return x.astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 16, 16, 3), (1, 13, 9, 4),
                                   (2, 7, 10, 2), (1, 1, 1, 2)],
                         ids=["even", "odd", "mixed", "single"])
@pytest.mark.parametrize("kind", ["random", "ties"])
def test_max_pool_bwd_plain_matches_jax_grad(kind, shape):
    x = _stem_input(kind, shape)
    b, h, w, c = shape
    dy = np.random.default_rng(5).normal(
        size=(b, (h - 1) // 2 + 1, (w - 1) // 2 + 1, c)).astype(np.float32)
    want = np.asarray(jax.grad(lambda v: jnp.sum(
        jax_max_pool(v) * jnp.asarray(dy)))(jnp.asarray(x)))
    before = dict(cuda_build.LAUNCHES)
    got = nhwc(port_max_pool.max_pool_3x3_s2_bwd(nchw(x), nchw(dy)))
    assert cuda_build.LAUNCHES == before  # CPU tensors launch nothing
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    # the stem's pool: nn.MaxPool2d's forward, this backward
    leaf = nchw(x).requires_grad_(True)
    out = port_max_pool.max_pool_3x3_s2(leaf)
    assert torch.equal(out, F.max_pool2d(nchw(x), 3, 2, 1))
    out.backward(nchw(dy))
    np.testing.assert_array_equal(nhwc(leaf.grad), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 16, 16, 3), (1, 13, 9, 4),
                                   (2, 7, 10, 2), (1, 1, 1, 2)],
                         ids=["even", "odd", "mixed", "single"])
def test_max_pool_channels_last_equals_nchw(shape, dtype):
    """The stem's pool on a channels-last input (a bfloat16 training
    step's) gives the NCHW input's values and gradient, in its own
    layout; ``x``, ``dy`` and ``dx`` each cross K5's NCHW boundary once
    (none where the maps are 1x1, which both layouts share)."""
    x = nchw(_stem_input("ties", shape)).to(getattr(torch, dtype))
    b, h, w, c = shape
    dy = torch.randn((b, c, (h - 1) // 2 + 1, (w - 1) // 2 + 1),
                     generator=torch.Generator().manual_seed(8)).to(x.dtype)
    results = []
    for fmt in (torch.contiguous_format, torch.channels_last):
        leaf = x.contiguous(memory_format=fmt).requires_grad_(True)
        cuda_build.reset_launches()
        out = port_max_pool.max_pool_3x3_s2(leaf)
        out.backward(dy.contiguous(memory_format=fmt))
        results.append((out, leaf.grad, dict(cuda_build.LAYOUT_COPIES)))
    (out, grad, copies), (out_cl, grad_cl, copies_cl) = results
    assert not any(copies.values())
    assert copies_cl.get(port_max_pool.KERNEL_NAME, 0) == (
        0 if h == w == 1 else 3)
    assert grad_cl.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(out_cl, out) and torch.equal(grad_cl, grad)


def test_max_pool_bwd_plain_matches_pallas_probe():
    """At C = 64 in bf16, the probe's only layout."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "pool_bwd_pallas_probe.py")
    spec = importlib.util.spec_from_file_location("pool_bwd_pallas_probe",
                                                  path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    pool_bwd_pallas = probe.pool_bwd_pallas

    x = _stem_input("ties", (1, 8, 8, 64))
    x = x + np.random.default_rng(6).choice([0.0, 0.5], x.shape)
    dy = np.random.default_rng(7).normal(size=(1, 4, 4, 64))
    xb = jnp.asarray(x, jnp.bfloat16)
    dyb = jnp.asarray(dy, jnp.bfloat16)
    want = np.asarray(pool_bwd_pallas(xb, dyb, interpret=True), np.float32)
    got = port_max_pool.max_pool_3x3_s2_bwd(
        nchw(np.asarray(xb, np.float32)).bfloat16(),
        nchw(np.asarray(dyb, np.float32)).bfloat16())
    got = nhwc(got.float())
    np.testing.assert_array_equal(got == 0, want == 0)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= ulp)


def test_stem_forward_is_max_pool2d_and_state_dict_unchanged():
    torch.manual_seed(0)
    block = stem(8).eval()
    ref = torch.nn.Sequential(torch.nn.Conv2d(1, 8, 7, 2, 3, bias=False),
                              torch.nn.BatchNorm2d(8), torch.nn.ReLU(),
                              torch.nn.MaxPool2d(3, 2, 1)).eval()
    ref.load_state_dict(block.state_dict(), strict=True)
    x = torch.randn(2, 1, 37, 30)
    with torch.inference_mode():
        assert torch.equal(block(x), ref(x))


def test_max_pool_bwd_wrapper_rejects_bad_input():
    x = torch.zeros(1, 2, 6, 7)
    with pytest.raises(ValueError):
        port_max_pool.max_pool_3x3_s2_bwd(x, torch.zeros(1, 2, 3, 3))
    with pytest.raises(TypeError):
        port_max_pool.max_pool_3x3_s2_bwd(x.half(), torch.zeros(1, 2, 3, 4)
                                          .half())
    with pytest.raises(ValueError):
        port_max_pool.max_pool_3x3_s2_bwd(x[0], torch.zeros(2, 3, 4))


def test_max_pool_bwd_plain_adds_windows_in_ascending_order():
    """Pixel (1, 1) is the maximum of all four windows (0, 0), (0, 1),
    (1, 0), (1, 1); with their dy (2^24, 1, -2^24, 1) the float32 sum in
    ascending (oy, ox) order is ((2^24 + 1) - 2^24) + 1 = 1 (2^24 + 1
    rounds to 2^24), in the reverse order 2. The kernel adds in the same
    ascending order and is held to this version to the bit on the card."""
    x = torch.zeros(1, 1, 4, 4)
    x[0, 0, 1, 1] = 10.0
    dy = torch.tensor([[2.0 ** 24, 1.0], [-2.0 ** 24, 1.0]]).view(1, 1, 2, 2)
    reverse = np.float32(0)
    for v in dy.flatten().numpy()[::-1]:
        reverse = np.float32(reverse + v)
    assert reverse == 2.0
    want = torch.zeros(1, 1, 4, 4)
    want[0, 0, 1, 1] = 1.0
    assert torch.equal(port_max_pool.max_pool_3x3_s2_bwd_plain(x, dy), want)
    assert torch.equal(port_max_pool.max_pool_3x3_s2_bwd(x, dy), want)


@pytest.mark.parametrize("case", ["dy_other_type", "float16", "float64",
                                  "dy_rows", "dy_batch", "five_dims"])
def test_max_pool_bwd_wrapper_refuses(case):
    """What the kernel does not take the wrapper refuses, on the CPU as
    on the card (the checks come before the device is looked at)."""
    x = torch.zeros(2, 3, 7, 9)
    dy = torch.zeros(2, 3, 4, 5)
    x, dy, error = {
        "dy_other_type": (x.bfloat16(), dy, TypeError),
        "float16": (x.half(), dy.half(), TypeError),
        "float64": (x.double(), dy.double(), TypeError),
        "dy_rows": (x, torch.zeros(2, 3, 3, 5), ValueError),
        "dy_batch": (x, torch.zeros(1, 3, 4, 5), ValueError),
        "five_dims": (x[None], dy[None], ValueError),
    }[case]
    with pytest.raises(error):
        port_max_pool.max_pool_3x3_s2_bwd(x, dy)


def test_pool_gradient_flows_when_the_kernel_output_has_no_graph(
        monkeypatch):
    """On a card the forward kernel fills a fresh tensor with no autograd
    graph; ``CornerPool`` must still carry the gradient to the pool's
    input (without it the branches before every pool got none). Here the
    wrapper is made to return such a tensor on the CPU."""
    monkeypatch.setattr(port_pool, "corner_pool",
                        lambda x, dim, reverse: port_pool.corner_pool_plain(
                            x, dim, reverse).detach())
    x, g = _pool_inputs("random")
    for direction, (axis, reverse) in DIRECTIONS.items():
        leaf = nchw(x).requires_grad_(True)
        getattr(port_pool, direction + "_pool")(leaf).backward(nchw(g))
        _assert_routed_alike(nhwc(leaf.grad), _jax_bwd(x, g, axis, reverse))
