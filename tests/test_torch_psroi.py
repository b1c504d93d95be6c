"""Deformable PSROI pooling, ``DCNPooling`` and the pooling factories of
the port (``ops/dcn.deform_psroi_pooling``, ``models/deformable.
DCNPooling``, ``models/pooling.py``) against the reference's compiled
op and the JAX package, on the CPU.

Tolerances:
- the ``psroi_*`` goldens (the reference's DCNv2 CPU extension, forward
  and the input and trans gradients): 2e-5, the JAX package's own
  (tests/test_native_goldens.py:119-156);
- JAX's function on random inputs: 2e-5 relative to the largest value
  (means of 16 samples of 4 corners, summed in another order);
- ``DCNPooling`` with flax's weights carried over: 1e-5 relative (two
  1024-wide float32 products in another order, then the deformable pass);
- pooling: max pools exact, means and resizes 1e-5 (float32 sums in
  another order); the bicubic resize is JAX's Keys a = -0.5, so it is
  held to JAX within 1e-5 and to torch's a = -0.75 only within 0.02 on a
  smooth field (tests/test_pooling.py's bound).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scd_resnet_tpu.models import pooling as jpool
from scd_resnet_tpu.models.deformable import DCNPooling as JaxDCNPooling
from scd_resnet_tpu.ops.dcn import deform_psroi_pooling as jax_psroi
from scd_resnet_tpu_torch.core.convert import dcn_pooling_state_dict
from scd_resnet_tpu_torch.models import pooling as tpool
from scd_resnet_tpu_torch.models.deformable import DCNPooling
from scd_resnet_tpu_torch.ops.dcn import deform_psroi_pooling

import torch_port_common  # noqa: F401  (the CPU-thread rule)

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "goldens", "native_goldens.npz")


@pytest.fixture(scope="module")
def g():
    return np.load(GOLDENS)


def _golden_kw(g):
    output_dim, group_size, pooled, part, spp = (int(v)
                                                 for v in g["psroi_geom"])
    scale, trans_std = (float(v) for v in g["psroi_scales"])
    return dict(output_dim=output_dim, group_size=group_size,
                pooled_size=pooled, spatial_scale=scale,
                trans_std=trans_std, sample_per_part=spp, part_size=part)


def _forward_backward(x, rois, trans, cotangent, **kw):
    x = torch.tensor(x, requires_grad=True)
    trans = torch.tensor(trans, requires_grad=True)
    out = deform_psroi_pooling(x, torch.tensor(rois), trans, **kw)
    out.backward(torch.tensor(cotangent))
    gtrans = trans.grad if trans.grad is not None else torch.zeros_like(
        trans)
    return out.detach().numpy(), x.grad.numpy(), gtrans.numpy()


@pytest.mark.parametrize("tag,no_trans", [("", False), ("_nt", True)])
def test_psroi_matches_reference_goldens(g, tag, no_trans):
    out, gx, gtrans = _forward_backward(
        g["psroi_input"], g["psroi_rois"], g["psroi_trans"],
        g["psroi_grad_out"], no_trans=no_trans, **_golden_kw(g))
    np.testing.assert_allclose(out, g["psroi_out" + tag], rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(gx, g["psroi_grad_input" + tag], rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(gtrans, g["psroi_grad_trans" + tag],
                               rtol=2e-5, atol=2e-5)


def _random_case(seed):
    """x (2, 3 * 3^2, 20, 24) with ROIs that reach past the map, part of
    them thinner than a bin, and displacements of up to a bin."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 27, 20, 24)).astype(np.float32)
    rois = np.array([[0, 4, 6, 50, 40], [1, 10, 2, 90, 70],
                     [0, 0, 0, 95, 79], [1, -20, 30, 120, 31],
                     [0, 60, 60, 61, 61]], np.float32)
    trans = rng.normal(0, 2, (5, 2, 3, 3)).astype(np.float32)
    ct = rng.normal(size=(5, 3, 3, 3)).astype(np.float32)
    return x, rois, trans, ct


@pytest.mark.parametrize("no_trans", [False, True])
def test_psroi_matches_jax(no_trans):
    x, rois, trans, ct = _random_case(1)
    kw = dict(output_dim=3, group_size=3, pooled_size=3, spatial_scale=0.25,
              trans_std=0.1, sample_per_part=4)
    out, gx, gtrans = _forward_backward(x, rois, trans, ct,
                                        no_trans=no_trans, **kw)

    def fwd(xj, tj):
        return jax_psroi(xj, jnp.asarray(rois), tj, no_trans=no_trans, **kw)

    want, vjp = jax.vjp(fwd, jnp.asarray(x.transpose(0, 2, 3, 1)),
                        jnp.asarray(trans.transpose(0, 2, 3, 1)))
    jgx, jgt = vjp(jnp.asarray(ct.transpose(0, 2, 3, 1)))
    for got, ref in ((out, np.asarray(want).transpose(0, 3, 1, 2)),
                     (gx, np.asarray(jgx).transpose(0, 3, 1, 2)),
                     (gtrans, np.asarray(jgt).transpose(0, 3, 1, 2))):
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=2e-5 * max(np.abs(ref).max(), 1.0))
    assert np.abs(out).max() > 0.1
    if not no_trans:
        assert np.abs(gtrans).max() > 0


def test_dcn_pooling_matches_flax():
    x, rois, _, ct = _random_case(2)
    jm = JaxDCNPooling(output_dim=3, pooled_size=3, group_size=3,
                       deform_fc_dim=32)
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), xj,
                            jnp.asarray(rois))["params"])
    # the displacement layer starts at zero; draw it so the deformable
    # pass moves the bins
    rng = np.random.default_rng(3)
    params["Dense_2"] = {
        "kernel": rng.normal(0, 0.5, (32, 18)).astype(np.float32),
        "bias": rng.normal(0, 0.5, 18).astype(np.float32)}
    want = np.asarray(jm.apply({"params": params}, xj, jnp.asarray(rois)))
    model = DCNPooling(3, pooled_size=3, group_size=3, deform_fc_dim=32)
    model.load_state_dict(dcn_pooling_state_dict(params), strict=True)
    got = model(torch.from_numpy(x), torch.from_numpy(rois))
    assert got.shape == (5, 3, 3, 3)
    ref = want.transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    base = deform_psroi_pooling(torch.from_numpy(x), torch.from_numpy(rois),
                                None, no_trans=True, **model.pool_args)
    assert (got - base).abs().max() > 1e-3  # the displacements moved it
    # a fresh module starts as the no-trans pass: its last layer is zero
    fresh = DCNPooling(3, pooled_size=3, group_size=3, deform_fc_dim=32)
    assert torch.equal(fresh(torch.from_numpy(x), torch.from_numpy(rois)),
                       base)
    got.backward(torch.from_numpy(ct))
    assert model.fc[4].weight.grad.abs().max() > 0
    no_trans = DCNPooling(3, pooled_size=3, group_size=3, no_trans=True)
    assert len(list(no_trans.parameters())) == 0
    assert torch.equal(no_trans(torch.from_numpy(x), torch.from_numpy(rois)),
                       base)


def _nchw(x):
    return torch.from_numpy(np.moveaxis(x, -1, 1).copy())


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


@pytest.fixture(scope="module")
def x():
    return np.random.default_rng(0).normal(size=(2, 12, 16, 3)).astype(
        np.float32)


@pytest.mark.parametrize("ptype", ["MaximalPool", "AveragePool"])
@pytest.mark.parametrize("scale", [2, 4])
def test_pooling_layer_matches_jax(x, ptype, scale):
    got = _nhwc(tpool.pooling_layer(scale, tpool.PoolingType[ptype])(
        _nchw(x)))
    want = np.asarray(jpool.pooling_layer(scale, jpool.PoolingType[ptype])(x))
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("ptype", ["MaximalPool", "AveragePool"])
@pytest.mark.parametrize("out_hw", [(6, 8), (5, 7), (3, 16), (12, 16)])
def test_adaptive_pooling_matches_jax(x, ptype, out_hw):
    oh, ow = out_hw
    got = _nhwc(tpool.adaptive_pooling_layer(ow, oh, tpool.PoolingType[ptype])(
        _nchw(x)))
    want = np.asarray(jpool.adaptive_pooling_layer(
        ow, oh, jpool.PoolingType[ptype])(x))
    assert got.shape == (2, oh, ow, 3)
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("mode,scale", [
    ("NearestNeighbour", 2), ("NearestNeighbour", 3),
    ("NearestNeighbour", 1.5), ("Bilinear", 2), ("Bilinear", 3),
    ("Bicubic", 2)])
def test_unpooling_2d_matches_jax(x, mode, scale):
    got = _nhwc(tpool.unpooling_layer(scale, tpool.UpsampleType[mode])(
        _nchw(x)))
    want = np.asarray(jpool.unpooling_layer(scale,
                                            jpool.UpsampleType[mode])(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("mode,shape", [("Linear", (2, 9, 4)),
                                        ("Trilinear", (1, 4, 6, 5, 2))])
def test_unpooling_1d_3d_match_jax(mode, shape):
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    got = _nhwc(tpool.unpooling_layer(2, tpool.UpsampleType[mode])(_nchw(x)))
    want = np.asarray(jpool.unpooling_layer(2, jpool.UpsampleType[mode])(x))
    np.testing.assert_allclose(got, want, atol=1e-5)
    ref = torch.nn.Upsample(scale_factor=2, mode=mode.lower())(_nchw(x))
    np.testing.assert_allclose(got, _nhwc(ref), atol=1e-5)


def test_unpooling_bicubic_is_jax_keys_kernel():
    yy, xx = np.meshgrid(np.linspace(0, 1, 10), np.linspace(0, 1, 12),
                         indexing="ij")
    field = (np.sin(3 * xx) * np.cos(2 * yy)).astype(np.float32)[None, :, :,
                                                                 None]
    got = _nhwc(tpool.unpooling_layer(2, tpool.UpsampleType.Bicubic)(
        _nchw(field)))
    ref = _nhwc(torch.nn.Upsample(scale_factor=2, mode="bicubic")(
        _nchw(field)))
    assert np.abs(got - ref).max() < 0.02


def test_unpooling_rank_guard_and_aliases():
    with pytest.raises(ValueError):
        tpool.unpooling_layer(2, tpool.UpsampleType.Trilinear)(
            torch.zeros(1, 2, 4, 4))
    with pytest.raises(ValueError):
        tpool.pooling_layer(2, "max")
    assert tpool.poolingLayer is tpool.pooling_layer
    assert tpool.adaptivePoolingLayer is tpool.adaptive_pooling_layer
    assert tpool.unpoolingLayer is tpool.unpooling_layer
    assert [m.value for m in tpool.PoolingType] == [
        m.value for m in jpool.PoolingType]
    assert [m.value for m in tpool.UpsampleType] == [
        m.value for m in jpool.UpsampleType]
