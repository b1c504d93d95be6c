"""The deformable slice against the JAX package (CPU, float32): the gather
and its backward (``ops/dcn.py``), ``deform_conv2d`` against the
reference's compiled DCNv2 goldens and the JAX op, the ``DCN`` module,
the weight converter, a quarter-width ``centerOffsetRes10dcn`` model, and
seeded serving weights for every family (``infer/synthetic.py``).

On these CPU tensors the wrappers compute their plain versions; the
kernels are held to them on the card by ``chip_smoke.py``. Tolerances,
each with its reason:

- the forward gather: equal to the bit to JAX's gather (the port
  evaluates the lerp weights and adds the four corner terms in its
  order), and within 1e-6 absolute (values O(1)) of its onehot and
  interpret-mode Pallas lowerings, which sum the terms through a dot;
- the backward: 1e-5 absolute (values O(1)): dx adds up to a few dozen
  terms and dpy, dpx sum over C in another order than XLA's;
- ``deform_conv2d`` and its five gradients against the goldens: rtol and
  atol 2e-5, the JAX package's own tolerance (``test_native_goldens.py``);
  against the JAX op: 1e-5 relative to each output's largest magnitude
  (the product sums K * Cin terms in another order);
- the module and the model: 1e-4 of each output's largest magnitude, the
  port's tolerance for convolutions (``tests/test_torch_models.py``).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scd_resnet_tpu.models.center_net_offset import CenterNetResidual as JaxCenterNet
from scd_resnet_tpu.models.center_net_offset import decode_center_net as jax_decode
from scd_resnet_tpu.models.deformable import DCN as JaxDCN
from scd_resnet_tpu.ops import dcn as jax_dcn
from scd_resnet_tpu.ops.pallas_kernels import dcn_gather_pallas
from scd_resnet_tpu.train import registry as jax_registry
from scd_resnet_tpu_torch.core import cuda_build
from scd_resnet_tpu_torch.core.convert import state_dict_from_flax
from scd_resnet_tpu_torch.infer import analyse
from scd_resnet_tpu_torch.infer.analyse import SCORE_THRESHOLD, make_device_tiler
from scd_resnet_tpu_torch.infer.server import InferenceService
from scd_resnet_tpu_torch.infer.synthetic import seeded_model, synthetic_slide
from scd_resnet_tpu_torch.infer.wrapper import make_wrapper
from scd_resnet_tpu_torch.models.center_net_offset import (
    CenterNetResidual,
    decode_center_net,
)
from scd_resnet_tpu_torch.models.deformable import DCN
from scd_resnet_tpu_torch.models.resnet import TerminalHead, init_like_flax
from scd_resnet_tpu_torch.ops import dcn
from scd_resnet_tpu_torch.train import registry

from torch_port_common import QUARTER, flax_variables, nchw, nhwc

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens",
                       "native_goldens.npz")
ARCH = "centerOffsetRes10dcnq"


def _awkward_positions(seed: int = 7):
    """x (2, 9, 11, 5) and the sampling positions (2, N) of a 3x3 conv at
    stride 2, padding 2, dilation 2 with offsets N(0, 6^2) (the geometry
    of ``tests/test_dcn.py::test_im2col_methods_agree_on_awkward_geometry``,
    N = 5 * 6 * 9 = 270, not a multiple of the Pallas sample tile), with
    positions exactly at -1, 0, h - 1 and h, integers, and values in
    (-1, 0) and (h - 1, h) written over the first samples."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 9, 11, 5)).astype(np.float32)
    offset = (rng.standard_normal((2, 5, 6, 9, 2)) * 6.0).astype(np.float32)
    py, px = dcn.sampling_positions(torch.from_numpy(offset), 3, 3, 2, 2, 2)
    py, px = py.reshape(2, -1).numpy().copy(), px.reshape(2, -1).numpy().copy()
    h, w = 9, 11
    edges_y = [-1.0, 0.0, h - 1.0, float(h), 3.0, -0.5, h - 0.25, 2.0, -1.0,
               4.5, float(h), 0.0]
    edges_x = [2.0, -1.0, 0.0, 3.5, float(w), w - 1.0, -0.75, w - 0.5, -1.0,
               0.0, 1.25, float(w)]
    py[:, :len(edges_y)] = edges_y
    px[:, :len(edges_x)] = edges_x
    return x, py, px


def test_awkward_positions_cover_the_edges():
    _, py, px = _awkward_positions()
    h, w = 9, 11
    inside = (py > -1) & (py < h) & (px > -1) & (px < w)
    integer = (py == np.floor(py)) & (px == np.floor(px))
    assert (inside & ~integer).any() and (inside & integer).any()
    assert (~inside).sum() > 50  # offsets of 6 reach far out
    for v in (-1.0, 0.0, h - 1.0, float(h)):
        assert (py == v).any()


@pytest.mark.parametrize("method", ["gather", "onehot", "pallas"])
def test_gather_plain_matches_jax(method):
    x, py, px = _awkward_positions()
    fn = {"gather": jax_dcn._bilinear_gather,
          "onehot": jax_dcn._bilinear_gather_onehot,
          "pallas": dcn_gather_pallas}[method]
    want = np.asarray(fn(jnp.asarray(x), jnp.asarray(py), jnp.asarray(px)))
    got = dcn.dcn_gather_plain(*(torch.from_numpy(a) for a in (x, py, px)))
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=0.0 if method == "gather" else 1e-6)
    # the wrapper takes the plain version for CPU tensors and counts no
    # launch
    before = dict(cuda_build.LAUNCHES)
    same = dcn.dcn_gather(*(torch.from_numpy(a) for a in (x, py, px)))
    assert torch.equal(same, got) and cuda_build.LAUNCHES == before


def test_gather_bwd_plain_matches_jax_vjp_and_autograd():
    x, py, px = _awkward_positions()
    g = np.random.default_rng(8).standard_normal(
        (2, py.shape[1], 5)).astype(np.float32)
    _, vjp = jax.vjp(jax_dcn._bilinear_gather, jnp.asarray(x),
                     jnp.asarray(py), jnp.asarray(px))
    want = [np.asarray(a) for a in vjp(jnp.asarray(g))]
    tx, tpy, tpx, tg = (torch.from_numpy(a) for a in (x, py, px, g))
    got = dcn.dcn_gather_bwd_plain(tx, tpy, tpx, tg)
    for name, a, b in zip(("dx", "dpy", "dpx"), got, want):
        assert np.abs(b).max() > 0.5, name
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5,
                                   err_msg=name)
    # the wrapper's backward is the plain one on the CPU
    for a, b in zip(dcn.dcn_gather_bwd(tx, tpy, tpx, tg), got):
        assert torch.equal(a, b)
    # autograd of the plain gather gives the same function
    leaves = [t.clone().requires_grad_() for t in (tx, tpy, tpx)]
    dcn.dcn_gather_plain(*leaves).backward(tg)
    for name, leaf, b in zip(("dx", "dpy", "dpx"), leaves, got):
        np.testing.assert_allclose(leaf.grad.numpy(), b.numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(1, 2, 2, 3)
    p = torch.zeros(1, 4)
    with pytest.raises(TypeError):
        dcn.dcn_gather(x.double(), p.double(), p.double())
    with pytest.raises(ValueError):
        dcn.dcn_gather(x, p, torch.zeros(1, 5))
    with pytest.raises(ValueError):
        dcn.dcn_gather_bwd(x, p, p, torch.zeros(1, 4, 2))


@pytest.mark.parametrize("case", ["g_rows", "g_channels", "g_float64",
                                  "px_shape", "py_batch", "x_three_dims"])
def test_bwd_wrapper_refuses_what_the_kernel_does_not_take(case):
    x = torch.zeros(2, 3, 4, 5)
    p = torch.zeros(2, 6)
    g = torch.zeros(2, 6, 5)
    args, error = {
        "g_rows": ((x, p, p, torch.zeros(2, 7, 5)), ValueError),
        "g_channels": ((x, p, p, torch.zeros(2, 6, 4)), ValueError),
        "g_float64": ((x, p, p, g.double()), TypeError),
        "px_shape": ((x, p, torch.zeros(2, 5), g), ValueError),
        "py_batch": ((x, torch.zeros(1, 6), torch.zeros(1, 6), g[:1]),
                     ValueError),
        "x_three_dims": ((x[0], p, p, g), ValueError),
    }[case]
    with pytest.raises(error):
        dcn.dcn_gather_bwd(*args)


def _plan_shapes():
    """(H, W, C): the DCN's S/32 map, ``chip_smoke``'s edge shapes and a
    200 x 200 x 64 map."""
    import chip_smoke

    shapes = [(16, 16, 512), (200, 200, 64)] + [
        shape[1:4] for shape in chip_smoke.DCN_EDGE_SHAPES]
    return list(dict.fromkeys(shapes))


@pytest.mark.parametrize("shape", _plan_shapes(), ids=str)
def test_bwd_plan_fits_shared_memory_and_covers_the_map_once(shape):
    """Every block's x and dx tiles fit the 232,448 bytes of shared memory
    a block may use, and the blocks' channel slices, bands of rows and
    tiles of columns cover C, H and W exactly once. The dpy/dpx scratch holds at most four parts per
    slice, whatever the map's size: a sample's corners reach at most 2 x
    2 tiles."""
    h, w, c = shape
    plan = dcn.bwd_plan(h, w, c)
    assert 1 <= plan.cs <= dcn.MAX_SLICE
    assert plan.shared_bytes() <= dcn.SHARED_BYTES == 232448
    blocks = 0
    for size, step, axis in ((c, plan.cs, "C"), (h, plan.rows, "H"),
                             (w, plan.cols, "W")):
        covered = np.zeros(size, int)
        starts = range(0, size, step)
        for start in starts:
            covered[start:start + min(step, size - start)] += 1
        assert (covered == 1).all(), axis
        blocks = len(starts) if blocks == 0 else blocks * len(starts)
    slices = -(-c // plan.cs)
    assert slices <= plan.parts(h, w, c) <= 4 * slices
    n = h * w * 9  # a 3x3 DCN's samples
    index, parts = dcn.bwd_scratch(2, h, w, c, n, plan, "cpu")
    assert index.shape == (2 * (n + (h + 1) * (w + 1) + 1),)
    assert parts.shape == (2, 2, plan.parts(h, w, c), n)
    if (h, w, c) == (16, 16, 512):  # one tile covers the DCN's map
        assert plan == dcn.BwdPlan(32, 16, 16) and blocks == 16
        assert plan.parts(h, w, c) == 16
    if (h, w, c) == (200, 200, 64):  # bands of one row: two row slots
        assert plan == dcn.BwdPlan(32, 1, 200) and blocks == 400
        # 11.5 MB an image, an eighth of its cotangent g (B, N, C)
        assert parts[:, 0].numel() * 4 == 11_520_000 == n * c * 4 // 8


def test_profile_kernels_needs_a_card(monkeypatch):
    """The kernel timer refuses to start without a card rather than time
    the plain versions on the CPU."""
    from scd_resnet_tpu_torch import profile_kernels

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        profile_kernels.main()


@pytest.fixture(scope="module")
def golden_grads():
    """``deform_conv2d`` on the goldens' inputs, its output and the
    gradients for their cotangent, in the goldens' native layouts."""
    g = np.load(GOLDENS)
    kh, kw, sh, _, ph, _, dh, _, _ = (int(v) for v in g["dcn_geom"])
    b, _, ho, wo = g["dcn_grad_out"].shape
    k = kh * kw
    x = torch.from_numpy(g["dcn_input"]).requires_grad_()
    weight = torch.from_numpy(g["dcn_weight"]).requires_grad_()
    bias = torch.from_numpy(g["dcn_bias"]).requires_grad_()
    # native (B, 2K, Ho, Wo), channel 2k = dy, 2k + 1 = dx
    offset = torch.from_numpy(g["dcn_offset"]).reshape(b, k, 2, ho, wo) \
        .permute(0, 3, 4, 1, 2).contiguous().requires_grad_()
    mask = torch.from_numpy(g["dcn_mask"]).permute(0, 2, 3, 1) \
        .contiguous().requires_grad_()
    out = dcn.deform_conv2d(x, offset, mask, weight, bias, stride=sh,
                            padding=ph, dilation=dh)
    out.backward(torch.from_numpy(g["dcn_grad_out"]))
    got = {"out": out.detach(), "input": x.grad, "weight": weight.grad,
           "bias": bias.grad,
           "offset": offset.grad.permute(0, 3, 4, 1, 2).reshape(
               b, 2 * k, ho, wo),
           "mask": mask.grad.permute(0, 3, 1, 2)}
    return got, g


@pytest.mark.parametrize("name", ["out", "input", "offset", "mask", "weight",
                                  "bias"])
def test_deform_conv2d_matches_native_goldens(golden_grads, name):
    got, g = golden_grads
    want = g["dcn_out"] if name == "out" else g["dcn_grad_" + name]
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got[name].numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("geometry", [(1, 1, 1), (2, 2, 2)],
                         ids=["s1p1d1", "s2p2d2"])
def test_deform_conv2d_matches_jax(geometry):
    """Forward and all five gradients against JAX's ``deform_conv2d``
    (its gather lowering) with offsets reaching far out of range."""
    stride, padding, dilation = geometry
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 9, 11, 5)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 5, 4)) * 0.3).astype(np.float32)
    bias = rng.standard_normal(4).astype(np.float32)
    ho = (9 + 2 * padding - 2 * dilation - 1) // stride + 1
    wo = (11 + 2 * padding - 2 * dilation - 1) // stride + 1
    off = (rng.standard_normal((2, ho, wo, 9, 2)) * 3.0).astype(np.float32)
    mask = rng.uniform(0, 1, (2, ho, wo, 9)).astype(np.float32)
    ct = rng.standard_normal((2, ho, wo, 4)).astype(np.float32)
    kw = dict(stride=stride, padding=padding, dilation=dilation)

    def fwd(x, off, mask, w, bias):
        return jax_dcn.deform_conv2d(x, off, mask, w, bias, method="gather",
                                     **kw)

    out, vjp = jax.vjp(fwd, *(jnp.asarray(a) for a in (x, off, mask, w, bias)))
    want = [np.asarray(out)] + [np.asarray(a) for a in vjp(jnp.asarray(ct))]
    leaves = [torch.from_numpy(a).requires_grad_() for a in (
        x.transpose(0, 3, 1, 2).copy(), off, mask,
        w.transpose(3, 2, 0, 1).copy(), bias)]
    got_out = dcn.deform_conv2d(*leaves, **kw)
    got_out.backward(nchw(ct))
    got = [nhwc(got_out), nhwc(leaves[0].grad), leaves[1].grad.numpy(),
           leaves[2].grad.numpy(), leaves[3].grad.permute(2, 3, 1, 0).numpy(),
           leaves[4].grad.numpy()]
    for name, a, b in zip(("out", "dx", "doffset", "dmask", "dweight",
                           "dbias"), got, want):
        scale = np.abs(b).max()
        assert scale > 0.1, name
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * scale,
                                   err_msg=name)


def _flax_dcn_variables(cin: int, cout: int, seed: int):
    """A flax ``DCN``'s parameters with every leaf drawn from ``seed``:
    kernels N(0, 1/fan_in), the offset conv's times 4 so that offsets
    reach a few pixels, biases N(0, 0.1)."""
    params = JaxDCN(features=cout).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, cin)))["params"]
    rng = np.random.default_rng(seed)

    def draw(shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    om = params["conv_offset_mask"]
    return {"kernel": draw(params["kernel"].shape, (9 * cin) ** -0.5),
            "bias": draw(params["bias"].shape, 0.1),
            "conv_offset_mask": {
                "kernel": draw(om["kernel"].shape, 4 * (9 * cin) ** -0.5),
                "bias": draw(om["bias"].shape, 0.1)}}


def test_dcn_module_matches_flax():
    """The port's ``DCN`` with converted weights against flax's ``DCN``:
    the output and the gradients of the input and of every parameter
    (``conv_offset_mask``'s reach the loss through the offsets and the
    masks, so its channel split is held here)."""
    cin, cout = 6, 5
    params = _flax_dcn_variables(cin, cout, seed=10)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 8, 8, cin)).astype(np.float32)
    ct = rng.standard_normal((2, 8, 8, cout)).astype(np.float32)
    module = JaxDCN(features=cout)

    def fwd(p, x):
        return module.apply({"params": p}, x)

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    out, vjp = jax.vjp(fwd, jp, jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(ct))

    port = DCN(cin, cout)
    port.load_state_dict({
        "weight": torch.from_numpy(params["kernel"].transpose(3, 2, 0, 1).copy()),
        "bias": torch.from_numpy(params["bias"]),
        "conv_offset_mask.weight": torch.from_numpy(
            params["conv_offset_mask"]["kernel"].transpose(3, 2, 0, 1).copy()),
        "conv_offset_mask.bias": torch.from_numpy(
            params["conv_offset_mask"]["bias"])})
    tx = nchw(x).requires_grad_()
    got = port(tx)
    got.backward(nchw(ct))
    pairs = [("out", nhwc(got), np.asarray(out)),
             ("dx", nhwc(tx.grad), np.asarray(gx)),
             ("dkernel", port.weight.grad.permute(2, 3, 1, 0).numpy(),
              np.asarray(gp["kernel"])),
             ("dbias", port.bias.grad.numpy(), np.asarray(gp["bias"])),
             ("doffset_kernel",
              port.conv_offset_mask.weight.grad.permute(2, 3, 1, 0).numpy(),
              np.asarray(gp["conv_offset_mask"]["kernel"])),
             ("doffset_bias", port.conv_offset_mask.bias.grad.numpy(),
              np.asarray(gp["conv_offset_mask"]["bias"]))]
    for name, a, b in pairs:
        scale = np.abs(b).max()
        assert scale > 1e-2, name
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)


def test_fresh_dcn_is_half_a_plain_conv():
    """A fresh ``DCN`` samples the plain grid with mask sigmoid(0) = 0.5
    (``tests/test_dcn.py::test_dcn_module_initializes_as_plain_conv``),
    and ``init_like_flax`` keeps ``conv_offset_mask`` at zero."""
    torch.manual_seed(0)
    model = CenterNetResidual(10, QUARTER, 64, dcn=True)
    model.deconv_dcn.conv_offset_mask.weight.data.normal_()
    init_like_flax(model, torch.Generator().manual_seed(0))
    layer = model.deconv_dcn
    om = layer.conv_offset_mask
    assert torch.all(om.weight == 0) and torch.all(om.bias == 0)
    assert torch.all(layer.bias == 0)
    # lecun_normal on fan-in Cin * 9 = 1152: std 1/sqrt(1152), within 2 std
    std = layer.weight.std().item()
    assert abs(std * 1152 ** 0.5 - 1.0) < 0.05
    assert layer.weight.abs().max().item() <= 2.0 / 0.8796 / 1152 ** 0.5
    layer.bias.data.normal_()
    x = torch.randn(2, 128, 8, 8, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = layer(x)
        want = 0.5 * torch.nn.functional.conv2d(x, layer.weight, padding=1) \
            + layer.bias[:, None, None]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_dcn_computes_in_float32_under_autocast():
    """Under bf16 autocast the DCN's offset conv, gather and product run in
    float32 on its input cast up, as the JAX DCN does: the output is the
    float32 output of the same input, to the bit."""
    params = _flax_dcn_variables(8, 8, seed=12)
    layer = DCN(8, 8)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(
            params["kernel"].transpose(3, 2, 0, 1).copy()))
        layer.conv_offset_mask.weight.copy_(torch.from_numpy(
            params["conv_offset_mask"]["kernel"].transpose(3, 2, 0, 1).copy()))
    x = torch.randn(1, 8, 6, 6, generator=torch.Generator().manual_seed(2)) \
        .to(torch.bfloat16)
    seen = []
    layer.conv_offset_mask.register_forward_hook(
        lambda m, args, out: seen.append(out.dtype))
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        got = layer(x)
    with torch.no_grad():
        want = layer(x.float())
    assert got.dtype == torch.float32 and seen[0] == torch.float32
    assert torch.equal(got, want)


def test_converter_places_the_dcn_and_its_batch_norm():
    """flax numbers the DCN's BatchNorm ``BatchNorm_1`` and the deconvs'
    ``BatchNorm_2..4``; without a DCN the deconvs keep ``BatchNorm_1..3``."""
    for with_dcn in (True, False):
        jax_model = JaxCenterNet(num_layers=10, dims=QUARTER,
                                 terminal_hidden=64, dcn=with_dcn)
        params, stats = flax_variables(jax_model, seed=13)
        arch = "centerOffsetRes10dcn" if with_dcn else "centerOffsetRes10q"
        sd = state_dict_from_flax(arch, params, stats)
        model = CenterNetResidual(10, QUARTER, 64, dcn=with_dcn)
        assert set(sd) == set(model.state_dict())
        model.load_state_dict(sd, strict=True)
        bns = stats["ResNetBackbone_0"]
        first = 2 if with_dcn else 1
        for j in range(3):
            want = bns["BatchNorm_{}".format(first + j)]["BatchNorm_0"]["mean"]
            np.testing.assert_array_equal(
                sd["deconvolutionLayers.{}.running_mean".format(3 * j + 1)]
                .numpy(), want)
        if with_dcn:
            np.testing.assert_array_equal(
                sd["deconv_dcn_bn.running_var"].numpy(),
                bns["BatchNorm_1"]["BatchNorm_0"]["var"])
            kernel = params["ResNetBackbone_0"]["deconv_dcn"]["kernel"]
            np.testing.assert_array_equal(
                sd["deconv_dcn.weight"].numpy(), kernel.transpose(3, 2, 0, 1))
        else:
            assert not any(k.startswith("deconv_dcn") for k in sd)


@pytest.fixture(scope="module")
def patch_registries():
    """The quarter-width ``centerOffsetRes10dcn`` in both registries."""
    with pytest.MonkeyPatch.context() as patch:
        for reg in (jax_registry, registry):
            base = reg.get_model_profile("centerOffsetRes10dcn")
            patch.setitem(reg.MODEL_PROFILES, ARCH, dataclasses.replace(
                base, name=ARCH, model_params=dict(
                    base.model_params, dims=QUARTER, terminal_hidden=64)))
        yield


def _quarter_dcn_variables(seed: int):
    """``flax_variables`` for the quarter DCN model with the offset conv's
    offset rows doubled (offsets reach a few pixels) and tap 4's (the
    center tap's) dy and dx rows zeroed: its samples sit on integers."""
    jax_model = jax_registry.get_model_profile(ARCH).model_cls(
        **jax_registry.get_model_profile(ARCH).model_params)
    params, stats = flax_variables(jax_model, seed)
    om = params["ResNetBackbone_0"]["deconv_dcn"]["conv_offset_mask"]
    om["kernel"][..., :18] *= 2.0
    for col in (4, 13):
        om["kernel"][..., col] = 0.0
        om["bias"][col] = 0.0
    return jax_model, params, stats


def test_quarter_dcn_model_matches_jax(patch_registries):
    """The quarter-width DCN model with converted weights against JAX at
    256^2 (an 8x8 map at the DCN): heads within 1e-4 of each head's
    largest magnitude, decode positions equal where the score is live;
    the DCN's samples include fractional ones inside the map, integer ones
    and ones beyond the outer cutoff."""
    jax_model, params, stats = _quarter_dcn_variables(seed=14)
    model = registry.get_model_profile(ARCH).build()
    model.load_state_dict(state_dict_from_flax(ARCH, params, stats),
                          strict=True)
    model.eval()
    x = np.random.default_rng(15).normal(size=(2, 256, 256, 1)).astype(
        np.float32)
    want = jax_model.apply({"params": params, "batch_stats": stats},
                           jnp.asarray(x), train=False)
    seen = {}
    model.deconv_dcn.register_forward_hook(
        lambda m, args, out: seen.__setitem__("x", args[0]))
    with torch.no_grad():
        got = model(nchw(x))
        offset, _ = model.deconv_dcn.offsets_and_mask(seen["x"])
    for head in ("heatmap", "regr", "offset"):
        ref = np.asarray(want[head])
        scale = np.abs(ref).max()
        assert scale > 0.1, head
        np.testing.assert_allclose(nhwc(got[head]), ref, rtol=0,
                                   atol=1e-4 * scale, err_msg=head)
    ref = jax_decode({k: jnp.asarray(v) for k, v in want.items()})
    dec = decode_center_net(got)
    live = np.asarray(ref[0]) > 0.3
    assert live.any()
    for i in (1, 2, 3):  # indices, y, x
        np.testing.assert_array_equal(dec[i].numpy()[live],
                                      np.asarray(ref[i])[live])

    py, px = dcn.sampling_positions(offset, 3, 3, 1, 1, 1)
    h = seen["x"].shape[2]
    assert h == 8
    inside = (py > -1) & (py < h) & (px > -1) & (px < h)
    integer = (py == py.floor()) & (px == px.floor())
    assert (inside & ~integer).sum() > 100
    assert (inside & integer).sum() >= 2 * 64  # tap 4 of every pixel
    assert (~inside).sum() > 10


def _heat_heads(model):
    return [m for m in model.modules()
            if isinstance(m, TerminalHead) and m.spec.final_bias is not None]


@pytest.mark.parametrize("arch", ["cornerRes10", "cornerCombinedRes10",
                                  "centerOffsetRes10dcn"])
def test_seeded_serving_weights_for_every_family(arch, monkeypatch):
    """``seeded_model`` finds the heat heads in the built model (the
    corner families' heads are named apart from cornerCPool's), calibrates
    every heat channel (the combined model's one head has three) so that
    about 0.3 % of its logits pass the serving threshold, and the model
    serves a clip."""
    slide = synthetic_slide(512, 512, seed=16)
    clips = make_device_tiler(512, 512, torch.device("cpu"))(
        torch.from_numpy(slide))
    # the slide's 1 clip(s) as one batch of 1: the analyzer pads a
    # slide of fewer than BATCH_SIZE clips to that batch, which on the CPU
    # only adds blank clips' forwards (test_torch_mesh_serving.py holds it)
    monkeypatch.setattr(analyse, "BATCH_SIZE", 1)
    model = seeded_model(arch, 17, clips)
    heads = _heat_heads(model)
    assert heads
    threshold = np.log(SCORE_THRESHOLD / (1 - SCORE_THRESHOLD))
    outs = {}
    hooks = [h.register_forward_hook(
        lambda m, args, out: outs.__setitem__(id(m), out)) for h in heads]
    with torch.inference_mode():
        model(clips)
    for hook in hooks:
        hook.remove()
    channels = 0
    for head in heads:
        for z in outs[id(head)].transpose(0, 1).flatten(1):
            share = (z > threshold).double().mean().item()
            assert 0.001 < share < 0.01, (arch, share)
            channels += 1
    assert channels == (1 if arch.startswith("centerOffset") else 3)
    family = registry.get_model_profile(arch).family
    detections = InferenceService(make_wrapper(model, family)).analyse_gray(
        slide)
    assert len(detections) > 0
