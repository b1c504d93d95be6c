"""The training slice's modules against the JAX package on the same numpy
inputs (CPU): the radius solvers, the heatmap render (the K1 kernel's
plain version, against JAX's ``render_heatmap`` and the interpret-mode
Pallas kernel), the loc flips and the batch transform, the losses and
their gradients, the [It] metric line, BatchNorm's training update, the
LR schedule, the optimizers' updates and the fresh-weight initialisers.

Tolerances, each with its reason:

- radius 1e-6 relative: the same float32 operations in the same order;
  sqrt and division are IEEE on both sides, so only the CPU libraries'
  last-bit choices remain.
- heatmap 1e-6 absolute: every term is exp of the same float32 argument,
  and ``exp`` differs by an ulp or two between the two CPU libraries;
  JAX's XLA render also sums the K terms in another order than the
  Pallas kernel and the port, which add them in order. The set of pixels
  at exactly 1.0 (the focal loss's positives) is identical, except where
  JAX's unclamped sum lies within 1e-6 of 1.0.
- batch transform xs 1e-5 absolute: the per-clip mean and variance sum
  the clip's values in another order; mask, indices and regr are exact.
- losses, their gradients and the metric battery 1e-5 relative, the [It]
  line 1e-4 relative: float32 sums over the batch in another order.
- BatchNorm running statistics 1e-6 relative: flax computes the batch
  variance as E[x^2] - E[x]^2, the port in two passes.
- optimizer updates on the same gradients: parameters within 1e-3 of
  the step's learning rate, Adam's moments within 1e-5 relative (1e-6 of
  the largest first moment where a sum of both signs nears 0): the same
  float32 formulas, rounded in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from scd_resnet_tpu.data.pipeline import (
    augment_and_render_batch as jax_augment_and_render,
)
from scd_resnet_tpu.models.center_net_offset import (
    CenterNetLoss as JaxCenterNetLoss,
    center_net_evaluation as jax_evaluation,
)
from scd_resnet_tpu.models.layers import BatchNorm as JaxBatchNorm
from scd_resnet_tpu.ops import losses as jax_losses
from scd_resnet_tpu.ops.augment import (
    flip_locs_horizontal as jax_flip_h,
    flip_locs_vertical as jax_flip_v,
)
from scd_resnet_tpu.ops.gaussian import render_heatmap as jax_render
from scd_resnet_tpu.ops.pallas_kernels import render_heatmap_pallas
from scd_resnet_tpu.ops.radius import (
    center_threshold_radius as jax_center_radius,
    corner_threshold_radius as jax_corner_radius,
)
from scd_resnet_tpu.train.expression import (
    expression_center_net as jax_expression,
)
from scd_resnet_tpu.train.factory import (
    make_lr_schedule as jax_lr_schedule,
    make_optimizer as jax_make_optimizer,
    parse_metric_line,
)
from scd_resnet_tpu_torch.core import cuda_build
from scd_resnet_tpu_torch.data.pipeline import augment_and_render_batch
from scd_resnet_tpu_torch.models.center_net_offset import (
    CenterNetLoss,
    center_net_evaluation,
)
from scd_resnet_tpu_torch.models.layers import batch_norm
from scd_resnet_tpu_torch.models.resnet import init_like_flax
from scd_resnet_tpu_torch.ops import losses
from scd_resnet_tpu_torch.ops.augment import (
    flip_locs_horizontal,
    flip_locs_vertical,
)
from scd_resnet_tpu_torch.ops.gaussian import render_heatmap, render_heatmap_plain
from scd_resnet_tpu_torch.ops.radius import (
    center_threshold_radius,
    corner_threshold_radius,
)
from scd_resnet_tpu_torch.train.expression import expression_center_net
from scd_resnet_tpu_torch.train.factory import make_lr_schedule, make_optimizer
from scd_resnet_tpu_torch.train.registry import get_model_profile

from torch_port_common import jax_draws, nchw, nhwc

HEAT = 16  # heatmap side of the 64^2 test clips


@pytest.mark.parametrize("threshold", [0.5, 0.7])
@pytest.mark.parametrize("solver", ["center", "corner"])
def test_radius_matches_jax(solver, threshold):
    rng = np.random.default_rng(0)
    width = rng.uniform(0.5, 30.0, 200).astype(np.float32)
    height = rng.uniform(0.5, 30.0, 200).astype(np.float32)
    port, ref = {"center": (center_threshold_radius, jax_center_radius),
                 "corner": (corner_threshold_radius, jax_corner_radius)}[solver]
    got = port(torch.from_numpy(width), torch.from_numpy(height),
               threshold).numpy()
    want = np.asarray(ref(width, height, threshold))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _render_cases(seed: int = 0):
    """(locs (B, K, 8), valid (B, K)) covering overlapping objects,
    invalid lanes, a clip with no objects, centers in (-1, 0) and at
    S - 1, and zero-size objects."""
    rng = np.random.default_rng(seed)
    b, k = 5, 12
    locs = np.zeros((b, k, 8), np.float32)
    locs[..., 0:2] = rng.uniform(0, HEAT, (b, k, 2))
    locs[..., 2:4] = rng.uniform(0, 4, (b, k, 2))
    locs[..., 4:6] = rng.uniform(-4, 4, (b, k, 2))
    locs[..., 6] = rng.uniform(0.5, 3, (b, k))
    locs[..., 7] = rng.uniform(2, 6, (b, k))
    valid = rng.uniform(size=(b, k)) < 0.8
    locs[0, :6, 0:2] = 7.3 + rng.uniform(0, 1.5, (6, 2))  # overlapping
    valid[0, :6] = True
    valid[1] = False  # a clip with no objects
    locs[2, 0, 0:2] = (-0.4, 5.0)  # truncates to 0: inside
    locs[2, 1, 0:2] = (6.0, -0.9)
    locs[2, 2, 0:2] = (HEAT - 1, HEAT - 1)  # the last pixel
    locs[2, 3, 0:2] = (HEAT - 0.5, 3.0)
    locs[2, 4, 0:2] = (HEAT, 3.0)  # out of bounds: masked
    locs[2, 5, 0:2] = (-1.0, 3.0)
    valid[2, :6] = True
    locs[3, :3, 4:7] = 0.0  # zero-size objects
    locs[3, 3, 6] = 0.0  # zero minor axis
    valid[3, :4] = True
    return locs, valid


def _assert_heat_close(got, want, sums=None):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    sums = want if sums is None else sums
    differ = (got == 1.0) != (want == 1.0)
    assert not (differ & (np.abs(sums - 1.0) > 1e-6)).any()


def test_render_plain_matches_jax_and_pallas():
    locs, valid = _render_cases()
    got = render_heatmap_plain(torch.from_numpy(locs),
                               torch.from_numpy(valid), HEAT).numpy()
    assert (got == 1.0).sum() >= 20  # every valid in-bounds center is a peak
    xla = np.asarray(jax.vmap(lambda l, v: jax_render(l, v, HEAT))(
        jnp.asarray(locs), jnp.asarray(valid)))
    pallas = np.asarray(render_heatmap_pallas(jnp.asarray(locs),
                                              jnp.asarray(valid), HEAT,
                                              interpret=True))
    _assert_heat_close(got, xla)
    _assert_heat_close(got, pallas)
    assert np.array_equal(got[1], np.zeros((HEAT, HEAT), np.float32))
    for cx, cy in ((0, 5), (6, 0), (HEAT - 1, HEAT - 1), (HEAT - 1, 3)):
        assert got[2, cy, cx] == 1.0


def test_render_wrapper_on_cpu_is_the_plain_version():
    locs, valid = _render_cases(1)
    before = dict(cuda_build.LAUNCHES)
    got = render_heatmap(torch.from_numpy(locs), torch.from_numpy(valid), HEAT)
    assert cuda_build.LAUNCHES == before  # CPU tensors launch nothing
    want = render_heatmap_plain(torch.from_numpy(locs),
                                torch.from_numpy(valid), HEAT)
    assert torch.equal(got, want)
    with pytest.raises(TypeError):
        render_heatmap(torch.from_numpy(locs).double(),
                       torch.from_numpy(valid), HEAT)
    with pytest.raises(ValueError):
        render_heatmap(torch.from_numpy(locs[0]), torch.from_numpy(valid[0]),
                       HEAT)


def test_render_plain_corner_variant_matches_jax():
    """The plain version keeps the JAX function's ``radius_fn`` and
    ``position_offset`` arguments (corner heatmaps, slice 3)."""
    locs, valid = _render_cases(2)
    offset = np.random.default_rng(3).uniform(-3, 3, locs.shape[:2] + (2,)
                                              ).astype(np.float32)
    got = render_heatmap_plain(torch.from_numpy(locs), torch.from_numpy(valid),
                               HEAT, radius_fn=corner_threshold_radius,
                               position_offset=torch.from_numpy(offset)).numpy()
    want = np.asarray(jax.vmap(lambda l, v, o: jax_render(
        l, v, HEAT, radius_fn=jax_corner_radius, position_offset=o))(
            jnp.asarray(locs), jnp.asarray(valid), jnp.asarray(offset)))
    _assert_heat_close(got, want)


def test_loc_flips_match_jax():
    locs, _ = _render_cases()
    for port, ref in ((flip_locs_horizontal, jax_flip_h),
                      (flip_locs_vertical, jax_flip_v)):
        got = port(torch.from_numpy(locs), HEAT).numpy()
        np.testing.assert_array_equal(got, np.asarray(ref(locs, HEAT)))


def _raw_batch(seed: int = 0):
    rng = np.random.default_rng(seed)
    b, s = 4, 4 * HEAT
    locs, _ = _render_cases(seed)
    locs = locs[:b]
    counts = np.array([7, 0, 12, 4], np.int32)
    samples = rng.normal(180.0, 20.0, (b, s, s)).astype(np.float32)
    samples[1] = 42.0  # a constant clip normalises to zeros
    return samples, locs, counts


@pytest.mark.parametrize("augment", [False, True])
def test_batch_transform_matches_jax(augment):
    samples, locs, counts = _raw_batch()
    b, s = samples.shape[:2]
    key = jax.random.fold_in(jax.random.PRNGKey(43), 5)
    draws = jax_draws(key, b, s) if augment else None
    if augment:  # the key must flip some clips both ways
        assert 0 < int(draws.flip_h.sum()) < b or 0 < int(draws.flip_v.sum()) < b
    xs, ys = augment_and_render_batch(
        torch.from_numpy(samples), torch.from_numpy(locs),
        torch.from_numpy(counts), HEAT, augment=augment, draws=draws)
    jxs, jys = jax_augment_and_render(key, samples, locs, counts, HEAT,
                                      augment=augment)
    np.testing.assert_allclose(nhwc(xs), np.asarray(jxs), rtol=0, atol=1e-5)
    _assert_heat_close(nhwc(ys[0]), np.asarray(jys[0]))
    np.testing.assert_array_equal(ys[1].numpy(), np.asarray(jys[1]))
    np.testing.assert_array_equal(ys[2].numpy(), np.asarray(jys[2]))
    np.testing.assert_array_equal(ys[3].numpy(), np.asarray(jys[3]))


def test_batch_transform_refuses_corner_targets():
    """The transform refuses a target family it does not know; the legacy
    family's targets are the cornerLegacy layout (held against JAX in
    test_torch_legacy.py); the corner families' targets add the tl/br
    heatmaps to the center batch's arrays (held against JAX in
    test_torch_corner_models.py)."""
    samples, locs, counts = _raw_batch()
    args = (torch.from_numpy(samples), torch.from_numpy(locs),
            torch.from_numpy(counts), HEAT)
    with pytest.raises(ValueError, match="corner_targets"):
        augment_and_render_batch(*args, augment=False,
                                 corner_targets="legacy corners")
    _, legacy = augment_and_render_batch(*args, augment=False,
                                         corner_targets="legacy")
    assert len(legacy) == 7 and legacy[0].shape == (len(samples), 1, HEAT,
                                                    HEAT)
    _, center = augment_and_render_batch(*args, augment=False)
    _, corner = augment_and_render_batch(*args, augment=False,
                                         corner_targets=True)
    assert len(corner) == 6
    for got, want in zip(corner, center):
        assert torch.equal(got, want)


def _head_outputs(seed: int, b: int = 4):
    rng = np.random.default_rng(seed)
    return {"heatmap": rng.normal(-1.0, 2.0, (b, HEAT, HEAT, 1)),
            "regr": rng.normal(0.0, 2.0, (b, HEAT, HEAT, 4)),
            "offset": rng.normal(0.0, 2.0, (b, HEAT, HEAT, 2))}


def _targets(seed: int = 0):
    samples, locs, counts = _raw_batch(seed)
    _, ys = augment_and_render_batch(
        torch.from_numpy(samples), torch.from_numpy(locs),
        torch.from_numpy(counts), HEAT, augment=False)
    return ys, [nhwc(ys[0]), ys[1].numpy(), ys[2].numpy(),
                ys[3].numpy().astype(np.int32)]


def test_losses_match_jax():
    ys, jys = _targets()
    outs = _head_outputs(1)
    pred = torch.sigmoid(nchw(outs["heatmap"].astype(np.float32)))
    pred = pred.clamp(1e-4, 1 - 1e-4)
    got = losses.focal_loss([pred], ys[0]).item()
    want = float(jax_losses.focal_loss([nhwc(pred)], jys[0]))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # no positive at all: the negative term alone
    zero = torch.zeros_like(ys[0])
    np.testing.assert_allclose(
        losses.focal_loss([pred], zero).item(),
        float(jax_losses.focal_loss([nhwc(pred)], nhwc(zero))), rtol=1e-5)
    reg = np.random.default_rng(2).normal(0, 2, (4, 12, 6)).astype(np.float32)
    for name in ("l1_loss_mask", "smooth_l1_loss_mask"):
        got = getattr(losses, name)(torch.from_numpy(reg), ys[2], ys[1])
        want = getattr(jax_losses, name)(reg, jys[2], jys[1])
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_center_net_loss_and_gradient_match_jax():
    ys, jys = _targets()
    outs = {k: v.astype(np.float32) for k, v in _head_outputs(3).items()}
    port_outs = {k: nchw(v).requires_grad_(True) for k, v in outs.items()}
    loss, stats = CenterNetLoss(0.1, 0.1)([port_outs], ys)
    loss.backward()

    jax_loss = JaxCenterNetLoss(0.1, 0.1)

    def objective(o):
        value, parts = jax_loss([o], jys)
        return value, parts

    (want, want_stats), grads = jax.value_and_grad(objective, has_aux=True)(
        {k: jnp.asarray(v) for k, v in outs.items()})
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    for got_s, want_s in zip(stats, want_stats):
        np.testing.assert_allclose(got_s.item(), float(want_s), rtol=1e-5)
    for name, tensor in port_outs.items():
        got_g = nhwc(tensor.grad)
        want_g = np.asarray(grads[name])
        scale = np.abs(want_g).max()
        assert scale > 0
        np.testing.assert_allclose(got_g, want_g, rtol=0, atol=1e-5 * scale)


def _decoded(seed: int, b: int = 4, k: int = 10):
    """Decoded rows whose boxes overlap the ground truth of ``_targets``:
    scores above and below the 0.3 gate, centers near the objects."""
    rng = np.random.default_rng(seed)
    _, locs, _ = _raw_batch(0)
    pick = rng.integers(0, locs.shape[1], (b, k))
    centers = np.take_along_axis(locs[:b, :, :2], pick[..., None], axis=1)
    ct = np.floor(centers + rng.normal(0, 0.6, centers.shape)).clip(0, HEAT - 1)
    scores = rng.uniform(0.0, 1.0, (b, k)).astype(np.float32)
    indices = (ct[..., 1] * HEAT + ct[..., 0]).astype(np.int64)
    offset = rng.uniform(0, 4, (b, k, 2)).astype(np.float32)
    regression = np.concatenate(
        [rng.normal(0, 3, (b, k, 2)), rng.uniform(0.5, 3, (b, k, 2))],
        axis=-1).astype(np.float32)
    return (scores, indices, ct[..., 1].astype(np.float32),
            ct[..., 0].astype(np.float32), offset, regression)


@pytest.mark.parametrize("layout", ["train", "validation"])
def test_evaluation_and_report_line_match_jax(layout):
    ys, jys = _targets()
    _, locs, counts = _raw_batch(0)
    if layout == "validation":  # ys[3] holds the float loc records
        ys = ys[:3] + [torch.from_numpy(locs), torch.from_numpy(counts)]
        jys = jys[:3] + [locs, counts]
    lines = []
    for seed in (4, 5):  # two batches, aggregated together
        scores, indices, cy, cx, offset, regression = _decoded(seed)
        got = center_net_evaluation(
            None, ys, *(torch.from_numpy(a) for a in
                        (scores, indices, cy, cx, offset, regression)),
            {"heatmap": torch.zeros((4, 1, HEAT, HEAT))})
        want = jax_evaluation(None, jys, scores, indices.astype(np.int32), cy,
                              cx, offset, regression,
                              {"heatmap": jnp.zeros((4, HEAT, HEAT, 1))})
        lines.append((got, jax.tree_util.tree_map(np.asarray, want)))
    got_line = expression_center_net([g for g, _ in lines])
    want_line = jax_expression([w for _, w in lines])
    names = ("mIoU", "mIoUC", "mIoUwoO", "mIoUO", "AP30", "AP50", "AP70",
             "AP90", "Orth", "majMAE", "minMAE", "radMAE", "avgS")
    assert parse_metric_line(want_line, "mIoU") > 0  # overlaps were found
    for name in names:
        got_v, want_v = (parse_metric_line(got_line, name),
                         parse_metric_line(want_line, name))
        assert got_v is not None and want_v is not None, name
        np.testing.assert_allclose(got_v, want_v, rtol=1e-4, atol=0,
                                   err_msg=name)


def test_batch_norm_training_update_matches_flax():
    """The port's BatchNorm keeps the biased batch variance in
    running_var, as flax does (nn.BatchNorm2d keeps the unbiased one:
    0.678 against 0.718 in the fault's first sighting)."""
    rng = np.random.default_rng(7)
    batches = [rng.normal(0.5, 1.3, (3, 5, 4, 6)).astype(np.float32)
               for _ in range(2)]
    module = JaxBatchNorm()
    variables = module.init(jax.random.PRNGKey(0), jnp.asarray(batches[0]),
                            train=False)
    bn = batch_norm(6).train()
    for x in batches:
        y_jax, mutated = module.apply(variables, jnp.asarray(x), train=True,
                                      mutable=["batch_stats"])
        variables = {"params": variables["params"], **mutated}
        y = bn(nchw(x))
        np.testing.assert_allclose(nhwc(y.detach()), np.asarray(y_jax),
                                   rtol=0, atol=1e-5)
    stats = variables["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=1e-6)
    unbiased = torch.nn.BatchNorm2d(6, momentum=0.1).train()
    for x in batches:
        unbiased(nchw(x))
    assert not np.allclose(unbiased.running_var.numpy(),
                           np.asarray(stats["var"]), rtol=1e-3)
    # eval mode and the state-dict names are nn.BatchNorm2d's
    assert set(bn.state_dict()) == set(unbiased.state_dict())


@pytest.mark.parametrize("count", [0, 10999, 11000, 13199])
def test_lr_schedule_matches_optax(count):
    port = make_lr_schedule(1.25e-4, [11000], [10])
    ref = jax_lr_schedule(1.25e-4, [11000], [10])
    assert np.float32(port(count)) == np.float32(ref(count))
    base = np.float32(1.25e-4)
    want = base if count < 11000 else np.float32(np.float32(0.1) * base)
    assert np.float32(port(count)) == want


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_optimizer_matches_optax(name):
    """Four updates of the port's optimizer, its learning rate set from the
    schedule before each as the train step does (a milestone at count 2),
    against optax's on the same numpy-seeded parameters and gradients;
    the gradients span 1e-8 to 1 in both signs, so Adam's eps matters."""
    base = 1e-3
    rng = np.random.default_rng(7)
    start = rng.normal(0.0, 0.01, (64, 33)).astype(np.float32)
    grads = [(rng.choice([-1.0, 1.0], start.shape)
              * 10.0 ** rng.uniform(-8, 0, start.shape)).astype(np.float32)
             for _ in range(4)]
    schedule = make_lr_schedule(base, [2], [10])
    param = torch.nn.Parameter(torch.from_numpy(start.copy()))
    opt = make_optimizer(name, [param], schedule(0))
    tx = jax_make_optimizer(name, jax_lr_schedule(base, [2], [10]))
    ref = jnp.asarray(start)
    state = tx.init(ref)
    for count, grad in enumerate(grads):
        for group in opt.param_groups:
            group["lr"] = schedule(count)
        param.grad = torch.from_numpy(grad)
        opt.step()
        updates, state = tx.update(jnp.asarray(grad), state, ref)
        ref = optax.apply_updates(ref, updates)
        np.testing.assert_allclose(param.detach().numpy(), np.asarray(ref),
                                   rtol=0, atol=1e-3 * schedule(count),
                                   err_msg="count {}".format(count))
        if name == "adam":
            mu, nu = np.asarray(state[0].mu), np.asarray(state[0].nu)
            moments = opt.state[param]
            np.testing.assert_allclose(moments["exp_avg"].numpy(), mu,
                                       rtol=1e-5,
                                       atol=1e-6 * np.abs(mu).max())
            np.testing.assert_allclose(moments["exp_avg_sq"].numpy(), nu,
                                       rtol=1e-5)
    assert not np.allclose(np.asarray(ref), start, rtol=0, atol=base)


def test_fresh_weights_follow_the_flax_initialisers():
    model = get_model_profile("centerOffsetRes10q").build()
    init_like_flax(model, torch.Generator().manual_seed(0))
    assert torch.all(model.heatmap[2].bias == -2.19)
    for head in ("regr", "offset"):
        final = getattr(model, head)[2]
        assert torch.all(final.bias == 0)
        assert abs(final.weight.std().item() - 0.001) < 2e-4
    for deconv in model.deconvolutionLayers[::3]:
        assert abs(deconv.weight.std().item() - 0.001) < 1e-4
    # lecun_normal: variance 1/fan_in, truncated at two of its std
    conv = model.layer3[0].conv2.weight
    fan_in = conv[0].numel()
    assert abs(conv.var().item() * fan_in - 1.0) < 0.05
    assert conv.abs().max().item() <= 2 * (1 / fan_in) ** 0.5 / 0.8796 + 1e-6
    assert torch.all(model.heatmap[0].bias == 0)
    bn = model.layer1[0].bn1
    assert torch.all(bn.weight == 1) and torch.all(bn.running_var == 1)
