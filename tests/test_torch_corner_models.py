"""The corner families against the JAX package on the same numpy inputs
and weights (CPU): the corner targets of the batch transform and the
validation pre-render, the loss and its gradient, the decode, the
center-gated pairing, the evaluation and its report line, the weight
converter for every corner family, and the heads' final conv in float32
under autocast.

Tolerances, each with its reason:

- heatmaps within 1e-6 absolute, the same pixels at exactly 1.0 except
  where JAX's unclamped sum lies within 1e-6 of 1.0: every term is exp
  of the same float32 argument, which the two CPU libraries round a last
  bit apart, and XLA sums the objects in another order;
- the loss, its gradient and the metric battery within 1e-5 relative,
  the report line within 1e-4 relative: float32 sums over the batch in
  another order;
- decode scores within 1e-6, indices equal where the score is above 0
  (zero-score ties after NMS order differently under ``torch.topk`` and
  ``lax.top_k``);
- the pairing exact: both sides get the same decoded peaks; the port
  ranks the pairs by a stable descending sort, so tied scores (every
  rejected pair scores -1) keep the lower pair index first, as
  ``lax.top_k`` does;
- head outputs within 1e-4 of the head's largest magnitude: float32
  convolutions sum in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scd_resnet_tpu.data.dataset import SCDDataset as JaxDataset
from scd_resnet_tpu.data.pipeline import (
    augment_and_render_batch as jax_augment_and_render,
)
from scd_resnet_tpu.models import corner_net as jax_corner
from scd_resnet_tpu.train.expression import (
    aggregate_corner_net as jax_aggregate,
    expression_corner_net as jax_expression,
)
from scd_resnet_tpu.train.factory import parse_metric_line
from scd_resnet_tpu_torch.core.convert import state_dict_from_flax
from scd_resnet_tpu_torch.data.dataset import SCDDataset
from scd_resnet_tpu_torch.data.pipeline import augment_and_render_batch
from scd_resnet_tpu_torch.data.synthetic import make_archive
from scd_resnet_tpu_torch.infer.wrapper import make_wrapper
from scd_resnet_tpu_torch.models import corner_net
from scd_resnet_tpu_torch.train.expression import (
    aggregate_corner_net,
    expression_corner_net,
)
from scd_resnet_tpu_torch.train.registry import get_model_profile

from torch_port_common import QUARTER, flax_variables, jax_draws, nchw, nhwc

HEAT = 16  # heatmap side of the 64^2 test clips
HEADS = ("heatmap", "tl", "br")


def _corner_batch(seed: int = 0):
    """Raw clips, loc records and counts of 4 clips of 64^2, with corner
    edge cases: corners in (-1, 0), at S - 1 and beyond S, zero-size
    objects, a clip with no objects."""
    rng = np.random.default_rng(seed)
    b, k = 4, 10
    locs = np.zeros((b, k, 8), np.float32)
    locs[..., 0:2] = rng.uniform(1, HEAT - 1, (b, k, 2))
    locs[..., 2:4] = rng.uniform(0, 4, (b, k, 2))
    locs[..., 4:6] = rng.uniform(-3, 3, (b, k, 2))
    locs[..., 6] = rng.uniform(0.5, 2.5, (b, k))
    locs[..., 7] = rng.uniform(2, 6, (b, k))
    # clip 0: tl corners in (-1, 0), a br corner at S - 1 and one beyond
    locs[0, 0, [0, 1, 4, 5, 6]] = (2.0, 3.0, 2.5, 0.0, 3.4)
    locs[0, 1, [0, 1, 4, 5, 6]] = (1.0, 1.5, 0.0, 1.8, 2.2)
    locs[0, 2, [0, 1, 4, 5, 6]] = (HEAT - 3.0, HEAT - 4.0, 2.0, 0.0, 3.0)
    locs[0, 3, [0, 1, 4, 5, 6]] = (HEAT - 1.0, 5.0, 2.0, 1.0, 1.0)
    locs[2, :3, 4:7] = 0.0  # zero-size objects
    counts = np.array([6, 0, 10, 4], np.int32)
    samples = rng.normal(180.0, 20.0, (b, 4 * HEAT, 4 * HEAT)).astype(
        np.float32)
    return samples, locs, counts


def _assert_heat_close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    differ = (got == 1.0) != (want == 1.0)
    assert not (differ & (np.abs(want - 1.0) > 1e-6)).any()


@pytest.mark.parametrize("augment", [False, True])
def test_corner_targets_match_jax(augment):
    samples, locs, counts = _corner_batch()
    key = jax.random.fold_in(jax.random.PRNGKey(44), 3)
    draws = jax_draws(key, 4, samples.shape[1]) if augment else None
    xs, ys = augment_and_render_batch(
        torch.from_numpy(samples), torch.from_numpy(locs),
        torch.from_numpy(counts), HEAT, augment=augment, draws=draws,
        corner_targets=True)
    jxs, jys = jax_augment_and_render(key, samples, locs, counts, HEAT,
                                      augment=augment, corner_targets=True)
    assert len(ys) == len(jys) == 6
    np.testing.assert_allclose(nhwc(xs), np.asarray(jxs), rtol=0, atol=1e-5)
    for i in (0, 4, 5):
        _assert_heat_close(nhwc(ys[i]), np.asarray(jys[i]))
    for i in (1, 2, 3):
        np.testing.assert_array_equal(ys[i].numpy(), np.asarray(jys[i]))
    if not augment:
        tl, br = ys[4][0, 0], ys[5][0, 0]
        assert tl[0, 0] == 1.0  # corners in (-1, 0) stamp at 0
        assert br[HEAT - 1, HEAT - 1] == 1.0  # a corner at S - 1
        assert (ys[4][1] == 0).all() and (ys[5][1] == 0).all()  # no objects


def test_corner_validation_pre_render_matches_jax(tmp_path):
    path = str(tmp_path / "scdx16p100.d")
    make_archive(path, num_images=2, reps=1, clips_per_image=5, size=64)
    port = SCDDataset(path, None, test_set=4, seed=42, device="cpu")
    ref = JaxDataset(path, None, test_set=4, seed=42)
    for corner_targets in (True, False):  # cached apart, as in JAX
        got = port.get_validation_set(2, corner_targets=corner_targets)
        want = ref.get_validation_set(2, corner_targets=corner_targets)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            np.testing.assert_allclose(nhwc(g["xs"][0]), w["xs"][0],
                                       atol=1e-5)
            assert len(g["ys"]) == len(w["ys"]) == 6
            heats = (0, 4, 5) if corner_targets else (0,)
            for i, (gy, wy) in enumerate(zip(g["ys"], w["ys"])):
                if i in heats:
                    _assert_heat_close(nhwc(gy), np.asarray(wy))
                else:
                    np.testing.assert_array_equal(gy.numpy(), np.asarray(wy))


def _targets(seed: int = 0):
    samples, locs, counts = _corner_batch(seed)
    _, ys = augment_and_render_batch(
        torch.from_numpy(samples), torch.from_numpy(locs),
        torch.from_numpy(counts), HEAT, augment=False, corner_targets=True)
    jys = [nhwc(y) if y.dim() == 4 else y.numpy() for y in ys]
    jys[3] = jys[3].astype(np.int32)
    return ys, jys


def _head_logits(ys, seed: int, combined: bool = False):
    """NHWC logits that peak near the targets' peaks, plus noise."""
    rng = np.random.default_rng(seed)
    heads = {}
    for name, i in zip(HEADS, (0, 4, 5)):
        gt = nhwc(ys[i])
        heads[name] = (6.0 * gt - 3.0 + rng.normal(0, 0.7, gt.shape)
                       ).astype(np.float32)
    if combined:
        return {"heatmap": np.concatenate([heads[h] for h in HEADS], -1)}
    return heads


@pytest.mark.parametrize("combined", [False, True])
def test_corner_loss_and_gradient_match_jax(combined):
    ys, jys = _targets()
    outs = _head_logits(ys, 1, combined)
    port_outs = {k: nchw(v).requires_grad_(True) for k, v in outs.items()}
    loss, stats = corner_net.CornerNetLoss(combined)([port_outs], ys)
    loss.backward()

    def objective(o):
        return jax_corner.CornerNetLoss(combined)([o], jys)

    (want, want_stats), grads = jax.value_and_grad(objective, has_aux=True)(
        {k: jnp.asarray(v) for k, v in outs.items()})
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    assert len(stats) == len(want_stats) == 1
    np.testing.assert_allclose(stats[0].item(), float(want_stats[0]),
                               rtol=1e-5)
    for name, tensor in port_outs.items():
        want_g = np.asarray(grads[name])
        scale = np.abs(want_g).max()
        assert scale > 0
        np.testing.assert_allclose(nhwc(tensor.grad), want_g, rtol=0,
                                   atol=1e-5 * scale)


def _decoded_pair(ys, seed, combined=False, k=20):
    """The port's and JAX's decode of the same logits."""
    outs = _head_logits(ys, seed, combined)
    got = corner_net.decode_corner_net({n: nchw(v) for n, v in outs.items()},
                                       k=k, combined=combined)
    want = jax_corner.decode_corner_net(
        {n: jnp.asarray(v) for n, v in outs.items()}, k=k,
        combined=combined)
    return got, want


@pytest.mark.parametrize("combined", [False, True])
def test_corner_decode_matches_jax(combined):
    ys, _ = _targets()
    got, want = _decoded_pair(ys, 2, combined)
    for h in range(3):
        s, i, y, x = (4 * h + j for j in range(4))
        ref_s = np.asarray(want[s])
        np.testing.assert_allclose(got[s].numpy(), ref_s, rtol=0, atol=1e-6)
        live = ref_s > 0
        assert (ref_s > 0.3).any()
        for j in (i, y, x):
            np.testing.assert_array_equal(got[j].numpy()[live],
                                          np.asarray(want[j])[live])
    assert set(got[-1]) == set(HEADS)  # the combined head split in three


@pytest.mark.parametrize("gate", ["point", "window", "peak"])
def test_pair_corner_boxes_matches_jax(gate):
    ys, _ = _targets()
    got, want = _decoded_pair(ys, 3)
    peaks = [np.asarray(want[j]) for j in (4, 6, 7, 8, 10, 11)]
    ct_heat = np.asarray(want[-1]["heatmap"])
    boxes, scores = corner_net.pair_corner_boxes(
        nchw(ct_heat), *(torch.from_numpy(np.array(p)) for p in peaks),
        center_gate=gate)
    ref_boxes, ref_scores = jax_corner.pair_corner_boxes(
        jnp.asarray(ct_heat), *(jnp.asarray(p) for p in peaks),
        center_gate=gate)
    np.testing.assert_array_equal(scores.numpy(), np.asarray(ref_scores))
    np.testing.assert_array_equal(boxes.numpy(), np.asarray(ref_boxes))
    assert (scores > 0.3).any() and (scores == -1.0).any()


def test_corner_evaluation_and_report_line_match_jax(monkeypatch):
    monkeypatch.delenv("SCD_CORNER_CENTER_GATE", raising=False)
    monkeypatch.delenv("SCD_CORNER_CENTER_WINDOW", raising=False)
    ys, jys = _targets()
    batches = []
    for seed in (4, 5):  # two batches, aggregated together
        got, want = _decoded_pair(ys, seed)
        port = corner_net.corner_net_evaluation(None, ys, *got)
        ref = jax.tree_util.tree_map(
            np.asarray, jax_corner.corner_net_evaluation(None, jys, *want))
        for head in ("heat", "tl", "br", "box"):
            for g, w in zip(port[head], ref[head]):
                np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                           atol=1e-6, err_msg=head)
        batches.append((port, ref))
    got_e = aggregate_corner_net([p for p, _ in batches])
    want_e = jax_aggregate([r for _, r in batches])
    assert got_e.keys() == want_e.keys()
    assert want_e["boxAP50"] > 0 and want_e["tlAP50"] > 0
    got_line = expression_corner_net([p for p, _ in batches])
    want_line = jax_expression([r for _, r in batches])
    for name in ("heatPeakAP50", "heatPeakAP75", "tlPeakAP50", "tlPeakAP75",
                 "brPeakAP50", "brPeakAP75", "boxAP50"):
        got_v = parse_metric_line(got_line, name)
        want_v = parse_metric_line(want_line, name)
        assert got_v is not None and want_v is not None, name
        np.testing.assert_allclose(got_v, want_v, rtol=1e-4, err_msg=name)


# arch -> the JAX model class at quarter width
JAX_CORNER_MODELS = {
    "cornerRes10": jax_corner.CornerNetResidual,
    "cornerCPoolRes10": jax_corner.CornerNetCPoolResidual,
    "cornerCombinedRes10": jax_corner.CornerNetCombined,
}


@pytest.mark.parametrize("arch", sorted(JAX_CORNER_MODELS))
def test_corner_weights_carry_across(arch):
    """``state_dict_from_flax`` fills every corner model key for key
    (``strict=True``), and the port's forward matches the JAX model's."""
    jax_model = JAX_CORNER_MODELS[arch](num_layers=10, dims=QUARTER)
    params, stats = flax_variables(jax_model, seed=12)
    profile = get_model_profile(arch)
    model = profile.model_cls(10, QUARTER)
    sd = state_dict_from_flax(arch, params, stats)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    x = np.random.default_rng(8).normal(size=(2, 64, 64, 1)).astype(
        np.float32)
    want = jax_model.apply({"params": params, "batch_stats": stats},
                           jnp.asarray(x), train=False)
    with torch.inference_mode():
        got = model.eval()(nchw(x))
    assert set(got) == set(want)
    for head, ref in want.items():
        ref = np.asarray(ref)
        scale = np.abs(ref).max()
        assert scale > 0.1, head
        np.testing.assert_allclose(nhwc(got[head]), ref, rtol=0,
                                   atol=1e-4 * scale, err_msg=head)
    # the corner contract decodes the combined model's one head in three
    rows = make_wrapper(model, "corner")(nchw(x))
    assert rows.shape[:2] == (12, 2)


@pytest.mark.parametrize("arch", sorted(JAX_CORNER_MODELS))
def test_heads_final_conv_runs_in_float32_under_autocast(arch):
    """Under bf16 autocast every head's output is float32: the final 1x1
    conv takes its input cast up, as the JAX heads' final ``nn.Conv``
    with float32 parameters and no ``dtype`` does."""
    torch.manual_seed(0)
    model = get_model_profile(arch).model_cls(10, QUARTER).eval()
    x = torch.randn(1, 1, 64, 64)
    with torch.inference_mode(), torch.autocast("cpu", dtype=torch.bfloat16):
        outs = model(x)
    for head, out in outs.items():
        assert out.dtype == torch.float32, head


def test_corner_profiles_are_registered_for_training():
    for depth in (10, 18):
        for family in ("cornerRes", "cornerCPoolRes", "cornerCombinedRes"):
            profile = get_model_profile("{}{}".format(family, depth))
            assert profile.family == "corner"
            assert profile.corner_targets is True
            assert profile.num_layers == depth
            for piece in ("loss", "decode", "evaluation", "expression"):
                assert getattr(profile, piece) is not None
            combined = family == "cornerCombinedRes"
            assert profile.loss.combined == combined
            assert profile.decode.keywords["combined"] == combined


def test_fresh_corner_heads_take_the_heat_prior():
    from scd_resnet_tpu_torch.models.resnet import init_like_flax

    model = get_model_profile("cornerCPoolRes10").model_cls(10, QUARTER)
    init_like_flax(model, torch.Generator().manual_seed(0))
    for final in (model.heatmap[2], model.tl_head.terminal[2],
                  model.br_head.terminal[2]):
        assert torch.all(final.bias == -2.19)
