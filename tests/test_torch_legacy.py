"""The associative-embedding CornerNet (``cornerLegacyHourglass``)
against the JAX package on the same numpy inputs and weights (CPU): the
pull/push embedding loss, the legacy targets of the batch transform and
the validation pre-render, the small model's forward, the loss and its
gradient, the paired decode with its ties, the evaluation and report
line, the legacy stitch and dedupe, and the (B, 1000, 8) serving
contract on a small slide.

Tolerances, each with its reason:

- the targets' masks, indices and offsets equal to the bit (the same
  float32 operations in the same order); heatmaps within 1e-6 absolute
  with the same pixels at exactly 1.0 (``tests/test_torch_render.py``:
  the two CPU libraries round exp a last bit apart, and XLA sums the
  objects in another order);
- the embedding loss, the loss and its gradient, and the metric grids
  within 1e-5 relative, the report line within 1e-4 relative: float32
  sums in another order;
- head outputs within 1e-4 of the head's largest magnitude: float32
  convolutions sum in another order;
- the decode equal to the bit, tie order included. ``torch.sigmoid`` and
  ``jax.nn.sigmoid`` round about one float32 input in 300 a last bit
  apart, so the decode tests draw their logits from values on which the
  two agree: the comparison isolates the decode's own pairing and order;
- the stitch in float64, equal to the bit.
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
from scd_resnet_tpu.infer.analyse import (
    dedupe_contract as jax_dedupe_contract,
    stitch_any as jax_stitch_any,
)
from scd_resnet_tpu.models import corner_net_legacy as jax_legacy
from scd_resnet_tpu.ops.losses import embedding_loss as jax_embedding_loss
from scd_resnet_tpu.train.factory import parse_metric_line
from scd_resnet_tpu_torch.core.convert import state_dict_from_flax
from scd_resnet_tpu_torch.data.dataset import SCDDataset
from scd_resnet_tpu_torch.data.pipeline import (
    augment_and_render_batch,
    identity_draws,
)
from scd_resnet_tpu_torch.data.synthetic import make_archive
from scd_resnet_tpu_torch.infer import analyse
from scd_resnet_tpu_torch.infer.analyse import (
    CONTRACT_FIELDS,
    dedupe_contract,
    slide_geometry,
    stitch_any,
)
from scd_resnet_tpu_torch.infer.server import InferenceService
from scd_resnet_tpu_torch.infer.wrapper import CONTRACTS, make_wrapper
from scd_resnet_tpu_torch.models import corner_net_legacy as legacy
from scd_resnet_tpu_torch.models.corner_net_legacy import CornerNetLegacy
from scd_resnet_tpu_torch.ops.losses import embedding_loss
from scd_resnet_tpu_torch.train import registry
from scd_resnet_tpu_torch.train.expression import expression_corner_net_legacy
from scd_resnet_tpu_torch.train.registry import get_model_profile

from torch_port_common import (
    HOURGLASS_SMALL,
    LEGACY_HEAD_PATHS,
    flax_variables,
    jax_small_legacy,
    nchw,
    nhwc,
)

HEAT = 16  # heatmap side of the 64^2 test clips
HEADS = ("tl_heat", "br_heat", "tl_tag", "br_tag", "tl_regr", "br_regr")


# -- the embedding loss ---------------------------------------------------------

def test_embedding_loss_and_gradient_match_jax():
    """Pull and push on (B, K, 1) tags with 0, 1, a few and all objects
    of a clip masked in, and their gradient."""
    rng = np.random.default_rng(0)
    b, k = 4, 9
    tl = rng.normal(0, 1.5, (b, k, 1)).astype(np.float32)
    br = (tl + rng.normal(0, 0.3, (b, k, 1))).astype(np.float32)
    counts = np.array([0, 1, 4, 9])
    mask = np.arange(k)[None, :] < counts[:, None]
    t_tl = torch.from_numpy(tl).requires_grad_(True)
    t_br = torch.from_numpy(br).requires_grad_(True)
    pull, push = embedding_loss(t_tl, t_br, torch.from_numpy(mask))
    (pull + 2.0 * push).backward()

    def objective(a, c):
        p, q = jax_embedding_loss(a, c, jnp.asarray(mask))
        return p + 2.0 * q, (p, q)

    (_, (want_pull, want_push)), grads = jax.value_and_grad(
        objective, argnums=(0, 1), has_aux=True)(jnp.asarray(tl),
                                                 jnp.asarray(br))
    np.testing.assert_allclose(pull.item(), float(want_pull), rtol=1e-5)
    np.testing.assert_allclose(push.item(), float(want_push), rtol=1e-5)
    assert abs(float(want_push)) > 1e-3 and float(want_pull) > 1e-3
    for got, want in ((t_tl.grad, grads[0]), (t_br.grad, grads[1])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


# -- the legacy targets ------------------------------------------------------------

def _legacy_batch(seed: int = 0):
    """Raw clips, loc records and counts of 4 clips of 64^2, with the
    legacy corners' edge cases planted in clip 0: a tl corner in (-1, 0)
    on each axis, corners exactly on integers (the offset target 0), a
    corner one float32 step below an integer, a br corner at S - 1 and
    one at S; a clip with no objects and zero-size objects."""
    rng = np.random.default_rng(seed)
    b, k = 4, 10
    locs = np.zeros((b, k, 8), np.float32)
    locs[..., 0:2] = rng.uniform(1, HEAT - 1, (b, k, 2))
    locs[..., 2:4] = rng.uniform(0, 4, (b, k, 2))
    locs[..., 4:6] = rng.uniform(-3, 3, (b, k, 2))
    locs[..., 6] = rng.uniform(0.5, 2.5, (b, k))
    locs[..., 7] = rng.uniform(2, 6, (b, k))
    # (ctX, ctY, offX, offY, majX, majY, minL): true = c + off/4 -/+ (|maj|, minL)
    planted = [
        (2.0, 3.0, 0.0, 0.0, 2.5, 0.0, 3.4),      # tl y in (-1, 0)
        (1.0, 4.0, 0.0, 2.0, 0.0, 1.8, 2.2),      # tl x in (-1, 0)
        (5.0, 6.0, 0.0, 0.0, 3.0, 0.0, 2.0),      # tl and br on integers
        (8.0, 7.0, 0.0, 0.0, 2.0, 0.0, 2.5),      # integers, minL .5 fractions
        (HEAT - 3.0, HEAT - 4.0, 0.0, 0.0, 2.0, 0.0, 3.0),  # br at S - 1
        (HEAT - 2.0, 6.0, 0.0, 0.0, 2.0, 0.0, 1.0),  # br x at S: masked
    ]
    for i, rec in enumerate(planted):
        locs[0, i, :7] = rec
    # tl y = 1.5 - (0.5 + 2^-24 ... ) = 1 - 2^-24, one float32 step below
    # 1; br y = 2 + 2^-23 rounds to 2
    locs[0, 6, :7] = (6.0, 1.5, 0.0, 0.0, 3.0, 0.0,
                      np.nextafter(np.float32(0.5), np.float32(1.0)))
    locs[2, :3, 4:7] = 0.0  # zero-size objects
    counts = np.array([7, 0, 10, 4], np.int32)
    samples = rng.normal(180.0, 20.0, (b, 4 * HEAT, 4 * HEAT)).astype(
        np.float32)
    return samples, locs, counts


def _assert_heat_close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert ((got == 1.0) == (want == 1.0)).all()


def _port_targets(samples, locs, counts):
    return augment_and_render_batch(
        torch.from_numpy(samples), torch.from_numpy(locs),
        torch.from_numpy(counts), HEAT, draws=identity_draws(
            samples.shape[0], samples.shape[1], torch.device("cpu")),
        corner_targets="legacy")


def test_legacy_targets_match_jax():
    samples, locs, counts = _legacy_batch()
    xs, ys = _port_targets(samples, locs, counts)
    jxs, jys = jax_augment_and_render(jax.random.PRNGKey(0), samples, locs,
                                      counts, HEAT, augment=False,
                                      corner_targets="legacy")
    assert len(ys) == len(jys) == 7
    np.testing.assert_allclose(nhwc(xs), np.asarray(jxs), rtol=0, atol=1e-5)
    for i in (0, 1):
        assert ys[i].shape == (4, 1, HEAT, HEAT)
        _assert_heat_close(nhwc(ys[i]), np.asarray(jys[i]))
    for i in (2, 3, 4, 5, 6):
        np.testing.assert_array_equal(ys[i].numpy(), np.asarray(jys[i]),
                                      err_msg="ys[{}]".format(i))
    assert ys[5].dtype == ys[6].dtype == torch.int64
    mask, tl_regr, br_regr, tl_inds, br_inds = ys[2:]
    # the planted corners (clip 0)
    assert not mask[0, 0] and not mask[0, 1]  # tl in (-1, 0): not counted
    # where the renderer's trunc would have stamped them
    assert ys[0][0, 0, 0, 0] < 1.0 and ys[0][0, 0, 2, 0] < 1.0
    assert mask[0, 2] and (tl_regr[0, 2] == 0).all() \
        and (br_regr[0, 2] == 0).all()
    assert tl_inds[0, 2] == 4 * HEAT + 2 and br_inds[0, 2] == 8 * HEAT + 8
    assert mask[0, 4] and br_inds[0, 4] == (HEAT - 1) * HEAT + HEAT - 1
    assert ys[1][0, 0, HEAT - 1, HEAT - 1] == 1.0  # a br corner at S - 1
    assert not mask[0, 5]  # br x at S
    assert tl_inds[0, 6] == 3 and br_inds[0, 6] == 2 * HEAT + 9
    assert tl_regr[0, 6, 1] == np.float32(1.0) - np.float32(2.0 ** -24)
    assert br_regr[0, 6, 1] == 0.0
    assert not mask[1].any() and (ys[0][1] == 0).all()  # no objects
    assert mask.sum() >= 10


def test_legacy_validation_pre_render_matches_jax(tmp_path):
    path = str(tmp_path / "scdx16p100.d")
    make_archive(path, num_images=2, reps=1, clips_per_image=5, size=64)
    port = SCDDataset(path, None, test_set=4, seed=42, device="cpu")
    ref = JaxDataset(path, None, test_set=4, seed=42)
    got = port.get_validation_set(2, corner_targets="legacy")
    want = ref.get_validation_set(2, corner_targets="legacy")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g["xs"][0]), w["xs"][0], atol=1e-5)
        assert len(g["ys"]) == len(w["ys"]) == 7
        for i, (gy, wy) in enumerate(zip(g["ys"], w["ys"])):
            if i < 2:
                _assert_heat_close(nhwc(gy), np.asarray(wy))
            else:
                np.testing.assert_array_equal(gy.numpy(), np.asarray(wy))


# -- the model ----------------------------------------------------------------

def test_small_legacy_forward_matches_flax():
    """Both stacks' six heads from the same seeded flax weights, eval
    mode; the corner pools take their plain versions on the CPU."""
    jax_model = jax_small_legacy(stacks=2)
    params, stats = flax_variables(jax_model, 13, heads=LEGACY_HEAD_PATHS)
    model = CornerNetLegacy(stacks=2, **HOURGLASS_SMALL)
    with pytest.MonkeyPatch.context() as patch:
        patch.setitem(registry.MODEL_PROFILES, "cornerLegacySmall",
                      _small_profile())
        sd = state_dict_from_flax("cornerLegacySmall", params, stats)
    model.load_state_dict(sd, strict=True)
    x = np.random.default_rng(8).normal(size=(2, 64, 64, 1)).astype(
        np.float32)
    want = jax_model.apply({"params": params, "batch_stats": stats},
                           jnp.asarray(x), train=False)
    with torch.inference_mode():
        got = model.eval()(nchw(x))
    assert len(got) == len(want) == 2
    for s, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w) == set(HEADS)
        for head in HEADS:
            ref = np.asarray(w[head])
            scale = np.abs(ref).max()
            assert scale > 0.1, head
            np.testing.assert_allclose(nhwc(g[head]), ref, rtol=0,
                                       atol=1e-4 * scale,
                                       err_msg="stack {} {}".format(s, head))


def _small_profile():
    import dataclasses

    base = get_model_profile("cornerLegacyHourglass")
    return dataclasses.replace(base, name="cornerLegacySmall",
                               model_params=dict(base.model_params,
                                                 **HOURGLASS_SMALL))


def test_legacy_profile_is_registered():
    profile = get_model_profile("cornerLegacyHourglass")
    assert profile.family == "cornerLegacy"
    assert profile.corner_targets == "legacy"
    assert profile.model_params == {"categories": 1, "stacks": 2}
    for piece in ("loss", "decode", "evaluation", "expression"):
        assert getattr(profile, piece) is not None
    assert CONTRACTS["cornerLegacy"] and \
        CONTRACT_FIELDS["cornerLegacy"] == ("tlx", "tly", "brx", "bry",
                                            "score")


# -- the loss -----------------------------------------------------------------

def _targets(seed: int = 0):
    samples, locs, counts = _legacy_batch(seed)
    _, ys = _port_targets(samples, locs, counts)
    jys = [nhwc(y) if y.dim() == 4 else y.numpy() for y in ys]
    jys[5], jys[6] = jys[5].astype(np.int32), jys[6].astype(np.int32)
    return ys, jys


def _head_outputs(ys, seed: int, stacks: int = 2):
    """NHWC head outputs per stack: heat logits that peak near the
    targets' peaks, tags that pair each object's corners, offsets near
    the targets; plus noise."""
    rng = np.random.default_rng(seed)
    outs = []
    for _ in range(stacks):
        out = {}
        for name, i in (("tl_heat", 0), ("br_heat", 1)):
            gt = nhwc(ys[i])
            out[name] = (6.0 * gt - 3.0 + rng.normal(0, 0.7, gt.shape)
                         ).astype(np.float32)
        for name in ("tl_tag", "br_tag"):
            out[name] = rng.normal(0, 1.0, (4, HEAT, HEAT, 1)).astype(
                np.float32)
        for name in ("tl_regr", "br_regr"):
            out[name] = rng.uniform(0, 1, (4, HEAT, HEAT, 2)).astype(
                np.float32)
        outs.append(out)
    return outs


def test_legacy_loss_and_gradient_match_jax():
    ys, jys = _targets()
    outs = _head_outputs(ys, 1)
    port_outs = [{k: nchw(v).requires_grad_(True) for k, v in o.items()}
                 for o in outs]
    loss, stats = legacy.CornerNetLegacyLoss()(port_outs, ys)
    loss.backward()

    def objective(o):
        return jax_legacy.CornerNetLegacyLoss()(o, jys)

    (want, want_stats), grads = jax.value_and_grad(objective, has_aux=True)(
        [{k: jnp.asarray(v) for k, v in o.items()} for o in outs])
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    assert len(stats) == len(want_stats) == 4
    for got, ref in zip(stats, want_stats):
        np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
        assert float(ref) != 0.0
    for s, out in enumerate(port_outs):
        for name, tensor in out.items():
            want_g = np.asarray(grads[s][name])
            scale = np.abs(want_g).max()
            assert scale > 0, name
            np.testing.assert_allclose(nhwc(tensor.grad), want_g, rtol=0,
                                       atol=1e-5 * scale, err_msg=name)


# -- the decode ----------------------------------------------------------------

def _agreeing_logits(n: int, seed: int) -> np.ndarray:
    """``n`` distinct float32 logits in [-4, 4] on which ``torch.sigmoid``
    and ``jax.nn.sigmoid`` give the same bits, in random order."""
    rng = np.random.default_rng(seed)
    pool = np.unique(rng.uniform(-4, 4, 8 * n).astype(np.float32))
    agree = torch.sigmoid(torch.from_numpy(pool)).numpy() == np.asarray(
        jax.nn.sigmoid(jnp.asarray(pool)))
    pool = pool[agree]
    assert len(pool) >= n
    return rng.permutation(pool)[:n]


def _decode_inputs(case: str):
    """NHWC head outputs of 2 clips for a planted decode case.

    ``symmetric``: the tl and br heat maps are the same, the tags equal
    and every br offset +30, so all 100 x 100 pairs pass and pair (i, j)
    ties pair (j, i) exactly: the top 1000 hold hundreds of exact ties.
    ``rejected``: spread tags and small offsets reject most pairs, so the
    top 1000 end in a run of -1 ties."""
    b = 2
    heat = _agreeing_logits(b * HEAT * HEAT, 3).reshape(b, HEAT, HEAT, 1)
    rng = np.random.default_rng(4)
    out = {"tl_heat": heat}
    if case == "symmetric":
        out["br_heat"] = heat.copy()
        out["tl_tag"] = np.zeros((b, HEAT, HEAT, 1), np.float32)
        out["br_tag"] = np.zeros((b, HEAT, HEAT, 1), np.float32)
        out["tl_regr"] = np.zeros((b, HEAT, HEAT, 2), np.float32)
        out["br_regr"] = np.full((b, HEAT, HEAT, 2), 30.0, np.float32)
    else:
        out["br_heat"] = _agreeing_logits(b * HEAT * HEAT, 5).reshape(
            b, HEAT, HEAT, 1)
        out["tl_tag"] = rng.normal(0, 5, (b, HEAT, HEAT, 1)).astype(
            np.float32)
        out["br_tag"] = rng.normal(0, 5, (b, HEAT, HEAT, 1)).astype(
            np.float32)
        out["tl_regr"] = rng.uniform(0, 1, (b, HEAT, HEAT, 2)).astype(
            np.float32)
        out["br_regr"] = rng.uniform(0, 1, (b, HEAT, HEAT, 2)).astype(
            np.float32)
    return out


@pytest.mark.parametrize("case", ["symmetric", "rejected"])
def test_legacy_decode_matches_jax_with_ties(case):
    out = _decode_inputs(case)
    got = legacy.decode_corner_net_legacy({k: nchw(v) for k, v in out.items()})
    want = np.asarray(jax_legacy.decode_corner_net_legacy(
        {k: jnp.asarray(v) for k, v in out.items()}))
    assert got.shape == want.shape == (2, 1000, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    scores = want[:, :, 4]
    if case == "symmetric":
        assert (scores > 0).all()
        ties = (np.diff(scores, axis=1) == 0).sum()
        assert ties >= 400  # pair (i, j) and pair (j, i), side by side
    else:
        assert (scores == -1.0).sum() > 200 and (scores > 0.3).any()
    listed = legacy.decode_corner_net_legacy_list(
        {k: nchw(v) for k, v in out.items()})
    assert len(listed) == 1 and torch.equal(listed[0], got)


# -- evaluation and the report line ------------------------------------------------

def test_legacy_evaluation_and_report_line_match_jax():
    ys, jys = _targets()
    batches = []
    for seed in (6, 7):  # two batches, aggregated together
        out = _head_outputs(ys, seed, stacks=1)[0]
        for name in ("tl_tag", "br_tag"):
            out[name] = np.zeros_like(out[name])  # pair every object
        det = legacy.decode_corner_net_legacy(
            {k: nchw(v) for k, v in out.items()})
        jdet = jax_legacy.decode_corner_net_legacy(
            {k: jnp.asarray(v) for k, v in out.items()})
        np.testing.assert_allclose(det[:, :, 4].numpy(),
                                   np.asarray(jdet)[:, :, 4], atol=1e-6)
        port = legacy.corner_net_legacy_evaluation(None, ys, det)
        ref = jax.tree_util.tree_map(np.asarray,
                                     jax_legacy.corner_net_legacy_evaluation(
                                         None, jys, jnp.asarray(det.numpy())))
        for g, w in zip(port["iouscore"], ref["iouscore"]):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(port["objs"].numpy(), ref["objs"])
        batches.append((port, ref))
    got_line = expression_corner_net_legacy([p for p, _ in batches])
    want_line = jax_legacy.expression_corner_net_legacy(
        [r for _, r in batches])
    for name in ("mIoU", "AP50"):
        got_v = parse_metric_line(got_line, name)
        want_v = parse_metric_line(want_line, name)
        assert got_v is not None and want_v is not None, name
        np.testing.assert_allclose(got_v, want_v, rtol=1e-4, err_msg=name)
    assert parse_metric_line(want_line, "AP50") > 0


# -- serving --------------------------------------------------------------------

def test_stitch_legacy_boxes_and_dedupe_match_jax():
    """(N, 1000, 8) rows of a 2 x 2 clip grid: slide-pixel boxes, the
    0.3 threshold, the center-in-slide bounds, then the center dedupe."""
    rng = np.random.default_rng(9)
    rows = np.zeros((4, 1000, 8), np.float32)
    rows[:, :, 0:2] = rng.uniform(-10, 128, (4, 1000, 2))
    rows[:, :, 2:4] = rows[:, :, 0:2] + rng.uniform(0, 12, (4, 1000, 2))
    rows[:, :, 4] = np.where(rng.uniform(size=(4, 1000)) < 0.7, -1.0,
                             rng.uniform(0, 1, (4, 1000)))
    width, height = 880, 850
    geometry = slide_geometry(width, height)
    assert geometry[:2] == (2, 2)
    got = stitch_any(rows, "cornerLegacy", *geometry, (width, height))
    want = jax_stitch_any(rows, "cornerLegacy", *geometry, (width, height))
    assert got == want and len(got) > 100
    assert all(len(d) == 5 and d[4] > 0.3 for d in got)
    assert dedupe_contract(got, 16.0, "cornerLegacy") == \
        jax_dedupe_contract(want, 16.0, "cornerLegacy")
    assert len(dedupe_contract(got, 16.0, "cornerLegacy")) < len(got)


def test_legacy_wrapper_contract_and_a_served_slide(monkeypatch):
    torch.manual_seed(0)
    model = CornerNetLegacy(stacks=2, **HOURGLASS_SMALL)
    wrapper = make_wrapper(model, "cornerLegacy")
    assert wrapper.contract == "cornerLegacy" and wrapper.rows == \
        CONTRACTS["cornerLegacy"]
    clips = torch.randn(3, 1, 64, 64)
    rows = wrapper(clips)
    assert rows.shape == (3, 1000, 8) and rows.dtype == torch.float32
    with torch.inference_mode():
        final = model(clips)[-1]
    assert torch.equal(rows, legacy.decode_corner_net_legacy(final))
    slide = np.random.default_rng(0).integers(0, 255, (600, 700), np.uint8)
    # the slide's 4 clip(s) as one batch of 4: the analyzer pads a
    # slide of fewer than BATCH_SIZE clips to that batch, which on the CPU
    # only adds blank clips' forwards (test_torch_mesh_serving.py holds it)
    monkeypatch.setattr(analyse, "BATCH_SIZE", 4)
    service = InferenceService(wrapper, dedupe_radius=8.0)
    detections = service.analyse_gray(slide)
    for det in detections:
        assert len(det) == 5 and det[4] > 0.3
        assert 0 <= (det[0] + det[2]) / 2 < 700
        assert 0 <= (det[1] + det[3]) / 2 < 600
    assert service.metrics()["requests"] == 1
