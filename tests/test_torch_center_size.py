"""The centerSize family (``centerRes10``) against the JAX package on the
CPU: the model through the converter, the loss, the decode, the
evaluation and its report line, the slide stitch, two float32 train
steps of a quarter-width ``centerRes10q`` against the JAX trainer, and
the registry's 21 profiles.

Tolerances, each with its reason:
- heads within 1e-4 of the head's largest magnitude: float32
  convolutions sum in another order on each side;
- the loss and its two terms within 1e-5 relative, on the same head
  outputs and targets (reductions in another order);
- the decode on the same heads: peak positions exact wherever the score
  is above 0; scores and sizes within 1e-6 (``sigmoid`` may round a last
  bit apart);
- the evaluation on the same decode: masks equal, IoUs and the
  ground-truth heat at the peaks within 1e-6 (the heat exact); the
  report line of the same evaluation equal as text;
- the train steps as ``tests/test_torch_train.py`` holds exp74's (its
  docstring gives each reason): losses within 1e-4 relative, each step
  replayed from the JAX state with parameters within 1e-2 lr wherever
  JAX's gradient is above rounding level and Adam's moments within
  1e-3 G and 1e-5 G^2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scd_resnet_tpu.core.config import Configuration as JaxConfiguration
from scd_resnet_tpu.data.dataset import SCDDataset as JaxDataset
from scd_resnet_tpu.infer.analyse import stitch_any as jax_stitch
from scd_resnet_tpu.models import center_net as jcn
from scd_resnet_tpu.parallel.mesh import create_mesh
from scd_resnet_tpu.train import registry as jax_registry
from scd_resnet_tpu.train.expression import (
    expression_center_net_size as jax_expression,
)
from scd_resnet_tpu.train.factory import NetworkFactory as JaxFactory
from scd_resnet_tpu_torch.core.config import Configuration
from scd_resnet_tpu_torch.core.convert import state_dict_from_flax
from scd_resnet_tpu_torch.data.dataset import SCDDataset
from scd_resnet_tpu_torch.data.synthetic import make_archive
from scd_resnet_tpu_torch.infer.analyse import (
    CONTRACT_FIELDS,
    dedupe_contract,
    slide_geometry,
    stitch_any,
)
from scd_resnet_tpu_torch.infer.wrapper import CONTRACTS, make_wrapper
from scd_resnet_tpu_torch.models import center_net as pcn
from scd_resnet_tpu_torch.train import registry
from scd_resnet_tpu_torch.train.expression import expression_center_net_size
from scd_resnet_tpu_torch.train.factory import NetworkFactory, parse_metric_line

from test_torch_train import _check_update, _port_state, _sync, _tree
from torch_port_common import QUARTER, flax_variables, jax_draws, nchw, nhwc

ARCH = "centerRes10q"
LR = 1e-3
SIZE_HEADS = ("ResNetBackbone_0/heatmap/Conv_1", "ResNetBackbone_0/size/Conv_1")
K = 8  # ground-truth slots per clip in the hand-made targets


@pytest.fixture(scope="module")
def outputs():
    """JAX heads (NHWC numpy), port heads (NCHW) and the flax variables
    on one seeded 64x64 batch of 2."""
    jax_model = jcn.CenterNetSizeResidual(num_layers=10, dims=QUARTER)
    params, stats = flax_variables(jax_model, seed=5, heads=SIZE_HEADS)
    x = np.random.default_rng(4).normal(size=(2, 64, 64, 1)).astype(
        np.float32)
    ref = jax_model.apply({"params": params, "batch_stats": stats},
                          jnp.asarray(x), train=False)
    model = pcn.CenterNetSizeResidual(10, QUARTER)
    model.load_state_dict(state_dict_from_flax("centerRes10", params, stats),
                          strict=True)
    with torch.inference_mode():
        got = model.eval()(nchw(x))
    return jax.tree_util.tree_map(np.asarray, ref), got, model


def _targets(seed: int, heat_size: int = 16, indices=None):
    """Hand-made training targets ``[heat, tag mask, regr, indices]``
    (NHWC heat for JAX; the objects at ``indices`` (B, K), else at random
    places) and their validation form, whose ``ys[3]`` is the (B, K, 8)
    loc records with the centers in columns 0, 1."""
    rng = np.random.default_rng(seed)
    b = 2
    heat = rng.uniform(0.0, 0.9, (b, heat_size, heat_size, 1)).astype(
        np.float32)
    mask = np.zeros((b, K), bool)
    mask[:, :5] = True
    if indices is None:
        indices = np.stack([rng.choice(heat_size * heat_size, K,
                                       replace=False) for _ in range(b)])
    indices = np.asarray(indices, np.int32)
    heat.reshape(b, -1)[np.arange(b)[:, None], indices] = 1.0
    regr = rng.normal(0.0, 1.5, (b, K, 6)).astype(np.float32)
    regr[:, :, 4] = np.abs(regr[:, :, 4]) + 0.5  # a minor axis length
    locs = np.zeros((b, K, 8), np.float32)
    locs[:, :, 0] = indices % heat_size
    locs[:, :, 1] = indices // heat_size
    return [heat, mask, regr, indices], locs


def _port_ys(ys):
    heat, mask, regr, third = (np.array(y) for y in ys)
    return [torch.from_numpy(heat.transpose(0, 3, 1, 2).copy()),
            torch.from_numpy(mask), torch.from_numpy(regr),
            torch.from_numpy(third).long() if third.ndim == 2
            else torch.from_numpy(third)]


def test_heads_match_jax(outputs):
    ref, got, _ = outputs
    assert set(got) == {"heatmap", "size"}
    for head in ("heatmap", "size"):
        scale = np.abs(ref[head]).max()
        assert scale > 0.1, head  # a live head
        np.testing.assert_allclose(nhwc(got[head]), ref[head], rtol=0,
                                   atol=1e-4 * scale, err_msg=head)


def test_loss_matches_jax(outputs):
    ref, _, _ = outputs
    ys, _ = _targets(1)
    want, (want_focal, want_size) = jcn.CenterNetSizeLoss(1.0)(
        [{k: jnp.asarray(v) for k, v in ref.items()}],
        [jnp.asarray(y) for y in ys])
    got, (focal, size) = pcn.CenterNetSizeLoss(1.0)(
        [{k: nchw(v) for k, v in ref.items()}], _port_ys(ys))
    assert float(want_size) > 0
    for g, w in ((got, want), (focal, want_focal), (size, want_size)):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)


def _decoded(ref):
    want = jcn.decode_center_net_size({k: jnp.asarray(v)
                                       for k, v in ref.items()})
    got = pcn.decode_center_net_size({k: nchw(v) for k, v in ref.items()})
    return got, want


def test_decode_matches_jax(outputs):
    """Peak positions equal wherever the score is above 0 (after NMS the
    zero-score ties order differently under ``torch.topk`` and
    ``lax.top_k``, as ``tests/test_torch_models.py`` says)."""
    got, want = _decoded(outputs[0])
    scores = np.asarray(want[0])
    live = scores > 0
    assert (scores > 0.3).any() and live.sum() > 20
    np.testing.assert_allclose(got[0].numpy(), scores, rtol=0, atol=1e-6)
    for i in (1, 2, 3):  # peak indices, y, x
        np.testing.assert_array_equal(got[i].numpy()[live],
                                      np.asarray(want[i])[live])
    np.testing.assert_allclose(got[4].numpy()[live], np.asarray(want[4])[live],
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("layout", ["train", "validation"])
def test_evaluation_and_report_line_match_jax(outputs, layout):
    """The evaluation on the same decode, and the report line: the
    port's expression on the JAX evaluation gives JAX's line as text, and
    on its own evaluation the same metrics within 1e-4. On both sides the
    heat logits move up by 1.5, so that peaks pass the box IoU's 0.5
    score gate, the sizes by 0.3, so that boxes have an area, and the
    objects sit at the first decoded peaks, so that boxes overlap."""
    ref = dict(outputs[0], heatmap=outputs[0]["heatmap"] + 1.5,
               size=outputs[0]["size"] + 0.3)
    got_dec, want_dec = _decoded(ref)
    ys, locs = _targets(2, indices=np.asarray(want_dec[1])[:, :K])
    if layout == "validation":
        ys = ys[:3] + [locs]
    want = jcn.center_net_size_evaluation(None, [jnp.asarray(y) for y in ys],
                                          *want_dec)
    got = pcn.center_net_size_evaluation(None, _port_ys(ys), *got_dec)
    np.testing.assert_array_equal(got["iou"][1].numpy(),
                                  np.asarray(want["iou"][1]))
    mask = np.asarray(want["iou"][1])
    assert mask.any()
    np.testing.assert_allclose(got["iou"][0].numpy()[mask],
                               np.asarray(want["iou"][0])[mask], atol=1e-6)
    peaks = np.asarray(want["heat"][2])  # scores >= 0.3, all live
    np.testing.assert_array_equal(got["heat"][2].numpy(), peaks)
    assert peaks.any()
    for i, tol in ((0, 0.0), (1, 1e-6)):
        np.testing.assert_allclose(got["heat"][i].numpy()[peaks],
                                   np.asarray(want["heat"][i])[peaks],
                                   atol=tol)
    np.testing.assert_array_equal(got["objs"].numpy(), np.asarray(want["objs"]))
    want_np = jax.tree_util.tree_map(np.asarray, want)
    line = jax_expression([want_np])
    assert expression_center_net_size([want_np]) == line
    own = expression_center_net_size([got])
    for metric in ("mIoU", "peakAP30", "peakAP50", "peakAP75"):
        np.testing.assert_allclose(parse_metric_line(own, metric),
                                   parse_metric_line(line, metric), atol=1e-4)


def test_stitch_size_rows_matches_jax():
    """centerSize rows (6, N, K) to ``[x, y, w, h, score]`` and the dedupe,
    exactly as the JAX package on the same seeded rows."""
    width, height = 1001, 789
    geometry = slide_geometry(width, height)
    n_clips = geometry[0] * geometry[1]
    rng = np.random.default_rng(12)
    rows = rng.uniform(0, 128, (6, n_clips, 30))
    rows[0] = rng.uniform(0, 1, (n_clips, 30))
    rows[4:6] = rng.normal(0.5, 0.3, (2, n_clips, 30))
    for bounds in ((width, height), None):
        got = stitch_any(rows, "centerSize", *geometry, bounds)
        want = jax_stitch(rows, "centerSize", *geometry, bounds)
        assert len(got) > 50 and got == want
        assert all(len(d) == len(CONTRACT_FIELDS["centerSize"]) for d in got)
    assert dedupe_contract(got, 16.0, "centerSize") == \
        dedupe_contract(want, 16.0, "centerSize")


def test_wrapper_contract_is_six_rows(outputs):
    model = outputs[2]
    wrapper = make_wrapper(model, "centerSize")
    rows = wrapper(torch.zeros(3, 1, 64, 64))
    assert rows.shape == (6, 3, 100) and wrapper.rows == CONTRACTS["centerSize"]


def test_registry_builds_every_jax_profile():
    """The port's registry holds the JAX registry's 21 model profiles, each
    with its family, and builds each (on the meta device: no weights)."""
    names = set(jax_registry.MODEL_PROFILES)
    assert len(names) == 21 and set(registry.MODEL_PROFILES) == names
    for name in sorted(names):
        port, ref = registry.get_model_profile(name), \
            jax_registry.get_model_profile(name)
        assert port.family == ref.family, name
        with torch.device("meta"):
            model = port.build()
        assert sum(p.numel() for p in model.parameters()) > 0, name
    profile = registry.get_model_profile("centerRes10")
    assert profile.family == "centerSize" and profile.loss.regression_weight \
        == jax_registry.get_model_profile("centerRes10").loss.regression_weight


# -- two float32 train steps against the JAX trainer ------------------------------

def _settings(root):
    return {"datasetName": "scdx16p100", "modelName": ARCH, "trainName": "tiny",
            "batchSize": 4, "validationBatchSize": 4, "iterations": 2,
            "validation": 2, "snapshot": 2, "learningRate": LR,
            "learningRateDecay": [100], "learningRateDecayRate": [10],
            "bestSnapshotMetric": "peakAP50",
            "dirTemp": str(root / "temp") + "/",
            "dirResult": str(root / "results") + "/",
            "dirDataset": str(root) + "/"}


def _snapshot(jfac):
    stats = _tree(jfac.batch_stats)
    adam = jfac.opt_state[0]
    return {"model": state_dict_from_flax(ARCH, _tree(jfac.params), stats),
            "count": int(adam.count),
            "mu": state_dict_from_flax(ARCH, _tree(adam.mu), stats),
            "nu": state_dict_from_flax(ARCH, _tree(adam.nu), stats)}


@pytest.fixture(scope="module")
def two_steps(tmp_path_factory):
    """Two float32 steps of the JAX trainer on a quarter-width
    ``centerRes10q`` (registered in both registries for this module),
    and a port trainer synced to the JAX state before each, on the same
    batches and draws."""
    root = tmp_path_factory.mktemp("center_size_train")
    path = str(root / "scdx16p100.d")
    make_archive(path, num_images=2, reps=1, clips_per_image=8, size=64)
    with pytest.MonkeyPatch.context() as patch:
        for reg in (jax_registry, registry):
            base = reg.get_model_profile("centerRes10")
            patch.setitem(reg.MODEL_PROFILES, ARCH, dataclasses.replace(
                base, name=ARCH,
                model_params=dict(base.model_params, dims=QUARTER)))
        jcfg = JaxConfiguration()
        jcfg.update_config(_settings(root / "jax"))
        jds = JaxDataset(path, None, test_set=4, seed=42)
        jfac = JaxFactory(jcfg, dataset=jds,
                          mesh=create_mesh(jax.devices()[:1]))
        steps = []
        for step, batch in enumerate(list(jds.epoch_batches(4, epoch=0))[:2]):
            key = jax.random.fold_in(jax.random.PRNGKey(43), step)
            before = _snapshot(jfac)
            loss, _ = jfac.train(*batch)
            steps.append({"batch": batch, "before": before,
                          "after": _snapshot(jfac), "loss": float(loss),
                          "draws": jax_draws(key, 4, batch[0].shape[1])})
        cfg = Configuration()
        cfg.update_config(_settings(root / "port"))
        port = NetworkFactory(cfg, dataset=SCDDataset(
            path, None, test_set=4, seed=42, device="cpu"), device="cpu")
        losses, synced = [], []
        for rec in steps:
            _sync(port, rec["before"])
            loss, _ = port.train(*rec["batch"], draws=rec["draws"])
            losses.append(loss.item())
            synced.append(_port_state(port))
        line = port._validation_lines(2)[1]
    return steps, losses, synced, line


def test_train_steps_match_jax(two_steps):
    steps, losses, synced, _ = two_steps
    np.testing.assert_allclose(losses, [r["loss"] for r in steps], rtol=1e-4)
    for rec, got in zip(steps, synced):
        n_rounding, n_all = _check_update(got, rec["before"], rec["after"], LR)
        assert n_rounding <= 0.1 * n_all


def test_trainer_report_line_carries_peak_ap50(two_steps):
    """The port trainer's validation line parses the best-snapshot metric
    of ``configs/centersize_full.json``."""
    line = two_steps[3]
    assert line.startswith("[It]")
    for metric in ("mIoU", "peakAP30", "peakAP50", "peakAP75"):
        assert parse_metric_line(line, metric) is not None, metric
