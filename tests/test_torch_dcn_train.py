"""DCN training against the JAX trainer (CPU): float32 train steps of a
quarter-width ``centerOffsetRes10dcn`` on 256^2 clips (an 8x8 map at
the deformable layer) through both ``NetworkFactory``s from the same
converted weights, and planted faults in the gather's backward that the
check must catch.

The quarter-width profile (``dims=(16, 16, 32, 64, 128, 64, 64, 64)``,
terminal hidden 64) is registered in both registries for the module's
run only. The steps are held as ``tests/test_torch_train.py`` holds
exp74's, with its helpers and tolerances (its module docstring gives
each reason): losses within 1e-4 relative at every step; each step
replayed from the JAX trainer's state gives parameters within 1e-2 lr
wherever JAX's gradient is above rounding level, Adam's moments within
1e-3 G and 1e-5 G^2, and BatchNorm statistics within 1e-4 relative.

The JAX trainer takes four steps from its initial weights, and the port
replays each from the JAX trainer's state before it (weights, BatchNorm
statistics, Adam's count and moments) on the same batch and draws. At
the first step ``conv_offset_mask`` is zero, so every sample sits on an
integer position, where the gather's derivative is one-sided (floor
passes none) in both frameworks; from the second step on the offsets
are fractional. All four updates are held, the first one too (unlike
``tests/test_torch_corner_train.py``, whose step-0 gradient is
ill-conditioned).

One tensor is left out of the update check: the DCN's bias. The DCN
feeds a BatchNorm in training mode, which subtracts every channel's batch
mean, so the bias has no gradient in exact arithmetic; both frameworks'
float32 gradients are rounding noise (about 1e-7 of the DCN kernel's
largest, measured here), and Adam turns noise of either sign into steps
of about lr. The test holds that reason instead: the bias's gradient is
below 1e-6 of the kernel's on both sides at every step.

The gradient of ``conv_offset_mask``'s offset rows reaches the loss only
through the gather's dpy and dpx: a planted fault there (dpy and dpx
dropped, or swapped) must fail the update check.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from scd_resnet_tpu.core.config import Configuration as JaxConfiguration
from scd_resnet_tpu.data.dataset import SCDDataset as JaxDataset
from scd_resnet_tpu.parallel.mesh import create_mesh
from scd_resnet_tpu.train import registry as jax_registry
from scd_resnet_tpu.train.factory import NetworkFactory as JaxFactory
from scd_resnet_tpu_torch.core.config import Configuration
from scd_resnet_tpu_torch.core.convert import state_dict_from_flax
from scd_resnet_tpu_torch.data.dataset import SCDDataset
from scd_resnet_tpu_torch.data.synthetic import make_archive
from scd_resnet_tpu_torch.ops import dcn
from scd_resnet_tpu_torch.train import registry
from scd_resnet_tpu_torch.train.factory import NetworkFactory

from test_torch_train import (
    _bn_stats,
    _check_update,
    _port_state,
    _sync,
    _tree,
)
from torch_port_common import QUARTER, jax_draws

ARCH = "centerOffsetRes10dcnq"
LR = 1e-3
SIZE = 256
OFFSET_ROWS = "deconv_dcn.conv_offset_mask.weight"
BIAS = "deconv_dcn.bias"  # no gradient in exact arithmetic: see above


def _without_bias(after):
    """A JAX state whose Adam moments skip the DCN's bias, so that
    ``_check_update`` (which checks the names in ``after["mu"]``) leaves
    it out."""
    return dict(after, mu={k: v for k, v in after["mu"].items() if k != BIAS})


def _register(patch) -> None:
    """The quarter-width centerOffsetRes10dcn in both registries."""
    for reg in (jax_registry, registry):
        base = reg.get_model_profile("centerOffsetRes10dcn")
        patch.setitem(reg.MODEL_PROFILES, ARCH, dataclasses.replace(
            base, name=ARCH, model_params=dict(
                base.model_params, dims=QUARTER, terminal_hidden=64)))


def _settings(root, **extra):
    settings = {
        "datasetName": "scdx16p100", "modelName": ARCH, "trainName": "tiny",
        "batchSize": 4, "validationBatchSize": 4, "iterations": 4,
        "validation": 2, "snapshot": 2, "learningRate": LR,
        "learningRateDecay": [100], "learningRateDecayRate": [10],
        "dirTemp": str(root / "temp") + "/",
        "dirResult": str(root / "results") + "/",
        "dirDataset": str(root) + "/",
    }
    settings.update(extra)
    return settings


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    """A small synthetic archive: 2 images x 1 rep x 10 clips of 256^2."""
    root = tmp_path_factory.mktemp("dcn_train")
    path = str(root / "scdx16p100.d")
    make_archive(path, num_images=2, reps=1, clips_per_image=10, size=SIZE)
    return root, path


@pytest.fixture(scope="module")
def patch_registries():
    with pytest.MonkeyPatch.context() as patch:
        _register(patch)
        yield


def _snapshot(jfac):
    """The JAX trainer's state in the port's names."""
    stats = _tree(jfac.batch_stats)
    adam = jfac.opt_state[0]
    return {"model": state_dict_from_flax(ARCH, _tree(jfac.params), stats),
            "count": int(adam.count),
            "mu": state_dict_from_flax(ARCH, _tree(adam.mu), stats),
            "nu": state_dict_from_flax(ARCH, _tree(adam.nu), stats)}


def _port_trainer(root, path):
    cfg = Configuration()
    cfg.update_config(_settings(root))
    return NetworkFactory(cfg, dataset=SCDDataset(
        path, None, test_set=4, seed=42, device="cpu"), device="cpu")


@pytest.fixture(scope="module")
def four_steps(archive, patch_registries):
    """Four float32 steps of the JAX trainer, with its state before and
    after each, and the losses and states of a port trainer synced to the
    JAX state before each step, on the same batches and draws."""
    root, path = archive
    jcfg = JaxConfiguration()
    jcfg.update_config(_settings(root / "jax"))
    jds = JaxDataset(path, None, test_set=4, seed=42)
    jfac = JaxFactory(jcfg, dataset=jds, mesh=create_mesh(jax.devices()[:1]))
    steps = []
    for step, batch in enumerate(list(jds.epoch_batches(4, epoch=0))[:4]):
        key = jax.random.fold_in(jax.random.PRNGKey(43), step)
        before = _snapshot(jfac)
        loss, _ = jfac.train(*batch)
        steps.append({"batch": batch, "before": before,
                      "after": _snapshot(jfac), "loss": float(loss),
                      "draws": jax_draws(key, 4, batch[0].shape[1])})
    port = _port_trainer(root / "port", path)
    losses, synced = [], []
    for rec in steps:
        _sync(port, rec["before"])
        loss, _ = port.train(*rec["batch"], draws=rec["draws"])
        losses.append(loss.item())
        synced.append(_port_state(port))
    return {"steps": steps, "losses": losses, "synced": synced,
            "path": path}


def test_dcn_steps_losses_match_jax(four_steps):
    want = [rec["loss"] for rec in four_steps["steps"]]
    got = four_steps["losses"]
    assert len(got) == 4 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert want[3] != want[1]  # the steps did train


def test_dcn_offsets_start_at_zero_and_then_move(four_steps):
    """The offset conv starts at zero in both trainers and the first step
    moves it: the later steps sample fractional positions."""
    steps = four_steps["steps"]
    assert torch.all(steps[0]["before"]["model"][OFFSET_ROWS] == 0)
    moved = steps[1]["before"]["model"][OFFSET_ROWS][:18]
    assert moved.abs().max() > 0.5 * LR


@pytest.mark.parametrize("kind", ["parameters", "batch_norm_stats"])
def test_dcn_steps_state_matches_jax(four_steps, kind):
    steps = four_steps["steps"]
    for step, (rec, got) in enumerate(zip(steps, four_steps["synced"])):
        if kind == "parameters":
            n_rounding, n_all = _check_update(got, rec["before"],
                                              _without_bias(rec["after"]), LR)
            assert 0 < n_rounding <= 0.1 * n_all
        else:
            want_stats = _bn_stats(rec["after"]["model"])
            assert "deconv_dcn_bn.running_var" in want_stats
            for key, want in want_stats.items():
                np.testing.assert_allclose(
                    got["model"][key].numpy(), want.numpy(), rtol=1e-4,
                    atol=1e-6, err_msg="step {} {}".format(step, key))


def test_dcn_bias_gradient_is_rounding_noise(four_steps):
    """The reason the DCN's bias is left out of the update check: its
    gradient, read back from Adam's first moment on both sides, is below
    1e-6 of the DCN kernel's largest at every step."""
    for rec, got in zip(four_steps["steps"], four_steps["synced"]):
        before, after = rec["before"]["mu"], rec["after"]["mu"]

        def grad(moments, name):
            return (moments[name] - 0.9 * before[name]) / 0.1

        kernel = grad(after, "deconv_dcn.weight").abs().max().item()
        assert kernel > 1e-3
        for moments in (after, got["exp_avg"]):
            assert grad(moments, BIAS).abs().max().item() < 1e-6 * kernel


def _no_position_gradient(x, py, px, g):
    dx, dpy, dpx = dcn.dcn_gather_bwd_plain(x, py, px, g)
    return dx, torch.zeros_like(dpy), torch.zeros_like(dpx)


def _swapped(x, py, px, g):
    dx, dpy, dpx = dcn.dcn_gather_bwd_plain(x, py, px, g)
    return dx, dpx, dpy


@pytest.mark.parametrize("fault", [_no_position_gradient, _swapped],
                         ids=["no_position_gradient", "dpy_dpx_swapped"])
def test_dcn_update_check_catches_a_planted_backward_fault(
        four_steps, tmp_path, monkeypatch, fault):
    """The third step replayed with the gather's position gradient
    dropped, or with dpy and dpx swapped, must fail the update check that
    the real backward passes."""
    rec = four_steps["steps"][2]
    port = _port_trainer(tmp_path, four_steps["path"])
    monkeypatch.setattr(dcn, "dcn_gather_bwd", fault)
    _sync(port, rec["before"])
    port.train(*rec["batch"], draws=rec["draws"])
    with pytest.raises(AssertionError):
        _check_update(_port_state(port), rec["before"],
                      _without_bias(rec["after"]), LR)
