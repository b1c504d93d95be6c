"""Corner training as a whole against the JAX trainer (CPU): three float32
train steps of a quarter-width ``cornerCPoolRes10`` on 64^2 clips through
both ``NetworkFactory``s from the same converted weights, planted faults
in the corner pools' gradient that the check must catch, and the
``python -m scd_resnet_tpu_torch.train`` entry point on a corner config.

The quarter-width profile (``dims=(16, 16, 32, 64, 128, 64, 64, 64)``)
is registered in both registries for the module's run only. The steps
are held as ``tests/test_torch_train.py`` holds exp74's, with its
helpers and tolerances (its module docstring gives each reason): losses
within 1e-4 relative at every step; each step replayed from the JAX
trainer's state gives parameters within 1e-2 lr wherever JAX's gradient
is above rounding level, Adam's moments within 1e-3 G and 1e-5 G^2, and
BatchNorm statistics within 1e-4 relative.

The JAX trainer takes four steps from the initial weights, and the
port replays the last three, each from the JAX trainer's state before it
(weights, BatchNorm statistics, Adam's count and moments) on the same
batch and draws; the first step's loss is held too. Its update is not:
from the initial weights, JAX's own step-0 gradient moves by up to
4.6 % of the largest element of the last deconvolution's kernel gradient
when its input clips move by 1e-6 (measured on the CPU in float32), so
two correct float32 runs that differ by rounding part there; from the
state after one step the same check holds to 1e-4 of that element.

A planted fault in the corner pools' gradient (dropped, or passed
straight through as if there were no pool) must fail the update check.
Routing a tie to its last element instead of its first is a fault this
check cannot see: after the branches' ReLU the pooled maps tie only at
0, where the ReLU passes no gradient whichever element takes it (the
op tests hold the routing itself, ``tests/test_torch_corner_ops.py``).
"""

import dataclasses
import json
import os

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
from scd_resnet_tpu_torch.ops import corner_pool as port_pool
from scd_resnet_tpu_torch.train import __main__ as train_cli
from scd_resnet_tpu_torch.train import registry
from scd_resnet_tpu_torch.train.factory import NetworkFactory, parse_metric_line

from test_torch_train import (
    _bn_stats,
    _check_update,
    _port_state,
    _sync,
    _tree,
)
from torch_port_common import QUARTER, jax_draws

ARCH = "cornerCPoolRes10q"
LR = 1e-3


def _register(patch) -> None:
    """The quarter-width cornerCPoolRes10 in both registries."""
    for reg in (jax_registry, registry):
        base = reg.get_model_profile("cornerCPoolRes10")
        patch.setitem(reg.MODEL_PROFILES, ARCH, dataclasses.replace(
            base, name=ARCH, model_params=dict(base.model_params,
                                               dims=QUARTER)))


def _settings(root, **extra):
    settings = {
        "datasetName": "scdx16p100", "modelName": ARCH, "trainName": "tiny",
        "batchSize": 4, "validationBatchSize": 4, "iterations": 4,
        "validation": 2, "snapshot": 2, "learningRate": LR,
        "learningRateDecay": [100], "learningRateDecayRate": [10],
        "bestSnapshotMetric": "boxAP50",
        "dirTemp": str(root / "temp") + "/",
        "dirResult": str(root / "results") + "/",
        "dirDataset": str(root) + "/",
    }
    settings.update(extra)
    return settings


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    """A tiny synthetic archive: 2 images x 2 reps x 5 clips of 64^2."""
    root = tmp_path_factory.mktemp("corner_train")
    path = str(root / "scdx16p100.d")
    make_archive(path, num_images=2, reps=2, clips_per_image=5, size=64)
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
def three_steps(archive, patch_registries):
    """Four float32 steps of the JAX trainer, with its state before and
    after each, and the losses of a port trainer synced to that state
    before each step, on the same batches and draws, with its state after
    the last three."""
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
            "root": root, "path": path}


def test_corner_three_steps_losses_match_jax(three_steps):
    want = [rec["loss"] for rec in three_steps["steps"]]
    got = three_steps["losses"]
    assert len(got) == 4 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert want[3] != want[1]  # the steps did train


@pytest.mark.parametrize("kind", ["parameters", "batch_norm_stats"])
def test_corner_three_steps_state_matches_jax(three_steps, kind):
    steps = three_steps["steps"]
    for step, (rec, got) in enumerate(zip(steps, three_steps["synced"])):
        if step == 0:  # the first step's update: see the module docstring
            continue
        if kind == "parameters":
            n_rounding, n_all = _check_update(got, rec["before"],
                                              rec["after"], LR)
            assert 0 < n_rounding <= 0.1 * n_all
        else:
            want_stats = _bn_stats(rec["after"]["model"])
            assert any("pool_block" in key for key in want_stats)
            for key, want in want_stats.items():
                np.testing.assert_allclose(
                    got["model"][key].numpy(), want.numpy(), rtol=1e-4,
                    atol=1e-6, err_msg="step {} {}".format(step, key))


def _dropped(x, g, dim, reverse):
    return torch.zeros_like(x)


def _straight_through(x, g, dim, reverse):
    return g


@pytest.mark.parametrize("fault", [_dropped, _straight_through],
                         ids=["dropped", "straight_through"])
def test_corner_update_check_catches_a_planted_pool_fault(
        three_steps, tmp_path, monkeypatch, fault):
    """The third step replayed with the pools' gradient dropped, or passed
    straight through, must fail the update check that the real backward
    passes."""
    rec = three_steps["steps"][2]
    port = _port_trainer(tmp_path, three_steps["path"])
    monkeypatch.setattr(port_pool, "corner_pool_bwd", fault)
    _sync(port, rec["before"])
    port.train(*rec["batch"], draws=rec["draws"])
    with pytest.raises(AssertionError):
        _check_update(_port_state(port), rec["before"], rec["after"], LR)


def test_corner_train_entry_point_on_cpu(archive, patch_registries,
                                         tmp_path):
    """The train entry point on a corner config: it trains, validates
    with a [boxAP50] line, snapshots, keeps the best and resumes."""
    _, path = archive
    os.symlink(path, tmp_path / "scdx16p100.d")
    config = tmp_path / "tiny.json"
    config.write_text(json.dumps(_settings(tmp_path)))
    summary = train_cli.main([str(config), "--device", "cpu"])
    assert summary["steps"] == 4 and summary["last_iteration"] == 4
    evals = (tmp_path / "results" / "evals.tiny.txt").read_text()
    it_lines = [line for line in evals.splitlines()
                if line.startswith("[It]")]
    assert len(it_lines) == 2
    for line in it_lines:
        for name in ("heatPeakAP50", "tlPeakAP75", "boxAP50"):
            assert parse_metric_line(line, name) is not None
    assert "[Best] [boxAP50]" in evals
    rows = np.loadtxt(tmp_path / "results" / "losses.tiny.4.txt",
                      delimiter=",")
    assert rows.shape == (2, 3) and np.isfinite(rows).all()
    assert (tmp_path / "temp" / "{}.tiny.best.pth".format(ARCH)).exists()
    config.write_text(json.dumps(_settings(tmp_path, iterations=6,
                                           currentIter=4)))
    summary = train_cli.main([str(config), "--device", "cpu"])
    assert summary["steps"] == 2 and summary["last_iteration"] == 6
    rows = np.loadtxt(tmp_path / "results" / "losses.tiny.6.txt",
                      delimiter=",")
    assert rows[0, 0] == 5  # the resumed run starts at iteration 5
