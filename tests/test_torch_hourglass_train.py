"""Stacked-hourglass training against the JAX trainer (CPU): float32
train steps of a small ``centerOffsetHourglass2`` with remat off and on
through both ``NetworkFactory``s from the same converted weights; the
same steps' gradients in float64 in both frameworks; and a planted fault
in the remat recompute that the checks must catch. The module also holds
what ``tests/test_torch_legacy_train.py`` runs the same way for a small
``cornerLegacyHourglass`` with remat (two files, so that a parallel run
takes them on two workers).

The small profiles (2 iterations, widths 16/24/32, one module a level,
prediction width 32, ``tests/torch_port_common.HOURGLASS_SMALL``) are
registered in both registries for the module's run only; the JAX
hourglass detector fixes its geometry, so the JAX side wraps its
``StackHourglass`` at that geometry (``SmallCenterNetHourglass``).
``remat`` comes from the configuration, as in a real run. The JAX trainer
takes three steps from the initial weights, and a port trainer replays
each from the JAX trainer's state before it (weights, BatchNorm
statistics, Adam's count and moments) on the same batch and draws. Both
hourglass cases, remat off and on, replay one JAX run without remat:
remat changes no value the JAX trainer computes, and the port's remat
against no remat is held to the bit in ``tests/test_torch_hourglass.py``.

Checks and tolerances, with ``tests/test_torch_train.py``'s helpers (its
module docstring gives each reason):

- the loss of every step within 1e-4 relative, and the BatchNorm running
  statistics after every step within 1e-4 relative (absolute floor
  1e-6), each BatchNorm moved once;
- every step's gradient in float64, the port's against the JAX model's
  (``compute_dtype="float64"`` under ``jax.enable_x64``) on the same
  inputs and targets, from the same state: within 1e-5 of each tensor's
  largest element, G. The losses keep their float32 casts on both sides,
  so this is the float32 loss's rounding carried through an exact
  backward;
- the update check (parameters within 1e-2 lr wherever JAX's gradient is
  above rounding level, Adam's moments within 1e-3 G and 1e-5 G^2) at
  every step whose two float32 gradients both lie within 1e-4 G of the
  float64 one. At these sizes a float32 step is often not smooth: a
  pre-activation within rounding of 0 takes the other side of a ReLU, or
  two inputs of a corner pool within rounding of each other swap which
  is the running maximum, in one framework and not in the other, and the
  two float32 gradients then part by up to a few 1e-2 G while the
  float64 ones agree. On this archive the check sees the third step of
  each hourglass case; the legacy model's float32 JAX gradient is off
  its float64 one in every step, so its optimizer arithmetic is held by
  the hourglass cases, its gradient by the float64 check.

A BatchNorm update applied a second time in the recompute of the
backward (the fault remat invites: the port's BatchNorm updates its
statistics inside ``forward``) must fail the statistics check.
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
from scd_resnet_tpu_torch.models import layers
from scd_resnet_tpu_torch.train import registry
from scd_resnet_tpu_torch.train.factory import NetworkFactory

from test_torch_train import _bn_stats, _check_update, _port_state, _sync, _tree
from torch_port_common import HOURGLASS_SMALL, SmallCenterNetHourglass, jax_draws

LR = 1e-3
STEPS = 3
# case -> (small profile name, its full-size base, the port's remat, the
# JAX trainer's remat). The JAX trainer's remat changes no value it
# computes, so the two hourglass cases share one JAX run without it.
CASES = {
    "hourglass2": ("centerOffsetHourglass2s", "centerOffsetHourglass2", False,
                   False),
    "hourglass2_remat": ("centerOffsetHourglass2s", "centerOffsetHourglass2",
                         True, False),
    "legacy_remat": ("cornerLegacyHourglasss", "cornerLegacyHourglass", True,
                     True),
}


def _register(patch) -> None:
    """The small profiles in both registries."""
    for name, base, _, _ in CASES.values():
        small = dict(HOURGLASS_SMALL)
        if base.startswith("cornerLegacy"):
            jax_profile = dataclasses.replace(
                jax_registry.get_model_profile(base), name=name,
                model_params={"categories": 1, "stacks": 2, **small})
        else:
            jax_profile = dataclasses.replace(
                jax_registry.get_model_profile(base), name=name,
                model_cls=SmallCenterNetHourglass,
                model_params={"stacks": 2})
        port_base = registry.get_model_profile(base)
        patch.setitem(jax_registry.MODEL_PROFILES, name, jax_profile)
        patch.setitem(registry.MODEL_PROFILES, name, dataclasses.replace(
            port_base, name=name,
            model_params=dict(port_base.model_params, **small)))


def _settings(root, arch, remat):
    return {
        "datasetName": "scdx16p100", "modelName": arch, "trainName": "tiny",
        "batchSize": 4, "validationBatchSize": 4, "iterations": 4,
        "validation": 2, "snapshot": 2, "learningRate": LR,
        "learningRateDecay": [100], "learningRateDecayRate": [10],
        "remat": remat,
        "dirTemp": str(root / "temp") + "/",
        "dirResult": str(root / "results") + "/",
        "dirDataset": str(root) + "/",
    }


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    """A tiny synthetic archive: 2 images x 2 reps x 5 clips of 64^2."""
    root = tmp_path_factory.mktemp("hourglass_train")
    path = str(root / "scdx16p100.d")
    make_archive(path, num_images=2, reps=2, clips_per_image=5, size=64)
    return root, path


@pytest.fixture(scope="module")
def patch_registries():
    with pytest.MonkeyPatch.context() as patch:
        _register(patch)
        yield


def _snapshot(jfac, arch):
    """The JAX trainer's state in the port's names."""
    stats = _tree(jfac.batch_stats)
    adam = jfac.opt_state[0]
    return {"model": state_dict_from_flax(arch, _tree(jfac.params), stats),
            "count": int(adam.count),
            "mu": state_dict_from_flax(arch, _tree(adam.mu), stats),
            "nu": state_dict_from_flax(arch, _tree(adam.nu), stats)}


def _port_trainer(root, path, arch, remat):
    cfg = Configuration()
    cfg.update_config(_settings(root, arch, remat))
    return NetworkFactory(cfg, dataset=SCDDataset(
        path, None, test_set=4, seed=42, device="cpu"), device="cpu")


def _check_bn(got, after, step):
    """The port's running statistics after a step against JAX's."""
    want_stats = _bn_stats(after["model"])
    assert want_stats
    for key, want in want_stats.items():
        np.testing.assert_allclose(
            got["model"][key].numpy(), want.numpy(), rtol=1e-4, atol=1e-6,
            err_msg="step {} {}".format(step, key))


def _gradient(after_mu, before_mu):
    """A step's gradient read back from Adam's first moment."""
    return {k: (after_mu[k] - 0.9 * before_mu[k]) / 0.1 for k in after_mu}


def _jax_layout(ys):
    """The port's targets in the JAX trainer's layout."""
    return [y.permute(0, 2, 3, 1).numpy() if y.dim() == 4
            else y.numpy().astype(np.int32) if y.dtype == torch.int64
            else y.numpy() for y in ys]


def _jax_grad64(arch, remat):
    """A jitted float64 gradient of the JAX model's loss, for arguments
    (params, batch_stats, xs NHWC, ys), to call under
    ``jax.enable_x64``."""
    from scd_resnet_tpu.models.center_net_offset import as_stack_list

    profile = jax_registry.get_model_profile(arch)
    model = profile.model_cls(**profile.model_params,
                              compute_dtype="float64", remat=remat)

    def grad(params, stats, xs, ys):
        def objective(p):
            outs, _ = model.apply({"params": p, "batch_stats": stats}, xs,
                                  train=True, mutable=["batch_stats"])
            return profile.loss(as_stack_list(outs), ys)[0]
        return jax.grad(objective)(params)

    return jax.jit(grad)


def _port_grad64(arch, remat, state, xs, ys):
    """The port model's float64 gradient of its loss from ``state``."""
    from scd_resnet_tpu_torch.models.center_net_offset import as_stack_list

    profile = registry.get_model_profile(arch)
    model = profile.build(remat=remat)
    model.load_state_dict(state["model"])
    model.double().train()
    loss, _ = profile.loss(as_stack_list(model(xs.double())), ys)
    loss.backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()}


def _relative(got, want):
    """Per tensor, the largest difference over the largest element."""
    return {k: ((got[k].double() - want[k].double()).abs().max()
                / want[k].double().abs().max()).item() for k in want}


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX trainer's runs, by (profile, remat), shared by the cases."""
    return {}


def _jax_run(runs, arch, remat, path, work):
    """``STEPS`` float32 steps of the JAX trainer with its state before and
    after each, and its jitted float64 gradient (``_jax_grad64``)."""
    if (arch, remat) in runs:
        return runs[(arch, remat)]
    jcfg = JaxConfiguration()
    jcfg.update_config(_settings(work, arch, remat))
    jds = JaxDataset(path, None, test_set=4, seed=42)
    jfac = JaxFactory(jcfg, dataset=jds, mesh=create_mesh(jax.devices()[:1]))
    steps = []
    for step, batch in enumerate(list(jds.epoch_batches(4, epoch=0))[:STEPS]):
        key = jax.random.fold_in(jax.random.PRNGKey(43), step)
        before = _snapshot(jfac, arch)
        trees = (_tree(jfac.params), _tree(jfac.batch_stats))
        loss, _ = jfac.train(*batch)
        steps.append({"batch": batch, "before": before, "trees": trees,
                      "after": _snapshot(jfac, arch), "loss": float(loss),
                      "draws": jax_draws(key, 4, batch[0].shape[1])})
    runs[(arch, remat)] = {"steps": steps, "grad64": _jax_grad64(arch, remat),
                           "grads64": {}}
    return runs[(arch, remat)]


def replay_steps(case, archive, jax_runs, tmp_path_factory):
    """The JAX trainer's steps for ``case``; the losses and states of a
    port trainer synced to its state before each step, on the same
    batches and draws; and each step's float64 gradients in both
    frameworks on the port's inputs and targets, with the float32 ones
    read back from Adam's moments."""
    arch, _, remat, jax_remat = CASES[case]
    root, path = archive
    work = tmp_path_factory.mktemp(case)
    run = _jax_run(jax_runs, arch, jax_remat, path, work / "jax")
    port = _port_trainer(work / "port", path, arch, remat)
    assert getattr(port.model, "remat") is remat and not port.remat_forward
    steps, losses, synced = [], [], []
    for step, shared in enumerate(run["steps"]):
        rec = dict(shared)
        _sync(port, rec["before"])
        loss, _ = port.train(*rec["batch"], draws=rec["draws"])
        losses.append(loss.item())
        synced.append(_port_state(port))
        xs, ys = port._last_batch
        rec["port_grad64"] = _port_grad64(arch, remat, rec["before"], xs, ys)
        if step not in run["grads64"]:
            with jax.enable_x64(True):
                params, stats = jax.tree_util.tree_map(
                    lambda a: np.asarray(a, np.float64), rec["trees"])
                grads = run["grad64"](
                    params, stats, xs.permute(0, 2, 3, 1).double().numpy(),
                    _jax_layout(ys))
                grads = jax.tree_util.tree_map(np.asarray, grads)
            run["grads64"][step] = state_dict_from_flax(arch, grads, stats)
        rec["jax_grad64"] = run["grads64"][step]
        rec["jax_grad32"] = _gradient(rec["after"]["mu"],
                                      rec["before"]["mu"])
        rec["port_grad32"] = _gradient(synced[-1]["exp_avg"],
                                       rec["before"]["mu"])
        steps.append(rec)
    return {"case": case, "arch": arch, "remat": remat, "steps": steps,
            "losses": losses, "synced": synced, "work": work, "path": path}


def check_losses(replayed) -> None:
    want = [rec["loss"] for rec in replayed["steps"]]
    got = replayed["losses"]
    assert len(got) == STEPS and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert want[2] != want[0]  # the steps did train


def check_batch_norm_stats(replayed) -> None:
    for step, (rec, got) in enumerate(zip(replayed["steps"],
                                          replayed["synced"])):
        _check_bn(got, rec["after"], step)
        # synced from a state dict with 0: each BatchNorm moved once
        assert all(int(v) == 1 for k, v in got["model"].items()
                   if k.endswith("num_batches_tracked"))


def check_float64_gradients(replayed) -> None:
    for step, rec in enumerate(replayed["steps"]):
        want = rec["jax_grad64"]
        got = rec["port_grad64"]
        assert set(got) == set(k for k in want if not k.endswith(
            ("running_mean", "running_var", "num_batches_tracked")))
        worst = max(_relative(got, {k: want[k] for k in got}).items(),
                    key=lambda kv: kv[1])
        assert worst[1] <= 1e-5, "step {}: {}".format(step, worst)


def check_update(replayed) -> int:
    """The update check at each step whose float32 gradients are smooth
    (module docstring); returns how many steps it saw."""
    seen = 0
    for rec, got in zip(replayed["steps"], replayed["synced"]):
        exact = {k: v for k, v in rec["jax_grad64"].items()
                 if k in rec["port_grad64"]}
        smooth = all(max(_relative({k: g[k] for k in exact}, exact)
                         .values()) <= 1e-4
                     for g in (rec["jax_grad32"], rec["port_grad32"]))
        if smooth:
            n_rounding, n_all = _check_update(got, rec["before"],
                                              rec["after"], LR)
            assert 0 < n_rounding <= 0.1 * n_all
            seen += 1
    return seen


def check_planted_recompute_fault(replayed, tmp_path, monkeypatch) -> None:
    """The third step replayed with the recompute's BatchNorm update let
    through (a second momentum step on each checkpointed BatchNorm) must
    fail the statistics check that the real step passes."""
    rec = replayed["steps"][2]
    port = _port_trainer(tmp_path, replayed["path"], replayed["arch"], True)
    monkeypatch.setattr(layers, "recomputing", lambda: _NoFlag())
    _sync(port, rec["before"])
    port.train(*rec["batch"], draws=rec["draws"])
    got = _port_state(port)
    assert any(int(v) == 2 for k, v in got["model"].items()
               if k.endswith("num_batches_tracked"))
    with pytest.raises(AssertionError):
        _check_bn(got, rec["after"], 2)


class _NoFlag:
    """A recompute context that sets nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.fixture(scope="module", params=["hourglass2", "hourglass2_remat"])
def three_steps(request, archive, patch_registries, jax_runs,
                tmp_path_factory):
    return replay_steps(request.param, archive, jax_runs, tmp_path_factory)


def test_hourglass_steps_losses_match_jax(three_steps):
    check_losses(three_steps)


def test_hourglass_steps_batch_norm_stats_match_jax(three_steps):
    check_batch_norm_stats(three_steps)


def test_hourglass_float64_gradients_match_jax(three_steps):
    check_float64_gradients(three_steps)


def test_hourglass_steps_update_matches_jax(three_steps):
    """The update check must see a step of each hourglass case."""
    assert check_update(three_steps) >= 1


@pytest.mark.parametrize("three_steps", ["hourglass2_remat"], indirect=True)
def test_bn_check_catches_an_update_repeated_in_the_recompute(
        three_steps, tmp_path, monkeypatch):
    check_planted_recompute_fault(three_steps, tmp_path, monkeypatch)
