"""The training slice as a whole against the JAX package (CPU), and the
trainer's own contracts: the port's synthetic archive, dataset and
configuration against the JAX package's, three float32 train steps of
both ``NetworkFactory``s from the same converted weights, exact resume,
preemption, and the ``python -m scd_resnet_tpu_torch.train`` entry point.

The three float32 steps run on three port trainers, each fed JAX's
draws: "synced" is set to the JAX trainer's state (weights, BatchNorm
statistics, Adam's count and moments) before every step, "free" runs
from the same converted weights on its own, and "held" runs like "free"
but takes JAX's values for the rounding-level elements after each step.

An element's gradient is at rounding level when it is at most
``ROUNDING`` (1e-3) of the largest JAX gradient of its tensor, G: the
two frameworks' float32 gradients differ by a few 1e-4 G. Adam's first
update moves an element by about lr whatever its gradient's size, so
where such a gradient has the other sign on the other side the element
ends 2 lr apart; from there the free runs drift apart step by step. The
JAX gradient is read back from Adam's first moment, mu' = 0.9 mu + 0.1 g.
Tolerances, each with its reason:

- losses 1e-4 relative at every step, synced and held: float32
  convolutions and reductions sum in another order on each side;
- the update of every synced step against JAX's, from the same state:
  parameters within 1e-2 lr wherever the JAX gradient is above rounding
  level (at most a tenth of the elements are not), Adam's first moment
  within 1e-3 G and its second within 1e-5 G^2 everywhere, G per tensor;
  a planted fault in the optimizer (no step, the sign flipped, SGD, a
  wrong beta1) fails this check;
- parameters after three free-running steps within 2 * lr * 3 absolute:
  Adam moves an element by at most about lr a step;
- BatchNorm running statistics after each synced step, 1e-4 relative
  with an absolute floor of 1e-6 for running means that are themselves
  near 0.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from scd_resnet_tpu.core.config import Configuration as JaxConfiguration
from scd_resnet_tpu.data.dataset import SCDDataset as JaxDataset
from scd_resnet_tpu.data.synthetic import make_archive as jax_make_archive
from scd_resnet_tpu.parallel.mesh import create_mesh
from scd_resnet_tpu.train.factory import NetworkFactory as JaxFactory
from scd_resnet_tpu_torch.core.checkpoint import load_state_dict
from scd_resnet_tpu_torch.core.config import Configuration
from scd_resnet_tpu_torch.core.convert import state_dict_from_flax
from scd_resnet_tpu_torch.data.archive import read_archive
from scd_resnet_tpu_torch.data.dataset import SCDDataset
from scd_resnet_tpu_torch.data.synthetic import make_archive
from scd_resnet_tpu_torch.train import __main__ as train_cli
from scd_resnet_tpu_torch.train.factory import (
    NetworkFactory,
    make_optimizer,
    parse_metric_line,
)

from torch_port_common import jax_draws

ARCH = "centerOffsetRes10q"
LR = 1e-3
ROUNDING = 1e-3  # a gradient's rounding level, as a share of its tensor's largest
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _settings(root, **extra):
    settings = {
        "datasetName": "scdx16p100", "modelName": ARCH, "trainName": "tiny",
        "batchSize": 4, "validationBatchSize": 4, "iterations": 4,
        "validation": 2, "snapshot": 2, "learningRate": LR,
        "learningRateDecay": [2], "learningRateDecayRate": [10],
        "bestSnapshotMetric": "mIoU",
        "dirTemp": str(root / "temp") + "/",
        "dirResult": str(root / "results") + "/",
        "dirDataset": str(root) + "/",
    }
    settings.update(extra)
    return settings


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    """A tiny synthetic archive: 2 images x 2 reps x 5 clips of 64^2."""
    root = tmp_path_factory.mktemp("train")
    path = str(root / "scdx16p100.d")
    make_archive(path, num_images=2, reps=2, clips_per_image=5, size=64)
    return root, path


def _port_dataset(path, split=None, **kw):
    return SCDDataset(path, split, test_set=4, seed=42, device="cpu", **kw)


def test_synthetic_archive_matches_jax(archive, tmp_path):
    _, path = archive
    ref = str(tmp_path / "ref.d")
    jax_make_archive(ref, num_images=2, reps=2, clips_per_image=5, size=64)
    for got, want in zip(read_archive(path), read_archive(ref)):
        if isinstance(got, list):
            assert got == want
        else:
            np.testing.assert_array_equal(got, want)


def test_dataset_split_orders_and_validation_match_jax(archive, tmp_path):
    _, path = archive
    port = _port_dataset(path, split_profile_path=str(tmp_path / "p.json"))
    ref = JaxDataset(path, None, test_set=4, seed=42,
                     split_profile_path=str(tmp_path / "j.json"))
    assert port.data_profile == ref.data_profile
    assert json.load(open(tmp_path / "p.json")) == \
        json.load(open(tmp_path / "j.json"))
    assert port.order == ref.order and len(port) == 16
    for epoch, skip in ((0, 0), (3, 1)):
        got = list(port.epoch_local_indices(4, epoch, skip))
        want = list(ref.epoch_local_indices(4, 1, [np.arange(16)], epoch,
                                            skip))
        assert [g.tolist() for g in got] == [w.tolist() for w in want]
        for g, w in zip(port.epoch_batches(4, epoch, skip),
                        ref.epoch_batches(4, epoch=epoch, skip=skip)):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
    # the validation pre-render, batch for batch (heat as in
    # test_torch_train_ops: 1e-6 absolute; xs 1e-5)
    got = port.get_validation_set(4)
    want = ref.get_validation_set(4)
    assert len(got) == len(want) == 1
    gx, gy = got[0]["xs"][0], got[0]["ys"]
    wx, wy = want[0]["xs"][0], want[0]["ys"]
    np.testing.assert_allclose(gx.permute(0, 2, 3, 1).numpy(), wx, atol=1e-5)
    np.testing.assert_allclose(gy[0].permute(0, 2, 3, 1).numpy(), wy[0],
                               atol=1e-6)
    for i in (1, 2, 3, 4, 5):
        np.testing.assert_array_equal(gy[i].numpy(), wy[i])
    # a split profile on disk gives the same split back
    again = _port_dataset(path, json.load(open(tmp_path / "p.json")))
    assert again.order == port.order


def test_configuration_matches_jax():
    for name in ("exp74.json", "exp.json", "hourglass2_best.json"):
        path = os.path.join(REPO, "configs", name)
        assert Configuration.from_json(path).config == \
            JaxConfiguration.from_json(path).config
    cfg = Configuration.from_json(os.path.join(REPO, "configs", "exp74.json"))
    assert cfg.modelName == "centerOffsetRes10" and cfg.batchSize == 32
    assert cfg.config["precision"] == "bfloat16"
    assert cfg.dirDatafile == "./workspace/data/scdx16p100.d"


def _tree(value):
    return jax.tree_util.tree_map(np.asarray, value)


def _snapshot(jfac):
    """The JAX trainer's state in the port's names: the model's state dict
    (parameters and BatchNorm statistics) and Adam's count and moments."""
    stats = _tree(jfac.batch_stats)
    adam = jfac.opt_state[0]
    return {"model": state_dict_from_flax(ARCH, _tree(jfac.params), stats),
            "count": int(adam.count),
            "mu": state_dict_from_flax(ARCH, _tree(adam.mu), stats),
            "nu": state_dict_from_flax(ARCH, _tree(adam.nu), stats)}


def _sync(port, state):
    """Set a port trainer to a JAX trainer's ``_snapshot``."""
    port.model.load_state_dict(state["model"])
    port.optimizer.state.clear()
    if state["count"]:
        for name, param in port.model.named_parameters():
            port.optimizer.state[param] = {
                "step": torch.tensor(float(state["count"])),
                "exp_avg": state["mu"][name].clone(),
                "exp_avg_sq": state["nu"][name].clone()}
    port.updates = state["count"]


def _port_state(port):
    """A port trainer's model state dict and Adam moments, copied."""
    out = {"model": {k: v.clone() for k, v in port.model.state_dict().items()},
           "exp_avg": {}, "exp_avg_sq": {}}
    for name, param in port.model.named_parameters():
        for key in ("exp_avg", "exp_avg_sq"):
            if key in port.optimizer.state[param]:
                out[key][name] = port.optimizer.state[param][key].clone()
    return out


def _rounding_level(before, after, name):
    """The JAX step's gradient of parameter ``name``, read back from Adam's
    first moment (mu' = 0.9 mu + 0.1 g): the mask of its elements at
    rounding level, and the tensor's largest gradient G."""
    grad = (after["mu"][name] - 0.9 * before["mu"][name]) / 0.1
    scale = grad.abs().max().item()
    return grad.abs() <= ROUNDING * scale, scale


def _check_update(got, before, after, lr):
    """A port step's result ``got`` (``_port_state``), started from the JAX
    state ``before``, against the JAX state ``after`` of the same step, as
    the module docstring says; returns (rounding-level elements, all)."""
    names = [k for k in after["mu"] if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))]
    assert names
    n_rounding = n_all = 0
    for name in names:
        rounding, _ = _rounding_level(before, after, name)
        n_rounding += int(rounding.sum())
        n_all += rounding.numel()
        np.testing.assert_allclose(
            got["model"][name][~rounding].numpy(),
            after["model"][name][~rounding].numpy(), rtol=0, atol=1e-2 * lr,
            err_msg="parameter " + name)
    for name in names:
        _, scale = _rounding_level(before, after, name)
        for key, ref, tol in (("exp_avg", "mu", 1e-3 * scale),
                              ("exp_avg_sq", "nu", 1e-5 * scale ** 2)):
            assert name in got[key], "no {} for {}".format(key, name)
            np.testing.assert_allclose(
                got[key][name].numpy(), after[ref][name].numpy(), rtol=0,
                atol=tol, err_msg="{} {}".format(key, name))
    return n_rounding, n_all


def _hold_rounding_level(port, before, after):
    """Give a port trainer's rounding-level elements (parameters and Adam
    moments) the JAX trainer's values after the step."""
    with torch.no_grad():
        for name, param in port.model.named_parameters():
            rounding, _ = _rounding_level(before, after, name)
            param[rounding] = after["model"][name][rounding]
            state = port.optimizer.state[param]
            state["exp_avg"][rounding] = after["mu"][name][rounding]
            state["exp_avg_sq"][rounding] = after["nu"][name][rounding]


def _bn_stats(state):
    return {k: v.clone() for k, v in state.items()
            if k.endswith(("running_mean", "running_var"))}


def _port_trainer(root, path):
    cfg = Configuration()
    cfg.update_config(_settings(root, learningRateDecay=[100]))
    return NetworkFactory(cfg, dataset=_port_dataset(path), device="cpu")


@pytest.fixture(scope="module")
def three_steps(archive):
    """Three float32 steps of the JAX trainer, with its state before and
    after each, and of the three port trainers of the module docstring on
    the same batches and draws."""
    root, path = archive
    jcfg = JaxConfiguration()
    jcfg.update_config(_settings(root / "jax", learningRateDecay=[100]))
    jds = JaxDataset(path, None, test_set=4, seed=42)
    jfac = JaxFactory(jcfg, dataset=jds, mesh=create_mesh(jax.devices()[:1]))
    steps = []
    for step, batch in enumerate(list(jds.epoch_batches(4, epoch=0))[:3]):
        key = jax.random.fold_in(jax.random.PRNGKey(43), step)
        before = _snapshot(jfac)
        loss, _ = jfac.train(*batch)
        steps.append({"batch": batch, "before": before,
                      "after": _snapshot(jfac), "loss": float(loss),
                      "draws": jax_draws(key, 4, batch[0].shape[1])})

    ports = {kind: _port_trainer(root / kind, path)
             for kind in ("synced", "free", "held")}
    _sync(ports["free"], steps[0]["before"])
    _sync(ports["held"], steps[0]["before"])
    losses = {kind: [] for kind in ports}
    synced = []
    for rec in steps:
        _sync(ports["synced"], rec["before"])
        for kind, port in ports.items():
            loss, _ = port.train(*rec["batch"], draws=rec["draws"])
            losses[kind].append(loss.item())
        synced.append(_port_state(ports["synced"]))
        _hold_rounding_level(ports["held"], rec["before"], rec["after"])
    return {"steps": steps, "losses": losses, "synced": synced,
            "free": _port_state(ports["free"]), "path": path}


def test_three_steps_losses_match_jax(three_steps):
    want = [rec["loss"] for rec in three_steps["steps"]]
    for kind in ("synced", "held"):
        got = three_steps["losses"][kind]
        assert np.isfinite(got).all()
        for step in range(3):
            np.testing.assert_allclose(got[step], want[step], rtol=1e-4,
                                       err_msg="{} step {}".format(kind, step))
    assert want[2] != want[0]  # the steps did train


@pytest.mark.parametrize("kind", ["parameters", "batch_norm_stats",
                                  "free_parameters"])
def test_three_steps_state_matches_jax(three_steps, kind):
    steps = three_steps["steps"]
    if kind == "parameters":
        for rec, got in zip(steps, three_steps["synced"]):
            n_rounding, n_all = _check_update(got, rec["before"],
                                              rec["after"], LR)
            assert 0 < n_rounding <= 0.1 * n_all
    elif kind == "batch_norm_stats":
        for step, (rec, got) in enumerate(zip(steps, three_steps["synced"])):
            want_stats = _bn_stats(rec["after"]["model"])
            assert want_stats
            for key, want in want_stats.items():
                np.testing.assert_allclose(
                    got["model"][key].numpy(), want.numpy(), rtol=1e-4,
                    atol=1e-6, err_msg="step {} {}".format(step, key))
    else:
        ref = steps[-1]["after"]["model"]
        got = three_steps["free"]["model"]
        keys = [k for k in ref if k not in _bn_stats(ref)
                and not k.endswith("num_batches_tracked")]
        assert keys
        for key in keys:
            np.testing.assert_allclose(got[key].numpy(), ref[key].numpy(),
                                       rtol=0, atol=2 * LR * 3, err_msg=key)


def _no_step(port):
    port.optimizer.step = lambda *args, **kwargs: None


def _sign_flipped(port):
    port.schedule = lambda count: -LR


def _sgd(port):
    port.optimizer = make_optimizer("sgd", port.model.parameters(), LR)


def _beta1(port):
    port.optimizer = torch.optim.Adam(port.model.parameters(), lr=LR,
                                      betas=(0.8, 0.999), eps=1e-8)


@pytest.mark.parametrize("fault", [_no_step, _sign_flipped, _sgd, _beta1],
                         ids=["no_step", "sign_flipped", "sgd", "beta1"])
def test_update_check_catches_a_planted_fault(three_steps, tmp_path, fault):
    """The second step (Adam's count 1: moments and bias correction both
    matter) replayed by a port trainer with a broken optimizer must fail
    the update check that the real one passes."""
    rec = three_steps["steps"][1]
    port = _port_trainer(tmp_path, three_steps["path"])
    fault(port)
    _sync(port, rec["before"])
    port.train(*rec["batch"], draws=rec["draws"])
    with pytest.raises(AssertionError):
        _check_update(_port_state(port), rec["before"], rec["after"], LR)


def _run(root, path, dataset=None, **extra):
    cfg = Configuration()
    cfg.update_config(_settings(root, **extra))
    factory = NetworkFactory(cfg, dataset=dataset or _port_dataset(path),
                             device="cpu")
    return factory, factory.begin_training()


def test_exact_resume(archive, tmp_path):
    """4 steps equal 2 steps + checkpoint + resume + 2 steps, bit for bit:
    weights, BatchNorm statistics, Adam moments and the loss rows."""
    _, path = archive
    straight, summary = _run(tmp_path / "a", path, iterations=4, snapshot=4)
    assert summary["steps"] == 4 and straight.resident
    _run(tmp_path / "b", path, iterations=2, snapshot=4)
    resumed, summary = _run(tmp_path / "b", path, iterations=4, snapshot=4,
                            currentIter=2)
    assert summary["steps"] == 2 and summary["last_iteration"] == 4
    want, got = straight.model.state_dict(), resumed.model.state_dict()
    for key in want:
        assert torch.equal(want[key], got[key]), key
    for a, b in zip(straight.optimizer.state.values(),
                    resumed.optimizer.state.values()):
        assert torch.equal(a["exp_avg"], b["exp_avg"])
        assert torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])
    rows = np.loadtxt(tmp_path / "a" / "results" / "losses.tiny.4.txt",
                      delimiter=",")
    first = np.loadtxt(tmp_path / "b" / "results" / "losses.tiny.2.txt",
                       delimiter=",")
    second = np.loadtxt(tmp_path / "b" / "results" / "losses.tiny.4.txt",
                        delimiter=",")
    np.testing.assert_array_equal(rows, np.concatenate([first, second]))
    assert second[0, 0] == 3  # the resumed run starts at iteration 3


def test_host_streaming_trains_the_same_schedule(archive, tmp_path):
    """``residency: host`` streams batches from the host in the epoch
    order the resident path indexes; both train, on their own orders."""
    _, path = archive
    factory, summary = _run(tmp_path, path, iterations=2, residency="host")
    assert not factory.resident and summary["steps"] == 2
    rows = np.loadtxt(tmp_path / "results" / "losses.tiny.2.txt",
                      delimiter=",")
    assert rows.shape == (2, 5) and np.isfinite(rows).all()


def test_preemption_checkpoints_and_stops(archive, tmp_path):
    _, path = archive
    cfg = Configuration()
    cfg.update_config(_settings(tmp_path, iterations=6, snapshot=6))
    factory = NetworkFactory(cfg, dataset=_port_dataset(path), device="cpu")
    train = factory.train_resident

    def train_then_stop(*args, **kwargs):
        factory.request_stop()
        return train(*args, **kwargs)

    factory.train_resident = train_then_stop
    summary = factory.begin_training()
    assert factory.preempted and summary["steps"] == 1
    ckpt = tmp_path / "temp" / "{}.tiny.1.pth".format(ARCH)
    assert ckpt.exists()
    evals = (tmp_path / "results" / "evals.tiny.txt").read_text()
    assert "resume with currentIter=1" in evals
    # a training checkpoint serves as it is
    assert set(load_state_dict(str(ckpt), ARCH)) == \
        set(factory.model.state_dict())


def test_train_entry_point_on_cpu(archive, tmp_path, monkeypatch):
    root, path = archive
    config = tmp_path / "tiny.json"
    os.symlink(path, tmp_path / "scdx16p100.d")
    config.write_text(json.dumps(_settings(tmp_path)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main([str(config)])
    # the caller's cuDNN settings survive a float32 run, which changes them
    cudnn = torch.backends.cudnn
    monkeypatch.setattr(cudnn, "deterministic", False)
    monkeypatch.setattr(cudnn, "benchmark", True)
    monkeypatch.setattr(cudnn, "allow_tf32", True)
    summary = train_cli.main([str(config), "--device", "cpu"])
    assert (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32) == \
        (False, True, True)
    assert summary["steps"] == 4 and summary["last_iteration"] == 4
    evals = (tmp_path / "results" / "evals.tiny.txt").read_text()
    it_lines = [line for line in evals.splitlines()
                if line.startswith("[It]")]
    assert len(it_lines) == 2
    for line in it_lines:
        assert parse_metric_line(line, "mIoU") is not None
        assert parse_metric_line(line, "avgS") is not None
    assert "[Best] [mIoU]" in evals
    for name in ("losses.tiny.2.txt", "losses.tiny.4.txt",
                 "telemetry.tiny.jsonl"):
        assert (tmp_path / "results" / name).exists()
    assert (tmp_path / "temp" / "{}.tiny.best.pth".format(ARCH)).exists()
    assert json.load(open(tmp_path / "scdx16p100.split.json"))["validation"]


def test_telemetry_rate_is_since_the_previous_row(tmp_path, monkeypatch):
    """Each telemetry row's ``ips`` is the steps a second since the row
    before it (the first row's since the telemetry began, at the run's
    first step), not a running mean from the start: a slow start (warm-up,
    autotuning) stays in the first row."""
    from types import SimpleNamespace

    from scd_resnet_tpu_torch.core import logging as port_logging

    # the clock at the start and at each written row: 10 s for the first
    # two steps, then 1 s and 2 s for two more each
    clock = iter([100.0, 110.0, 111.0, 113.0])
    monkeypatch.setattr(port_logging, "time",
                        SimpleNamespace(perf_counter=lambda: next(clock)))
    path = tmp_path / "telemetry.jsonl"
    telemetry = port_logging.StepTelemetry(str(path), every=2, first_step=10)
    for step in range(11, 17):
        telemetry.record(step, {"loss": 1.0})
    telemetry.close()
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["step"] for r in rows] == [12, 14, 16]
    assert [r["ips"] for r in rows] == [0.2, 2.0, 1.0]
    assert [r["t"] for r in rows] == [10.0, 11.0, 13.0]
    assert all(r["loss"] == 1.0 for r in rows)
