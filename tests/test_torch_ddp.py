"""Data parallelism and the ``model`` axis of the port's trainer on gloo
ranks (CPU), against the single-process trainer and the JAX trainer.

One launch of two rank processes (``torch_dist_worker.run_ranks``, the
environment ``torchrun`` sets) runs every multi-rank job of the module:

- ``dp``: ``meshShape [2]``, three float32 steps of ``centerOffsetRes10q``
  on global host batches of 4 (2 clips a rank) with the global batch's
  draws, from the JAX trainer's converted initial weights, the first
  under a CPU profiler (the collectives' spans in rank 0's trace);
- ``resident``: the same on the resident rows, each step's global index
  vector from ``epoch_local_indices(4, 2 shards)`` and JAX's draws, held
  against the JAX trainer on a ``data`` mesh of two virtual devices with
  ``residency: device``;
- ``positives``: one step on a batch whose second rank holds no object,
  then one on a batch with no object at all (the focal loss's
  negative-only branch reads the global count);
- ``tp``: ``meshShape [1, 2]`` (data x model), the ``dp`` steps, and a
  checkpoint written in the plain layout;
- ``writes``: ``begin_training`` with a directory a rank, to show that
  rank 1 writes nothing;
- ``stop``: rank 1 asks to stop before the first step; both ranks stop
  after it, at the same boundary, and rank 0 saves the state;
- ``reuse``: a second trainer of ``meshShape [2]`` in the same process
  takes the process groups the first one's mesh made, and makes none.

Tolerances, each with its reason:

- two data ranks against one process, float32: losses 1e-5 relative and
  every gradient within 1e-4 of its tensor's largest, since BatchNorm's
  moments are combined from two halves (Chan's formula) and the weight
  gradients summed over ranks, other summation orders of the same terms;
- against JAX: the first step's loss 1e-4 relative (the two frameworks'
  float32 convolutions, as ``test_torch_train.py``), the later steps'
  2e-3 (the runs drift apart, as ``test_torch_train.py``'s free runs);
  the first step's gradients, JAX's read back from Adam's first moment,
  within ``JAX_GRAD_TOL`` (1e-4) of each tensor's largest G, the bound
  of the one-process comparison above (the two frameworks' float32
  gradients differ here by at most about 4e-6 G on the CPU; a rank's
  half-batch gradient, unsummed, is off by about half of G); and the
  parameters after the first update within 1e-2 lr of JAX's wherever
  JAX's gradient is above ``ROUNDING`` (1e-3) G, at most a tenth of the
  elements not: Adam's first update moves an element by about lr
  whatever its gradient's size, so a rounding-level gradient of the
  other sign puts it 2 lr away (``test_torch_train.py``'s synced check);
- data x model against data parallelism: losses within 2e-3 relative,
  the JAX package's contract for the same comparison
  (``tests/test_mesh_config.py``), and gradients within 1e-4 of each
  tensor's largest (column-parallel layers sum the input's gradient over
  the model ranks in another order).
"""

import os
import socket
from datetime import timedelta

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from scd_resnet_tpu.core.config import Configuration as JaxConfiguration
from scd_resnet_tpu.data.dataset import SCDDataset as JaxDataset
from scd_resnet_tpu.parallel.mesh import create_mesh as jax_create_mesh
from scd_resnet_tpu.train.factory import NetworkFactory as JaxFactory
from scd_resnet_tpu_torch.core.checkpoint import load_training_checkpoint
from scd_resnet_tpu_torch.core.config import Configuration
from scd_resnet_tpu_torch.core.convert import state_dict_from_flax
from scd_resnet_tpu_torch.data.dataset import SCDDataset
from scd_resnet_tpu_torch.data.pipeline import Draws, draw
from scd_resnet_tpu_torch.data.synthetic import make_archive
from scd_resnet_tpu_torch.models.layers import BatchNorm
from scd_resnet_tpu_torch.train.factory import NetworkFactory
from scd_resnet_tpu_torch.train.registry import get_model_profile

from torch_dist_worker import run_ranks
from torch_port_common import jax_draws

ARCH = "centerOffsetRes10q"
LR = 1e-3
STEPS = 3
JAX_GRAD_TOL = 1e-4  # the first step's gradients against JAX's, of G
ROUNDING = 1e-3  # a gradient's rounding level, as a share of G


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module: the shapes are small, and the
    suite runs six workers on the machine's cores, where each torch
    process's default of a thread a core oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _settings(root, **extra):
    settings = {
        "datasetName": "scdx16p100", "modelName": ARCH, "trainName": "ddp",
        "batchSize": 4, "validationBatchSize": 4, "iterations": 2,
        "validation": 2, "snapshot": 2, "learningRate": LR,
        "learningRateDecay": [100], "learningRateDecayRate": [10],
        "residency": "host", "bestSnapshotMetric": "mIoU",
        "dirTemp": str(root / "temp") + "/",
        "dirResult": str(root / "results") + "/",
        "dirDataset": str(root) + "/",
    }
    settings.update(extra)
    return settings


def _port_dataset(path):
    return SCDDataset(path, None, test_set=4, seed=42, device="cpu")


def _host_steps(path):
    """Three global host batches of 4 and seeded draws for each."""
    batches = list(_port_dataset(path).epoch_batches(4, 0))[:STEPS]
    gen = torch.Generator().manual_seed(7)
    return [{"batch": b, "draws": draw(gen, 4, 64, torch.device("cpu"))}
            for b in batches]


def _positive_steps(path):
    """A batch whose rows 2-3 (rank 1's) hold no object, then one whose
    rows hold none at all."""
    samples, locs, counts = next(_port_dataset(path).epoch_batches(4, 1))
    assert counts[:2].sum() > 0
    half = counts.copy()
    half[2:] = 0
    gen = torch.Generator().manual_seed(8)
    return [{"batch": (samples, locs, half),
             "draws": draw(gen, 4, 64, torch.device("cpu"))},
            {"batch": (samples, locs, np.zeros_like(counts)),
             "draws": draw(gen, 4, 64, torch.device("cpu"))}]


def _single(root, path, state, steps, **extra):
    """The single-process trainer on the same steps: losses, the first
    step's gradients, the final state."""
    cfg = Configuration()
    cfg.update_config(_settings(root, **extra))
    factory = NetworkFactory(cfg, dataset=_port_dataset(path), device="cpu")
    factory.model.load_state_dict(state)
    out = {"losses": []}
    for k, step in enumerate(steps):
        if "idx" in step:
            loss, stats = factory.train_resident(step["idx"], step["draws"])
        else:
            loss, stats = factory.train(*step["batch"], draws=step["draws"])
        out["losses"].append([loss.item()] + [s.item() for s in stats])
        if k == 0:
            out["grads"] = {n: p.grad.clone()
                            for n, p in factory.model.named_parameters()}
    out["state"] = factory.model.state_dict()
    return out


def _tree(value):
    return jax.tree_util.tree_map(np.asarray, value)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ddp")
    path = str(root / "scdx16p100.d")
    make_archive(path, num_images=2, reps=2, clips_per_image=5, size=64)

    # the JAX trainer on a data mesh of two virtual devices, resident rows
    jcfg = JaxConfiguration()
    jcfg.update_config(_settings(root / "jax", residency="device"))
    jds = JaxDataset(path, None, test_set=4, seed=42)
    jfac = JaxFactory(jcfg, dataset=jds,
                      mesh=jax_create_mesh(jax.devices()[:2]))
    assert jfac.resident and jfac._n_dev == 2
    state = state_dict_from_flax(ARCH, _tree(jfac.params),
                                 _tree(jfac.batch_stats))
    state_path = str(root / "init.pt")
    torch.save(state, state_path)
    resident_steps, jax_losses = [], []
    for step, idx in enumerate(list(jds.epoch_local_indices(
            4, 2, jfac._local_train, epoch=0))[:STEPS]):
        key = jax.random.fold_in(jax.random.PRNGKey(43), step)
        loss, _ = jfac.train_resident(idx)
        jax_losses.append(float(loss))
        resident_steps.append({"idx": idx.astype(np.int64),
                               "draws": jax_draws(key, 4, 64)})
        if step == 0:
            # the first step's gradient from Adam's first moment (mu = 0.1
            # g after one step from 0), and the parameters it made
            stats = _tree(jfac.batch_stats)
            mu = state_dict_from_flax(ARCH, _tree(jfac.opt_state[0].mu),
                                      stats)
            jax_first = state_dict_from_flax(ARCH, _tree(jfac.params), stats)

    host_steps = _host_steps(path)
    positive_steps = _positive_steps(path)
    rank_dir = root / "rank{rank}"
    jobs = [
        {"name": "dp", "settings": _settings(root / "dp", meshShape=[2]),
         "archive": path, "state": state_path, "steps": host_steps,
         "profile": True},
        {"name": "resident", "settings": _settings(
            root / "res", residency="device"), "archive": path,
         "state": state_path, "steps": resident_steps},
        {"name": "positives", "settings": _settings(root / "pos"),
         "archive": path, "state": state_path, "steps": positive_steps},
        {"name": "tp", "settings": _settings(
            root / "tp", meshShape=[1, 2], meshAxes=["data", "model"]),
         "archive": path, "state": state_path, "steps": host_steps,
         "save": str(root / "tp.ckpt")},
        {"name": "writes", "settings": _settings(rank_dir),
         "archive": path, "begin_training": True},
        {"name": "stop", "settings": _settings(root / "stop", iterations=4,
                                               snapshot=4),
         "archive": path, "begin_training": True, "stop_rank": 1},
        {"name": "reuse", "settings": _settings(root / "reuse",
                                                meshShape=[2]),
         "archive": path, "again": True},
    ]
    ranks = run_ranks(2, jobs, str(root / "ranks"))
    return {"root": root, "path": path, "state": state, "ranks": ranks,
            "host_steps": host_steps, "positive_steps": positive_steps,
            "resident_steps": resident_steps, "jax_losses": jax_losses,
            "jax_first": jax_first,
            "jax_grads": {k: v / 0.1 for k, v in mu.items()},
            "single": _single(root / "single", path, state, host_steps),
            "single_positives": _single(root / "single_pos", path, state,
                                        positive_steps)}


def _assert_grads_close(got, want, tol):
    assert got.keys() == want.keys()
    for name, g in want.items():
        scale = g.abs().max().item()
        np.testing.assert_allclose(got[name].numpy(), g.numpy(), rtol=0,
                                   atol=tol * scale + 1e-12, err_msg=name)


@pytest.mark.parametrize("job,single", [("dp", "single"),
                                        ("positives", "single_positives")])
def test_two_data_ranks_equal_one_process(runs, job, single):
    got, want = runs["ranks"][job], runs[single]
    np.testing.assert_allclose(np.asarray(got["losses"]),
                               np.asarray(want["losses"]), rtol=1e-5)
    _assert_grads_close(got["grads"], want["grads"], 1e-4)
    assert not got["sharded"]


def test_rank_zero_trace_splits_the_collectives(runs):
    """The profiled step of the ``dp`` job: the BatchNorm statistics'
    all-reduce, the loss counts, the gradient sum and the loss report
    are spans of their own beside the step's phases, a BatchNorm's
    once per BatchNorm of the model."""
    spans = runs["ranks"]["dp"]["spans"]
    for name in ("scd.collective.grad_sum", "scd.collective.report",
                 "scd.step.feed", "scd.step.forward", "scd.step.backward"):
        assert spans.count(name) == 1, name
    assert spans.count("scd.collective.loss_counts") >= 2
    model = get_model_profile(ARCH).build()
    assert spans.count("scd.collective.bn_stats") == sum(
        isinstance(m, BatchNorm) for m in model.modules())


def test_no_positive_anywhere_reads_the_global_count(runs):
    """The positives job's second step has no object on either rank: its
    focal term is the negative sum alone, its regression terms 0."""
    losses = np.asarray(runs["ranks"]["positives"]["losses"])
    assert losses[1, 2] == 0.0 and losses[1, 3] == 0.0
    assert losses[1, 1] > 0 and losses[0, 2] > 0


def test_two_data_ranks_against_jax_data_mesh(runs):
    got = runs["ranks"]["resident"]
    assert got["resident"]
    losses = [row[0] for row in got["losses"]]
    np.testing.assert_allclose(losses[0], runs["jax_losses"][0], rtol=1e-4)
    np.testing.assert_allclose(losses, runs["jax_losses"], rtol=2e-3)
    n_rounding = n_all = 0
    for name, g in got["grads"].items():
        want = runs["jax_grads"][name]
        scale = want.abs().max().item()
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=0,
                                   atol=JAX_GRAD_TOL * scale, err_msg=name)
        # the first update, from the same state, where it is not a sign
        # away from rounding level
        keep = want.abs() > ROUNDING * scale
        n_rounding += int((~keep).sum())
        n_all += keep.numel()
        np.testing.assert_allclose(
            got["first_state"][name][keep].numpy(),
            runs["jax_first"][name][keep].numpy(), rtol=0, atol=1e-2 * LR,
            err_msg=name)
    assert n_rounding <= 0.1 * n_all


def test_data_by_model_axis_against_data_parallel(runs):
    tp, dp = runs["ranks"]["tp"], runs["ranks"]["dp"]
    assert tp["sharded"] and all(dim in (0, 1)
                                 for dim in tp["sharded"].values())
    np.testing.assert_allclose([r[0] for r in tp["losses"]],
                               [r[0] for r in dp["losses"]], rtol=2e-3)
    _assert_grads_close(tp["grads"], runs["single"]["grads"], 1e-4)


def test_model_axis_checkpoint_loads_into_the_plain_model(runs):
    """The data x model run's checkpoint is in the plain layout: it loads
    strictly into a plain model, Adam's moments have the plain shapes,
    and the weights are the run's, gathered."""
    ckpt = load_training_checkpoint(str(runs["root"] / "tp.ckpt"), ARCH)
    model = get_model_profile(ARCH).build()
    model.load_state_dict(ckpt["state_dict"], strict=True)
    shapes = [p.shape for p in model.parameters()]
    moments = ckpt["optimizer"]["state"]
    assert len(moments) == len(shapes)
    for idx, shape in enumerate(shapes):
        assert moments[idx]["exp_avg"].shape == shape
    for key, value in runs["ranks"]["tp"]["state"].items():
        assert torch.equal(ckpt["state_dict"][key], value), key


def test_only_rank_zero_writes(runs):
    root = runs["root"]
    assert runs["ranks"]["writes"]["summary"]["steps"] == 2
    written = {p.name for p in (root / "rank0").rglob("*") if p.is_file()}
    assert {"losses.ddp.2.txt", "evals.ddp.txt"} <= written
    assert any(name.endswith(".best.pth") for name in written)
    assert not [p for p in (root / "rank1").rglob("*") if p.is_file()]


def test_a_stop_on_one_rank_stops_every_rank(runs):
    stop = runs["ranks"]["stop"]
    assert stop["preempted"] and stop["summary"]["steps"] == 1
    evals = (runs["root"] / "stop" / "results" / "evals.ddp.txt").read_text()
    assert "Preempted at iteration 1" in evals
    assert any((runs["root"] / "stop" / "temp").iterdir())


def test_a_second_trainer_takes_the_first_ones_groups(runs):
    """One set of line groups and one host group a process, however many
    trainers it builds: no new communicators, no groups left behind."""
    assert runs["ranks"]["reuse"]["again"] == {
        "groups_made": 0, "same_data_group": True, "same_host_group": True}


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_group_of_one_equals_no_group(runs, tmp_path):
    """A world of one process with ``meshShape [1]`` trains bit for bit as
    the plain single-process trainer."""
    dist.init_process_group(
        "gloo", init_method="tcp://127.0.0.1:{}".format(_free_port()),
        rank=0, world_size=1, timeout=timedelta(seconds=60))
    try:
        got = _single(tmp_path, runs["path"], runs["state"],
                      runs["host_steps"], meshShape=[1])
    finally:
        dist.destroy_process_group()
    want = runs["single"]
    assert got["losses"] == want["losses"]
    for key, value in want["state"].items():
        assert torch.equal(got["state"][key], value), key
    for key, value in want["grads"].items():
        assert torch.equal(got["grads"][key], value), key
