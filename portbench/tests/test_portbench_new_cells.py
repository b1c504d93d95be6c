"""The published CornerNet's cell, ``cornerNetHourglass104.train_b32_remat``,
whole on the CPU at a test's size (a narrowed hourglass: widths 8-16, the
published modules and depth). It agrees with the plain reference
(``correct``), and the fp8 control and both planted faults come out not
correct. Besides: the ``cornerLegacy`` family's targets, rebuilt from the
shared transform's labels, equal the port's legacy transform on a seeded
pool; the reference's rounding points leave its float32 arithmetic as
it is; ``head_gap`` reads the first stack of the first forward."""

from __future__ import annotations

import copy
import dataclasses

import pytest
import torch

from portbench import harness, inputs
from portbench.drivers import train, train_heads
from portbench.reference import cornerLegacy
from portbench.reference import model as reference_model
from portbench.reference import train as reference_train
from portbench.run import control, run_cell

CPU = torch.device("cpu")
SEED = 2 ** 31 + 4104
HG = "cornerNetHourglass104.train_b32_remat"
SMALL_HOURGLASS = {"iterations": 5, "stacks": 2,
                   "dimensions": (8, 8, 12, 12, 12, 16),
                   "modules": (2, 2, 2, 2, 2, 4), "prediction_dim": 16}


def _register(name: str, base: str, **params) -> None:
    from scd_resnet_tpu_torch.train import registry

    if name not in registry.MODEL_PROFILES:
        full = registry.get_model_profile(base)
        registry.register_model(dataclasses.replace(
            full, name=name, model_params=dict(full.model_params, **params)))


def small(precision: str = "float32"):
    """The cell's files at a test's size, its limits as committed."""
    torch.set_num_threads(4)
    bench = harness.benchmark()
    entry = harness.cell(bench, HG)
    files = copy.deepcopy(harness.cell_files(bench, entry))
    config, traffic = files["config"], files["traffic"]
    config["train"]["precision"] = precision
    _register("cornerNetHourglass104s", "cornerNetHourglass104",
              **SMALL_HOURGLASS)
    config.update(arch="cornerNetHourglass104s",
                  dims=list(SMALL_HOURGLASS["dimensions"]),
                  prediction_dim=SMALL_HOURGLASS["prediction_dim"])
    traffic.update(clip=128, batch=8, pool=32, rows=64, max_objects=6,
                   warmup_steps=4)
    return bench, entry, files


def run(system=None, seconds=1.0):
    bench, entry, files = small()
    if system is control:
        system = control(files)
    result, numbers, _, record = run_cell(bench, entry, SEED, seconds, False,
                                          CPU, system=system, files=files)
    return result, numbers, record


def test_cell_agrees_with_the_reference():
    result, numbers, record = run()
    assert result["correct"], numbers
    # the first step to float32 rounding; the later losses and changes are
    # not held so close: a tenth of the small hourglass's gradient elements
    # lie within rounding of 0, and Adam moves each by about lr whatever
    # its sign
    assert numbers["first_loss_gap"] < 1e-4 and numbers["grad_gap"] < 1e-4
    assert numbers["head_gap"] < 1e-4
    assert set(result["metrics"]) == {"train_throughput", "setup_s"}
    assert record["steps"] >= 1 and record["failed"] == 0


@pytest.mark.parametrize("system", ["control", "unchanged", "half_batch"])
def test_control_and_faults_are_not_correct(system):
    planted = control if system == "control" else train.FAULTS[system]
    result, numbers, _ = run(planted, seconds=0.5)
    assert not result["correct"], numbers


def test_rebuilt_legacy_targets_equal_the_port_transform():
    from scd_resnet_tpu_torch.data.pipeline import (
        Draws,
        augment_and_render_batch,
    )

    size, heat = 512, 128
    samples, locs, counts = inputs.train_pool(16, size, 30, SEED, CPU)
    feed = train.Feed(SEED, 16, 1, 16, size, CPU)
    _, draws = feed.next()
    _, labels = reference_train.transform(samples, locs, counts, draws, heat,
                                          False, 0.5, 0.05, 0.05)
    want = cornerLegacy.targets(labels)
    _, ys = augment_and_render_batch(samples, locs, counts, heat,
                                     draws=Draws(**draws),
                                     corner_targets="legacy")
    names = ("tl_heat", "br_heat", "mask", "tl_regr", "br_regr", "tl_inds",
             "br_inds")
    for name, got in zip(names, ys):
        ref = want[name]
        if name.endswith("heat"):
            got = got[:, 0]
        if got.dtype.is_floating_point:
            assert torch.allclose(got, ref, rtol=0, atol=1e-5), name
        else:
            assert torch.equal(got, ref), name
    present = torch.arange(30)[None] < counts[:, None]
    assert torch.equal(want["mask"], present)


def test_new_cell_files_and_metrics():
    bench = harness.benchmark()
    entry = harness.cell(bench, HG)
    files = harness.cell_files(bench, entry)
    assert files["traffic"]["driver"] == "train_heads" and files["limits"]
    assert entry["chips"] == 1 and len(entry["why"]) <= 200
    ends = [m["name"] for m in harness.metrics_of(bench, HG, False)]
    assert set(ends) == {"train_throughput", "setup_s"}
    layer = {m["name"] for m in harness.metrics_of(bench, HG, True)}
    assert layer == {"launches_per_step", "mfu.train", "kernel_roofline.train",
                     "device_idle_share.train", "step_python_idle_ms",
                     "model_python_idle_ms"}


def test_family_count_of_the_published_widths():
    """The ``cornerLegacy`` family's convolutions equal
    ``torch.utils.flop_counter``'s count on its reference model, and the
    published widths give 900.34 GFLOP a 512x512 clip."""
    from torch.utils.flop_counter import FlopCounterMode

    from portbench import flops
    from portbench.reference import model as reference_model

    bench, entry, files = small()
    config = files["config"]
    model = reference_model.build(config)
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.01)
    for m in model.modules():
        if isinstance(m, reference_model.Norm):
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    model.eval()
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(torch.zeros(2, 1, 128, 128))
    assert flops.forward_per_clip(config, 128) * 2 == \
        counter.get_total_flops()
    full = harness.cell_files(bench, entry)["config"]
    assert round(flops.forward_per_clip(full, 512) / 1e7) / 100 == 900.34


def test_head_gap_reads_the_first_forward():
    model = torch.nn.Linear(2, 2)
    kept = {}

    class Heads(torch.nn.Module):
        def forward(self, x):
            return [{"tl_heat": model(x)}, {"tl_heat": 2 * model(x)}]

    heads = Heads()
    train_heads.keep_first(heads, kept)
    x = torch.ones(4, 2)
    first = heads(x)[0]["tl_heat"].detach()
    heads(2 * x)
    assert torch.equal(kept["tl_heat"], first)
    assert train_heads.head_gap(kept, {"tl_heat": first}) == 0
    half = {"tl_heat": first[:2]}
    assert train_heads.head_gap(half, {"tl_heat": first}) == 0
    assert train_heads.head_gap({}, {"tl_heat": first}) == float("inf")
    assert train_heads.head_gap({"tl_heat": 1.1 * first},
                                {"tl_heat": first}) == pytest.approx(0.1)


def test_witness_reads_the_reference_under_autocast():
    """The witness's float32 and autocast runs start from one state: the
    heads differ by bfloat16's rounding, not by more."""
    from portbench import witness

    _, _, files = small("bfloat16")
    numbers = witness.readings(files, SEED, CPU)
    assert 0 < numbers["head_gap"] < 0.5
    assert numbers["first_loss_gap"] < 0.1 and numbers["leaves_left_out"] == 0
