"""The trainer's debug overlays and ``StepProfiler`` in the port
(``scd_resnet_tpu_torch/train/factory.py``, ``core/profiling.py``)
against the JAX trainer's (``scd_resnet_tpu/train/factory.py:862-935``,
``core/profiling.py``), on the CPU.

Short train runs (64x64 clips, batch 4, 2 steps, validation at 2) of a
centerOffset, a corner-pool and a legacy CornerNet model, at quarter
width or the small hourglass geometry, through the train CLI with
``-debug``. Each writes ``it000002.clip{j}.png``. The JAX trainer's own
``dump_debug_overlays`` then draws the same batch (handed over in its
NHWC layout) with every ``ImageDraw`` call recorded: its markers must
equal the port's ``overlay_markers`` exactly (the same float64
arithmetic on the same float32 targets), and its PNGs must be within one
grey level of the port's (both stretch the same float32 clip).
"""

import dataclasses
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

from scd_resnet_tpu.train.factory import NetworkFactory as JaxFactory
from scd_resnet_tpu_torch.core.profiling import StepProfiler
from scd_resnet_tpu_torch.data.synthetic import make_archive
from scd_resnet_tpu_torch.train import __main__ as train_cli
from scd_resnet_tpu_torch.train import factory as factory_mod
from scd_resnet_tpu_torch.train import registry

import torch_port_common  # noqa: F401  (the CPU-thread rule)

ARCHS = {"center": "centerOffsetRes10q", "corner": "cornerCPoolRes10q",
         "legacy": "cornerLegacyHourglassq"}


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    make_archive(str(root / "scdx16p100.d"), num_images=2, reps=1,
                 clips_per_image=4, size=64)
    return root


@pytest.fixture
def small_profiles(monkeypatch):
    monkeypatch.setitem(registry.MODEL_PROFILES, ARCHS["corner"],
                        dataclasses.replace(
                            registry.get_model_profile("cornerCPoolRes10"),
                            name=ARCHS["corner"],
                            model_params={"num_layers": 10,
                                          "dims": registry.QUARTER}))
    monkeypatch.setitem(registry.MODEL_PROFILES, ARCHS["legacy"],
                        dataclasses.replace(
                            registry.get_model_profile(
                                "cornerLegacyHourglass"),
                            name=ARCHS["legacy"],
                            model_params={"categories": 1, "stacks": 2,
                                          "iterations": 2,
                                          "dimensions": (16, 24, 32),
                                          "modules": (1, 1, 1),
                                          "prediction_dim": 32}))


def _config(data_dir, work, arch):
    path = os.path.join(work, arch + ".json")
    with open(path, "w") as f:
        json.dump({"datasetName": "scdx16p100", "modelName": arch,
                   "trainName": arch, "batchSize": 4,
                   "validationBatchSize": 4, "iterations": 2,
                   "validation": 2, "snapshot": 2,
                   "dirTemp": os.path.join(work, "temp/"),
                   "dirResult": os.path.join(work, "results/"),
                   "dirDataset": str(data_dir) + "/"}, f)
    return path


class _Recorder:
    """An ``ImageDraw.Draw`` that records every call and draws it."""

    calls = []

    def __init__(self, img):
        self.draw = _Recorder.original(img)

    def __getattr__(self, method):
        def call(xy, **style):
            _Recorder.calls.append((method, xy, style))
            return getattr(self.draw, method)(xy, **style)
        return call


_Recorder.original = ImageDraw.Draw


def _jax_layout(ys, legacy):
    """The port's host targets in the JAX trainer's layout: heatmaps
    NHWC, the rest as they are."""
    heats = (0, 1) if legacy else (0,)
    return [np.moveaxis(y, 1, -1) if i in heats else y
            for i, y in enumerate(ys)]


@pytest.mark.parametrize("family", sorted(ARCHS))
def test_debug_overlays_match_the_jax_trainer(family, data_dir, tmp_path,
                                              small_profiles, monkeypatch):
    arch = ARCHS[family]
    captured = {}
    dump = factory_mod.NetworkFactory.dump_debug_overlays

    def capture(self, it, max_clips=4):
        captured["batch"] = self._last_batch
        captured["heat_size"] = self.heat_size
        captured["it"] = it
        return dump(self, it, max_clips)

    monkeypatch.setattr(factory_mod.NetworkFactory, "dump_debug_overlays",
                        capture)
    config = _config(data_dir, str(tmp_path), arch)
    train_cli.main([config, "--device", "cpu", "-debug"])
    port_dir = tmp_path / "results" / "debug.{}".format(arch)
    names = sorted(os.listdir(port_dir))
    assert names == ["it000002.clip{}.png".format(j) for j in range(4)]
    assert captured["it"] == 2

    xs, ys = captured["batch"]
    xs = xs.float().numpy()
    ys = [y.numpy() for y in ys]
    legacy = family == "legacy"
    jax_dir = tmp_path / "jax"
    fake = SimpleNamespace(
        _rebuild_last_batch=lambda: (np.moveaxis(xs, 1, -1),
                                     _jax_layout(ys, legacy)),
        profile=SimpleNamespace(corner_targets="legacy" if legacy else True),
        config=SimpleNamespace(dirResult=str(jax_dir), trainName=arch))
    _Recorder.calls = []
    monkeypatch.setattr(ImageDraw, "Draw", _Recorder)
    JaxFactory.dump_debug_overlays(fake, 2)
    jax_calls = list(_Recorder.calls)
    ours = [m for j in range(4) for m in factory_mod.overlay_markers(
        ys, captured["heat_size"], legacy, j)]
    assert len(ours) > 0
    assert ours == jax_calls
    for name in names:
        port_png = np.asarray(Image.open(port_dir / name), np.int16)
        jax_png = np.asarray(Image.open(
            jax_dir / "debug.{}".format(arch) / name), np.int16)
        assert port_png.shape == jax_png.shape == (64, 64, 3)
        assert np.abs(port_png - jax_png).max() <= 1


def test_profiler_traces_a_window_of_steps(data_dir, tmp_path, monkeypatch):
    """SCD_PROFILE_* around step 2 of a 2-step run: the trace opens before
    step 2 and is closed and written when the run ends inside it."""
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("SCD_PROFILE_DIR", str(trace_dir))
    monkeypatch.setenv("SCD_PROFILE_START", "2")
    monkeypatch.setenv("SCD_PROFILE_STEPS", "5")
    train_cli.main([_config(data_dir, str(tmp_path), ARCHS["center"]),
                    "--device", "cpu"])
    traces = os.listdir(trace_dir)
    assert traces == ["trace.2-2.json"]
    with open(trace_dir / traces[0]) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any("conv" in n for n in names)


def test_step_profiler_window(tmp_path, monkeypatch):
    for var in ("SCD_PROFILE_DIR", "SCD_PROFILE_START", "SCD_PROFILE_STEPS"):
        monkeypatch.delenv(var, raising=False)
    assert not StepProfiler().enabled
    prof = StepProfiler(str(tmp_path), start_step=3, num_steps=2)
    x = torch.ones(8)
    opened = []
    for it in range(1, 7):
        prof.step(it)
        opened.append(prof.active)
        x = x * 2 + 1
    # active for steps 3 and 4; stopped when step 5 begins
    assert opened == [False, False, True, True, False, False]
    assert os.listdir(tmp_path) == ["trace.3-4.json"]
    prof.close()  # nothing open: nothing written
    assert len(os.listdir(tmp_path)) == 1

    monkeypatch.setenv("SCD_PROFILE_DIR", str(tmp_path / "env"))
    monkeypatch.setenv("SCD_PROFILE_START", "1")
    monkeypatch.setenv("SCD_PROFILE_STEPS", "10")
    prof = StepProfiler()
    assert (prof.start_step, prof.num_steps) == (1, 10)
    prof.step(1)
    torch.ones(4).sum()
    prof.close()
    assert not prof.active
    assert os.listdir(tmp_path / "env") == ["trace.1-end.json"]
