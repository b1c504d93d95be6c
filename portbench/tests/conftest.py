"""Shared set-up of the benchmark's CPU tests: quarter-width models, a
700x600 slide and 128x128 training clips, so that a whole run of a cell
(set-up, window, reference and comparison) takes seconds on the host.

The ``card`` marker names tests that need a CUDA card; each decides inside
itself whether one is there.
"""

from __future__ import annotations

import copy
import dataclasses

import pytest
import torch

from portbench import harness

QUARTER = [16, 16, 32, 64, 128, 64, 64, 64]
SMALL_PROFILES = {"centerOffsetRes10": "centerOffsetRes10q",
                  "cornerCPoolRes10": "cornerCPoolRes10q"}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips "
                            "itself without one")


def _register_small_corner() -> None:
    from scd_resnet_tpu_torch.train import registry

    if "cornerCPoolRes10q" not in registry.MODEL_PROFILES:
        full = registry.get_model_profile("cornerCPoolRes10")
        registry.register_model(dataclasses.replace(
            full, name="cornerCPoolRes10q",
            model_params=dict(full.model_params, dims=tuple(QUARTER))))


@pytest.fixture
def small_cell(monkeypatch):
    """``make(cell_name, precision=None) -> (bench, entry, files)``: the
    cell's files cut to a CPU test's size (quarter widths, a 700x600
    slide, 128x128 clips in batches of 8), its limits as committed."""
    import scd_resnet_tpu_torch.infer.analyse as analyse

    torch.set_num_threads(4)
    monkeypatch.setattr(analyse, "BATCH_SIZE", 4)
    _register_small_corner()
    bench = harness.benchmark()

    def make(name: str, precision: str = None):
        entry = harness.cell(bench, name)
        files = copy.deepcopy(harness.cell_files(bench, entry))
        config = files["config"]
        config.update(arch=SMALL_PROFILES[config["name"]], dims=QUARTER)
        if config["family"] == "centerOffset":
            config["terminal_hidden"] = 64
        if precision:
            config["train"]["precision"] = precision
        if files["traffic"]["driver"] == "serve":
            files["traffic"].update(width=700, height=600, slides=2,
                                    calibration_clips=2, device_batch=4,
                                    reference_block=4)
        else:
            files["traffic"].update(clip=128, batch=8, pool=32, rows=64,
                                    max_objects=6, warmup_steps=4)
        return bench, entry, files

    return make
