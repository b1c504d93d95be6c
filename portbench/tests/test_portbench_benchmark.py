"""``BENCHMARK.json`` against the benchmark's contract, and every name in
it found as a file: a configuration, a traffic mix with its driver, the
limits of each cell, a reader of each metric."""

import json
import os
import re

import pytest

from portbench import harness, metrics_common

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert (harness.HERE / "metrics" / (metric["name"] + ".py")).exists()
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        ends = {m["name"]: m for m in BENCH["end_to_end"]}
        assert metric["moves"] in ends
        moved = ends[metric["moves"]].get("workloads")
        assert moved is None or set(metric["workloads"]) <= set(moved)


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_and_metrics(entry):
    files = harness.cell_files(BENCH, entry)
    assert (harness.HERE / "drivers"
            / (files["traffic"]["driver"] + ".py")).exists()
    assert files["limits"] and entry["chips"] == 1
    ends = [m["name"] for m in harness.metrics_of(BENCH, entry["name"],
                                                  False)]
    assert "setup_s" in ends and len(ends) >= 2
    assert harness.metrics_of(BENCH, entry["name"], True)
    assert len(entry["why"]) <= 200


def test_configs_and_kernel_files():
    for config in BENCH["configs"]:
        assert config["file"].startswith("portbench/configs/")
        assert harness.load_json(harness.ROOT / config["file"])["name"] \
            == config["name"]
    shape = {"B": 32, "S": 128, "M": 3, "K": 30, "X": 256, "C0": 64,
             "C": 128, "E": 2}
    for kernel in metrics_common.kernels():
        assert metrics_common.evaluate(kernel["bytes"], shape) > 0
        assert metrics_common.evaluate(kernel["flops"], shape) >= 0


def test_a_per_layer_metric_needs_its_workloads():
    bench = dict(BENCH, per_layer=[dict(BENCH["per_layer"][0])])
    del bench["per_layer"][0]["workloads"]
    with pytest.raises(KeyError):
        harness.metrics_of(bench, BENCH["workloads"][0]["name"], True)


def test_build_state_sees_a_new_or_rewritten_file(tmp_path):
    assert harness.build_state(tmp_path) == {}
    (tmp_path / "build" / "cuda").mkdir(parents=True)
    empty = harness.build_state(tmp_path)
    library = tmp_path / "build" / "cuda" / "kernel.so"
    library.write_bytes(b"1")
    built = harness.build_state(tmp_path)
    assert built != empty and harness.build_state(tmp_path) == built
    os.utime(library, ns=(1, 1))
    assert harness.build_state(tmp_path) != built
