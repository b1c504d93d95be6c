"""The readers of the port's own spans (``analyse_upload_ms``,
``analyse_stitch_ms``, ``step_python_idle_ms``): on
hand-made events, on records without the spans (a port that has none,
an untraced run), and on the CPU traces of whole traced runs."""

import pytest
import torch

from portbench import harness
from portbench import trace as tracing
from portbench.run import run_cell

SEED = 2 ** 31 + 777


def events(device, host, spans=None, window=(0.0, 200.0)):
    return {"window": window, "device": [(s, e, n, "kernel")
                                         for s, e, n in device],
            "host": sorted(host), "spans": spans or {}}


REQUESTS = {"portbench.request": [(0.0, 100.0), (100.0, 200.0)]}
SERVED = events([(20, 90, "conv"), (130, 190, "conv")],
                [(5, 15, "scd.analyse.upload"), (92, 99, "scd.analyse.stitch"),
                 (105, 125, "scd.analyse.upload"),
                 (191, 196, "scd.analyse.stitch"),
                 (250, 260, "scd.analyse.upload")], REQUESTS)
# gaps 0-10 (middle 5: the forward span), 30-60 (45: aten::item), 70-75
# (72.5: the optimizer span), 100-120 (110: the benchmark's own step span)
TRAINED = events([(10, 30, "conv"), (60, 70, "bn"), (75, 100, "conv"),
                  (120, 200, "conv")],
                 [(0, 100, "portbench.step"), (1, 40, "scd.step.forward"),
                  (35, 55, "aten::item"), (56, 75, "scd.step.optimizer"),
                  (100, 200, "portbench.step")])


def read(name, record):
    return harness.reader(name)(record)


@pytest.mark.parametrize("name, ms", [("analyse_upload_ms", 0.015),
                                      ("analyse_stitch_ms", 0.006)])
def test_analyzer_phase_per_request(name, ms):
    # upload 10 + 20 us over two requests (the span outside every request
    # left out), stitch 7 + 5 us
    record = {"kind": "serve", "events": SERVED}
    assert read(name, record) == pytest.approx(ms)


def test_step_idle_under_the_step_spans_agrees_with_the_breakdown():
    record = {"kind": "train", "events": TRAINED, "steps": 2}
    # 10 us under the forward span, 5 under the optimizer's, over 2 steps
    assert read("step_python_idle_ms", record) == pytest.approx(7.5e-3)
    idle = dict(tracing.breakdown(TRAINED)["idle_gaps"])
    assert idle["scd.step.forward"] + idle["scd.step.optimizer"] \
        == pytest.approx(15e-6)
    assert idle["aten::item"] == pytest.approx(30e-6)
    assert idle["portbench.step"] == pytest.approx(20e-6)


@pytest.mark.parametrize("name, kind", [("analyse_upload_ms", "serve"),
                                        ("analyse_stitch_ms", "serve"),
                                        ("step_python_idle_ms", "train")])
def test_nothing_to_read_without_port_spans(name, kind):
    """A port without the spans (an older checkout), an untraced run and
    the other kind of cell give no value."""
    bare = dict(SERVED if kind == "serve" else TRAINED)
    bare["host"] = [h for h in bare["host"] if not h[2].startswith("scd.")]
    for record in ({"kind": kind, "events": bare, "steps": 2},
                   {"kind": kind, "events": None, "steps": 2},
                   {"kind": "train" if kind == "serve" else "serve",
                    "events": SERVED if kind == "serve" else TRAINED,
                    "steps": 2}):
        assert read(name, record) is None


def _traced(small_cell, name, precision=None):
    bench, entry, files = small_cell(name, precision)
    files["traffic"]["trace_seconds"] = 2.0
    result, _, _, record = run_cell(bench, entry, SEED, 2.0, True,
                                    torch.device("cpu"), files=files)
    assert result["correct"]
    return result["metrics"], record


def test_a_traced_served_window_on_the_cpu(small_cell):
    """The port's spans reach the benchmark's reader through a real
    Chrome trace of a window of served slides: upload and stitch a
    request, positive, and parts of the request's host time."""
    metrics, record = _traced(small_cell, "centerOffsetRes10.serve_slide")
    upload = metrics["analyse_upload_ms"]["value"]
    stitch = metrics["analyse_stitch_ms"]["value"]
    assert upload > 0 and stitch > 0
    assert upload + stitch <= metrics["analyse_host_ms"]["value"]
    names = {n for _, _, n in record["events"]["host"]}
    assert {"scd.analyse.tile", "scd.analyse.forward",
            "scd.analyse.readback"} <= names


def test_a_traced_training_window_on_the_cpu(small_cell):
    metrics, record = _traced(small_cell, "centerOffsetRes10.train_b32",
                              precision="float32")
    assert metrics["step_python_idle_ms"]["value"] >= 0
    names = {n for _, _, n in record["events"]["host"]}
    assert {"scd.step.feed", "scd.step.transform", "scd.step.forward",
            "scd.step.backward", "scd.step.optimizer"} <= names
