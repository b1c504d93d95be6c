"""The port's named spans (``core/profiling.span``) on the CPU: the
analyzer's, the service's and the train step's phases as
``record_function`` ranges under a profiler, none without one, and the
same answers and losses either way; the service's ``SCD_PROFILE_*``
window of requests. Quarter-width ``centerOffsetRes10q`` on a 700x600
slide and on 64x64 clips in batches of 4, as the other port tests.
"""

import json
import threading

import numpy as np
import pytest
import torch

import scd_resnet_tpu_torch.infer.analyse as analyse_module
from scd_resnet_tpu_torch.core import profiling
from scd_resnet_tpu_torch.core.config import Configuration
from scd_resnet_tpu_torch.data.dataset import SCDDataset
from scd_resnet_tpu_torch.data.pipeline import draw
from scd_resnet_tpu_torch.data.synthetic import make_archive
from scd_resnet_tpu_torch.infer.analyse import (
    band_plan,
    make_device_analyzer,
    slide_geometry,
)
from scd_resnet_tpu_torch.infer.server import InferenceService
from scd_resnet_tpu_torch.infer.synthetic import seeded_model, synthetic_slide
from scd_resnet_tpu_torch.infer.wrapper import make_wrapper
from scd_resnet_tpu_torch.train.factory import NetworkFactory

ARCH = "centerOffsetRes10q"
WIDTH, HEIGHT = 700, 600
BAND_CLIPS = 2  # a band of one column of two clips: two bands a slide
ANALYSE = ["scd.analyse.upload", "scd.analyse.tile", "scd.analyse.forward",
           "scd.analyse.readback", "scd.analyse.stitch"]
STEP = ["scd.step.feed", "scd.step.draws", "scd.step.transform",
        "scd.step.optimizer", "scd.step.forward", "scd.step.loss",
        "scd.step.backward", "scd.step.optimizer"]
CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def small_batches(monkeypatch):
    """Slides and bands run padded to 4 clips, not 24: the CPU's float32
    forward is the same at any batch, and 24 blank clips a call only cost
    time here."""
    monkeypatch.setattr(analyse_module, "BATCH_SIZE", 4)


@pytest.fixture(scope="module")
def slide():
    return synthetic_slide(HEIGHT, WIDTH, seed=7)


@pytest.fixture(scope="module")
def wrapper(slide):
    probe = torch.from_numpy(slide[:512, :512].astype(np.float32))
    probe = (probe - probe.mean()) / probe.std()
    return make_wrapper(seeded_model(ARCH, 3, probe[None, None]),
                        "centerOffset")


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    root = tmp_path_factory.mktemp("tracing")
    path = str(root / "scdx16p100.d")
    make_archive(path, num_images=2, reps=1, clips_per_image=6, size=64)
    return root, path


def _factory(root, path):
    cfg = Configuration()
    cfg.update_config({
        "datasetName": "scdx16p100", "modelName": ARCH, "trainName": "spans",
        "batchSize": 4, "validationBatchSize": 4, "learningRate": 1e-3,
        "residency": "device", "dirTemp": str(root / "temp") + "/",
        "dirResult": str(root / "results") + "/",
        "dirDataset": str(root) + "/"})
    dataset = SCDDataset(path, None, test_set=4, seed=42, device="cpu")
    factory = NetworkFactory(cfg, dataset=dataset, device="cpu", seed=5)
    assert factory.resident
    return factory


def _step_args(factory):
    idx = next(iter(factory.dataset.epoch_local_indices(4, 0)))
    gen = torch.Generator().manual_seed(11)
    return idx, draw(gen, 4, 64, torch.device("cpu"))


def _profiled(fn, tmp_path, outer="call"):
    """``fn()`` under a CPU profiler inside a ``record_function(outer)``;
    its result and the trace's ``(name, ts, end, tid)`` of the outer
    range and every ``scd.`` span, in start order."""
    with torch.profiler.profile(activities=CPU) as prof:
        with torch.profiler.record_function(outer):
            out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["name"], float(e["ts"]), float(e["ts"]) + e["dur"],
                    e["tid"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and (e["name"] == outer or e["name"].startswith("scd.")))
    return out, sorted(spans, key=lambda s: s[1])


def test_span_is_one_shared_no_op_without_a_profiler():
    assert profiling.span("scd.a") is profiling.span("scd.b")
    with profiling.span("scd.a"):
        pass
    with torch.profiler.profile(activities=CPU):
        inside = profiling.span("scd.a")
    assert isinstance(inside, torch.profiler.record_function)


@pytest.mark.parametrize("path", ["analyzer", "banded", "service", "step",
                                  "host_step"])
def test_no_range_is_entered_without_a_profiler(path, slide, wrapper,
                                                archive, monkeypatch):
    """(a): a request and a step enter no ``record_function`` untraced;
    the same call under a profiler enters some, so the count sees them."""
    calls = []
    real = torch.profiler.record_function

    def counting(name, *args):
        calls.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    if path in ("step", "host_step"):
        factory = _factory(*archive)
        idx, draws = _step_args(factory)
        if path == "step":
            run = lambda: factory.train_resident(idx, draws)  # noqa: E731
        else:
            batch = next(iter(factory.dataset.epoch_batches(4, 0)))
            run = lambda: factory.train_rows(*batch, draws)  # noqa: E731
    elif path == "service":
        service = InferenceService(wrapper)
        body = slide.tobytes()
        run = lambda: service.analyse_raw(body, WIDTH, HEIGHT)  # noqa: E731
        run()  # the analyzer's build, outside the count
    else:
        analyse = make_device_analyzer(
            wrapper, WIDTH, HEIGHT,
            max_resident_clips=BAND_CLIPS if path == "banded" else None)
        run = lambda: analyse(slide)  # noqa: E731
    calls.clear()
    run()
    assert calls == []
    with torch.profiler.profile(activities=CPU):
        run()
    assert any(name.startswith("scd.") for name in calls)


@pytest.mark.parametrize("mode", ["whole", "mesh", "banded"])
def test_analyzer_phases_in_order_on_the_calling_thread(mode, slide, wrapper,
                                                        tmp_path):
    """(b): upload, tile, forward, readback, stitch, nested in the call
    on its thread; streamed, an upload, tile and forward a band; answers
    equal to the untraced ones."""
    analyse = make_device_analyzer(
        wrapper, WIDTH, HEIGHT, dedupe_radius=8.0,
        max_resident_clips=BAND_CLIPS if mode == "banded" else None,
        mesh=["cpu", "cpu"] if mode == "mesh" else None)
    untraced = analyse(slide)
    traced, spans = _profiled(lambda: analyse(slide), tmp_path)
    assert traced == untraced and len(untraced) > 0
    (_, lo, hi, tid), spans = spans[0], spans[1:]
    assert all(lo <= s and e <= hi and t == tid for _, s, e, t in spans)
    names = [name for name, _, _, _ in spans]
    if mode != "banded":
        assert names == ANALYSE
        return
    bands = len(band_plan(*slide_geometry(WIDTH, HEIGHT)[:2], BAND_CLIPS))
    assert bands == 2
    # band 2 is queued before band 1's rows are read back
    assert names == ANALYSE[:3] * 2 + ["scd.analyse.readback"] * 2 \
        + ["scd.analyse.stitch"]


def test_train_step_spans_nest_in_the_call(archive, tmp_path):
    """(c): one ``train_resident`` step makes every ``scd.step.*`` span,
    in order, inside the call; its losses and parameters are bit-equal to
    an untraced step's from the same state."""
    factory = _factory(*archive)
    idx, draws = _step_args(factory)
    plain = _factory(*archive)
    want_loss, want_stats = plain.train_resident(idx, draws)
    (loss, stats), spans = _profiled(
        lambda: factory.train_resident(idx, draws), tmp_path)
    (_, lo, hi, _), spans = spans[0], spans[1:]
    assert [name for name, _, _, _ in spans] == STEP
    assert all(lo <= s and e <= hi for _, s, e, _ in spans)
    assert torch.equal(loss, want_loss)
    assert all(torch.equal(a, b) for a, b in zip(stats, want_stats))
    for (name, p), q in zip(factory.model.named_parameters(),
                            plain.model.parameters()):
        assert torch.equal(p, q), name


def test_service_profiles_a_window_of_requests(slide, wrapper, tmp_path,
                                               monkeypatch):
    """``SCD_PROFILE_*`` counted in requests: a window on request 2 of
    two, request 2 sent from another thread (as the threaded daemon
    does), written at ``close`` as ``trace.2-2.json`` with the request's
    analyzer spans."""
    monkeypatch.setenv("SCD_PROFILE_DIR", str(tmp_path))
    monkeypatch.setenv("SCD_PROFILE_START", "2")
    monkeypatch.setenv("SCD_PROFILE_STEPS", "1")
    service = InferenceService(wrapper)
    body = slide.tobytes()
    first = service.analyse_raw(body, WIDTH, HEIGHT)
    answers = []
    thread = threading.Thread(target=lambda: answers.append(
        service.analyse_raw(body, WIDTH, HEIGHT)))
    thread.start()
    thread.join()
    assert answers == [first]
    assert list(tmp_path.iterdir()) == []  # the window is still open
    service.close()
    assert [p.name for p in tmp_path.iterdir()] == ["trace.2-2.json"]
    with open(tmp_path / "trace.2-2.json") as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    assert names.count("scd.analyse.stitch") == 1
    assert "scd.analyse.upload" in names
