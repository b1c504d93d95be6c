"""The port's F1 path and its tools against the JAX package's (CPU):
``tools/f1_eval`` (matching, grouping, the CLI's output), the eval stage
of ``tools/f1_pipeline`` (``report.json``/``report.md`` to the byte),
the pipeline's train and serve stages (configuration and commands), the
synthetic slides of its seeds, ``tools/eval_checkpoint`` (the [It] line
from a torch file and a msgpack file against the trainer's own),
``tools/export_checkpoint`` (key for key and bit for bit against
``scd_resnet_tpu/core/torch_convert``'s exporters) and
``tools/loadtest`` against a stub daemon.

Tolerances: everything is compared exactly (the same float64 numpy
arithmetic and the same string formats on both sides; a checkpoint
moves float32 values through transposes only, and the same weights on
the same CPU kernels give the same validation rows), except the load
test's clips/s, which is a wall-clock rate (see its test)."""

import argparse
import dataclasses
import http.server
import json
import os
import subprocess
import threading
import time

import jax
import numpy as np
import optax
import pytest
import torch

from scd_resnet_tpu.core.checkpoint import save_checkpoint as jax_save_checkpoint
from scd_resnet_tpu.core.config import Configuration as JaxConfiguration
from scd_resnet_tpu.core.torch_convert import (
    convert_center_net_residual,
    export_center_net_hourglass,
    export_pth_file,
)
from scd_resnet_tpu.data import synthetic as jax_synthetic
from scd_resnet_tpu.train.registry import get_model_profile as jax_profile
from scd_resnet_tpu_torch.core.checkpoint import load_state_dict, save_checkpoint
from scd_resnet_tpu_torch.core.config import Configuration
from scd_resnet_tpu_torch.data import synthetic
from scd_resnet_tpu_torch.data.labels import Marker, save_markers
from scd_resnet_tpu_torch.tools import (
    eval_checkpoint,
    export_checkpoint,
    f1_eval,
    f1_pipeline,
    loadtest,
)
from scd_resnet_tpu_torch.train import __main__ as train_cli
from scd_resnet_tpu_torch.train import registry
from tools import f1_eval as jax_f1_eval
from tools import f1_pipeline as jax_f1_pipeline
from tools import loadtest as jax_loadtest

from torch_port_common import (
    HEAD_PATHS,
    HOURGLASS_HEAD_PATHS,
    HOURGLASS_SMALL,
    SmallCenterNetHourglass,
    _randomize,
    jax_center_model,
)

RADIUS = 24.0


# -- f1_eval -------------------------------------------------------------------

def _match_cases():
    rng = np.random.default_rng(0)
    gt = rng.uniform(0, 500, (12, 2))
    pred = np.concatenate([gt[:9] + rng.normal(0, 9, (9, 2)),
                           rng.uniform(0, 500, (6, 2))])
    none = np.zeros((0, 2))
    return {
        "seeded": (pred, gt),
        "no-predictions": (none, gt),
        "no-truth": (pred, none),
        "neither": (none, none),
        # two predictions 10 px from one center, one prediction 10 px from
        # two centers: exact distance ties decide the matching
        "ties": (np.array([[10.0, 0.0], [-10.0, 0.0], [50.0, 0.0],
                           [0.0, 10.0]]),
                 np.array([[0.0, 0.0], [60.0, 0.0], [40.0, 0.0]])),
        # one pair at exactly the radius (matched), one just beyond it
        "at-radius": (np.array([[24.0, 0.0], [100.0, 24.0000001]]),
                      np.array([[0.0, 0.0], [100.0, 0.0]])),
    }


@pytest.mark.parametrize("case", list(_match_cases()))
def test_match_f1_equals_jax(case):
    pred, gt = _match_cases()[case]
    got = f1_eval.match_f1(pred, gt, RADIUS)
    assert got == jax_f1_eval.match_f1(pred, gt, RADIUS)
    if case == "at-radius":
        assert got[:3] == (1, 1, 1)


def _payload(images=True):
    dets = [{"image": "a.png", "x": 1.5, "y": 2.0, "rhr": 0.25},
            {"image": "c.png", "x": 3, "y": 4},
            {"image": "a.png", "x": 5.0, "y": 6.5, "rhr": 0.5},
            {"image": "d.png", "x": 7.0, "y": 8.0, "rhr": 0.75}]
    payload = {"detections": dets, "contract": "centerOffset"}
    if images:
        payload["images"] = ["a.png", "b.png", "c.png"]
    return payload


@pytest.mark.parametrize("with_rhr", [False, True])
@pytest.mark.parametrize("images", [True, False], ids=["images", "no-images"])
def test_group_detections_equals_jax(with_rhr, images):
    got = f1_eval.group_detections(_payload(images), with_rhr)
    assert got == jax_f1_eval.group_detections(_payload(images), with_rhr)
    assert ("b.png" in got) == images  # a slide without detections


def _annotations(path, seed, slides=3, objects=10):
    """Seeded label files ``1.txt`` .. ``{slides}.txt`` of 1200x800
    slides; returns each slide's centers."""
    rng = np.random.default_rng(seed)
    os.makedirs(path, exist_ok=True)
    centers = {}
    for i in range(1, slides + 1):
        markers = []
        for _ in range(objects):
            cx, cy = rng.uniform(60, 1140), rng.uniform(60, 740)
            dx, dy = rng.uniform(-20, 20, 2)
            markers.append(Marker(cx - dx, cy - dy, cx + dx, cy + dy,
                                  rng.uniform(8, 20), rng.uniform(14, 40)))
        save_markers(os.path.join(path, "{}.txt".format(i)), markers)
        centers[i] = [m.center for m in markers]
    return centers


def _detections(centers, rng, image_dir, skip=(), extra=()):
    """Detections near the centers (a few px off, with duplicates within
    the dedupe radii and misses), plus false positives, as the test CLI
    writes them."""
    dets, images = [], []
    for i, points in centers.items():
        image = os.path.join(image_dir, "{}.png".format(i))
        images.append(image)
        if i in skip:
            continue
        for cx, cy in points:
            if rng.uniform() < 0.1:
                continue  # a miss
            for _ in range(1 + int(rng.integers(0, 3))):
                dets.append({"image": image,
                             "x": float(cx + rng.normal(0, 5)),
                             "y": float(cy + rng.normal(0, 5)),
                             "rhr": float(rng.uniform(0.1, 1.5))})
        for _ in range(int(rng.integers(0, 4))):
            dets.append({"image": image, "x": float(rng.uniform(0, 1200)),
                         "y": float(rng.uniform(0, 800)),
                         "rhr": float(rng.uniform(0.1, 1.5))})
    for i in extra:
        images.append(os.path.join(image_dir, "{}.png".format(i)))
    return {"detections": dets, "contract": "centerOffset",
            "images": images}


def test_f1_eval_cli_equals_jax(tmp_path, capsys, monkeypatch):
    centers = _annotations(str(tmp_path / "annots"), seed=1)
    # slide 2 without detections, slide 9 without a label file
    payload = _detections(centers, np.random.default_rng(2), "/slides",
                          skip=(2,), extra=(9,))
    det_path = str(tmp_path / "dets.json")
    with open(det_path, "w") as f:
        json.dump(payload, f)
    argv = [det_path, str(tmp_path / "annots"), "--radius", "16"]
    totals = f1_eval.main(argv)
    got = capsys.readouterr().out
    monkeypatch.setattr("sys.argv", ["f1_eval.py"] + argv)
    jax_f1_eval.main()
    assert got == capsys.readouterr().out
    assert totals["fn"] >= 10 and got.count("\n") == 5
    # through the pipeline's runner: the CLI in a subprocess, its last
    # JSON line returned; a failing CLI raises
    assert f1_pipeline.run("scd_resnet_tpu_torch.tools.f1_eval",
                           *argv) == totals
    with pytest.raises(subprocess.CalledProcessError):
        f1_pipeline.run("scd_resnet_tpu_torch.tools.f1_eval",
                        str(tmp_path / "missing.json"), str(tmp_path))


# -- f1_pipeline ---------------------------------------------------------------

def _eval_root(root, agree: bool):
    """A root with held-out label files and seeded live/traced detections;
    with ``agree`` the traced ones sit within the equality bounds of the
    live ones apart from one in 1000, else one in 20 moves."""
    centers = _annotations(os.path.join(root, "test_annots"), seed=3,
                           slides=6, objects=40)
    rng = np.random.default_rng(4)
    live = _detections(centers, rng, os.path.join(root, "test_imgs"),
                       skip=(4,))
    traced = json.loads(json.dumps(live))
    for k, det in enumerate(traced["detections"]):
        det["y"] += float(rng.uniform(-0.9, 0.9))  # x keeps the sort order
        det["rhr"] += float(rng.uniform(-4e-3, 4e-3))
        if k % (1000 if agree else 20) == 7:
            det["y"] += 3.0
    traced["detections"] = traced["detections"][::-1]
    for name, payload in (("live", live), ("traced", traced)):
        with open(os.path.join(root, name + ".json"), "w") as f:
            json.dump(payload, f)


@pytest.mark.parametrize("agree", [True, False], ids=["agree", "disagree"])
def test_eval_stage_report_equals_jax(tmp_path, agree):
    root = str(tmp_path / "f1_case")
    _eval_root(root, agree)
    args = argparse.Namespace(root=root, match_radius=24.0)
    reports = {}
    for name, stage, fault in (("jax", jax_f1_pipeline.stage_eval,
                                AssertionError),
                               ("port", f1_pipeline.stage_eval,
                                RuntimeError)):
        if agree:
            stage(args)
        else:
            with pytest.raises(fault):
                stage(args)
        reports[name] = [open(os.path.join(root, f), "rb").read()
                         for f in ("report.json", "report.md")]
        for f in ("report.json", "report.md"):
            os.remove(os.path.join(root, f))
    assert reports["port"] == reports["jax"]
    report = json.loads(reports["port"][0])
    assert report["objects"] == 240 and len(report["table"]) == 10
    assert (report["equality_rate"] >= 0.995) == agree
    dedupe8 = report["table"][2]
    assert dedupe8["fp"] < report["table"][0]["fp"]  # dedupe removed some


def test_eval_stage_refuses_a_missing_detections_file(tmp_path):
    root = str(tmp_path / "f1_case")
    _eval_root(root, True)
    os.remove(os.path.join(root, "traced.json"))
    with pytest.raises(FileNotFoundError):
        f1_pipeline.main(["--root", root, "--stage", "eval"])
    assert not os.path.exists(os.path.join(root, "report.json"))


def _stage_args(root, **kw):
    values = dict(root=root, arch="centerOffsetRes10", iters=3000,
                  device="cuda", match_radius=24.0)
    values.update(kw)
    return argparse.Namespace(**values)


def test_train_and_serve_stages_match_jax(tmp_path, monkeypatch):
    """The train stage's configuration is JAX's (but for the run's name),
    every key of it reads the same in both ``Configuration``s and none is
    unknown to the port's; the serve stage runs the JAX stage's commands
    on the port's CLIs, on the snapshot the port's trainer writes."""
    root = str(tmp_path / "f1")
    img_dir = os.path.join(root, "test_imgs")
    os.makedirs(img_dir)
    for name in ("10.png", "2.png", "1.png"):
        open(os.path.join(img_dir, name), "w").close()
    args = _stage_args(root)

    commands = {"jax": [], "port": []}
    monkeypatch.setattr(jax_f1_pipeline, "run",
                        lambda cmd, **kw: commands["jax"].append(cmd[1:]))
    monkeypatch.setattr(f1_pipeline, "run",
                        lambda module, *a: commands["port"].append(
                            [module, *a]))
    jax_f1_pipeline.stage_train(args)
    with open(os.path.join(root, "f1.json")) as f:
        jax_values = json.load(f)
    f1_pipeline.stage_train(args)
    with open(os.path.join(root, "f1.json")) as f:
        port_values = json.load(f)
    assert port_values == dict(jax_values, trainName=f1_pipeline.TRAIN_NAME)
    assert commands["port"][0] == [
        "scd_resnet_tpu_torch.train", os.path.join(root, "f1.json"),
        "--device", "cuda"]

    warnings = []
    monkeypatch.setattr("scd_resnet_tpu_torch.core.config.Logger.warn",
                        warnings.append)
    port_cfg = Configuration.from_json(os.path.join(root, "f1.json"))
    jax_cfg = JaxConfiguration.from_json(os.path.join(root, "f1.json"))
    assert warnings == []
    for key in port_values:
        assert port_cfg.config[key] == jax_cfg.config[key], key
    for getter in ("totalIterations", "validationFrequency",
                   "snapshotFrequency", "learningRate", "learningRateDecay",
                   "learningRateDecayRate", "batchSize",
                   "validationBatchSize", "dirTemp", "dirResult",
                   "dirDatafile", "dirDataSplitProfile"):
        assert getattr(port_cfg, getter) == getattr(jax_cfg, getter), getter
    jax_cfg.update_iteration(3000)
    assert f1_pipeline.snapshot_path(args) == os.path.join(
        jax_cfg.dirTemp, jax_cfg.naming)

    commands["jax"].clear()
    commands["port"].clear()
    jax_f1_pipeline.stage_serve(args)
    f1_pipeline.stage_serve(args)
    slides = [os.path.join(img_dir, n) for n in ("1.png", "2.png", "10.png")]
    ckpt = f1_pipeline.snapshot_path(args)
    bundle = os.path.join(root, "f1-torch.pt2")
    assert commands["port"] == [
        ["scd_resnet_tpu_torch.test", "-c", ckpt, "-a", "centerOffsetRes10",
         "--pipelined", "--fit", "-o", os.path.join(root, "live.json"),
         "--device", "cuda", *slides],
        ["scd_resnet_tpu_torch.trace", bundle, "-a", "centerOffsetRes10",
         "-m", ckpt, "-s", "24 1 512 512", "--device", "cuda"],
        ["scd_resnet_tpu_torch.test", "-m", bundle, "-o",
         os.path.join(root, "traced.json"), "--device", "cuda", *slides]]
    # JAX's: test.py / trace.py / test.py with the same options and slides
    assert [c[0] for c in commands["jax"]] == ["test.py", "trace.py",
                                               "test.py"]
    assert commands["jax"][0][-3:] == slides and \
        commands["jax"][0][5:8] == ["--pipelined", "--fit", "-o"]
    assert commands["jax"][1][-2:] == ["-s", "24 1 512 512"]


@pytest.mark.parametrize("index, objects, seed", [(1, 40, 100), (60, 10, 5000)],
                         ids=["train", "held-out"])
def test_pipeline_slides_are_jax_bytes(tmp_path, index, objects, seed):
    """The gen stage's slides (1200x800) and label files, at the train
    set's and the held-out set's seeds, are the JAX package's bytes."""
    for module, sub in ((jax_synthetic, "jax"), (synthetic, "port")):
        module.make_slide_and_annotation(
            str(tmp_path / sub / "i"), str(tmp_path / sub / "a"), index,
            *f1_pipeline.SLIDE_SIZE, objects=objects, seed=seed)
    for rel in ("i/{}.png".format(index), "a/{}.txt".format(index)):
        assert (tmp_path / "jax" / rel).read_bytes() == \
            (tmp_path / "port" / rel).read_bytes()


# -- eval_checkpoint -----------------------------------------------------------

def _seeded_variables(model, seed, heads=()):
    """``torch_port_common.flax_variables``' seeded weights (heads' final
    convs at ``heads``), at ``model``'s init shapes traced without
    computing (``jax.eval_shape``)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            np.zeros((1, 64, 64, 1), np.float32))
    rng = np.random.default_rng(seed)
    return (_randomize(shapes["params"], rng, final_heads=heads),
            _randomize(shapes["batch_stats"], rng))


def _write_flax(path, params, stats):
    """The JAX package's msgpack checkpoint of ``params``/``stats`` (an
    Adam state at its start)."""
    jax_save_checkpoint(path, params, stats, optax.adam(1e-3).init(params), 0)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two float32 steps of the port's trainer on ``centerOffsetRes10q``,
    warm-started from seeded, well-conditioned flax weights (so that its
    heads give peaks), with a validation pass and a snapshot at step 2."""
    root = tmp_path_factory.mktemp("evalckpt")
    synthetic.make_archive(str(root / "scdx16p100.d"), num_images=2, reps=2,
                           clips_per_image=5, size=64)
    params, stats = _seeded_variables(jax_center_model(), 8, HEAD_PATHS)
    _write_flax(str(root / "warm.msgpack"), params, stats)
    values = {"datasetName": "scdx16p100", "modelName": "centerOffsetRes10q",
              "trainName": "tiny", "batchSize": 4, "validationBatchSize": 4,
              "iterations": 2, "validation": 2, "snapshot": 2,
              "learningRate": 1e-5, "pretrain": "warm.msgpack",
              "dirPretrain": str(root) + "/",
              "dirTemp": str(root / "temp") + "/",
              "dirResult": str(root / "results") + "/",
              "dirDataset": str(root) + "/"}
    config = str(root / "tiny.json")
    with open(config, "w") as f:
        json.dump(values, f)
    train_cli.main([config, "--device", "cpu"])
    with open(root / "results" / "evals.tiny.txt") as f:
        it_line = [line for line in f if line.startswith("[It]")][-1]
    return root, config, it_line.split(":", 1)[1].strip()


def test_eval_checkpoint_gives_the_trainers_line(trained, capsys):
    root, config, expression = trained
    assert "[AP50]" in expression and expression.count(" 0.00000000") < 4
    snapshot = str(root / "temp" / "centerOffsetRes10q.tiny.2.pth")
    line = eval_checkpoint.main([config, snapshot, "--device", "cpu"])
    assert line == "[It] " + expression
    assert capsys.readouterr().out.rstrip().endswith(line)

    # the same weights as the JAX package's msgpack checkpoint
    sd = load_state_dict(snapshot, "centerOffsetRes10q")
    params, stats = convert_center_net_residual(
        {k: v.numpy() for k, v in sd.items()}, num_layers=10)
    flax_path = str(root / "snapshot.msgpack")
    _write_flax(flax_path, params, stats)
    assert eval_checkpoint.main([config, flax_path, "--device", "cpu"]) \
        == line
    # the warm start's weights give another line
    assert eval_checkpoint.main([config, str(root / "warm.msgpack"),
                                 "--device", "cpu"]) != line


# -- export_checkpoint ---------------------------------------------------------

def _assert_same_file(got_path, want):
    got = torch.load(got_path, map_location="cpu", weights_only=True)
    assert set(got) == set(want)
    for key, value in want.items():
        value = torch.as_tensor(np.asarray(value))
        assert got[key].dtype == value.dtype, key
        assert torch.equal(got[key], value), key


def test_export_residual_equals_jax(tmp_path):
    params, stats = _seeded_variables(
        jax_profile("centerOffsetRes10").build(), seed=9)
    flax_path = str(tmp_path / "ckpt.msgpack")
    _write_flax(flax_path, params, stats)
    ref = export_pth_file(str(tmp_path / "ref.pth"), params, stats,
                          num_layers=10)
    want = torch.load(ref, map_location="cpu", weights_only=True)
    out = str(tmp_path / "out.pth")
    export_checkpoint.main([flax_path, out, "-a", "centerOffsetRes10"])
    _assert_same_file(out, want)
    # from the port's own checkpoint of the same weights
    port_path = save_checkpoint(
        str(tmp_path / "port.pt"), "centerOffsetRes10",
        load_state_dict(flax_path, "centerOffsetRes10"))
    export_checkpoint.main([port_path, out, "-a", "centerOffsetRes10"])
    _assert_same_file(out, want)


def test_export_small_hourglass_equals_jax(tmp_path, monkeypatch):
    base = registry.get_model_profile("centerOffsetHourglass2")
    monkeypatch.setitem(registry.MODEL_PROFILES, "centerOffsetHourglass2s",
                        dataclasses.replace(
                            base, name="centerOffsetHourglass2s",
                            model_params={**base.model_params,
                                          **HOURGLASS_SMALL}))
    params, stats = _seeded_variables(SmallCenterNetHourglass(stacks=2), 10,
                                      HOURGLASS_HEAD_PATHS)
    flax_path = str(tmp_path / "hg.msgpack")
    _write_flax(flax_path, params, stats)
    want = export_center_net_hourglass(
        params, stats, stacks=2, iterations=HOURGLASS_SMALL["iterations"],
        modules=HOURGLASS_SMALL["modules"])
    out = str(tmp_path / "hg.pth")
    export_checkpoint.main([flax_path, out, "-a", "centerOffsetHourglass2s"])
    _assert_same_file(out, want)


@pytest.mark.parametrize("arch", ["centerOffsetRes10dcn", "cornerCPoolRes10"])
def test_export_refuses_what_jax_refuses(tmp_path, monkeypatch, arch):
    out = tmp_path / "out.pth"
    with pytest.raises(SystemExit) as port_exit:
        export_checkpoint.main([str(tmp_path / "none"), str(out), "-a", arch])
    from tools import export_checkpoint as jax_export

    monkeypatch.setattr("sys.argv", ["export_checkpoint.py",
                                     str(tmp_path / "none"), str(out),
                                     "-a", arch])
    with pytest.raises(SystemExit) as jax_exit:
        jax_export.main()
    assert port_exit.value.code == jax_exit.value.code == 1
    assert not out.exists()


# -- loadtest ------------------------------------------------------------------

STUB_CLIPS = 6  # clips a stub request counts
STUB_SECONDS = 0.1  # the stub's time a request


@pytest.fixture()
def stub_daemon():
    """An ``http.server`` answering ``POST /analyse`` and ``GET /metrics``
    with the port's daemon's keys, each request taking STUB_SECONDS; it
    records each request's body and headers."""
    stats = {"requests": 0, "errors": 0, "detections": 0, "clips": 0}
    seen = []
    lock = threading.Lock()

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _json(self, payload):
            body = json.dumps(payload).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            with lock:
                self._json(dict(stats))

        def do_POST(self):
            body = self.rfile.read(int(self.headers["Content-Length"]))
            time.sleep(STUB_SECONDS)
            with lock:
                seen.append((body, dict(self.headers)))
                stats["requests"] += 1
                stats["clips"] += STUB_CLIPS
            self._json({"detections": [], "contract": "centerOffset",
                        "count": 0})

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield "http://127.0.0.1:{}".format(server.server_address[1]), seen
    server.shutdown()
    server.server_close()


@pytest.mark.parametrize("mode", ["png", "raw", "image"])
def test_loadtest_against_a_stub_daemon(stub_daemon, tmp_path, capsys,
                                        monkeypatch, mode):
    """The port's load test and the JAX tool send the same bodies and
    report the same keys; clips/s is the stub's clip count over the wall
    time (within 10 %: the printed wall time is rounded to 10 ms of about
    200 ms)."""
    url, seen = stub_daemon
    image = tmp_path / "slide.bin"
    image.write_bytes(b"slide bytes")
    extra = {"png": [], "raw": ["--raw"], "image": ["--image", str(image)]}
    argv = ["--url", url, "--width", "40", "--height", "30", "--requests",
            "5", "--concurrency", "3"] + extra[mode]
    got = loadtest.main(argv)
    assert json.loads(capsys.readouterr().out) == got
    port_seen = list(seen)
    seen.clear()
    monkeypatch.setattr("sys.argv", ["loadtest.py"] + argv)
    jax_loadtest.main()
    want = json.loads(capsys.readouterr().out)
    assert set(got) == set(want)
    assert [b for b, _ in port_seen] == [b for b, _ in seen]
    assert len(port_seen) == 6  # one priming request, then five
    for key in ("requests", "concurrency", "server_errors"):
        assert got[key] == want[key]
    assert got["clips_per_second"] == pytest.approx(
        5 * STUB_CLIPS / got["wall_seconds"], rel=0.1)
    assert got["latency_p50_ms"] >= STUB_SECONDS * 1000
    if mode == "raw":
        assert port_seen[0][1]["X-Width"] == "40"
        assert len(port_seen[0][0]) == 40 * 30
