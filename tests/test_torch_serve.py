"""The port's serving entry points on the CPU: the HTTP daemon
(/analyse with PNG and raw bytes, /healthz, /metrics, /warmup), the
``serve`` CLI's refusal to start without CUDA unless ``--device cpu``,
and subprocesses that block ``jax``, ``flax``, ``optax`` and
``scd_resnet_tpu`` (and the root ``tools``) and still import the port
(``trace``, ``test``, the msgpack reader, the parallel layer and the
tools of ``scd_resnet_tpu_torch/tools`` among its modules), serve a
clip, preprocess a small slide through ``python -m
scd_resnet_tpu_torch.preprocess`` and read it back through the host
library (with its build cache, packer and grayscale), build
``DCNPooling``, score fixture
detections with ``tools/f1_eval`` and the F1 pipeline's eval stage, and
train
through ``python -m scd_resnet_tpu_torch.train`` (the legacy CornerNet
with remat among the models)."""

import io
import json
import os
import subprocess
import sys
import textwrap
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from scd_resnet_tpu_torch.core.checkpoint import save_checkpoint
from scd_resnet_tpu_torch.infer.server import InferenceService, create_server
from scd_resnet_tpu_torch.infer.wrapper import make_wrapper
from scd_resnet_tpu_torch.models.center_net_offset import CenterNetResidual
from scd_resnet_tpu_torch import serve

import torch_port_common  # noqa: F401  (the CPU-thread rule)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = (8, 8, 16, 32, 64, 32, 32, 32)


def _tiny_wrapper():
    torch.manual_seed(0)
    return make_wrapper(CenterNetResidual(10, TINY, terminal_hidden=16),
                        "centerOffset")


@pytest.fixture(scope="module")
def server_url():
    httpd = create_server(InferenceService(_tiny_wrapper()), "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield "http://127.0.0.1:{}".format(httpd.server_address[1])
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=30)


def _get(url):
    with urllib.request.urlopen(url, timeout=300) as resp:
        return json.loads(resp.read())


def _post(url, data, headers=None):
    req = urllib.request.Request(url, data=data, method="POST",
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def test_http_analyse_health_metrics(server_url):
    from PIL import Image

    slide = np.random.default_rng(0).integers(0, 255, (600, 700), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(slide).save(buf, format="PNG")
    status, png = _post(server_url + "/analyse", buf.getvalue())
    assert status == 200 and png["contract"] == "centerOffset"
    assert png["count"] == len(png["detections"])
    for det in png["detections"]:
        assert set(det) == {"x", "y", "rhr"}
        assert 0 <= det["x"] < 700 and 0 <= det["y"] < 600

    status, raw = _post(server_url + "/analyse?dedupe=16", slide.tobytes(), {
        "Content-Type": "application/octet-stream",
        "X-Width": "700", "X-Height": "600"})
    assert status == 200 and raw["count"] <= png["count"]
    status, bad = _post(server_url + "/analyse", slide.tobytes()[:-1], {
        "Content-Type": "application/octet-stream",
        "X-Width": "700", "X-Height": "600"})
    assert status == 400

    status, warm = _post(server_url + "/warmup?width=512&height=512", b"")
    assert status == 200 and warm["compiled_seconds"] > 0
    health = _get(server_url + "/healthz")
    assert health["status"] == "ok" and health["devices"] == ["cpu"]
    assert set(health["geometries"]) == {"700x600", "512x512"}
    metrics = _get(server_url + "/metrics")
    assert metrics["requests"] == 2 and metrics["errors"] == 0
    assert metrics["clips"] == 8 and metrics["compiles"] == 2
    assert metrics["clips_per_second"] > 0


def test_serve_cli_needs_cuda_unless_cpu(tmp_path, monkeypatch):
    path = save_checkpoint(str(tmp_path / "q.pt"), "centerOffsetRes10q",
                           CenterNetResidual(10, (16, 16, 32, 64, 128, 64,
                                                  64, 64), 64).state_dict())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["-c", path, "-a", "centerOffsetRes10q"])
    args = serve.parse_args(["-c", path, "-a", "centerOffsetRes10q",
                             "--device", "cpu", "--warmup", "512x512"])
    service = serve.build_service(args)
    assert service.health()["geometries"] == ["512x512"]
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.deterministic


BLOCK = textwrap.dedent("""
    import importlib.abc, sys

    BLOCKED = ("jax", "jaxlib", "flax", "optax", "scd_resnet_tpu", "tools")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked import: " + name)
            return None

    sys.meta_path.insert(0, Block())
""")

LEAK_CHECK = textwrap.dedent("""
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not leaked, leaked
""")

SERVE_BLOCKED = BLOCK + textwrap.dedent("""
    import numpy as np
    import torch
    from scd_resnet_tpu_torch import serve, test, trace
    from scd_resnet_tpu_torch.core import msgpack
    from scd_resnet_tpu_torch.infer.server import InferenceService
    from scd_resnet_tpu_torch.parallel import collectives, mesh, pipeline
    from scd_resnet_tpu_torch.infer.wrapper import make_wrapper
    from scd_resnet_tpu_torch.train.registry import get_model_profile

    torch.manual_seed(0)
    wrapper = make_wrapper(get_model_profile("cornerCPoolRes10").build(),
                           "corner")
    slide = np.random.default_rng(0).integers(0, 255, (512, 512), np.uint8)
    # the slide's one clip as a batch of one: padded to BATCH_SIZE, the
    # CPU would run 23 blank clips' full-width forwards
    from scd_resnet_tpu_torch.infer import analyse
    analyse.BATCH_SIZE = 1
    detections = InferenceService(wrapper).analyse_gray(slide)
    assert msgpack.unpackb(b"\\x81\\xa1a\\x01") == {"a": 1}

    # the preprocessing CLI on a small slide, and DCNPooling
    import contextlib, io, json, os, runpy, tempfile, zipfile
    REPO = os.getcwd()
    from scd_resnet_tpu_torch.data.synthetic import make_slide_and_annotation
    from scd_resnet_tpu_torch.models.deformable import DCNPooling
    root = tempfile.mkdtemp()
    make_slide_and_annotation(root + "/i", root + "/a", 1, width=200,
                              height=120, objects=3)
    sys.argv = ["preprocess", root + "/out.d", "-i", root + "/i", "-a",
                root + "/a", "-s", "64", "-m", "28 4 28 4", "--device",
                "cpu"]
    with contextlib.redirect_stdout(io.StringIO()):
        runpy.run_module("scd_resnet_tpu_torch.preprocess",
                         run_name="__main__")
    assert len(zipfile.ZipFile(root + "/out.d").namelist()) == 2 * 128 + 2
    # the host input layer: its build cache, reader, packer and grayscale
    from scd_resnet_tpu_torch.core import compile_cache
    from scd_resnet_tpu_torch.data import native_io
    from scd_resnet_tpu_torch.data.archive import read_archive
    from scd_resnet_tpu_torch.ops.image import grayscale_inference_u8
    assert compile_cache.enable_compilation_cache().startswith(REPO)
    names, clips, _, _ = read_archive(root + "/out.d")
    assert len(names) == 128 and np.array_equal(
        native_io.gather_batch(clips, np.arange(3)), clips[:3])
    assert grayscale_inference_u8(np.zeros((2, 2, 3), np.uint8)).sum() == 0
    pooled = DCNPooling(2, pooled_size=3, group_size=3, deform_fc_dim=8)(
        torch.randn(1, 18, 16, 16), torch.tensor([[0.0, 4, 4, 40, 50]]))
    assert pooled.shape == (1, 2, 3, 3)

    # the F1 tools and the label tools; f1_eval and the pipeline's eval
    # stage on fixture files
    from scd_resnet_tpu_torch.data import labels
    from scd_resnet_tpu_torch.tools import (
        eval_checkpoint, export_checkpoint, f1_eval, f1_pipeline,
        label_server, label_tool, loadtest)
    f1 = root + "/f1"
    os.makedirs(f1 + "/test_annots")
    labels.save_markers(f1 + "/test_annots/1.txt",
                        [labels.Marker(90, 100, 110, 100, 10, 20),
                         labels.Marker(300, 200, 320, 210, 10, 20)])
    labels.save_markers(f1 + "/test_annots/2.txt",
                        [labels.Marker(50, 50, 60, 60, 10, 20)])
    dets = {"detections": [{"image": f1 + "/test_imgs/1.png", "x": 101.0,
                            "y": 99.0, "rhr": 0.5}],
            "contract": "centerOffset",
            "images": [f1 + "/test_imgs/1.png", f1 + "/test_imgs/2.png"]}
    for name in ("live", "traced"):
        with open(f1 + "/" + name + ".json", "w") as f:
            json.dump(dets, f)
    with contextlib.redirect_stdout(io.StringIO()):
        totals = f1_eval.main([f1 + "/live.json", f1 + "/test_annots"])
        f1_pipeline.main(["--root", f1, "--stage", "eval", "--device",
                          "cpu"])
    assert (totals["tp"], totals["fp"], totals["fn"]) == (1, 0, 2)
    with open(f1 + "/report.json") as f:
        report = json.load(f)
    assert report["equality_rate"] == 1.0 and report["objects"] == 3
""") + LEAK_CHECK + 'print("served", len(detections))\n'

# python -m scd_resnet_tpu_torch.train <tiny config> --device cpu, for a
# centerOffset, a corner-pool and a DCN model (quarter width) and a
# two-stack legacy CornerNet under remat (the small hourglass geometry),
# registered here
TRAIN_ARCHS = ("centerOffsetRes10q", "cornerCPoolRes10q",
               "centerOffsetRes10dcnq", "cornerLegacyHourglassq")
TRAIN_BLOCKED = BLOCK + textwrap.dedent("""
    import dataclasses, json, os, runpy
    from scd_resnet_tpu_torch.data.synthetic import make_archive
    from scd_resnet_tpu_torch.train import registry

    registry.MODEL_PROFILES["cornerCPoolRes10q"] = dataclasses.replace(
        registry.get_model_profile("cornerCPoolRes10"),
        name="cornerCPoolRes10q",
        model_params={"num_layers": 10, "dims": registry.QUARTER})
    registry.MODEL_PROFILES["centerOffsetRes10dcnq"] = dataclasses.replace(
        registry.get_model_profile("centerOffsetRes10dcn"),
        name="centerOffsetRes10dcnq",
        model_params={"num_layers": 10, "dims": registry.QUARTER,
                      "terminal_hidden": 64, "dcn": True})
    registry.MODEL_PROFILES["cornerLegacyHourglassq"] = dataclasses.replace(
        registry.get_model_profile("cornerLegacyHourglass"),
        name="cornerLegacyHourglassq",
        model_params={"categories": 1, "stacks": 2, "iterations": 2,
                      "dimensions": (16, 24, 32), "modules": (1, 1, 1),
                      "prediction_dim": 32})
    root = sys.argv[1]
    make_archive(os.path.join(root, "scdx16p100.d"), num_images=2, reps=1,
                 clips_per_image=8, size=64)
    for arch in sys.argv[2:]:
        config = os.path.join(root, arch + ".json")
        with open(config, "w") as f:
            json.dump({"datasetName": "scdx16p100", "modelName": arch,
                       "trainName": arch, "batchSize": 4,
                       "validationBatchSize": 4, "iterations": 2,
                       "validation": 2, "snapshot": 2,
                       "remat": arch.startswith("cornerLegacy"),
                       "dirTemp": os.path.join(root, "temp/"),
                       "dirResult": os.path.join(root, "results/"),
                       "dirDataset": root + "/"}, f)
        sys.argv = ["scd_resnet_tpu_torch.train", config, "--device", "cpu"]
        runpy.run_module("scd_resnet_tpu_torch.train", run_name="__main__")
""") + LEAK_CHECK + 'print("trained")\n'


def _run_blocked(script, *args):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script, *args], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_port_imports_no_jax():
    assert _run_blocked(SERVE_BLOCKED).startswith("served ")


def test_train_entry_point_imports_no_jax(tmp_path):
    out = _run_blocked(TRAIN_BLOCKED, str(tmp_path), *TRAIN_ARCHS)
    assert out.rstrip().endswith("trained")
    for arch in TRAIN_ARCHS:
        assert (tmp_path / "results" / "losses.{}.2.txt".format(arch)).exists()
