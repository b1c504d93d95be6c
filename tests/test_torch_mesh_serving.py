"""Mesh serving on the CPU: ``make_device_analyzer(..., mesh=[...])``
shards a slide's clips over a list of devices (the JAX analyzer's
``data`` mesh axis), here two or more entries of ``"cpu"``.

- real weights: the 700x600 slide (4 clips, 2 a shard) through
  calibrated quarter-width centerOffset and corner models gives the
  monolithic analyzer's detections exactly (on these shapes the CPU's
  float32 forward of a clip does not depend on its batch; on the card a
  shard of at least 24 is what makes that hold);
- a wrapper whose rows are a function of a few pixels of each clip
  (batch-independent by construction) on a 15-clip slide over 2, 3 and
  4 shards: the padding to a multiple of the mesh, the padding of each
  shard to 24, the order of the shards and the cut to the slide's clips
  are exact, with dedupe, ``many`` and ``dispatch``/``finish``;
- a slide of fewer than 24 clips reaches the monolithic analyzer's
  wrapper as one batch of 24, as each mesh shard does, with the mesh's
  detections, and a slide off a multiple of the batch as the next
  multiple; and the mesh queues every shard's copy to its device
  before the first shard's forward (on the card a copy between cards
  waits for the source card's queue);
- the refusals: streaming with a mesh (the JAX analyzer's error), and
  the CLIs' ``--mesh`` errors.
"""

import numpy as np
import pytest
import torch

from scd_resnet_tpu_torch import serve as serve_cli
from scd_resnet_tpu_torch import test as test_cli
from scd_resnet_tpu_torch.infer import analyse
from scd_resnet_tpu_torch.infer.server import InferenceService
from scd_resnet_tpu_torch.infer.synthetic import synthetic_slide
from scd_resnet_tpu_torch.infer.wrapper import make_wrapper

from torch_port_common import calibrated_variables, port_model

SLIDE = synthetic_slide(600, 700, seed=21)


class PixelRows:
    """A fake centerOffset wrapper: rows (10, B, 100) from two pixels of
    each clip, each clip's rows independent of its batch; it records the
    size of every batch it runs."""

    contract = "centerOffset"
    device = torch.device("cpu")

    def __init__(self):
        self.batches = []

    def __call__(self, clips):
        self.batches.append(clips.shape[0])
        a = clips[:, 0, 100, 200].double()
        b = clips[:, 0, 300, 57].double()
        rows = torch.zeros((10, clips.shape[0], 100), dtype=torch.float32)
        rows[0, :, 0] = (torch.sigmoid(a) * 0.5 + 0.4).float()
        rows[2, :, 0] = (10.0 + 20 * torch.sigmoid(b)).float()
        rows[3, :, 0] = (20.0 - 10 * torch.sigmoid(a)).float()
        rows[6, :, 0] = 2.0
        rows[7, :, 0] = 6.0
        rows[8, :, 0] = a.float()
        rows[9, :, 0] = -b.float()
        return rows


@pytest.mark.parametrize("family", ["centerOffset", "corner"])
def test_mesh_detections_equal_monolithic(family, monkeypatch):
    """Shards of 2 clips run as they are (``BATCH_SIZE`` patched to 2:
    the padding to 24 is the pixel wrapper's test below, and 48 clip
    forwards of a quarter-width model would cost the CPU tens of
    seconds)."""
    monkeypatch.setattr(analyse, "BATCH_SIZE", 2)
    clips = analyse.make_device_tiler(700, 600, torch.device("cpu"))(
        torch.from_numpy(SLIDE))
    params, stats = calibrated_variables(family, 13, clips)
    wrapper = make_wrapper(port_model(family, params, stats), family)
    want = analyse.make_device_analyzer(wrapper, 700, 600)(SLIDE)
    got = analyse.make_device_analyzer(wrapper, 700, 600,
                                       mesh=["cpu", "cpu"])(SLIDE)
    assert len(want) > 20
    assert got == want


@pytest.mark.parametrize("shards", [2, 3, 4])
def test_mesh_shards_pad_and_cut_exactly(shards):
    rng = np.random.default_rng(5)
    gray = np.round(rng.uniform(0.0, 255.0, (900, 1700))).astype(np.uint8)
    other = np.ascontiguousarray(gray[:, ::-1])
    model = PixelRows()
    mono = analyse.make_device_analyzer(model, 1700, 900, dedupe_radius=16.0)
    want, want_other = mono(gray), mono(other)
    assert len(want) > 0 and want_other != want
    mesh = analyse.make_device_analyzer(model, 1700, 900, dedupe_radius=16.0,
                                        mesh=["cpu"] * shards)
    model.batches.clear()
    assert mesh(gray) == want
    assert model.batches == [analyse.BATCH_SIZE] * shards  # 15 clips
    assert mesh.many(iter([gray, other])) == [want, want_other]
    assert mesh.finish(mesh.dispatch(other)) == want_other


@pytest.mark.parametrize("width,height,batch,seen,shards", [
    (1024, 768, 24, [24], [24, 24]),
    (1700, 900, 4, [16], [8, 8]),
], ids=["6_clips", "15_clips_batch_4"])
def test_a_slide_runs_padded_to_a_multiple_of_the_batch(width, height,
                                                        batch, seen, shards,
                                                        monkeypatch):
    """A 1024x768 slide (3 x 2 clips): the monolithic analyzer's wrapper
    sees one batch of ``BATCH_SIZE`` (24), as each shard of a mesh of
    two does; a 1700x900 slide (5 x 3 clips) with the batch at 4, one
    batch of 16, and shards of 8. Mesh and monolithic detections are
    equal."""
    monkeypatch.setattr(analyse, "BATCH_SIZE", batch)
    gray = np.round(np.random.default_rng(6).uniform(
        0.0, 255.0, (height, width))).astype(np.uint8)
    model = PixelRows()
    mono = analyse.make_device_analyzer(model, width, height,
                                        dedupe_radius=16.0)
    want = mono(gray)
    assert len(want) > 0
    assert model.batches == seen
    mesh = analyse.make_device_analyzer(model, width, height,
                                        dedupe_radius=16.0,
                                        mesh=["cpu", "cpu"])
    model.batches.clear()
    assert mesh(gray) == want
    assert model.batches == shards


def test_mesh_queues_every_copy_before_the_first_forward(monkeypatch):
    """Over ``["cpu", "cpu"]`` (15 clips, 8 a shard): both shards' copies
    to their devices come before the first forward, in the order the
    calls reach ``Tensor.to`` and the wrapper."""
    events = []

    class Recording(PixelRows):
        def __call__(self, clips):
            events.append(("forward", clips.shape[0]))
            return super().__call__(clips)

    gray = np.round(np.random.default_rng(5).uniform(
        0.0, 255.0, (900, 1700))).astype(np.uint8)
    mesh = analyse.make_device_analyzer(Recording(), 1700, 900,
                                        mesh=["cpu", "cpu"])
    to = torch.Tensor.to

    def recording_to(self, *args, **kwargs):
        if isinstance(args[0] if args else kwargs.get("device"),
                      (str, torch.device)):
            events.append(("copy", self.shape[0]))
        return to(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "to", recording_to)
    rows = mesh.dispatch(gray)
    monkeypatch.undo()
    assert events == [("copy", 8), ("copy", 8), ("forward", 24),
                      ("forward", 24)]
    assert len(mesh.finish(rows)) > 0


def test_mesh_refuses_streaming():
    model = PixelRows()
    with pytest.raises(ValueError, match="max_resident_clips and mesh are "
                                         "mutually exclusive"):
        analyse.make_device_analyzer(model, 1700, 900, mesh=["cpu", "cpu"],
                                     max_resident_clips=7)
    # a slide that fits the bound streams nothing, as in the JAX analyzer
    analyse.make_device_analyzer(model, 1700, 900, mesh=["cpu", "cpu"],
                                 max_resident_clips=15)


def test_service_reports_its_mesh():
    model = PixelRows()
    plain = InferenceService(model)
    service = InferenceService(model, mesh=["cpu", "cpu"])
    assert plain.health()["mesh"] is None
    health = service.health()
    assert health["mesh"] == str({"data": 2}) and health["devices"] == ["cpu"]
    assert service.analyse_gray(SLIDE) == plain.analyse_gray(SLIDE)


@pytest.mark.parametrize("argv,message", [
    (["-m", "b.pt2", "--mesh"], "--mesh requires -c"),
    (["-c", "x.pt", "--mesh", "--max-resident-clips", "4"],
     "--mesh/--pipelined hold more in flight"),
    (["-c", "x.pt", "--mesh", "--device", "cpu"], "excludes --device cpu"),
], ids=["no_checkpoint", "streaming", "cpu"])
def test_test_cli_mesh_errors(argv, message, capsys):
    with pytest.raises(SystemExit):
        test_cli.main(["slide.png", *argv])
    assert message in capsys.readouterr().err


def test_serve_cli_mesh_errors(capsys):
    with pytest.raises(SystemExit):
        serve_cli.parse_args(["-c", "x.pt", "--mesh", "--device", "cpu"])
    assert "excludes --device cpu" in capsys.readouterr().err
    assert serve_cli.parse_args(["-c", "x.pt", "--mesh"]).mesh
