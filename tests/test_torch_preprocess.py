"""The port's offline preprocessing (``scd_resnet_tpu_torch/data/
preprocess.py`` and ``python -m scd_resnet_tpu_torch.preprocess``)
against the JAX package's on the same slides, on the CPU.

Two seeded 200x120 slides with -s 64 and margins '28 4 28 4' (as
tests/test_preprocess_cli.py runs the JAX CLI) give 2 x 16 x 8 clips.
The archives are compared four ways:
- member names in order, ``dataset.json`` and ``object-count.json``:
  equal;
- locs: within 1e-4 heatmap cells (float32 records rotated with cos and
  sin an ulp apart, at coordinates of a few tens of cells);
- samples: within ``ops/augment.rotation_tolerance`` of the padded slide
  (derived there from one ulp of cos and sin, the roundings of the source
  coordinates and the slide's largest neighbour difference);
- an object within 1e-4 cells of a clip edge may fall into the
  neighbouring clip: the test lists every such object (none with these
  seeds) and checks that each one that moved was that close to an edge.
"""

import io
import json
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch
from PIL import Image

from scd_resnet_tpu.data import preprocess as jprep
from scd_resnet_tpu.data import synthetic as jsyn
from scd_resnet_tpu.data.archive import read_archive as jax_read_archive
from scd_resnet_tpu_torch import preprocess as cli
from scd_resnet_tpu_torch.data import preprocess as tprep
from scd_resnet_tpu_torch.data import synthetic as tsyn
from scd_resnet_tpu_torch.data.archive import read_archive
from scd_resnet_tpu_torch.ops.augment import rotation_tolerance
from scd_resnet_tpu_torch.ops.image import grayscale_preprocess

import torch_port_common  # noqa: F401  (the CPU-thread rule)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, MARGIN = 64, [28, 4, 28, 4]
LOC_TOL = 1e-4


@pytest.fixture(scope="module")
def slides(tmp_path_factory):
    root = tmp_path_factory.mktemp("slides")
    for i in (1, 2):
        tsyn.make_slide_and_annotation(str(root / "imgs"), str(root / "ann"),
                                       i, width=200, height=120, objects=5,
                                       seed=7)
    return root


def _settings(root, out):
    return {"inputImage": str(root / "imgs"), "annotation": str(root / "ann"),
            "destinationSize": SIZE, "margin": list(MARGIN),
            "outputPath": str(out)}


@pytest.fixture(scope="module")
def archives(slides):
    """(JAX's archive, the port's) from the same slides."""
    out = {}
    for name, module, kw in (("jax", jprep, {}),
                             ("port", tprep, {"device": "cpu"})):
        path = slides / "{}.d".format(name)
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
            module.generate_archive(_settings(slides, path),
                                    ["1.png", "2.png"], zf, **kw)
        out[name] = zipfile.ZipFile(path)
    yield out["jax"], out["port"]
    for zf in out.values():
        zf.close()


def test_slide_and_labels_are_the_same_bytes(tmp_path):
    for module, sub in ((jsyn, "jax"), (tsyn, "port")):
        module.make_slide_and_annotation(str(tmp_path / sub / "i"),
                                         str(tmp_path / sub / "a"), 3,
                                         width=150, height=130, objects=4,
                                         seed=11)
    for rel in ("i/3.png", "a/3.txt"):
        assert (tmp_path / "jax" / rel).read_bytes() == \
            (tmp_path / "port" / rel).read_bytes()


def test_decode_and_mirrors_equal_jax(slides):
    ann = str(slides / "ann")
    got = tprep.decode_annotations(ann, "1.png")
    assert got == jprep.decode_annotations(ann, "1.png") and len(got) == 5
    assert tprep.decode_annotations(ann, "9.png") is None
    assert tprep._replicate_mirrors(got, 200, 120) == \
        jprep._replicate_mirrors(got, 200, 120)


def test_grayscale_equals_jax():
    from scd_resnet_tpu.ops.image import grayscale_preprocess as jgray

    rgb = np.random.default_rng(0).integers(0, 256, (7, 9, 3), np.uint8)
    np.testing.assert_array_equal(grayscale_preprocess(rgb), jgray(rgb))


def _npy(zf, name):
    return np.load(io.BytesIO(zf.read(name)))


def _near_edge(rec):
    """Is a record's pixel position within LOC_TOL cells of a clip edge?"""
    full = rec[:2] * 4 + rec[2:4]
    gap = np.abs(full - np.round(full / SIZE) * SIZE)
    return bool((gap <= 4 * LOC_TOL).any())


def test_archive_matches_jax(archives, slides):
    jz, tz = archives
    assert jz.namelist() == tz.namelist()
    assert jz.read("dataset.json") == tz.read("dataset.json")
    jcount = json.loads(jz.read("object-count.json"))
    tcount = json.loads(tz.read("object-count.json"))
    names = json.loads(jz.read("dataset.json"))["names"]
    assert len(names) == 2 * 16 * 8

    bound = max(
        rotation_tolerance(torch.from_numpy(np.pad(grayscale_preprocess(
            np.asarray(Image.open(slides / "imgs" / f))),
            ((MARGIN[1], MARGIN[3]), (MARGIN[0], MARGIN[2])),
            mode="reflect").astype(np.float32)), 15.0)
        for f in ("1.png", "2.png"))
    worst_sample, worst_loc, moved = 0.0, 0.0, []
    for name in names:
        js, ts = (_npy(z, "samples/" + name) for z in (jz, tz))
        assert js.shape == ts.shape == (SIZE, SIZE)
        worst_sample = max(worst_sample, float(np.abs(js - ts).max()))
        jl, tl = (_npy(z, "locs/" + name) for z in (jz, tz))
        if jl.shape == tl.shape:
            if jl.size:
                worst_loc = max(worst_loc, float(np.abs(jl - tl).max()))
            continue
        # an object changed clips: every record of one side missing from
        # the other must sit at a clip edge
        for rec in np.concatenate([jl, tl]):
            if not (np.abs(jl - rec).max(1) <= LOC_TOL).any() or \
                    not (np.abs(tl - rec).max(1) <= LOC_TOL).any():
                assert _near_edge(rec), (name, rec)
                moved.append((name, rec.tolist()))
    print("objects that changed clips:", moved)
    assert worst_sample <= bound, (worst_sample, bound)
    assert worst_loc <= LOC_TOL, worst_loc
    moved_keys = {"{}.{}".format(n.split(".")[0], n.split(".")[2])
                  for n, _ in moved}
    assert {k: v for k, v in jcount.items() if k not in moved_keys} == \
        {k: v for k, v in tcount.items() if k not in moved_keys}
    assert sum(jcount.values()) > 0


def test_misfit_margin_raises_jax_message(slides, tmp_path):
    messages = []
    for module, kw in ((jprep, {}), (tprep, {"device": "cpu"})):
        settings = dict(_settings(slides, tmp_path / "bad.d"),
                        margin=[10, 10, 10, 10])
        with zipfile.ZipFile(tmp_path / "bad.d", "w") as zf:
            with pytest.raises(ValueError) as err:
                module.generate_archive(settings, ["1.png"], zf, **kw)
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    assert "cannot fit the destination size" in messages[1]


def test_cli_needs_a_card_unless_cpu(slides, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [str(tmp_path / "x.d"), "-i", str(slides / "imgs"), "-a",
            str(slides / "ann"), "-s", str(SIZE), "-m", "28 4 28 4"]
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(argv)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(argv + ["-gpu"])
    assert not (tmp_path / "x.d").exists()


def test_cli_writes_an_archive_both_readers_read(slides, tmp_path, archives):
    out = tmp_path / "cli.d"
    proc = subprocess.run(
        [sys.executable, "-m", "scd_resnet_tpu_torch.preprocess", str(out),
         "-i", str(slides / "imgs"), "-a", str(slides / "ann"), "-s",
         str(SIZE), "-m", "28 4 28 4", "-v", "-p",
         "datasets.preprocessor.scdManual", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["slides"] == 2 and summary["clips"] == 256
    assert summary["device"] == "cpu"
    with zipfile.ZipFile(out) as zf:
        assert zf.namelist() == archives[1].namelist()
        assert all(i.compress_type == zipfile.ZIP_DEFLATED
                   for i in zf.infolist())
    names, samples, locs, counts = read_archive(str(out))
    jnames, jsamples, jlocs, jcounts = jax_read_archive(str(out))[:4]
    assert names == jnames and len(names) == 256
    np.testing.assert_array_equal(samples, jsamples)
    np.testing.assert_array_equal(locs, jlocs)
    np.testing.assert_array_equal(counts, jcounts)
    # -v: one overlay a clip of the first rotation, 8 clips a slide
    overlays = sorted(os.listdir(str(out) + ".debug"))
    assert len(overlays) == 16
    assert overlays[0].endswith(".png") and ".0." in overlays[0]
