"""The port's annotation files and label tools against the JAX package's
(CPU): ``data/labels`` (markers, the load/save round trip to the byte,
the validation messages, the overlay to the bit), ``tools/label_tool``
(its output and overlay PNG equal to the root tool's) and
``tools/label_server`` (the HTTP cases of ``tests/test_label_server.py``
against the port's server). Every comparison is exact: both sides run
the same float64 arithmetic, string formats and PIL calls."""

import dataclasses

import numpy as np
import pytest
from PIL import Image

from scd_resnet_tpu.data import labels as jax_labels
from scd_resnet_tpu_torch.data import labels
from scd_resnet_tpu_torch.tools import label_server, label_tool
from tools import label_tool as jax_label_tool

# the HTTP cases of the JAX server's tests, run here against the port's
# server through this module's ``server`` fixture
from test_label_server import (  # noqa: F401
    test_image_bytes_and_tiff_transcode,
    test_marker_roundtrip,
    test_page_and_listing,
    test_rejects_path_traversal_and_bad_payload,
    test_save_reports_validation_problems,
)

import torch_port_common  # noqa: F401  (the CPU-thread rule)


def _rows(seed: int, n: int = 12):
    """Seeded marker fields: positions with many decimals, some
    degenerate axes, zero or negative widths and halos, endpoints out of
    a 60x40 image."""
    rng = np.random.default_rng(seed)
    rows = rng.uniform(-10.0, 70.0, (n, 6))
    rows[:, 4:] = rng.uniform(-2.0, 20.0, (n, 2))
    rows[1, 2:4] = rows[1, 0:2]  # zero-length axis
    rows[2, 4] = 0.0
    rows[3, 5] = -1.5
    return [tuple(float(v) for v in row) for row in rows]


def test_marker_geometry_equals_jax():
    for row in _rows(0) + [(1.0, 2.0, 3.0, 4.0, 0.0, 5.0)]:
        got, want = labels.Marker(*row), jax_labels.Marker(*row)
        assert got.center == want.center
        assert got.major_length == want.major_length
        assert got.rhr == want.rhr
        assert dataclasses.astuple(got.swap_ends()) == \
            dataclasses.astuple(want.swap_ends())


def test_save_load_round_trip_to_the_byte(tmp_path):
    rows = _rows(1)
    labels.save_markers(str(tmp_path / "port.txt"),
                        [labels.Marker(*r) for r in rows])
    jax_labels.save_markers(str(tmp_path / "jax.txt"),
                            [jax_labels.Marker(*r) for r in rows])
    text = (tmp_path / "port.txt").read_bytes()
    assert text == (tmp_path / "jax.txt").read_bytes()
    # a file with short and blank lines, as the GUI may leave them
    (tmp_path / "raw.txt").write_text(
        "1.5;2.25;30;31.125;6;12\n\n 1;2 \n" + text.decode())
    got = labels.load_markers(str(tmp_path / "raw.txt"))
    want = jax_labels.load_markers(str(tmp_path / "raw.txt"))
    assert [dataclasses.astuple(m) for m in got] == \
        [dataclasses.astuple(m) for m in want]
    assert len(got) == len(rows) + 1
    labels.save_markers(str(tmp_path / "again.txt"), got[1:])
    assert (tmp_path / "again.txt").read_bytes() == text


@pytest.mark.parametrize("size", [None, (60, 40)], ids=["no-size", "60x40"])
def test_validate_messages_equal_jax(size):
    rows = _rows(2)
    size = size or (None, None)
    got = labels.validate_markers([labels.Marker(*r) for r in rows], *size)
    want = jax_labels.validate_markers(
        [jax_labels.Marker(*r) for r in rows], *size)
    assert got == want and len(got) >= 3


@pytest.mark.parametrize("channels", [1, 3], ids=["gray", "rgb"])
def test_render_overlay_bit_equal_to_jax(channels):
    rng = np.random.default_rng(3)
    shape = (40, 60) if channels == 1 else (40, 60, 3)
    image = rng.integers(0, 256, shape).astype(np.float32) * 1.1 - 10
    rows = [r for r in _rows(4) if r[4] > 0 and r[5] > 0]
    got = labels.render_overlay(image, [labels.Marker(*r) for r in rows])
    want = jax_labels.render_overlay(image,
                                     [jax_labels.Marker(*r) for r in rows])
    assert got.dtype == np.uint8 and got.shape == (40, 60, 3)
    np.testing.assert_array_equal(got, want)
    assert (got != np.clip(np.stack([image] * 3, -1) if channels == 1
                           else image, 0, 255).astype(np.uint8)).any()


@pytest.fixture()
def folder(tmp_path):
    """Four images: two with clean label files, one whose file has
    problems, and one without a label file."""
    imgs, annots = tmp_path / "imgs", tmp_path / "annots"
    imgs.mkdir()
    annots.mkdir()
    rng = np.random.default_rng(5)
    for name in ("1.png", "2.png", "3.png", "4.png"):
        Image.fromarray(rng.integers(0, 255, (40, 60), np.uint8)).save(
            str(imgs / name))
    labels.save_markers(str(annots / "1.txt"),
                        [labels.Marker(10.0, 12.0, 30.0, 32.0, 8.0, 14.0)])
    labels.save_markers(str(annots / "2.txt"),
                        [labels.Marker(*r) for r in _rows(6, 5)])
    labels.save_markers(str(annots / "3.txt"),
                        [labels.Marker(*r) for r in _rows(7)
                         if r[4] > 0 and r[5] > 0])
    (annots / "notes.md").write_text("not a label file")
    return imgs, annots


@pytest.mark.parametrize("command", [
    ["validate", "{annots}"], ["validate", "{annots}", "-i", "{imgs}"],
    ["stats", "{annots}"], ["stats", "{empty}"],
    ["overlay", "{imgs}/3.png", "{annots}/3.txt", "{out}"]],
    ids=["validate", "validate-sized", "stats", "stats-empty", "overlay"])
def test_label_tool_output_equals_jax(folder, tmp_path, capsys, monkeypatch,
                                      command):
    imgs, annots = folder
    (tmp_path / "empty").mkdir()
    outputs = {}
    for name, tool in (("port", label_tool.main), ("jax", None)):
        argv = [a.format(imgs=imgs, annots=annots, empty=tmp_path / "empty",
                         out=tmp_path / "{}.png".format(name))
                for a in command]
        if tool is None:
            monkeypatch.setattr("sys.argv", ["label_tool.py"] + argv)
            jax_label_tool.main()
        else:
            tool(argv)
        outputs[name] = capsys.readouterr().out.replace(
            str(tmp_path / "{}.png".format(name)), "OUT")
    assert outputs["port"] == outputs["jax"] and outputs["port"]
    if command[0] == "overlay":
        assert (tmp_path / "port.png").read_bytes() == \
            (tmp_path / "jax.png").read_bytes()


@pytest.fixture()
def server(tmp_path):
    """The port's label server on the folder ``tests/test_label_server.py``
    builds for the JAX one."""
    imgs = tmp_path / "imgs"
    annots = tmp_path / "annots"
    imgs.mkdir()
    annots.mkdir()
    rng = np.random.default_rng(0)
    for name in ("1.png", "2.png"):
        Image.fromarray(
            rng.integers(0, 255, (40, 60), np.uint8)).save(str(imgs / name))
    Image.fromarray(
        rng.integers(0, 255, (40, 60), np.uint8)).save(str(imgs / "3.tif"))
    labels.save_markers(str(annots / "1.txt"),
                        [labels.Marker(10.0, 12.0, 30.0, 32.0, 8.0, 14.0)])
    srv, port = label_server.serve_background(str(imgs), str(annots))
    yield f"http://127.0.0.1:{port}", annots
    srv.shutdown()
    srv.server_close()


def test_label_server_page_is_the_jax_page():
    from tools import label_server as jax_label_server

    assert label_server.PAGE == jax_label_server.PAGE
