"""The rest of slide serving against the JAX package on the CPU: host
tiling, column bands and streaming, ``analyse.many``, the msgpack reader
of the JAX trainer's checkpoints and the ``trace``/``test`` CLIs'
refusals (the bundles themselves: ``tests/test_torch_bundles.py``).

Tolerances, each with its reason:
- host clips, band pixels and band plans equal to the bit: the same
  numpy arithmetic on both sides;
- the port's device tiler against its host tiler within 1e-4, the
  account ``tests/test_infer.py`` gives of the JAX package's two paths
  (the host standardises in float32 numpy, the device from exact integer
  moments);
- the host path with real weights against JAX's: detections in the same
  number, order and place, Rhr within 1e-4 absolute plus 1e-3 relative
  (``tests/test_torch_slice.py`` gives the reason);
- streamed against monolithic, ``many`` against one slide at a time, a
  JAX checkpoint against flax's reader: exactly equal;
- a slide of fewer clips than the batch, run padded to it by the device
  analyzer, against the host path and JAX's: as the host path against
  JAX's (the device tiler standardises within 1e-4 of the host's).

The streaming tests use a wrapper whose rows are a function of a few
pixels of each clip, so that any pixel or ordering fault changes the
detections, and a clip's rows do not depend on its batch (a float32
convolution's do, on the CPU as on the card).
"""

import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from scd_resnet_tpu.core.checkpoint import load_params_only
from scd_resnet_tpu.infer import analyse as jax_analyse
from scd_resnet_tpu.infer.wrapper import make_wrapper as jax_make_wrapper
from scd_resnet_tpu_torch import test as test_cli
from scd_resnet_tpu_torch import trace as trace_cli
from scd_resnet_tpu_torch.core import msgpack
from scd_resnet_tpu_torch.core.checkpoint import (
    checkpoint_kind,
    load_flax_params,
    save_checkpoint,
)
from scd_resnet_tpu_torch.infer import analyse
from scd_resnet_tpu_torch.infer.synthetic import synthetic_slide
from scd_resnet_tpu_torch.infer.wrapper import load_wrapper, make_wrapper

from torch_port_common import (
    FAMILIES,
    calibrated_variables,
    flax_variables,
    port_model,
    write_jax_checkpoint,
)

SLIDE = synthetic_slide(600, 700, seed=21)


class PixelRows:
    """A fake wrapper: centerOffset rows (10, B, 100) from a few pixels of
    each clip, batch by batch independent; it records each batch's size."""

    contract = "centerOffset"
    device = torch.device("cpu")

    def __init__(self):
        self.batches = []

    def __call__(self, clips):
        self.batches.append(clips.shape[0])
        with torch.inference_mode():
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


# -- host tiling and bands --------------------------------------------------

def test_tile_slide_matches_jax_to_the_bit():
    gray = SLIDE.astype(np.float32)
    got, ref = analyse.tile_slide(gray), jax_analyse.tile_slide(gray)
    assert got[1:] == ref[1:]
    np.testing.assert_array_equal(got[0], ref[0])


def test_device_tiler_against_host_tiler():
    host = analyse.tile_slide(SLIDE.astype(np.float32))[0]
    device = analyse.make_device_tiler(700, 600, torch.device("cpu"))(
        torch.from_numpy(SLIDE)).numpy()[:, 0]
    np.testing.assert_allclose(device, host, rtol=0, atol=1e-4)


def test_standardize_u8_does_not_depend_on_the_batch():
    clips = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (6, 512, 512), dtype=np.uint8))
    clips[3] = 77  # a constant clip maps to zeros
    whole = analyse.standardize_u8(clips)
    assert torch.equal(whole[3], torch.zeros(512, 512))
    for i in range(6):
        assert torch.equal(analyse.standardize_u8(clips[i:i + 1])[0], whole[i])


@pytest.mark.parametrize("memmap", [False, True], ids=["array", "memmap"])
def test_bands_match_jax(tmp_path, memmap):
    """Band plans equal JAX's; every band's pixels equal the full padded
    slide's and JAX's band (``tests/test_infer.py``'s cases), from an
    ``np.memmap`` slide too."""
    gray = np.random.default_rng(11).integers(0, 255, (900, 1700)).astype(
        np.uint8)
    if memmap:
        np.save(tmp_path / "g.npy", gray)
        gray = np.load(tmp_path / "g.npy", mmap_mode="r")
    clip_h, clip_v, pad_lr, pad_tb = analyse.slide_geometry(1700, 900)
    full = analyse.pad_reflect_hybrid(np.asarray(gray), pad_lr, pad_tb)
    for max_clips in (1, clip_v, 2 * clip_v + 1, 5 * clip_v, 100):
        plan = analyse.band_plan(clip_h, clip_v, max_clips)
        assert plan == jax_analyse.band_plan(clip_h, clip_v, max_clips)
        for x0, n_cols in plan:
            band = analyse.extract_padded_band(gray, x0, n_cols, pad_lr,
                                               pad_tb)
            np.testing.assert_array_equal(band, full[
                :, x0 * analyse.STRIDE: x0 * analyse.STRIDE
                + (n_cols - 1) * analyse.STRIDE + analyse.INPUT_SIZE])
            np.testing.assert_array_equal(band, jax_analyse.extract_padded_band(
                gray, x0, n_cols, pad_lr, pad_tb))


def test_host_path_streaming_matches_monolithic(tmp_path):
    """``max_resident_clips`` leaves the host path's detections as they
    are, from an array and from an ``np.memmap`` slide."""
    gray = np.random.default_rng(3).uniform(0.0, 255.0, (1200, 3600)).astype(
        np.float32)
    model = PixelRows()
    want = analyse.analyse_grayscale(model, gray, bounds="slide")
    assert len(want) > 0
    for max_clips in (3, 7, 9):  # one-column floor, mid, remainder band
        assert analyse.analyse_grayscale(model, gray, bounds="slide",
                                         max_resident_clips=max_clips) == want
    np.save(tmp_path / "g.npy", gray)
    mm = np.load(tmp_path / "g.npy", mmap_mode="r")
    assert analyse.analyse_grayscale(model, mm, bounds="slide",
                                     max_resident_clips=7) == want


def test_device_analyzer_streaming_and_many():
    """The device analyzer streamed (5 x 3 clips in bands of 1, 2 and 3
    columns, each run padded to the batch of 24) gives the monolithic
    detections, dedupe included; ``many`` equals one slide at a time in
    both modes, and so does ``finish(dispatch(...))``."""
    rng = np.random.default_rng(5)
    gray = np.round(rng.uniform(0.0, 255.0, (900, 1700))).astype(np.uint8)
    other = np.ascontiguousarray(gray[:, ::-1])
    model = PixelRows()
    mono = analyse.make_device_analyzer(model, 1700, 900, dedupe_radius=16.0)
    want, want_other = mono(gray), mono(other)
    assert len(want) > 0 and want_other != want
    assert mono.many(iter([gray, other])) == [want, want_other]
    assert mono.finish(mono.dispatch(gray)) == want
    for max_clips in (3, 7, 9):
        streamed = analyse.make_device_analyzer(
            model, 1700, 900, dedupe_radius=16.0,
            max_resident_clips=max_clips)
        model.batches.clear()
        assert streamed(gray) == want
        assert model.batches == [analyse.BATCH_SIZE] * len(
            analyse.band_plan(5, 3, max_clips))
        assert streamed.many([gray, other]) == [want, want_other]
    assert streamed.finish(streamed.dispatch(gray)) == want


@pytest.fixture(scope="module")
def center_weights():
    """Calibrated quarter-width centerOffset weights (flax trees) for the
    700x600 slide."""
    clips = analyse.make_device_tiler(700, 600, torch.device("cpu"))(
        torch.from_numpy(SLIDE))
    return calibrated_variables("centerOffset", 13, clips)


def test_host_path_matches_jax(center_weights):
    """``analyse_grayscale`` monolithic and streamed (batch 4, bands of 2
    clips padded to it) on the same weights as JAX's."""
    params, stats = center_weights
    gray = SLIDE.astype(np.float32)
    jax_wrapper = jax.jit(jax_make_wrapper(FAMILIES["centerOffset"][0](),
                                           params, stats))
    ref = jax_analyse.analyse_grayscale(lambda b: jax_wrapper(b), gray,
                                        batch_size=4, bounds="slide",
                                        contract="centerOffset")
    wrapper = make_wrapper(port_model("centerOffset", params, stats),
                           "centerOffset")
    got = analyse.analyse_grayscale(wrapper, gray, batch_size=4,
                                    bounds="slide")
    streamed = analyse.analyse_grayscale(wrapper, gray, batch_size=4,
                                         bounds="slide", max_resident_clips=2)
    assert streamed == got
    assert len(got) == len(ref) >= 40
    assert [d[:2] for d in got] == [d[:2] for d in ref]
    got_rhr, ref_rhr = np.array([d[2] for d in got]), np.array(
        [d[2] for d in ref])
    finite = np.isfinite(ref_rhr)
    np.testing.assert_array_equal(np.isfinite(got_rhr), finite)
    np.testing.assert_allclose(got_rhr[finite], ref_rhr[finite], rtol=1e-3,
                               atol=1e-4)


class RecordingWrapper:
    """A wrapper that records the size of every batch it runs."""

    def __init__(self, inner):
        self.inner, self.batches = inner, []
        self.contract, self.device = inner.contract, inner.device

    def __call__(self, clips):
        self.batches.append(clips.shape[0])
        return self.inner(clips)


def _assert_detections_close(got, ref):
    """Same number, order and positions; Rhr within 1e-4 + 1e-3 rel."""
    assert len(got) == len(ref) >= 40
    assert [d[:2] for d in got] == [d[:2] for d in ref]
    got_rhr, ref_rhr = np.array([d[2] for d in got]), np.array(
        [d[2] for d in ref])
    finite = np.isfinite(ref_rhr)
    np.testing.assert_array_equal(np.isfinite(got_rhr), finite)
    np.testing.assert_allclose(got_rhr[finite], ref_rhr[finite], rtol=1e-3,
                               atol=1e-4)


def test_small_slide_runs_padded_like_the_host_path_and_jax(center_weights,
                                                           monkeypatch):
    """The 700x600 slide's 4 clips, with the batch at 6 (24 quarter-width
    clip forwards a path would cost the CPU tens of seconds): the device
    analyzer's wrapper sees one batch of 6, and its detections are the
    host path's and JAX's host path's at the same batch."""
    monkeypatch.setattr(analyse, "BATCH_SIZE", 6)
    params, stats = center_weights
    gray = SLIDE.astype(np.float32)
    wrapper = RecordingWrapper(make_wrapper(
        port_model("centerOffset", params, stats), "centerOffset"))
    got = analyse.make_device_analyzer(wrapper, 700, 600)(SLIDE)
    assert wrapper.batches == [6]
    host = analyse.analyse_grayscale(wrapper, gray, batch_size=6,
                                     bounds="slide")
    jax_wrapper = jax.jit(jax_make_wrapper(FAMILIES["centerOffset"][0](),
                                           params, stats))
    ref = jax_analyse.analyse_grayscale(lambda b: jax_wrapper(b), gray,
                                        batch_size=6, bounds="slide",
                                        contract="centerOffset")
    _assert_detections_close(got, host)
    _assert_detections_close(got, ref)


# -- the JAX trainer's checkpoints ------------------------------------------

@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory, center_weights):
    """A quarter-width centerOffset checkpoint written by the JAX
    package's ``save_checkpoint``, with a real optax Adam state."""
    path = str(tmp_path_factory.mktemp("jaxckpt") / "model.pth")
    write_jax_checkpoint(path, *center_weights)
    return path


def _assert_trees_equal(got, want, where=""):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for key in want:
            _assert_trees_equal(got[key], want[key], where + "/" + key)
    else:
        want = np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, where
        np.testing.assert_array_equal(got, want, err_msg=where)


def test_msgpack_reader_reads_jax_checkpoint_bit_for_bit(jax_checkpoint):
    params, stats = load_flax_params(jax_checkpoint)
    want_params, want_stats = load_params_only(jax_checkpoint)
    _assert_trees_equal(params, want_params)
    _assert_trees_equal(stats, want_stats)
    with open(jax_checkpoint, "rb") as f:
        raw = msgpack.unpackb(f.read())
    assert raw["step"] == 1 and set(raw) == {"params", "batch_stats",
                                             "opt_state", "step"}
    assert checkpoint_kind(jax_checkpoint) == "flax"


def test_jax_checkpoint_serves_like_the_converter(jax_checkpoint,
                                                  center_weights):
    arch = FAMILIES["centerOffset"][1]
    wrapper = load_wrapper(jax_checkpoint, arch, device="cpu")
    ref = make_wrapper(port_model("centerOffset", *center_weights),
                       "centerOffset")
    clips = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 1, 64, 64)).astype(np.float32))
    assert torch.equal(wrapper(clips), ref(clips))


def test_msgpack_reader_refuses_what_it_cannot_read(tmp_path, jax_checkpoint):
    from flax import serialization

    # bfloat16 reads as float32, exactly
    blob = serialization.to_bytes({"a": jnp.asarray([1.5, -2.25],
                                                    jnp.bfloat16)})
    np.testing.assert_array_equal(msgpack.unpackb(blob)["a"],
                                  np.array([1.5, -2.25], np.float32))
    # an unknown ext code (fixext 1, code 9)
    with pytest.raises(ValueError, match="ext code 9"):
        msgpack.unpackb(b"\x81\xa1a\xd4\x09\x00")
    # a flax chunked array
    with pytest.raises(ValueError, match="chunked"):
        msgpack.unpackb(b"\x81\xb9__msgpack_chunked_array__\xc3")
    # a truncated checkpoint
    data = open(jax_checkpoint, "rb").read()
    cut = tmp_path / "cut.pth"
    cut.write_bytes(data[: len(data) // 2])
    with pytest.raises(ValueError, match="truncated"):
        load_flax_params(str(cut))
    # neither kind of file
    junk = tmp_path / "junk.pth"
    junk.write_bytes(b"GIF89a....")
    with pytest.raises(ValueError, match="junk.pth"):
        load_wrapper(str(junk), "centerOffsetRes10q", device="cpu")


def test_checkpoint_kinds(tmp_path):
    sd = {"w": torch.ones(2)}
    torch.save(sd, tmp_path / "zip.pt")
    torch.save(sd, tmp_path / "legacy.pt", _use_new_zipfile_serialization=False)
    assert checkpoint_kind(str(tmp_path / "zip.pt")) == "torch"
    assert checkpoint_kind(str(tmp_path / "legacy.pt")) == "torch"


# -- the CLIs -------------------------------------------------------------------

@pytest.fixture(scope="module")
def slide_png(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "slide.png"
    Image.fromarray(SLIDE).save(path)
    return str(path)


def test_test_cli_argument_errors(tmp_path, slide_png, capsys):
    """The JAX CLI's refusals; ``--fit`` without the centerOffset contract
    is refused before a checkpoint, a bundle or a slide is read (neither
    file below exists but the bundle's ``meta.json``)."""
    ckpt = str(tmp_path / "missing.pt")
    refused = [
        [slide_png],  # neither -m nor -c
        [slide_png, "-m", "b.pt2", "-c", ckpt],  # both
        [slide_png, "-m", "b.pt2", "--pipelined"],  # --pipelined needs -c
        [slide_png, "-c", ckpt, "--pipelined", "--max-resident-clips", "4"],
    ]
    for argv in refused:
        with pytest.raises(SystemExit):
            test_cli.main(argv + ["--device", "cpu"])
    bundle = tmp_path / "size.pt2"
    with zipfile.ZipFile(bundle, "w") as zf:
        zf.writestr("meta.json", json.dumps({
            "format": "scd-resnet-tpu-torch.traced.v1",
            "contract": "centerSize"}))
    for source in (["-c", ckpt, "-a", "centerRes10"], ["-m", str(bundle)]):
        with pytest.raises(SystemExit):
            test_cli.main(["missing.png", *source, "--fit", "--device",
                           "cpu"])
        assert "--fit needs the Rhr row" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        trace_cli.main([str(tmp_path / "x.pt2"), "-a", "centerRes10", "-m",
                        slide_png, "-s", "4 3 512 512", "--device", "cpu"])


def test_entry_points_refuse_without_cuda(tmp_path, slide_png, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ckpt = save_checkpoint(str(tmp_path / "c.pt"), "centerOffsetRes10q",
                           port_model("centerOffset", *flax_variables(
                               FAMILIES["centerOffset"][0](), 1)).state_dict())
    with pytest.raises(RuntimeError, match="CUDA"):
        test_cli.main([slide_png, "-c", ckpt, "-a", "centerOffsetRes10q"])
    with pytest.raises(RuntimeError, match="CUDA"):
        trace_cli.main([str(tmp_path / "b.pt2"), "-a", "centerOffsetRes10q",
                        "-m", ckpt, "-s", "4 1 512 512"])
