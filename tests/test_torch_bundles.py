"""Traced bundles and the ``trace``/``test`` CLIs on the CPU: each
family's bundle (``infer/wrapper.save_traced``/``load_traced``) against
its live wrapper, the refusal of the JAX package's bundles, and
``python -m scd_resnet_tpu_torch.trace`` of a JAX checkpoint served by
``test -m`` and ``test -c``.

A bundle's rows are held to its live wrapper's exactly: the exported
program runs the same operators on the same weights. ``test -m`` is held
to the live host path's detections and ``test -c`` to the live device
analyzer's, exactly.
"""

import json
import zipfile

import numpy as np
import pytest
import torch
from PIL import Image

from scd_resnet_tpu_torch import test as test_cli
from scd_resnet_tpu_torch import trace as trace_cli
from scd_resnet_tpu_torch.infer import analyse
from scd_resnet_tpu_torch.infer.synthetic import synthetic_slide
from scd_resnet_tpu_torch.infer.wrapper import (
    load_traced,
    load_wrapper,
    make_wrapper,
    save_traced,
)
from scd_resnet_tpu_torch.train.registry import QUARTER, get_model_profile

from torch_port_common import (
    FAMILIES,
    HOURGLASS_SMALL,
    calibrated_variables,
    write_jax_checkpoint,
)

SLIDE = synthetic_slide(600, 700, seed=21)


# -- traced bundles -----------------------------------------------------------

BUNDLE_MODELS = {
    "centerOffset": ("centerOffsetRes10q", {}),
    "centerSize": ("centerRes10", {"dims": QUARTER}),
    "corner": ("cornerCPoolRes10", {"dims": QUARTER}),
    "cornerLegacy": ("cornerLegacyHourglass", HOURGLASS_SMALL),
    "dcn": ("centerOffsetRes10dcn", {"dims": QUARTER, "terminal_hidden": 64}),
}


@pytest.mark.parametrize("kind", sorted(BUNDLE_MODELS))
def test_bundle_round_trip(tmp_path, kind):
    """Each family's bundle reproduces its live wrapper's rows on the CPU;
    its ``meta.json`` names the contract and the torch that wrote it."""
    arch, overrides = BUNDLE_MODELS[kind]
    profile = get_model_profile(arch)
    torch.manual_seed(3)
    wrapper = make_wrapper(profile.build(**overrides), profile.family)
    path = str(tmp_path / "b.pt2")
    save_traced(path, wrapper, (2, 1, 64, 64))
    fn, shape = load_traced(path, "cpu")
    assert shape == (2, 1, 64, 64) and fn.contract == profile.family
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=shape).astype(np.float32))
    assert torch.equal(fn(x), wrapper(x))
    with zipfile.ZipFile(path) as zf:
        meta = json.loads(zf.read("meta.json"))
    assert meta["torch_version"] == torch.__version__
    assert meta["format"] == "scd-resnet-tpu-torch.traced.v1"
    assert meta["device"] == "cpu" and meta["rows"] == wrapper.rows


def test_load_traced_refuses_a_jax_bundle(tmp_path):
    path = tmp_path / "jax.pt"
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("meta.json", json.dumps({
            "format": "scd-resnet-tpu.traced.v1", "input_shape": [24, 512,
                                                                  512, 1],
            "contract": "centerOffset"}))
        zf.writestr("module.stablehlo", b"")
    with pytest.raises(ValueError, match="JAX StableHLO"):
        load_traced(str(path), "cpu")


# -- trace, then test -m and test -c --------------------------------------

@pytest.fixture(scope="module")
def slide_png(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "slide.png"
    Image.fromarray(SLIDE).save(path)
    return str(path)


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """The JAX package's checkpoint of calibrated quarter-width
    centerOffset weights for the 700x600 slide."""
    clips = analyse.make_device_tiler(700, 600, torch.device("cpu"))(
        torch.from_numpy(SLIDE))
    path = str(tmp_path_factory.mktemp("jaxckpt") / "model.pth")
    write_jax_checkpoint(path, *calibrated_variables("centerOffset", 13,
                                                     clips))
    return path


def test_trace_then_test_m_from_a_jax_checkpoint(tmp_path, slide_png,
                                                 jax_checkpoint):
    """``trace`` exports the JAX checkpoint; ``test -m`` serves the PNG with
    the bundle and writes JAX's JSON, the detections of the live
    checkpoint's host path; ``test -c`` serves it through the device
    analyzer with the same keys and ``--fit``."""
    arch = FAMILIES["centerOffset"][1]
    bundle = str(tmp_path / "b.pt2")
    trace_cli.main([bundle, "-a", arch, "-m", jax_checkpoint, "-s",
                    "4 1 512 512", "--device", "cpu", "-wrapped"])
    out = str(tmp_path / "m.json")
    result = test_cli.main([slide_png, "-m", bundle, "--device", "cpu",
                            "-o", out])
    assert json.load(open(out)) == json.loads(json.dumps(result))
    assert set(result) == {"detections", "contract", "images"}
    assert result["images"] == [slide_png]
    live = analyse.analyse_images(load_wrapper(jax_checkpoint, arch, "cpu"),
                                  slide_png, batch_size=4)
    assert [[d["x"], d["y"], d["rhr"]] for d in result["detections"]] == live
    assert all(set(d) == {"image", "x", "y", "rhr"}
               for d in result["detections"])
    fitted = test_cli.main([slide_png, slide_png, "-c", jax_checkpoint, "-a",
                            arch, "--device", "cpu", "--fit", "--pipelined",
                            "-o", str(tmp_path / "c.json")])
    assert set(fitted["gauss2"]) == {"a1", "m1", "s1", "a2", "m2", "s2"}
    device = analyse.make_device_analyzer(
        load_wrapper(jax_checkpoint, arch, "cpu"), 700, 600)(
            analyse.read_gray_u8(slide_png))
    assert [[d["image"], d["x"], d["y"], d["rhr"]]
            for d in fitted["detections"]] == \
        [[slide_png, *d] for d in device] * 2


def test_a_fit_that_does_not_converge_keeps_the_detections(
        tmp_path, slide_png, jax_checkpoint, monkeypatch):
    """scipy's curve_fit raising (no convergence within its evaluations)
    leaves ``gauss2`` null with its reason; the detections are written."""
    def no_fit(rhrs):
        raise RuntimeError("Optimal parameters not found: planted")

    monkeypatch.setattr(analyse, "fit_rhr", no_fit)
    arch = FAMILIES["centerOffset"][1]
    out = str(tmp_path / "c.json")
    result = test_cli.main([slide_png, "-c", jax_checkpoint, "-a", arch,
                            "--device", "cpu", "--fit", "-o", out])
    assert json.load(open(out)) == json.loads(json.dumps(result))
    assert result["gauss2"] is None and "planted" in result["gauss2_error"]
    assert result["detections"]


