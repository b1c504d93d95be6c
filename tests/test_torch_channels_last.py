"""The channels-last layout of a bfloat16 training step (CPU), on a
quarter-width ``centerOffsetRes10`` and ``cornerCPoolRes10`` at 64^2:

- a bfloat16 trainer lays its model out channels-last: every 4-D
  parameter, the stem's one-channel filter with channels-last strides,
  the stem's output, the gradients and Adam's moments; the hand kernels'
  boundary converts exactly the tensors ``LAYOUT_COPIES`` names (K5's
  ``x``, ``dy`` and ``dx``; each corner pool's input and output, and
  their gradients); its loss lies within bfloat16's noise of the NCHW
  step's (5e-3 relative; it reads 8.8e-5 and 9.2e-4 on 1 thread, 1.1e-4
  and 1.7e-3 on 2);
- the same channels-last step in float32 against the NCHW step, at the
  tolerances of ``tests/test_torch_train.py``: losses within 1e-4
  relative, gradients and Adam's first moment within 1e-3 G and its
  second within 1e-5 G^2, G the tensor's largest NCHW gradient, and
  BatchNorm statistics within 1e-4 relative (floor 1e-6). Each step
  starts from the state after one NCHW step, as
  ``tests/test_torch_corner_train.py`` replays from a trained state: at
  the initial weights a float32 rounding difference moves the corner
  heads' gradient by up to 1.3e-2 G (measured, either layout);
- float32 trainers and the serving wrapper stay NCHW;
- a checkpoint written after a channels-last step holds the plain
  layout, reloads to the bit into an NCHW model, through
  ``load_wrapper`` and through the reference ``.pth`` export, and a
  resumed trainer's Adam state follows its channels-last parameters.

Why bfloat16's values are held only to its noise here: on the CPU the
two layouts take kernels that round otherwise, and which ones depends on
the thread count (on 4 threads the losses agree to 1.2e-7 and 6.9e-6, on
1 to 8.8e-5 and 9.2e-4); and at this size a bfloat16 step is chaotic:
nudging the input clips by 1e-6 relative moves the NCHW step's loss by
up to 2e-3 relative and its gradients by a median 26 % of their norm
(measured). A layout fault moves the float32 step far beyond its
tolerances, which hold the channels-last arithmetic;
``tests/test_torch_ops.py`` and ``tests/test_torch_corner_ops.py`` hold
the bfloat16 conversions at the kernels' boundary to the bit.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from scd_resnet_tpu_torch.core import cuda_build
from scd_resnet_tpu_torch.core.config import Configuration
from scd_resnet_tpu_torch.data.dataset import SCDDataset
from scd_resnet_tpu_torch.data.synthetic import make_archive
from scd_resnet_tpu_torch.infer.wrapper import load_wrapper
from scd_resnet_tpu_torch.ops.layout import is_channels_last, to_memory_format
from scd_resnet_tpu_torch.tools.export_checkpoint import export_state_dict
from scd_resnet_tpu_torch.train import registry
from scd_resnet_tpu_torch.train.factory import NetworkFactory

from torch_port_common import QUARTER

ARCHS = ("centerOffsetRes10q", "cornerCPoolRes10q")
STEM = {"centerOffsetRes10q": "preprocess.0",
        "cornerCPoolRes10q": "backbone.preprocess.0"}
# tensors converted at the kernels' boundary in one step
COPIES = {"centerOffsetRes10q": {"max_pool_3x3_s2_bwd": 3},
          "cornerCPoolRes10q": {"max_pool_3x3_s2_bwd": 3,
                                "corner_pool_h": 4, "corner_pool_w": 4,
                                "corner_pool_bwd_h": 4,
                                "corner_pool_bwd_w": 4}}
BF16_LOSS_RTOL = 5e-3


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    """2 images x 2 reps x 5 clips of 64^2, and the quarter-width
    cornerCPoolRes10 in the port's registry for the module's run."""
    root = tmp_path_factory.mktemp("channels_last")
    path = str(root / "scdx16p100.d")
    make_archive(path, num_images=2, reps=2, clips_per_image=5, size=64)
    base = registry.get_model_profile("cornerCPoolRes10")
    with pytest.MonkeyPatch.context() as patch:
        patch.setitem(registry.MODEL_PROFILES, "cornerCPoolRes10q",
                      dataclasses.replace(base, name="cornerCPoolRes10q",
                                          model_params=dict(
                                              base.model_params,
                                              dims=QUARTER)))
        yield root, path


def _factory(archive, arch, precision, name="t", **extra):
    root, path = archive
    cfg = Configuration()
    cfg.update_config(dict({
        "datasetName": "scdx16p100", "modelName": arch, "trainName": name,
        "batchSize": 4, "validationBatchSize": 4, "iterations": 4,
        "validation": 2, "snapshot": 2, "learningRate": 1e-3,
        "learningRateDecay": [100], "learningRateDecayRate": [10],
        "precision": precision, "dirTemp": str(root / name) + "/",
        "dirResult": str(root / name) + "/", "dirDataset": str(root) + "/"},
        **extra))
    return NetworkFactory(cfg, dataset=SCDDataset(
        path, None, test_set=4, seed=42, device="cpu"), device="cpu")


def _nchw_strides(t):
    return torch.empty_like(t, memory_format=torch.contiguous_format).stride()


def _cl_strides(t):
    return torch.empty_like(t, memory_format=torch.channels_last).stride()


def _step(factory, batch):
    """One step; returns the loss and the tensors converted at the
    kernels' boundary, by kernel."""
    cuda_build.reset_launches()
    loss, _ = factory.train(*batch)
    return loss.item(), {k: v for k, v in cuda_build.LAYOUT_COPIES.items()
                         if v}


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_step_is_channels_last(archive, arch):
    cl = _factory(archive, arch, "bfloat16")
    nchw = _factory(archive, arch, "bfloat16")
    assert cl.memory_format == torch.channels_last
    nchw.memory_format = torch.contiguous_format
    to_memory_format(nchw.model, nchw.memory_format)
    stem = dict(cl.model.named_modules())[STEM[arch]]
    assert stem.weight.shape[1] == 1
    assert stem.weight.stride() == _cl_strides(stem.weight)
    seen = []
    stem.register_forward_hook(lambda m, i, out: seen.append(out))
    batch = next(cl.dataset.epoch_batches(4, 0))
    loss, copies = _step(cl, batch)
    want, nchw_copies = _step(nchw, batch)
    assert is_channels_last(seen[0]) and seen[0].dtype == torch.bfloat16
    assert copies == COPIES[arch] and nchw_copies == {}
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, want, rtol=BF16_LOSS_RTOL)
    for name, p in cl.model.named_parameters():
        state = cl.optimizer.state[p]
        for t in (p, p.grad, state["exp_avg"], state["exp_avg_sq"]):
            assert t.stride() == (_cl_strides(p) if p.dim() == 4
                                  else p.stride()), name


@pytest.mark.parametrize("arch", ARCHS)
def test_channels_last_step_matches_nchw(archive, arch):
    warm = _factory(archive, arch, "float32", name="warm")
    batches = list(warm.dataset.epoch_batches(4, 0))
    warm.train(*batches[0])
    start = {k: v.clone() for k, v in warm.model.state_dict().items()}
    runs = {}
    for layout in ("channels_last", "nchw"):
        factory = _factory(archive, arch, "float32", name=layout)
        factory.model.load_state_dict(start)
        if layout == "channels_last":
            factory.memory_format = torch.channels_last
            to_memory_format(factory.model, factory.memory_format)
        runs[layout] = factory, _step(factory, batches[1])
    (cl, (loss, copies)), (nchw, (want, nchw_copies)) = \
        runs["channels_last"], runs["nchw"]
    assert copies == COPIES[arch] and nchw_copies == {}
    np.testing.assert_allclose(loss, want, rtol=1e-4)
    for (name, p), q in zip(cl.model.named_parameters(),
                            nchw.model.parameters()):
        g = q.grad.abs().max().item()
        assert p.grad.stride() == p.stride(), name
        got, ref = cl.optimizer.state[p], nchw.optimizer.state[q]
        for a, b, tol in ((p.grad, q.grad, 1e-3 * g),
                          (got["exp_avg"], ref["exp_avg"], 1e-3 * g),
                          (got["exp_avg_sq"], ref["exp_avg_sq"],
                           1e-5 * g ** 2)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=tol, err_msg=name)
    ref_state = nchw.model.state_dict()
    for key, value in cl.model.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(value.numpy(), ref_state[key].numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=key)


def test_float32_trainer_and_serving_stay_nchw(archive, tmp_path):
    arch = ARCHS[0]
    factory = _factory(archive, arch, "float32")
    assert factory.memory_format == torch.contiguous_format
    for name, p in factory.model.named_parameters():
        assert p.stride() == _nchw_strides(p), name
    _, copies = _step(factory, next(factory.dataset.epoch_batches(4, 0)))
    assert copies == {}
    factory.save_parameters(str(tmp_path / "f32.pth"))
    wrapper = load_wrapper(str(tmp_path / "f32.pth"), arch, device="cpu")
    for name, p in wrapper.model.named_parameters():
        assert p.stride() == _nchw_strides(p), name


def test_checkpoint_after_a_channels_last_step_is_plain(archive, tmp_path):
    arch = ARCHS[0]
    factory = _factory(archive, arch, "bfloat16", name="ckpt")
    factory.train(*next(factory.dataset.epoch_batches(4, 0)))
    path = str(tmp_path / "cl.pth")
    factory.save_parameters(path)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    saved = [*ckpt["state_dict"].values(), *(
        v for pstate in ckpt["optimizer"]["state"].values()
        for v in pstate.values() if torch.is_tensor(v))]
    assert all(t.stride() == _nchw_strides(t) for t in saved)
    want = factory.model.state_dict()
    fresh = registry.get_model_profile(arch).build()
    fresh.load_state_dict(ckpt["state_dict"], strict=True)
    wrapper = load_wrapper(path, arch, device="cpu")
    exported = export_state_dict(path, arch)
    for state in (fresh.state_dict(), wrapper.model.state_dict(), exported):
        assert state.keys() == want.keys()
        for key, value in state.items():
            assert value.stride() == _nchw_strides(value), key
            assert torch.equal(value, want[key].cpu()), key
    reference = registry.get_model_profile(arch).build()
    reference.load_state_dict(exported, strict=True)
    # a resumed trainer: the plain file's Adam state follows its
    # channels-last parameters
    os.replace(path, factory._checkpoint_path())
    resumed = _factory(archive, arch, "bfloat16", name="ckpt")
    resumed.load_parameters()
    for name, p in resumed.model.named_parameters():
        assert p.stride() == (_cl_strides(p) if p.dim() == 4
                              else p.stride()), name
        for key in ("exp_avg", "exp_avg_sq"):
            value = resumed.optimizer.state[p][key]
            assert value.stride() == p.stride(), name
            assert torch.equal(value, factory.optimizer.state[
                dict(factory.model.named_parameters())[name]][key]), name
