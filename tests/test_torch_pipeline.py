"""The GPipe hourglass pipeline (``parallel/pipeline.py``) against the
JAX package's, and the trainer's ``pipe`` axis.

- ``pipeline_apply`` and ``sequential_apply`` of the trainer's stages
  (``StackStage``, views of a plain stacked hourglass's stacks) at the
  geometry of ``tests/test_pipeline_parallel.py`` (2 and 4 stages, 3
  microbatches of 2), the plain model's weights converted from JAX's and
  split into JAX's stages by its ``split_stack_variables``, as the JAX
  trainer splits them: heads and parameter gradients of sum(heads^2)
  against JAX's ``pipeline_apply`` within 1e-4 of each tensor's largest
  magnitude (float32 convolutions sum in another order in each
  framework), and the port's schedule against its own sequential loop
  bit for bit (the same operations on the same inputs);
- ``make_pipelined_stack_forward`` on a small two-stack hourglass
  (``TINY``: one hourglass level, the widths of
  ``torch_port_common.HOURGLASS_SMALL``) with 2 microbatches in train
  mode against JAX's: heads, parameter gradients and the new BatchNorm
  statistics, in float64 in both frameworks (train-mode BatchNorm
  through two hourglasses is badly conditioned in float32, as
  ``test_torch_hourglass_train.py`` found), within 1e-9 of each tensor's
  largest magnitude;
- one microbatch against the plain forward, and the trainer's pipelined
  step (``meshShape [1, 2]``, axes data x pipe, one microbatch) against
  the plain trainer's step, bit for bit; its checkpoint in the plain
  layout; the trainer's refusals, with the JAX trainer's messages.
"""

import dataclasses

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from scd_resnet_tpu.models.center_net_offset import HOURGLASS_TERMINALS
from scd_resnet_tpu.parallel import pipeline as jax_pipeline
from scd_resnet_tpu_torch.core import convert
from scd_resnet_tpu_torch.core.config import Configuration
from scd_resnet_tpu_torch.data.dataset import SCDDataset
from scd_resnet_tpu_torch.data.pipeline import draw
from scd_resnet_tpu_torch.data.synthetic import make_archive
from scd_resnet_tpu_torch.models.center_net_offset import CenterNetHourglass
from scd_resnet_tpu_torch.parallel import pipeline
from scd_resnet_tpu_torch.train import registry
from scd_resnet_tpu_torch.train.factory import NetworkFactory

from torch_port_common import (
    HOURGLASS_HEAD_PATHS,
    HOURGLASS_SMALL,
    SmallCenterNetHourglass,
    flax_variables,
    nchw,
)

# the stages' geometry (tests/test_pipeline_parallel.py's)
GEO = dict(iterations=2, dimensions=(8, 8, 16), modules=(1, 1, 1),
           prediction_dim=8)
# the pipelined detector against JAX's: one level keeps JAX's compile of
# the float64 schedule and its gradient short
TINY = dict(iterations=1, dimensions=(16, 24), modules=(1, 1),
            prediction_dim=32)
MICRO, MB = 3, 2
CPU = torch.device("cpu")


def _close(got, want, tol, what):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * scale + 1e-30, err_msg=what)


def _nhwc(t):
    return t.permute(*range(t.dim() - 3), -2, -1, -3).detach().numpy()


class _JaxStack(flax_nn.Module):
    """The JAX stacked hourglass at a given geometry, under the detector's
    ``StackHourglass_0`` scope."""

    stacks: int
    iterations: int
    dimensions: tuple
    modules: tuple
    prediction_dim: int

    @flax_nn.compact
    def __call__(self, x, train: bool = False):
        from scd_resnet_tpu.models.hourglass import StackHourglass

        return StackHourglass(
            hourglass_iterations=self.iterations, stacks=self.stacks,
            dimensions=self.dimensions, modules=self.modules,
            prediction_dim=self.prediction_dim,
            terminals=HOURGLASS_TERMINALS, pool_downsample=False)(x, train)


def _head_paths(stacks: int):
    return tuple("StackHourglass_0/{}_{}/Conv_0".format(head, s)
                 for head, _, _ in HOURGLASS_TERMINALS
                 for s in range(stacks))


def _port_stacked(params, stats, model):
    """The port model's state dict (or gradients) from a JAX
    ``StackHourglass_0`` scope, through the converter."""
    sd = {}
    convert._stacked(convert._Writer(sd, params, stats).sub(
        "StackHourglass_0"), model)
    return sd


@pytest.fixture(scope="module", params=[2, 4], ids=["2stages", "4stages"])
def stages(request):
    """A plain stacked hourglass of n stacks at ``GEO`` with seeded
    weights: JAX's stage variables split from it, the port's stages on
    the same model converted, and 3 microbatches of 2."""
    n = request.param
    params, stats = flax_variables(_JaxStack(stacks=n, **GEO), 30 + n,
                                   heads=_head_paths(n))
    model = CenterNetHourglass(stacks=n, **GEO)
    model.load_state_dict(_port_stacked(params, stats, model), strict=True)
    model.eval()
    port = [pipeline.StackStage(model, s) for s in range(n)]
    names = tuple(name for name, _, _ in HOURGLASS_TERMINALS)
    stage = jax_pipeline.HourglassPipelineStage(
        **GEO, terminals=HOURGLASS_TERMINALS, pool_downsample=False)
    rng = np.random.default_rng(40 + n)
    mbs = rng.normal(size=(MICRO, MB, 8, 8, GEO["dimensions"][0])).astype(
        np.float32)
    mesh = Mesh(np.array(jax.devices()[:n]), ("pipe",))

    def apply_fn(variables, x):
        return stage.apply(variables, x, False)

    def split(p):
        return jax_pipeline.split_stack_variables(
            {"params": p["StackHourglass_0"],
             "batch_stats": stats["StackHourglass_0"]}, n, names)[1]

    def loss(p):
        heads = jax_pipeline.pipeline_apply(apply_fn, split(p),
                                            jnp.asarray(mbs), mesh)
        return sum(jnp.sum(h ** 2) for h in
                   jax.tree_util.tree_leaves(heads)), heads

    # JAX's heads and gradients (to the plain tree, through the split)
    # through its pipeline, and its sequential loop's heads, each one
    # compile
    (_, heads), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    want_seq = jax.jit(lambda p, m: jax_pipeline.sequential_apply(
        apply_fn, split(p), m))(params, jnp.asarray(mbs))
    grads = jax.tree_util.tree_map(np.asarray, grads)
    return (n, model, port, mbs, heads, want_seq,
            _port_stacked(grads, stats, model))


def _port_run(model, port, mbs, schedule):
    model.zero_grad(set_to_none=True)
    x = torch.from_numpy(mbs).permute(0, 1, 4, 2, 3)
    if schedule == "pipeline":
        heads = pipeline.pipeline_apply(port, x, [CPU] * len(port))
    else:
        heads = pipeline.sequential_apply(port, x)
    sum((h ** 2).sum() for h in heads.values()).backward()
    # the preprocess feeds no stage: no gradient (JAX's is zero)
    return {k: h.detach() for k, h in heads.items()}, {
        k: torch.zeros_like(p) if p.grad is None else p.grad.clone()
        for k, p in model.named_parameters()}


def test_pipeline_apply_heads_match_jax(stages):
    n, model, port, mbs, want, want_seq, _ = stages
    got, _ = _port_run(model, port, mbs, "pipeline")
    seq, _ = _port_run(model, port, mbs, "sequential")
    assert got.keys() == want.keys() == want_seq.keys()
    for name, _, _ in HOURGLASS_TERMINALS:
        head = got[name]
        assert want[name].shape == want_seq[name].shape == (
            n, MICRO, MB, 8, 8, head.shape[3])
        assert head.shape[:3] == (n, MICRO, MB)
        assert torch.equal(head, seq[name]), name
        _close(_nhwc(head), want[name], 1e-4,
               name + " against pipeline_apply")
        _close(_nhwc(head), want_seq[name], 1e-4,
               name + " against sequential_apply")


def test_pipeline_apply_gradients_match_jax(stages):
    n, model, port, mbs, _, _, want = stages
    _, got = _port_run(model, port, mbs, "pipeline")
    _, seq = _port_run(model, port, mbs, "sequential")
    assert got.keys() <= want.keys()
    for s in range(n):  # every stack's hourglass has a gradient
        assert float(got["hourglassStack.{}.preserveCurrentDimension.0.conv1.weight"
                         .format(s)].abs().sum()) > 0, s
    for name, g in got.items():
        assert torch.equal(g, seq[name]), name
        _close(g.numpy(), want[name].numpy(), 1e-4, name)


# -- the trainer's pipelined forward on the plain stacked hourglass ------------

def _small_model(seed: int, dtype=torch.float32, geometry=None):
    geometry = geometry or HOURGLASS_SMALL
    jax_model = _JaxStack(stacks=2, **TINY) if geometry is TINY else \
        SmallCenterNetHourglass(stacks=2)
    params, stats = flax_variables(jax_model, seed,
                                   heads=HOURGLASS_HEAD_PATHS)
    model = CenterNetHourglass(stacks=2, **geometry)
    model.load_state_dict(_port_stacked(params, stats, model), strict=True)
    return params, stats, model.to(dtype).train()


def _heads_loss(outs):
    return sum((h.double() ** 2).sum() for out in outs for h in out.values())


def test_pipelined_stack_forward_matches_jax():
    """Two microbatches through the two stacks in train mode, float64."""
    params, stats, model = _small_model(40, torch.float64, TINY)
    xs = np.random.default_rng(41).normal(size=(4, 64, 64, 1))
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: jnp.asarray(a, jnp.float64), t)
        forward = jax_pipeline.make_pipelined_stack_forward(
            Mesh(np.array(jax.devices()[:2]), ("pipe",)), 2, 2,
            terminals=HOURGLASS_TERMINALS, dtype=jnp.float64,
            **TINY)
        p64, s64 = f64(params), f64(stats)

        def loss(p):
            o, new = forward(p, s64, jnp.asarray(xs))
            return sum(jnp.sum(h ** 2) for h in jax.tree_util.tree_leaves(
                o)), (o, new["batch_stats"])

        (_, (outs, new)), grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(p64)
        grads, outs, new = jax.tree_util.tree_map(np.asarray,
                                                  (grads, outs, new))
    port_forward = pipeline.make_pipelined_stack_forward(model, [CPU, CPU], 2)
    got = port_forward(nchw(xs).double())
    _heads_loss(got).backward()
    for s in range(2):
        for head, value in got[s].items():
            _close(_nhwc(value), outs[s][head], 1e-9,
                   "stack {} {}".format(s, head))
    grad_sd, stats_sd = {}, {}
    convert._stacked(convert._Writer(grad_sd, grads, stats).sub(
        "StackHourglass_0"), model)
    convert._stacked(convert._Writer(stats_sd, params, new).sub(
        "StackHourglass_0"), model)
    for name, p in model.named_parameters():
        _close(p.grad.numpy(), grad_sd[name].numpy(), 1e-9, name)
    state = model.state_dict()
    for key, value in stats_sd.items():
        if key.endswith(("running_mean", "running_var")):
            _close(state[key].numpy(), value.numpy(), 1e-9, key)
        elif key.endswith("num_batches_tracked"):
            # the stages' BatchNorms move once a microbatch
            moved = int(state[key])
            assert moved == (1 if key.startswith("preprocess") else 2), key


def test_one_microbatch_equals_the_plain_forward():
    _, _, plain = _small_model(42)
    _, _, piped = _small_model(42)
    x = nchw(np.random.default_rng(43).normal(size=(4, 64, 64, 1))).float()
    want = plain(x)
    got = pipeline.make_pipelined_stack_forward(piped, [CPU, CPU], 1)(x)
    _heads_loss(want).backward()
    _heads_loss(got).backward()
    for g, w in zip(got, want):
        for head in w:
            assert torch.equal(g[head], w[head]), head
    for (name, p), q in zip(plain.named_parameters(), piped.parameters()):
        assert torch.equal(p.grad, q.grad), name
    for key, value in plain.state_dict().items():
        assert torch.equal(piped.state_dict()[key], value), key


# -- the trainer --------------------------------------------------------------

@pytest.fixture(scope="module")
def small_hourglasses(tmp_path_factory):
    """Small one- and two-stack hourglass profiles in the port's
    registry for the module, and a tiny archive."""
    root = tmp_path_factory.mktemp("pipeline_train")
    path = str(root / "scdx16p100.d")
    make_archive(path, num_images=2, reps=2, clips_per_image=5, size=64)
    with pytest.MonkeyPatch.context() as patch:
        for name, base in (("hourglass1q", "centerOffsetHourglass"),
                           ("hourglass2q", "centerOffsetHourglass2")):
            profile = registry.get_model_profile(base)
            patch.setitem(registry.MODEL_PROFILES, name, dataclasses.replace(
                profile, name=name, model_params=dict(
                    profile.model_params, **HOURGLASS_SMALL)))
        yield root, path


def _factory(root, path, **extra):
    settings = {
        "datasetName": "scdx16p100", "modelName": "hourglass2q",
        "trainName": "pipe", "batchSize": 4, "validationBatchSize": 4,
        "iterations": 2, "validation": 2, "snapshot": 2,
        "learningRate": 1e-3, "residency": "host",
        "dirTemp": str(root / "temp") + "/",
        "dirResult": str(root / "results") + "/",
        "dirDataset": str(root) + "/"}
    settings.update(extra)
    cfg = Configuration()
    cfg.update_config(settings)
    dataset = SCDDataset(path, None, test_set=4, seed=42, device="cpu")
    return NetworkFactory(cfg, dataset=dataset, device="cpu")


def test_pipelined_trainer_step_equals_the_plain_step(small_hourglasses,
                                                      tmp_path):
    """``meshShape [1, 2]`` (data x pipe) with one microbatch: one step
    equals the plain trainer's to the bit (loss, parameters, statistics),
    the validation lines too, and the checkpoint loads into the plain
    model."""
    root, path = small_hourglasses
    plain = _factory(tmp_path / "plain", path)
    piped = _factory(tmp_path / "piped", path, meshShape=[1, 2],
                     meshAxes=["data", "pipe"], pipelineMicrobatches=1)
    assert piped.mesh.shape == {"data": 1, "pipe": 2}
    assert piped.pipeline_microbatches == 1
    batch = next(plain.dataset.epoch_batches(4, 0))
    draws = draw(torch.Generator().manual_seed(5), 4, 64, CPU)
    want, _ = plain.train(*batch, draws=draws)
    got, _ = piped.train(*batch, draws=draws)
    assert torch.equal(got, want)
    for key, value in plain.model.state_dict().items():
        assert torch.equal(piped.model.state_dict()[key], value), key
    assert piped._validation_lines(1) == plain._validation_lines(1)
    piped.save_parameters(str(tmp_path / "piped.ckpt"))
    model = CenterNetHourglass(stacks=2, **HOURGLASS_SMALL)
    from scd_resnet_tpu_torch.core.checkpoint import load_training_checkpoint
    model.load_state_dict(load_training_checkpoint(
        str(tmp_path / "piped.ckpt"), "hourglass2q")["state_dict"],
        strict=True)


def test_pipelined_trainer_microbatches_train(small_hourglasses, tmp_path):
    """Two microbatches: a finite loss, and the stages' statistics moved
    once a microbatch."""
    root, path = small_hourglasses
    piped = _factory(tmp_path, path, meshShape=[1, 2],
                     meshAxes=["data", "pipe"])
    assert piped.pipeline_microbatches == 4  # 2 x pipe by default
    loss, _ = piped.train(*next(piped.dataset.epoch_batches(4, 0)))
    assert torch.isfinite(loss)
    tracked = piped.model.hourglassStack[1].preserveCurrentDimension[0] \
        .bn1.num_batches_tracked
    assert int(tracked) == 4


@pytest.mark.parametrize("arch,extra,match", [
    ("centerOffsetRes10q", {}, "no stack boundary to cut at"),
    ("hourglass1q", {}, r"must equal the model's stack count \(1\)"),
    ("hourglass2q", {"pipelineMicrobatches": 3},
     "must split into 3 microbatches"),
], ids=["not_a_hourglass", "stack_count", "microbatches"])
def test_pipelined_trainer_refusals(small_hourglasses, tmp_path, arch, extra,
                                    match):
    root, path = small_hourglasses
    with pytest.raises(ValueError, match=match):
        _factory(tmp_path, path, modelName=arch, meshShape=[1, 2],
                 meshAxes=["data", "pipe"], **extra)
