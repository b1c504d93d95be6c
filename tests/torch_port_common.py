"""Shared fixtures for the PyTorch port's tests: small JAX models with
seeded, well-conditioned weights, and their port counterparts.

Every weight is drawn with numpy from a seed and handed to both sides:
conv and deconv kernels N(0, 1/fan_in), conv biases N(0, 0.1),
BatchNorm scale/var U(0.5, 1.5) and bias/mean N(0, 0.1) — so each
parameter's mapping shows in the outputs. The heads' final 1x1 convs
get bias 0 and kernels N(0, 4/fan_in) made zero-mean over their input
channels, so the ReLU'd hidden features' common mode does not push the
map to one side (the training init's -2.19 bias gives a flat 0.1 map
and no detections).

For a whole slide, ``calibrated_variables`` then rescales each heat
head's final conv so that its logits over the slide's clips have
standard deviation 2 and their 99.7th percentile sits at the 0.3
serving threshold: a few dozen distinct peaks per clip pass the
threshold, well inside top-100, with score gaps far above float32
rounding, so both frameworks rank them alike. (Plain N(0, 1) kernels on
these O(1) features saturate the sigmoid to exactly 1.0, and the ties
order differently under ``torch.topk`` and ``lax.top_k``.)

Importing this module sets the port tests' one CPU-thread rule: torch
takes this process's share of the cores (``os.cpu_count()`` over
pytest-xdist's worker count), and child processes get the same through
``OMP_NUM_THREADS`` unless the environment already sets it. Torch's
default of a thread a core, in each of the suite's workers side by side,
oversubscribes the cores many times over, while a file run alone keeps
every core."""

from __future__ import annotations

import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import torch

THREADS = max(1, (os.cpu_count() or 1)
              // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
torch.set_num_threads(THREADS)
os.environ.setdefault("OMP_NUM_THREADS", str(THREADS))

QUARTER = (16, 16, 32, 64, 128, 64, 64, 64)
# the stacked hourglasses' small test geometry, as keyword arguments of
# the port's CenterNetHourglass and CornerNetLegacy
HOURGLASS_SMALL = {"iterations": 2, "dimensions": (16, 24, 32),
                   "modules": (1, 1, 1), "prediction_dim": 32}
# flax paths of the hourglass heads' final 1x1 convs (two stacks)
HOURGLASS_HEAD_PATHS = tuple(
    "StackHourglass_0/{}_{}/Conv_0".format(head, s)
    for head in ("heatmap", "regr", "offset") for s in (0, 1))
LEGACY_HEAD_PATHS = tuple("{}_{}/{}".format(corner, s, head)
                          for corner in ("tl", "br") for s in (0, 1)
                          for head in ("heat", "tag", "regr"))


class SmallCenterNetHourglass(nn.Module):
    """The JAX ``CenterNetHourglass`` at ``HOURGLASS_SMALL``: the JAX
    model fixes its geometry in constants, so the tests wrap its
    ``StackHourglass`` the same way at a smaller one."""

    stacks: int = 1
    compute_dtype: str = "float32"
    remat: bool = False

    @nn.compact
    def __call__(self, x, train: bool = False):
        from scd_resnet_tpu.models.center_net_offset import HOURGLASS_TERMINALS
        from scd_resnet_tpu.models.hourglass import StackHourglass

        return StackHourglass(
            hourglass_iterations=HOURGLASS_SMALL["iterations"],
            stacks=self.stacks, dimensions=HOURGLASS_SMALL["dimensions"],
            modules=HOURGLASS_SMALL["modules"],
            prediction_dim=HOURGLASS_SMALL["prediction_dim"],
            terminals=HOURGLASS_TERMINALS, pool_downsample=False,
            remat=self.remat, dtype=jnp.dtype(self.compute_dtype))(x, train)


def jax_small_legacy(**kw):
    """The JAX ``CornerNetLegacy`` at ``HOURGLASS_SMALL``."""
    from scd_resnet_tpu.models.corner_net_legacy import CornerNetLegacy

    return CornerNetLegacy(**HOURGLASS_SMALL, **kw)
# flax paths of the heads' final 1x1 convs in both model trees
HEAD_PATHS = ("ResNetBackbone_0/heatmap/Conv_1", "ResNetBackbone_0/regr/Conv_1",
              "ResNetBackbone_0/offset/Conv_1", "Conv_1", "tl_head/Conv_1",
              "br_head/Conv_1")


def _randomize(tree, rng, path="", final_heads=()):
    out = {}
    for key, value in tree.items():
        sub = "{}/{}".format(path, key) if path else key
        if isinstance(value, dict) or hasattr(value, "items"):
            out[key] = _randomize(value, rng, sub, final_heads)
            continue
        shape = np.shape(value)
        head = sub.rsplit("/", 1)[0] in final_heads
        if key == "kernel":
            arr = rng.normal(0.0, 1.0 / np.sqrt(np.prod(shape[:-1])), shape)
            if head:  # zero-mean over input channels, twice the spread
                arr = 2.0 * (arr - arr.mean(axis=-2, keepdims=True))
        elif key == "bias" and head:
            arr = np.zeros(shape)
        elif key in ("scale", "var"):
            arr = rng.uniform(0.5, 1.5, shape)
        else:  # conv/BN bias, BN mean
            arr = rng.normal(0.0, 0.1, shape)
        out[key] = arr.astype(np.float32)
    return out


def flax_variables(model, seed: int, heads=HEAD_PATHS):
    """(params, batch_stats) numpy trees for ``model``, drawn from
    ``seed`` (head finals at ``heads`` as the module says)."""
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1)),
                           train=False)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    rng = np.random.default_rng(seed)
    params = _randomize(variables["params"], rng, final_heads=heads)
    stats = _randomize(variables["batch_stats"], rng)
    return params, stats


def jax_center_model():
    from scd_resnet_tpu.models.center_net_offset import CenterNetResidual

    return CenterNetResidual(num_layers=10, dims=QUARTER, terminal_hidden=64)


def jax_corner_model():
    from scd_resnet_tpu.models.corner_net import CornerNetCPoolResidual

    return CornerNetCPoolResidual(num_layers=10, dims=QUARTER)


# family -> (JAX model factory, port arch whose converter applies)
FAMILIES = {
    "centerOffset": (jax_center_model, "centerOffsetRes10q"),
    "corner": (jax_corner_model, "cornerCPoolRes10"),
}


def port_model(family: str, params, stats):
    """The port model of ``family`` at quarter width with the flax
    weights converted in (CPU, eval mode)."""
    from scd_resnet_tpu_torch.core.convert import state_dict_from_flax
    from scd_resnet_tpu_torch.models.center_net_offset import CenterNetResidual
    from scd_resnet_tpu_torch.models.corner_net import CornerNetCPoolResidual

    if family == "centerOffset":
        model = CenterNetResidual(10, QUARTER, terminal_hidden=64)
    else:
        model = CornerNetCPoolResidual(10, QUARTER)
    sd = state_dict_from_flax(FAMILIES[family][1], params, stats)
    model.load_state_dict(sd, strict=True)
    return model.eval()


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(a).transpose(0, 3, 1, 2)))


# family -> (flax path of each heat head's final conv, port head name)
HEAT_HEADS = {
    "centerOffset": [("ResNetBackbone_0/heatmap/Conv_1", "heatmap")],
    "corner": [("Conv_1", "heatmap"), ("tl_head/Conv_1", "tl"),
               ("br_head/Conv_1", "br")],
}


def calibrated_variables(family: str, seed: int, clips: torch.Tensor):
    """``flax_variables`` for ``family`` with each heat head's final conv
    rescaled on ``clips`` (N, 1, 512, 512) as the module docstring says."""
    params, stats = flax_variables(FAMILIES[family][0](), seed)
    with torch.inference_mode():
        outs = port_model(family, params, stats)(clips)
    for path, head in HEAT_HEADS[family]:
        z = outs[head].double().flatten().numpy()  # bias is 0 here
        scale = 2.0 / z.std()
        node = params
        for part in path.split("/"):
            node = node[part]
        node["kernel"] = (node["kernel"] * scale).astype(np.float32)
        bias = np.log(0.3 / 0.7) - scale * np.percentile(z, 99.7)
        node["bias"] = np.full_like(node["bias"], bias)
    return params, stats


def jax_draws(key, b: int, s: int):
    """The JAX batch transform's own random draws for ``key``
    (``scd_resnet_tpu/data/pipeline.py:64-86``: split(4) -> two fair
    coins, a jitter and a noise field), as the port's ``Draws``."""
    from scd_resnet_tpu_torch.data.pipeline import Draws

    k_fliph, k_flipv, k_jit, k_noise = jax.random.split(key, 4)
    return Draws(*(torch.from_numpy(np.array(a)) for a in (
        jax.random.bernoulli(k_fliph, 0.5, (b,)),
        jax.random.bernoulli(k_flipv, 0.5, (b,)),
        jax.random.normal(k_jit, (b, 1, 1)),
        jax.random.normal(k_noise, (b, s, s)))))


def write_jax_checkpoint(path: str, params, stats) -> None:
    """The JAX package's checkpoint of ``params``/``stats`` with a real
    optax Adam state (one update of a constant gradient), at step 1."""
    import optax

    from scd_resnet_tpu.core.checkpoint import save_checkpoint

    adam = optax.adam(1e-3)
    tree = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = adam.init(tree)
    grads = jax.tree_util.tree_map(lambda p: jnp.full_like(p, 0.01), tree)
    _, opt_state = jax.jit(adam.update)(grads, opt_state)
    save_checkpoint(path, params, stats, opt_state, 1)
