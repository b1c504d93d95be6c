"""The stacked hourglass against the JAX package (CPU, float32): the
pre-ResNet ``Residual``, the residual stacks, the recursive
``Hourglass`` and the 1- and 2-stack center detector at a small
geometry (64^2 inputs, 2 iterations, widths 16/24/32, one module a
level, prediction width 32) from the same seeded flax weights; the
converter key for key at the production geometry and against the
reference exporter; remat against no remat; the float32 heads under
autocast; and the deeper ResNet profiles that share
``models/resnet.py``.

Tolerances: every output within 1e-4 of its tensor's largest magnitude
(convolutions sum in another order in each framework); BatchNorm running
statistics after a training-mode forward within 1e-4 relative, with an
absolute floor of 1e-6 for means near 0 (the batch moments are sums in
another order). Remat against no remat in the port: equal to the bit,
since the recompute repeats the same CPU operations on the same inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import (
    HOURGLASS_HEAD_PATHS,
    HOURGLASS_SMALL,
    LEGACY_HEAD_PATHS,
    QUARTER,
    SmallCenterNetHourglass,
    _randomize,
    flax_variables,
    jax_small_legacy,
    nchw,
    nhwc,
)

from scd_resnet_tpu.core.torch_convert import export_center_net_hourglass
from scd_resnet_tpu.models import center_net_offset as jax_cno
from scd_resnet_tpu.models import hourglass as jax_hg
from scd_resnet_tpu.models.corner_net_legacy import CornerNetLegacy as JaxLegacy
from scd_resnet_tpu.models.resnet import Residual as JaxResidual
from scd_resnet_tpu_torch.core import convert
from scd_resnet_tpu_torch.core.convert import state_dict_from_flax
from scd_resnet_tpu_torch.models.center_net_offset import (
    CenterNetHourglass,
    CenterNetResidual,
)
from scd_resnet_tpu_torch.models.corner_net_legacy import CornerNetLegacy
from scd_resnet_tpu_torch.models.hourglass import (
    Hourglass,
    ResidualStack,
    ResidualStackReverted,
)
from scd_resnet_tpu_torch.models.resnet import Residual, TerminalHead
from scd_resnet_tpu_torch.train.registry import get_model_profile

DIMS, MODS = HOURGLASS_SMALL["dimensions"], HOURGLASS_SMALL["modules"]


def _close(got: torch.Tensor, ref, what: str) -> None:
    ref = np.asarray(ref)
    got = nhwc(got) if got.dim() == 4 else got.detach().numpy()
    assert got.shape == ref.shape, what
    scale = np.abs(ref).max()
    assert scale > 0.1, what  # a live output, not a flat map
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * scale,
                               err_msg=what)


def _port_sd(walk, params, stats, module):
    """``walk`` (a converter step) of a flax subtree into ``module``'s
    state dict keys."""
    sd = {}
    walk(convert._Writer(sd, params, stats), "m", module)
    return {key[2:]: value for key, value in sd.items()}


# -- the modules --------------------------------------------------------------

def _residual(cin, cout, stride):
    return (JaxResidual(cout, stride), Residual(cin, cout, stride),
            convert._residual)


def _stack(cin, cout, n, stride):
    return (jax_hg.ResidualStack(cout, n, stride),
            ResidualStack(cin, cout, n, stride), convert._residual_stack)


def _reverted(cin, cout, n):
    return (jax_hg.ResidualStackReverted(cout, n),
            ResidualStackReverted(cin, cout, n), convert._residual_stack)


def _hourglass(pool):
    return (jax_hg.Hourglass(2, DIMS, MODS, pool),
            Hourglass(2, DIMS, MODS, pool), convert._hourglass)


MODULES = {
    "residual_identity": (lambda: _residual(16, 16, 1), 16),
    "residual_skip_width": (lambda: _residual(16, 24, 1), 16),
    "residual_skip_stride": (lambda: _residual(16, 16, 2), 16),
    "residual_stack": (lambda: _stack(16, 24, 2, 2), 16),
    "residual_stack_reverted": (lambda: _reverted(24, 16, 2), 24),
    "hourglass_stride": (lambda: _hourglass(False), 16),
    "hourglass_pool": (lambda: _hourglass(True), 16),
}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_modules_match_flax(name):
    """Each module on a (2, 16, 16, C) batch in eval mode, from the same
    seeded weights."""
    build, cin = MODULES[name]
    jax_module, port_module, walk = build()
    x = np.random.default_rng(5).normal(size=(2, 16, 16, cin)).astype(
        np.float32)
    variables = jax_module.init(jax.random.PRNGKey(0), jnp.zeros_like(x),
                                train=False)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    rng = np.random.default_rng(9)
    params = _randomize(variables["params"], rng)
    stats = _randomize(variables["batch_stats"], rng)
    port_module.load_state_dict(_port_sd(walk, params, stats, port_module),
                                strict=True)
    ref = jax_module.apply({"params": params, "batch_stats": stats},
                           jnp.asarray(x), train=False)
    with torch.inference_mode():
        got = port_module.eval()(nchw(x))
    _close(got, ref, name)


def test_residual_skip_exists_only_where_the_shape_changes():
    assert Residual(16, 16).skip is None
    assert Residual(16, 24).skip is not None
    assert Residual(16, 16, 2).skip is not None


# -- the stacked center detector ---------------------------------------------

def _small(stacks: int, **kw) -> CenterNetHourglass:
    return CenterNetHourglass(stacks=stacks, **HOURGLASS_SMALL, **kw)


def _small_sd(stacks: int, seed: int):
    """Seeded flax variables of the small JAX detector, and the port's
    state dict from them (the profile's converter walks the model)."""
    params, stats = flax_variables(SmallCenterNetHourglass(stacks=stacks),
                                   seed, heads=HOURGLASS_HEAD_PATHS)
    model = _small(stacks)
    sd = {}
    convert._stacked(convert._Writer(sd, params, stats).sub(
        "StackHourglass_0"), model)
    return params, stats, sd


@pytest.fixture(scope="module", params=[1, 2], ids=["1stack", "2stacks"])
def stacked(request):
    stacks = request.param
    params, stats, sd = _small_sd(stacks, seed=20 + stacks)
    x = np.random.default_rng(4).normal(size=(2, 64, 64, 1)).astype(
        np.float32)
    return stacks, params, stats, sd, x


def test_stack_hourglass_heads_match_flax(stacked):
    stacks, params, stats, sd, x = stacked
    ref = SmallCenterNetHourglass(stacks=stacks).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), train=False)
    model = _small(stacks)
    model.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        got = model.eval()(nchw(x))
    assert len(got) == len(ref) == stacks
    for s, (g, r) in enumerate(zip(got, ref)):
        assert set(g) == {"heatmap", "regr", "offset"}
        for head in g:
            _close(g[head], r[head], "stack {} {}".format(s, head))


def test_export_center_net_hourglass_loads_strict(stacked):
    """The JAX package's reference exporter's dict loads into the port
    model with ``strict=True`` and equals the converter's, key for key."""
    stacks, params, stats, sd, _ = stacked
    ref = export_center_net_hourglass(
        params, stats, stacks=stacks,
        iterations=HOURGLASS_SMALL["iterations"], modules=MODS)
    assert set(ref) == set(sd)
    for key, value in ref.items():
        np.testing.assert_array_equal(sd[key].numpy(), np.asarray(value),
                                      err_msg=key)
    _small(stacks).load_state_dict(
        {k: torch.from_numpy(np.asarray(v)) for k, v in ref.items()},
        strict=True)


def _abstract_variables(model, side: int):
    """Zero numpy variables of ``model`` at its init shapes, traced
    without computing (``jax.eval_shape``)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, side, side, 1)))
    return jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes)


@pytest.mark.parametrize("arch", ["centerOffsetHourglass",
                                  "centerOffsetHourglass2",
                                  "cornerLegacyHourglass"])
def test_state_dict_from_flax_key_for_key(arch):
    """At the production geometry: the converter fills every key of the
    profile's port model with a tensor of its shape, and uses every flax
    variable."""
    profile = get_model_profile(arch)
    if arch.startswith("cornerLegacy"):
        jax_model = JaxLegacy(categories=1, stacks=2)
    else:
        jax_model = jax_cno.CenterNetHourglass(
            stacks=profile.model_params["stacks"])
    variables = _abstract_variables(jax_model, 128)
    sd = state_dict_from_flax(arch, variables["params"],
                              variables["batch_stats"])
    want = profile.build().state_dict()
    assert set(sd) == set(want)
    for key, value in want.items():
        assert tuple(sd[key].shape) == tuple(value.shape), key
    n_flax = sum(np.size(v) for v in jax.tree_util.tree_leaves(variables))
    n_port = sum(v.numel() for k, v in sd.items()
                 if not k.endswith("num_batches_tracked"))
    assert n_port == n_flax


# -- remat -------------------------------------------------------------------

def _train_step(model: torch.nn.Module, x: torch.Tensor, weights):
    """One training-mode forward and backward of a fixed weighted sum of
    every head; returns the outputs and the gradients."""
    model.train()
    model.zero_grad(set_to_none=True)
    outs = model(x)
    total = sum((w * out[head]).sum() for out in outs
                for head, w in weights.items())
    total.backward()
    return outs, {n: p.grad.clone() for n, p in model.named_parameters()}


def _bn_state(model):
    return {k: v.clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var",
                           "num_batches_tracked"))}


def _assert_bn_close_to_flax(port_sd, params, new_stats, convert_root):
    """The port's running statistics against flax's after a
    training-mode apply (``mutable=["batch_stats"]``)."""
    want = {}
    convert_root(convert._Writer(want, params, new_stats))
    checked = 0
    for key, value in want.items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(port_sd[key].numpy(), value.numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=key)
            checked += 1
        elif key.endswith("num_batches_tracked"):
            assert int(port_sd[key]) == 1, key
    assert checked > 0


REMAT_CASES = {
    "hourglass2": (lambda remat: _small(2, remat=remat),
                   {"heatmap": 1.0, "regr": 0.5, "offset": -0.25}),
    "legacy": (lambda remat: CornerNetLegacy(stacks=2, remat=remat,
                                             **HOURGLASS_SMALL),
               {"tl_heat": 1.0, "br_heat": -0.5, "tl_tag": 0.25,
                "br_tag": 0.5, "tl_regr": -1.0, "br_regr": 0.75}),
}


@pytest.mark.parametrize("case", sorted(REMAT_CASES))
def test_remat_matches_no_remat_and_flax(case):
    """A training step with remat and one without, from the same weights:
    the same outputs, gradients and BatchNorm running statistics (each
    BatchNorm moved once: ``num_batches_tracked`` 1), and those statistics
    equal to flax's training-mode update of the same model."""
    build, weights = REMAT_CASES[case]
    if case == "legacy":
        jax_model = jax_small_legacy(stacks=2)
        params, stats = flax_variables(jax_model, 31,
                                       heads=LEGACY_HEAD_PATHS)
        root = lambda w, m: convert._stacked(w, m)  # noqa: E731
    else:
        jax_model = SmallCenterNetHourglass(stacks=2)
        params, stats = flax_variables(jax_model, 31,
                                       heads=HOURGLASS_HEAD_PATHS)
        root = lambda w, m: convert._stacked(  # noqa: E731
            w.sub("StackHourglass_0"), m)
    plain, remat = build(False), build(True)
    sd = {}
    root(convert._Writer(sd, params, stats), plain)
    plain.load_state_dict(sd, strict=True)
    remat.load_state_dict(sd, strict=True)
    assert set(plain.state_dict()) == set(remat.state_dict())

    x = nchw(np.random.default_rng(6).normal(size=(2, 64, 64, 1)).astype(
        np.float32))
    outs_p, grads_p = _train_step(plain, x, weights)
    outs_r, grads_r = _train_step(remat, x, weights)
    for op, orr in zip(outs_p, outs_r):
        for head in op:
            assert torch.equal(op[head], orr[head]), head
    assert set(grads_p) == set(grads_r)
    for name in grads_p:
        assert torch.equal(grads_p[name], grads_r[name]), name
    bn_p, bn_r = _bn_state(plain), _bn_state(remat)
    for key in bn_p:
        assert torch.equal(bn_p[key], bn_r[key]), key

    _, mutated = jax_model.apply(
        {"params": params, "batch_stats": stats},
        jnp.asarray(nhwc(x)), train=True, mutable=["batch_stats"])
    new_stats = jax.tree_util.tree_map(np.asarray, mutated["batch_stats"])
    _assert_bn_close_to_flax(remat.state_dict(), params, new_stats,
                             lambda w: root(w, build(False)))


# -- float32 heads under autocast ---------------------------------------------

@pytest.mark.parametrize("case", sorted(REMAT_CASES))
def test_heads_final_conv_runs_in_float32_under_autocast(case):
    """Under bf16 autocast every head's final 1x1 conv takes a float32
    input and returns float32 (the JAX heads cast up, or promote to their
    float32 parameters), while the conv before it computes in bf16."""
    model = REMAT_CASES[case][0](False).eval()
    heads = [m for m in model.modules() if isinstance(m, TerminalHead)]
    assert len(heads) == (2 * 3 if case == "hourglass2" else 2 * 2 * 3)
    seen = {}
    hooks = [head[-1].register_forward_hook(
        lambda m, args, out: seen.__setitem__(id(m), (args[0].dtype,
                                                      out.dtype)))
        for head in heads]
    hooks += [head[0].conv.register_forward_hook(
        lambda m, args, out: seen.__setitem__(id(m), (None, out.dtype)))
        for head in heads]
    try:
        with torch.inference_mode(), torch.autocast("cpu",
                                                    dtype=torch.bfloat16):
            outs = model(torch.randn(1, 1, 64, 64))
    finally:
        for hook in hooks:
            hook.remove()
    for head in heads:
        assert seen[id(head[-1])] == (torch.float32, torch.float32)
        assert seen[id(head[0].conv)][1] == torch.bfloat16
    assert all(v.dtype == torch.float32 for out in outs for v in out.values())


# -- the deeper ResNet profiles share models/resnet.py ---------------------------

@pytest.mark.parametrize("arch", ["centerOffsetRes18", "centerOffsetRes34",
                                  "centerOffsetRes50", "centerOffsetRes101h"])
def test_deeper_resnets_match_flax_at_quarter_width(arch):
    """The ResNet profiles beyond depth 10 (``BasicBlock`` at 18 and 34,
    ``Bottleneck`` at 50 and 101) at quarter width on 64^2 inputs, heads
    against the JAX model through the converter."""
    profile = get_model_profile(arch)
    depth = profile.num_layers
    hidden = profile.model_params["terminal_hidden"]
    jax_model = jax_cno.CenterNetResidual(num_layers=depth, dims=QUARTER,
                                          terminal_hidden=hidden)
    params, stats = flax_variables(jax_model, seed=depth)
    x = np.random.default_rng(8).normal(size=(2, 64, 64, 1)).astype(
        np.float32)
    ref = jax_model.apply({"params": params, "batch_stats": stats},
                          jnp.asarray(x), train=False)
    model = CenterNetResidual(depth, QUARTER, terminal_hidden=hidden)
    model.load_state_dict(state_dict_from_flax(arch, params, stats),
                          strict=True)
    with torch.inference_mode():
        got = model.eval()(nchw(x))
    for head in ("heatmap", "regr", "offset"):
        _close(got[head], ref[head], "{} {}".format(arch, head))
