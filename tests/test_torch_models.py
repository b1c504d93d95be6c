"""The port's models, weight converter, decode and checkpoints against
the JAX package on the same seeded weights and inputs (CPU, float32).

Tolerances: head outputs within 1e-4 relative to the head's largest
magnitude (convolutions sum in another order); decode scores within
1e-6; decode indices equal wherever the score is above 0 (after NMS,
zero-score ties may order differently under ``torch.topk`` and
``lax.top_k``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_common import FAMILIES, flax_variables, nchw, nhwc, port_model

from scd_resnet_tpu.core.torch_convert import export_center_net_residual
from scd_resnet_tpu.models.center_net_offset import decode_center_net as jax_decode_center
from scd_resnet_tpu.models.corner_net import decode_corner_net as jax_decode_corner
from scd_resnet_tpu_torch.core.checkpoint import load_state_dict, save_checkpoint
from scd_resnet_tpu_torch.core.convert import state_dict_from_flax
from scd_resnet_tpu_torch.infer.wrapper import load_wrapper
from scd_resnet_tpu_torch.models.center_net_offset import decode_center_net
from scd_resnet_tpu_torch.models.corner_net import decode_corner_net

HEADS = {"centerOffset": ("heatmap", "regr", "offset"),
         "corner": ("heatmap", "tl", "br")}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family_outputs(request):
    """(family, JAX head outputs NHWC, port head outputs NCHW, flax vars)
    on one seeded 64x64 batch of 2."""
    family = request.param
    jax_model = FAMILIES[family][0]()
    params, stats = flax_variables(jax_model, seed=7)
    x = np.random.default_rng(3).normal(size=(2, 64, 64, 1)).astype(np.float32)
    jax_out = jax_model.apply({"params": params, "batch_stats": stats},
                              jnp.asarray(x), train=False)
    with torch.inference_mode():
        port_out = port_model(family, params, stats)(nchw(x))
    return family, jax.tree_util.tree_map(np.asarray, jax_out), port_out, (
        params, stats)


def test_heads_match_jax(family_outputs):
    family, jax_out, port_out, _ = family_outputs
    assert set(port_out) == set(HEADS[family])
    for head in HEADS[family]:
        ref = jax_out[head]
        got = nhwc(port_out[head])
        assert got.shape == ref.shape
        scale = np.abs(ref).max()
        assert scale > 0.1, head  # a live head, not a flat map
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * scale,
                                   err_msg=head)


def _assert_topk_equal(got_scores, got_inds, ref_scores, ref_inds):
    np.testing.assert_allclose(got_scores, ref_scores, rtol=0, atol=1e-6)
    live = ref_scores > 0
    assert live.any()
    np.testing.assert_array_equal(np.asarray(got_inds)[live],
                                  np.asarray(ref_inds)[live])


def test_decode_matches_jax(family_outputs):
    """The port's decode on the JAX heads (NCHW) against the JAX decode,
    so the comparison isolates the decode."""
    family, jax_out, _, _ = family_outputs
    port_heads = {k: nchw(v) for k, v in jax_out.items()}
    jax_heads = {k: jnp.asarray(v) for k, v in jax_out.items()}
    if family == "centerOffset":
        ref = jax_decode_center(jax_heads)
        got = decode_center_net(port_heads)
        _assert_topk_equal(got[0].numpy(), got[1].numpy(),
                           np.asarray(ref[0]), np.asarray(ref[1]))
        live = np.asarray(ref[0]) > 0
        for i in (2, 3, 4, 5):  # y, x, offset, regr
            np.testing.assert_allclose(got[i].numpy()[live],
                                       np.asarray(ref[i])[live],
                                       rtol=0, atol=1e-6)
        assert (np.asarray(ref[0]) > 0.3).any()
    else:
        ref = jax_decode_corner(jax_heads)
        got = decode_corner_net(port_heads)
        for h in range(3):
            s, i, y, x = (4 * h + j for j in range(4))
            _assert_topk_equal(got[s].numpy(), got[i].numpy(),
                               np.asarray(ref[s]), np.asarray(ref[i]))
            live = np.asarray(ref[s]) > 0
            np.testing.assert_array_equal(got[y].numpy()[live],
                                          np.asarray(ref[y])[live])
            np.testing.assert_array_equal(got[x].numpy()[live],
                                          np.asarray(ref[x])[live])
            assert (np.asarray(ref[s]) > 0.3).any()


def test_converter_equals_reference_exporter():
    """On the CenterNetResidual tree the converter writes exactly the
    state dict the JAX package's reference exporter writes."""
    jax_model, arch = FAMILIES["centerOffset"]
    params, stats = flax_variables(jax_model(), seed=11)
    ours = state_dict_from_flax(arch, params, stats)
    ref = export_center_net_residual(params, stats, num_layers=10)
    assert set(ours) == set(ref)
    for key, value in ref.items():
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(value),
                                      err_msg=key)


def test_checkpoints_load_into_wrapper(tmp_path, family_outputs):
    """A port checkpoint round-trips through ``load_wrapper``; a
    reference ``.pth`` (``module.``-prefixed) loads for centerOffset and
    is refused for the corner family; a wrong arch is refused."""
    family, _, _, (params, stats) = family_outputs
    arch = FAMILIES[family][1]
    sd = state_dict_from_flax(arch, params, stats)
    if family == "centerOffset":  # quarter width == centerOffsetRes10q
        path = save_checkpoint(str(tmp_path / "port.pt"), arch, sd)
        wrapper = load_wrapper(path, arch, device="cpu")
        assert wrapper.contract == "centerOffset"
        assert len(wrapper.rows) == 10
        ref_path = str(tmp_path / "ref.pth")
        torch.save({"module." + k: v for k, v in sd.items()}, ref_path)
        loaded = load_state_dict(ref_path, arch)
        assert all(torch.equal(loaded[k], sd[k]) for k in sd)
        with pytest.raises(ValueError):
            load_state_dict(path, "centerOffsetRes10")
    else:
        ref_path = str(tmp_path / "corner.pth")
        torch.save(sd, ref_path)
        with pytest.raises(ValueError):
            load_state_dict(ref_path, arch)
        path = save_checkpoint(str(tmp_path / "corner.pt"), arch, sd)
        assert set(load_state_dict(path, arch)) == set(sd)
