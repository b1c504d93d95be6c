"""The port's CornerNet (``models/corner_net_legacy.CornerNetLegacy``) held
to a plain reference of the published CornerNet (``tests/plain_corner_net``,
float32, nothing of the port or of the JAX package) on the CPU, through
the same classes as the published ``cornerNetHourglass104`` profile at a
narrowed geometry: widths (8, 8, 12, 12, 12, 16), the published modules
(2, 2, 2, 2, 2, 4), 5 iterations and 2 stacks, prediction width 16,
128x128 clips, batch 2, remat off and on. Both sides load one seeded
state dict.

Tolerances, each with its reason:

- heads: 1e-4 of the map's largest magnitude. Both sides run the same
  float32 convolutions on the same weights; what differs is the order of
  a few sums (BatchNorm's moments, the residual and merge additions),
  about 1e-6 relative through 25 BatchNorms a stack. A bfloat16 forward
  of the reference misses it by orders of magnitude (a bfloat16
  mantissa holds 8 bits), which a test shows;
- targets: equal, maps within 1e-6 (the same float32 operations, a
  Gaussian's exp in another order);
- losses: 1e-5 relative (float32 sums over 2 x 32 x 32 pixels);
- gradients: each parameter's within 1e-4 of the larger of its norm and
  the median parameter's (a gradient sums over the batch and the map in
  another order; the corner pools route each output's gradient to one
  input on both sides);
- one Adam step: each element's change within 1e-3 of the step's size
  ``lr``, where its gradient is ten times its gap between the two sides
  and above 1e-6 (so both sides' signs are settled): Adam's first step
  moves an element by about ``lr`` whatever its gradient, so an element
  whose gradient lies within rounding of 0 (BatchNorm shifts on the 1x1
  innermost maps, whose gradients nearly cancel) takes either sign. Over
  three quarters of the elements are so settled (84 % here);
- decode rows: equal to 1e-6 (the same corners, offsets and tags, paired
  in the same order).
"""

from __future__ import annotations

import math

import pytest
import torch

from scd_resnet_tpu_torch.data.pipeline import legacy_targets
from scd_resnet_tpu_torch.models.corner_net_legacy import (
    HOURGLASS104,
    CornerBranch,
    CornerNetLegacy,
    CornerNetLegacyLoss,
    decode_corner_net_legacy,
)
from scd_resnet_tpu_torch.train.registry import get_model_profile
from tests import plain_corner_net as plain

GEOMETRY = {"iterations": 5, "stacks": 2,
            "dimensions": (8, 8, 12, 12, 12, 16),
            "modules": HOURGLASS104["modules"], "prediction_dim": 16}
SIZE, BATCH, OBJECTS, LR = 128, 2, 5, 1e-3
HEAT = SIZE // 4
MAPS = tuple(c + "_" + h for c in ("tl", "br") for h in ("heat", "tag", "regr"))


def seeded_state(model: torch.nn.Module, seed: int = 104):
    """Convolution kernels N(0, 1/fan_in), biases N(0, 0.1), BatchNorm
    scale U(0.5, 1.5) and shift N(0, 0.1); each head's final 1x1 kernel
    zero-mean over its inputs and N(0, 4/fan_in), bias 0, so that no map
    saturates."""
    gen = torch.Generator().manual_seed(seed)
    state = {}
    for name, t in model.state_dict().items():
        leaf = name.rsplit(".", 1)[1]
        if leaf == "num_batches_tracked":
            state[name] = t.clone()
        elif t.dim() == 4:
            fan_in = t[0].numel()
            w = torch.randn(t.shape, generator=gen) / math.sqrt(fan_in)
            if name.endswith(".1.weight") and any(
                    "." + h + "." in name for h in ("heat", "tag", "regr")):
                w = 2 * (w - w.mean(dim=1, keepdim=True))
            state[name] = w
        elif leaf == "weight" or leaf == "running_var":
            state[name] = 0.5 + torch.rand(t.shape, generator=gen)
        elif name.endswith(".1.bias") and any(
                "." + h + "." in name for h in ("heat", "tag", "regr")):
            state[name] = torch.zeros(t.shape)
        else:
            state[name] = 0.1 * torch.randn(t.shape, generator=gen)
    return state


def loc_records(seed: int = 7):
    """(B, K, 8) loc records on the 32x32 map and their (B, K) mask of
    real objects; the last two objects of each clip sit on its edges, so
    some corners fall off the map (one in (-1, 0))."""
    gen = torch.Generator().manual_seed(seed)
    u = lambda *s: torch.rand(s, generator=gen)  # noqa: E731
    locs = torch.zeros(BATCH, OBJECTS, 8)
    locs[..., 0:2] = torch.floor(4 + (HEAT - 8) * u(BATCH, OBJECTS, 2))
    locs[..., 2:4] = 4 * u(BATCH, OBJECTS, 2)
    major = 1 + 3 * u(BATCH, OBJECTS)
    angle = math.pi * u(BATCH, OBJECTS)
    locs[..., 4] = major * torch.cos(angle)
    locs[..., 5] = major * torch.sin(angle)
    locs[..., 6] = 0.5 + (major - 0.5) * u(BATCH, OBJECTS)
    locs[..., 7] = locs[..., 6] + 2
    locs[:, -2, 0:4] = torch.tensor([1.0, 1.0, 0.0, 0.0])
    locs[:, -1, 0:4] = torch.tensor([HEAT - 2.0, 2.0, 2.0, 0.0])
    present = torch.tensor([[True] * OBJECTS, [True] * (OBJECTS - 1) + [False]])
    return locs, present


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the suite's workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    """``(port model, reference model, clips)`` on one seeded state."""
    torch.manual_seed(0)
    port = CornerNetLegacy(categories=1, **GEOMETRY)
    state = seeded_state(port)
    port.load_state_dict(state, strict=True)
    ref = plain.CornerNet(GEOMETRY["dimensions"], GEOMETRY["modules"],
                          GEOMETRY["iterations"], GEOMETRY["stacks"],
                          GEOMETRY["prediction_dim"])
    ref.load_state_dict(state, strict=True)
    clips = torch.randn(BATCH, 1, SIZE, SIZE,
                        generator=torch.Generator().manual_seed(11))
    return port, ref, state, clips


def head_gap(got, want) -> float:
    got, want = got.detach(), want.detach()
    return float((got - want).abs().max() / max(1.0, want.abs().max()))


@pytest.mark.parametrize("remat", [False, True])
def test_forward_heads_match_the_reference(pair, remat):
    port, ref, _, clips = pair
    port.remat = remat
    port.train(), ref.train()
    outs, want = port(clips), ref(clips)
    assert len(outs) == len(want) == 2
    for stack in range(2):
        assert set(outs[stack]) == set(MAPS)
        for name in MAPS:
            assert head_gap(outs[stack][name], want[stack][name]) < 1e-4, \
                (stack, name)


def test_bfloat16_reference_misses_the_head_tolerance(pair):
    port, ref, _, clips = pair
    port.train(), ref.train()
    with torch.no_grad():
        outs = port(clips)
        with torch.autocast("cpu", dtype=torch.bfloat16):
            low = ref(clips)
    worst = max(head_gap(low[s][n].float(), outs[s][n])
                for s in range(2) for n in MAPS)
    assert worst > 1e-2


def test_legacy_targets_match_the_pipeline():
    locs, present = loc_records()
    got = legacy_targets(locs, present, HEAT)
    want = plain.targets(locs, present, HEAT)
    names = ("tl_heat", "br_heat", "mask", "tl_regr", "br_regr", "tl_inds",
             "br_inds")
    for name, tensor in zip(names, got):
        assert tensor.shape == want[name].shape, name
        if tensor.dtype.is_floating_point:
            assert torch.allclose(tensor, want[name], rtol=0, atol=1e-6), name
        else:
            assert torch.equal(tensor, want[name]), name
    # the edge objects: corners off the map do not count
    assert not want["mask"][:, -2].any() and want["mask"][0, 0]
    assert want["tl_heat"].amax() == 1.0


def _ys(t):
    return [t["tl_heat"], t["br_heat"], t["mask"], t["tl_regr"], t["br_regr"],
            t["tl_inds"], t["br_inds"]]


@pytest.mark.parametrize("remat", [False, True])
def test_loss_gradients_and_adam_step(pair, remat):
    port, ref, state, clips = pair
    port.load_state_dict(state), ref.load_state_dict(state)
    port.remat = remat
    port.train(), ref.train()
    locs, present = loc_records()
    t = plain.targets(locs, present, HEAT)

    optimizer = torch.optim.Adam(port.parameters(), lr=LR, betas=(0.9, 0.999),
                                 eps=1e-8)
    optimizer.zero_grad(set_to_none=True)
    value, parts = CornerNetLegacyLoss()(port(clips), _ys(t))
    value.backward()
    total, *want_parts = plain.loss(ref(clips), t)
    ref.zero_grad(set_to_none=True)
    total.backward()
    for got, want in zip([value] + parts, [total] + want_parts):
        got, want = float(got.detach()), float(want.detach())
        assert abs(got - want) <= 1e-5 * abs(want), (got, want)

    grads = {k: p.grad for k, p in port.named_parameters()}
    want_grads = {k: p.grad for k, p in ref.named_parameters()}
    assert set(grads) == set(want_grads)
    norms = {k: float(g.norm()) for k, g in want_grads.items()}
    median = sorted(norms.values())[len(norms) // 2]
    for k, g in grads.items():
        gap = float((g - want_grads[k]).norm()) / max(norms[k], median)
        assert gap < 1e-4, (k, gap)

    before = {k: p.detach().clone() for k, p in port.named_parameters()}
    optimizer.step()
    params = dict(ref.named_parameters())
    plain.adam(params, {}, LR)
    settled = 0
    for k, p in port.named_parameters():
        want = want_grads[k]
        sure = want.abs() > 10 * (grads[k] - want).abs() + 1e-6
        gap = (p.detach() - params[k].detach()).abs()[sure]
        assert gap.numel() == 0 or float(gap.max()) <= 1e-3 * LR, k
        settled += int(sure.sum())
        assert not torch.equal(p.detach(), before[k]), k
    assert settled > 0.75 * sum(p.numel() for p in port.parameters())


def test_decode_rows_match_the_reference(pair):
    port, ref, _, clips = pair
    ref.eval()
    with torch.no_grad():
        out = ref(clips)[-1]
    got = decode_corner_net_legacy(out)
    want = plain.decode(out)
    assert got.shape == want.shape == (BATCH, 1000, 8)
    assert torch.allclose(got, want, rtol=0, atol=1e-6)
    assert (want[:, :, 4] > -1).any()


def test_spans_mark_the_stacks_branches_and_embedding_loss(pair):
    port, _, state, clips = pair
    port.load_state_dict(state)
    port.remat = True
    port.train()
    locs, present = loc_records()
    ys = _ys(plain.targets(locs, present, HEAT))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        CornerNetLegacyLoss()(port(clips), ys)[0].backward()
    counts = {}
    for event in prof.events():
        if event.name.startswith("scd."):
            counts[event.name] = counts.get(event.name, 0) + 1
    # forward and recompute: 2 hourglasses, 4 branches; 2 embedding losses
    assert counts == {"scd.model.hourglass": 4, "scd.model.corner": 8,
                      "scd.loss.embedding": 2}


def test_published_geometry_on_the_meta_device():
    """``cornerNetHourglass104``: the paper's 200,941,456 parameters, 4
    branches of a pool block and 3 heads (16 branch modules, 12 heads),
    and the reference's state dict at the published widths, key for key
    and shape for shape."""
    with torch.device("meta"):
        model = get_model_profile("cornerNetHourglass104").build()
        ref = plain.CornerNet(HOURGLASS104["dimensions"],
                              HOURGLASS104["modules"])
    assert sum(p.numel() for p in model.parameters()) == 200_941_456
    branches = [m for m in model.modules() if isinstance(m, CornerBranch)]
    assert len(branches) == 4
    assert sum(len(list(b.children())) for b in branches) == 16
    assert {k: v.shape for k, v in model.state_dict().items()} \
        == {k: v.shape for k, v in ref.state_dict().items()}
