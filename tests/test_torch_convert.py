"""Torch checkpoint conversion: numerical forward equivalence between a
torch model using the reference's module naming and our flax
CenterNetResidual loaded with the converted weights."""

import numpy as np
import pytest
import torch
import torch.nn as tnn

import jax
import jax.numpy as jnp

from scd_resnet_tpu.core.torch_convert import convert_center_net_residual
from scd_resnet_tpu.models.center_net_offset import CenterNetResidual

import torch_port_common  # noqa: F401  (the CPU-thread rule)

DIMS = (16, 16, 32, 64, 128, 64, 64, 64)
HIDDEN = 32


class _TorchBasicBlock(tnn.Module):
    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.conv1 = tnn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = tnn.BatchNorm2d(cout)
        self.conv2 = tnn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = tnn.BatchNorm2d(cout)
        self.downsample = (
            tnn.Sequential(tnn.Conv2d(cin, cout, 1, stride, bias=False),
                           tnn.BatchNorm2d(cout))
            if stride != 1 or cin != cout else None
        )

    def forward(self, x):
        r = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return torch.relu(y + r)


class _TorchRef(tnn.Module):
    """Reference-named CenterNetResidual (tiny dims); ``repeats`` mirrors
    the ResNetSpec stage depths (e.g. (2,2,2,2) for ResNet-18)."""

    def __init__(self, repeats=(1, 1, 1, 1)):
        super().__init__()
        d = DIMS
        self.preprocess = tnn.Sequential(
            tnn.Conv2d(1, d[0], 7, 2, 3, bias=False), tnn.BatchNorm2d(d[0]),
            tnn.ReLU(), tnn.MaxPool2d(3, 2, 1),
        )

        def stage(cin, cout, stride, n):
            blocks = [_TorchBasicBlock(cin, cout, stride)]
            blocks += [_TorchBasicBlock(cout, cout) for _ in range(n - 1)]
            return tnn.Sequential(*blocks)

        self.layer1 = stage(d[0], d[1], 1, repeats[0])
        self.layer2 = stage(d[1], d[2], 2, repeats[1])
        self.layer3 = stage(d[2], d[3], 2, repeats[2])
        self.layer4 = stage(d[3], d[4], 2, repeats[3])
        ups = []
        cin = d[4]
        for cout in d[5:8]:
            ups += [tnn.ConvTranspose2d(cin, cout, 4, 2, 1, bias=False),
                    tnn.BatchNorm2d(cout), tnn.ReLU()]
            cin = cout
        self.deconvolutionLayers = tnn.Sequential(*ups)
        for name, out in (("heatmap", 1), ("regr", 4), ("offset", 2)):
            setattr(self, name, tnn.Sequential(
                tnn.Conv2d(d[7], HIDDEN, 3, 1, 1), tnn.ReLU(),
                tnn.Conv2d(HIDDEN, out, 1)))

    def forward(self, x):
        x = self.preprocess(x)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        x = self.deconvolutionLayers(x)
        return {"heatmap": self.heatmap(x), "regr": self.regr(x),
                "offset": self.offset(x)}


@pytest.mark.parametrize("num_layers,repeats", [(10, (1, 1, 1, 1)),
                                                (18, (2, 2, 2, 2))])
def test_converted_forward_matches_torch(num_layers, repeats):
    torch.manual_seed(0)
    ref = _TorchRef(repeats).eval()
    # nontrivial running stats
    with torch.no_grad():
        ref.train()
        for _ in range(3):
            ref(torch.randn(2, 1, 64, 64))
        ref.eval()

    state_dict = {"module." + k: v for k, v in ref.state_dict().items()}
    params, stats = convert_center_net_residual(state_dict,
                                                num_layers=num_layers)

    model = CenterNetResidual(num_layers=num_layers, dims=DIMS,
                              terminal_hidden=HIDDEN)
    x = np.random.default_rng(1).standard_normal((2, 64, 64, 1)).astype(
        np.float32)
    # template init to validate the converted tree structure matches
    template = model.init(jax.random.PRNGKey(0), jnp.array(x), train=False)
    t_leaves = jax.tree_util.tree_structure(template["params"])
    c_leaves = jax.tree_util.tree_structure(params)
    assert t_leaves == c_leaves, (t_leaves, c_leaves)

    outs = model.apply(
        {"params": params, "batch_stats": stats}, jnp.array(x), train=False)
    with torch.no_grad():
        want = ref(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    for head in ("heatmap", "regr", "offset"):
        got = np.asarray(outs[head]).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(got, want[head].numpy(), atol=2e-4,
                                   err_msg=head)


def test_export_round_trips_exactly():
    """export_center_net_residual is the exact inverse of the forward
    conversion: every tensor round-trips bit-identically."""
    from scd_resnet_tpu.core.torch_convert import export_center_net_residual

    torch.manual_seed(3)
    net = _TorchRef((1, 1, 1, 1))
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    params, stats = convert_center_net_residual(sd, 10)
    back = export_center_net_residual(params, stats, 10)
    assert set(back) == set(sd)
    for key, value in sd.items():
        if key.endswith("num_batches_tracked"):
            continue  # informational counter, exported as 0
        np.testing.assert_array_equal(back[key], value, err_msg=key)
