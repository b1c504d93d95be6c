"""The benchmark's FLOP count against ``torch.utils.flop_counter`` on the
plain reference model."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import flops
from portbench.reference import model as reference_model

CONFIGS = {
    "centerOffset": {"family": "centerOffset", "num_layers": 10,
                     "dims": [16, 16, 32, 64, 128, 64, 64, 64],
                     "terminal_hidden": 32},
    "cornerCPool": {"family": "cornerCPool", "num_layers": 10,
                    "dims": [16, 16, 32, 64, 128, 64, 64, 64],
                    "terminal_hidden": 128, "pool_width": 128,
                    "corner_hidden": 128},
}


@pytest.mark.parametrize("family", sorted(CONFIGS))
@pytest.mark.parametrize("size", [64, 96])
@pytest.mark.parametrize("num_layers", [10, 18])
def test_forward_count_equals_flop_counter(family, size, num_layers):
    config = dict(CONFIGS[family], num_layers=num_layers)
    model = reference_model.build(config)
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.01)
    for m in model.modules():
        if isinstance(m, reference_model.Norm):
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    model.eval()
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(torch.zeros(2, 1, size, size))
    assert flops.forward_per_clip(config, size) * 2 == \
        counter.get_total_flops()


def test_full_width_counts():
    """The published widths at 512x512 give PERF.md's 49.3 and 150.2
    GFLOP a clip."""
    full = [64, 64, 128, 256, 512, 256, 256, 256]
    center = dict(CONFIGS["centerOffset"], dims=full, terminal_hidden=128)
    corner = dict(CONFIGS["cornerCPool"], dims=full)
    assert round(flops.forward_per_clip(center, 512) / 1e9, 1) == 49.3
    assert round(flops.forward_per_clip(corner, 512) / 1e9, 1) == 150.2


@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_a_family_is_found_by_name(family):
    module = reference_model.family(family)
    assert type(module.build(CONFIGS[family])).__module__ == module.__name__
    assert module.layers(CONFIGS[family], 64) \
        == reference_model.layers(CONFIGS[family], 64)
