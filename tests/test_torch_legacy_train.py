"""Legacy CornerNet training against the JAX trainer (CPU): three float32
train steps of a small ``cornerLegacyHourglass`` with remat, through both
``NetworkFactory``s from the same converted weights, held as
``tests/test_torch_hourglass_train.py`` holds the hourglass's (its module
docstring gives each check and tolerance): the losses, the BatchNorm
statistics and every step's gradient in float64 in both frameworks; the
update check on the steps whose float32 gradients are smooth, which on
this archive are none (the legacy model's float32 JAX gradient parts
from its float64 one in every step); and a BatchNorm update repeated in
the remat recompute, planted, must fail the statistics check.
"""

import pytest

from test_torch_hourglass_train import (  # noqa: F401  (module fixtures)
    archive,
    check_batch_norm_stats,
    check_float64_gradients,
    check_losses,
    check_planted_recompute_fault,
    check_update,
    jax_runs,
    patch_registries,
    replay_steps,
)

import torch_port_common  # noqa: F401  (the CPU-thread rule)


@pytest.fixture(scope="module")
def legacy_steps(archive, patch_registries, jax_runs, tmp_path_factory):
    return replay_steps("legacy_remat", archive, jax_runs, tmp_path_factory)


def test_legacy_steps_losses_match_jax(legacy_steps):
    check_losses(legacy_steps)


def test_legacy_steps_batch_norm_stats_match_jax(legacy_steps):
    check_batch_norm_stats(legacy_steps)


def test_legacy_float64_gradients_match_jax(legacy_steps):
    check_float64_gradients(legacy_steps)


def test_legacy_steps_update_matches_jax(legacy_steps):
    check_update(legacy_steps)


def test_legacy_bn_check_catches_an_update_repeated_in_the_recompute(
        legacy_steps, tmp_path, monkeypatch):
    check_planted_recompute_fault(legacy_steps, tmp_path, monkeypatch)
