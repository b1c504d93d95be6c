"""The resident step's index feed (``NetworkFactory.train_resident``) on
the CPU: int32 and int64 indices, numpy or tensors, train what the
int64 gather of the same rows trains; the run-ahead counter
(``core/cuda_build.FEED``) stays empty off a card, and
``begin_training``'s summary carries its share as None. The pinned,
non-blocking copy and the counter's events run only on a card
(``chip_smoke.py``'s ``check_feed``). Quarter-width
``centerOffsetRes10q`` on 64x64 clips in batches of 4, as the other port
tests.
"""

import numpy as np
import pytest
import torch

from scd_resnet_tpu_torch.core import cuda_build
from scd_resnet_tpu_torch.core.config import Configuration
from scd_resnet_tpu_torch.data.dataset import SCDDataset
from scd_resnet_tpu_torch.data.pipeline import draw
from scd_resnet_tpu_torch.data.synthetic import make_archive
from scd_resnet_tpu_torch.train.factory import NetworkFactory

BATCH = 4


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    root = tmp_path_factory.mktemp("feed")
    path = str(root / "scdx16p100.d")
    make_archive(path, num_images=2, reps=1, clips_per_image=6, size=64)
    return root, path


def _factory(root, path, **extra):
    cfg = Configuration()
    cfg.update_config(dict({
        "datasetName": "scdx16p100", "modelName": "centerOffsetRes10q",
        "trainName": "feed", "batchSize": BATCH, "validationBatchSize": 4,
        "iterations": 2, "validation": 100, "snapshot": 100,
        "learningRate": 1e-3, "residency": "device",
        "dirTemp": str(root / "temp") + "/",
        "dirResult": str(root / "results") + "/",
        "dirDataset": str(root) + "/"}, **extra))
    dataset = SCDDataset(path, None, test_set=4, seed=42, device="cpu")
    factory = NetworkFactory(cfg, dataset=dataset, device="cpu", seed=5)
    assert factory.resident
    return factory


def _draws():
    return draw(torch.Generator().manual_seed(11), BATCH, 64,
                torch.device("cpu"))


@pytest.fixture(scope="module")
def gathered(archive):
    """The step on the rows of the int64 gather, given as rows: its
    index vector, loss and gradients."""
    factory = _factory(*archive)
    idx = np.asarray(next(iter(factory.dataset.epoch_local_indices(
        BATCH, 0))))[::-1].copy()
    rows = torch.as_tensor(idx, dtype=torch.int64)
    loss, _ = factory.train_rows(*(t.index_select(0, rows) for t in (
        factory._ds_samples, factory._ds_locs, factory._ds_counts)),
        draws=_draws())
    return idx, loss, {k: p.grad.clone()
                       for k, p in factory.model.named_parameters()}


@pytest.mark.parametrize("form", [
    lambda i: i.astype(np.int32), lambda i: i.astype(np.int64),
    lambda i: torch.from_numpy(i.astype(np.int32)),
    lambda i: torch.from_numpy(i.astype(np.int64))],
    ids=["int32-numpy", "int64-numpy", "int32-tensor", "int64-tensor"])
def test_resident_step_trains_the_int64_gather(form, archive, gathered):
    idx, want_loss, want_grads = gathered
    factory = _factory(*archive)
    loss, _ = factory.train_resident(form(idx), _draws())
    assert torch.equal(loss, want_loss)
    for name, p in factory.model.named_parameters():
        assert torch.equal(p.grad, want_grads[name]), name


def test_feed_counter_stays_empty_on_the_cpu(archive, tmp_path):
    cuda_build.reset_launches()
    factory = _factory(tmp_path, archive[1])
    summary = factory.begin_training()
    assert summary["steps"] == 2
    assert "feed_ahead_share" in summary
    assert summary["feed_ahead_share"] is None
    assert not any(cuda_build.FEED.values())
