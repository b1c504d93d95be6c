"""The per-node epoch split on the CPU, against the JAX dataset: the
port's ``steps_per_epoch`` and ``epoch_batches`` with shard counts 1-3
on an order that does not split evenly, ``parallel/mesh.node_layout``
from torchrun's environment, and two gloo ranks started as two nodes of
one rank each, whose host-streamed steps must train exactly their block
of the JAX dataset's batch of their node. Every comparison is exact
(the same rows)."""

import numpy as np
import pytest

from scd_resnet_tpu.data.dataset import SCDDataset as JaxDataset
from scd_resnet_tpu_torch.core.config import Configuration
from scd_resnet_tpu_torch.data.dataset import SCDDataset
from scd_resnet_tpu_torch.data.synthetic import make_archive
from scd_resnet_tpu_torch.parallel.mesh import node_layout
from scd_resnet_tpu_torch.train.factory import NetworkFactory

from torch_dist_worker import run_ranks
import torch_port_common  # noqa: F401  (the CPU-thread rule)

BATCH = 4


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    """21 clips: 4 validation, 17 training rows (shards of 9 and 8, or 6,
    6 and 5)."""
    path = str(tmp_path_factory.mktemp("nodes") / "scdx16p100.d")
    make_archive(path, num_images=3, reps=1, clips_per_image=7, size=64)
    return path


@pytest.fixture(scope="module")
def datasets(archive):
    port = SCDDataset(archive, None, test_set=4, seed=42, device="cpu")
    jax_ds = JaxDataset(archive, None, test_set=4, seed=42)
    assert port.order == list(jax_ds.order) and len(port.order) == 17
    return port, jax_ds


@pytest.mark.parametrize("shards", [1, 2, 3])
def test_epoch_split_equals_jax(datasets, shards):
    port, jax_ds = datasets
    batch = 2 if shards == 3 else BATCH
    for index in range(shards):
        steps = port.steps_per_epoch(batch, shards)
        assert steps == jax_ds.steps_per_epoch(batch, shards, index)
        for epoch, skip in ((0, 0), (3, 1)):
            got = list(port.epoch_batches(batch, epoch, skip, shards, index))
            want = list(jax_ds.epoch_batches(batch, shards, index,
                                             epoch=epoch, skip=skip))
            assert len(got) == len(want) == steps - skip
            for g, w in zip(got, want):
                for a, b in zip(g, w):
                    assert a.tobytes() == b.tobytes()
            rows = slice(batch // 2, batch)
            for g, w in zip(port.epoch_batches(batch, epoch, skip, shards,
                                               index, rows), want):
                for a, b in zip(g, w):
                    assert a.tobytes() == b[rows].tobytes()


@pytest.mark.parametrize("dtype", ["float16", "uint8"])
def test_other_storage_dtypes_equal_jax(archive, dtype):
    port = SCDDataset(archive, None, test_set=4, seed=42,
                      storage_dtype=dtype, device="cpu")
    jax_ds = JaxDataset(archive, None, test_set=4, seed=42,
                        storage_dtype=dtype)
    got = next(port.epoch_batches(BATCH, 5, 0, 2, 1))
    want = next(jax_ds.epoch_batches(BATCH, 2, 1, epoch=5))
    assert got[0].dtype == np.dtype(dtype)
    for a, b in zip(got, want):
        assert a.tobytes() == b.tobytes()


def test_node_layout(monkeypatch):
    for key in ("WORLD_SIZE", "LOCAL_WORLD_SIZE", "GROUP_RANK"):
        monkeypatch.delenv(key, raising=False)
    assert node_layout() == (1, 0)
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert node_layout() == (1, 0)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setenv("GROUP_RANK", "1")
    assert node_layout() == (2, 1)
    monkeypatch.setenv("GROUP_RANK", "2")
    with pytest.raises(ValueError, match="outside the 2 nodes"):
        node_layout()
    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="does not divide"):
        node_layout()


def _settings(root, **extra):
    settings = {
        "datasetName": "scdx16p100", "modelName": "centerOffsetRes10q",
        "trainName": "nodes", "batchSize": BATCH, "validationBatchSize": 4,
        "iterations": 2, "validation": 100, "snapshot": 100,
        "learningRate": 1e-3, "residency": "host",
        "dirTemp": str(root / "temp") + "/",
        "dirResult": str(root / "results") + "/",
        "dirDataset": str(root) + "/"}
    settings.update(extra)
    return settings


def test_a_shard_without_a_batch_raises(archive, datasets, tmp_path,
                                        monkeypatch):
    cfg = Configuration()
    cfg.update_config(_settings(tmp_path, batchSize=8))
    factory = NetworkFactory(cfg, dataset=datasets[0], device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    monkeypatch.setenv("GROUP_RANK", "2")
    with pytest.raises(RuntimeError, match=r"this node's dataset shard \(5 "
                       r"of 17 rows over 3 node\(s\)\) yields no batches of "
                       r"size 8"):
        factory.begin_training()


def test_two_nodes_train_their_blocks_of_jax_node_batches(
        archive, datasets, tmp_path):
    jobs = [{"name": "nodes", "settings": _settings(
        tmp_path / "rank{rank}"), "archive": archive,
        "begin_training": True, "record_rows": True}]
    ranks = run_ranks(2, jobs, str(tmp_path / "ranks"), nodes=2,
                      every_rank=True)
    jax_ds = datasets[1]
    half = BATCH // 2
    for rank, result in enumerate(ranks):
        out = result["nodes"]
        assert out["summary"]["steps"] == 2 and len(out["rows"]) == 2
        want = list(jax_ds.epoch_batches(BATCH, 2, rank, epoch=0))
        block = slice(rank * half, (rank + 1) * half)
        for got, batch in zip(out["rows"], want):
            for g, w in zip(got, batch):
                assert g.tobytes() == w[block].tobytes()
