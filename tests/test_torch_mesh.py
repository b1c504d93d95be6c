"""The port's mesh (``parallel/mesh.py``) against the JAX package's:
``mesh_from_config``'s geometry and refusals, message for message, and
the tensor-parallel sharding rule, parameter for parameter through the
converter's key map, on the conftest's eight virtual CPU devices; and
the dataset's resident shards (``device_shards``,
``steps_per_epoch_resident``, ``epoch_local_indices``) against the JAX
dataset's. Besides, the collective timeout of the groups the port makes
(two gloo ranks, ``torch_dist_worker.run_ranks``).

The port lays the ``data`` and ``model`` axes over ``torchrun`` ranks
and the ``pipe`` axis over a rank's devices, so a JAX mesh over N
devices is a port mesh of ``world_size`` ranks of ``len(devices)``
devices each, N = world_size x len(devices) (every case states both).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scd_resnet_tpu.data.dataset import SCDDataset as JaxDataset
from scd_resnet_tpu.parallel.mesh import mesh_from_config as jax_mesh_from_config
from scd_resnet_tpu.parallel.mesh import tree_param_shardings as jax_shardings
from scd_resnet_tpu_torch.core.convert import state_dict_from_flax
from scd_resnet_tpu_torch.data.dataset import SCDDataset
from scd_resnet_tpu_torch.data.synthetic import make_archive
from scd_resnet_tpu_torch.parallel import mesh as port_mesh
from scd_resnet_tpu_torch.train.registry import get_model_profile

from torch_dist_worker import run_ranks
from torch_port_common import jax_center_model

# (meshShape, meshAxes, batchSize, ranks, devices a rank); the JAX side
# takes ranks x devices of the eight virtual devices
CASES = {
    "data_model": ([4, 2], None, None, 8, 1),
    "three_axes": ([2, 2, 2], None, None, 4, 2),
    "named_axes": ([2, 4], ["model", "data"], 8, 8, 1),
    "pipe_only": ([1, 2], ["data", "pipe"], 8, 1, 2),
    "too_few_devices": ([16], None, None, 8, 1),
    "batch_not_divisible": ([3, 2], None, 8, 6, 1),
    "axes_mismatch": ([4, 2], ["data"], None, 8, 1),
    "no_data_axis": ([4, 2], ["model", "pipe"], None, 8, 1),
    "rank_four": ([1, 1, 1, 1], None, None, 1, 1),
}


def _jax(shape, axes, batch, ranks, per):
    devices = jax.devices()[:ranks * per]
    try:
        mesh = jax_mesh_from_config(shape, axes, devices, batch_size=batch)
    except ValueError as exc:
        return str(exc)
    return mesh.axis_names, dict(mesh.shape)


def _port(shape, axes, batch, ranks, per):
    try:
        mesh = port_mesh.mesh_from_config(
            shape, axes, ["cpu"] * per, batch_size=batch, world_size=ranks)
    except ValueError as exc:
        return str(exc)
    return mesh.axis_names, mesh.shape


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_from_config_matches_jax(case):
    want = _jax(*CASES[case])
    assert _port(*CASES[case]) == want
    if case in ("data_model", "three_axes", "named_axes", "pipe_only"):
        assert not isinstance(want, str)
    else:
        assert isinstance(want, str)


def test_ranks_must_fill_the_process_axes():
    """A rank cannot sit idle as a spare JAX device does: data x model
    must equal the world size (the JAX mesh takes the first 2 of 4)."""
    with pytest.raises(ValueError, match="runs data x model = 2 ranks; "
                                         "this run has 4"):
        port_mesh.mesh_from_config([2], world_size=4)
    assert dict(jax_mesh_from_config([2], devices=jax.devices()[:4]).shape) \
        == {"data": 2}


def test_rank_coordinates_and_rows():
    mesh = port_mesh.Mesh(("model", "data"), (2, 3), rank=4)
    assert mesh.coords == {"model": 1, "data": 1}
    assert mesh.size("pipe") == 1 and mesh.group("pipe") is None
    rows = np.arange(12).reshape(6, 2)
    np.testing.assert_array_equal(port_mesh.shard_rows(mesh, rows),
                                  rows[2:4])
    with pytest.raises(ValueError, match="does not split"):
        port_mesh.shard_rows(mesh, rows[:4])
    with pytest.raises(RuntimeError, match="no process group"):
        mesh.group("data")


def test_stage_devices(monkeypatch):
    cpu = torch.device("cpu")
    assert port_mesh.stage_devices("cpu", 2, 1) == [cpu, cpu]
    card = torch.device("cuda", 3)
    assert port_mesh.stage_devices(card, 2, 1) == [card, card]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert port_mesh.stage_devices(torch.device("cuda"), 1, 2) == \
        [torch.device("cuda", 2)]
    with pytest.raises(RuntimeError, match="needs cuda:3"):
        port_mesh.stage_devices(torch.device("cuda"), 2, 1)


def test_sharded_parameters_match_jax():
    """``centerOffsetRes10q`` on a (4, 2) data x model mesh: the port's
    rule shards exactly the parameters whose JAX counterparts carry the
    'model' axis, each along its output channels. Marker trees (ones
    where JAX shards, zeros elsewhere) go through the converter, so the
    comparison is name for name through its key map."""
    model = jax_center_model()
    abstract = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1)), train=False))
    specs = jax_shardings(jax_mesh_from_config([4, 2]), abstract)

    def markers(tree, spec_tree):
        return jax.tree_util.tree_map(
            lambda leaf, sharding: np.full(
                leaf.shape, 1.0 if "model" in sharding.spec else 0.0,
                np.float32), tree, spec_tree)

    state = state_dict_from_flax(
        "centerOffsetRes10q", markers(abstract["params"], specs["params"]),
        markers(abstract["batch_stats"], specs["batch_stats"]))
    port = get_model_profile("centerOffsetRes10q").build()
    rule = port_mesh.tree_param_shardings(
        port_mesh.Mesh(("data", "model"), (4, 2)), port)
    params = dict(port.named_parameters())
    assert rule.keys() == params.keys()
    sharded = {name for name, dim in rule.items() if dim is not None}
    want = {name for name in params if bool(state[name].all())}
    assert sharded == want and len(sharded) == 12
    for name in params:
        assert bool(state[name].any()) == (name in sharded), name
    modules = dict(port.named_modules())
    for name in sharded:
        module = modules[name.rsplit(".", 1)[0]]
        out_dim = 1 if isinstance(module, torch.nn.ConvTranspose2d) else 0
        assert rule[name] == out_dim, name
    # a one-axis data mesh replicates everything (plain data parallelism)
    assert not any(port_mesh.tree_param_shardings(
        port_mesh.Mesh(("data",), (8,)), port).values())


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    """A tiny synthetic archive: 16 training rows of 64^2."""
    path = str(tmp_path_factory.mktemp("shards") / "scdx16p100.d")
    make_archive(path, num_images=2, reps=2, clips_per_image=5, size=64)
    return path


@pytest.mark.parametrize("shards,batch", [(2, 4), (4, 4), (2, 6)])
def test_resident_shards_match_jax(archive, shards, batch):
    """The data ranks' resident rows, the epoch length and every epoch's
    shard-major index vectors equal the JAX dataset's (6 rows over 2
    shards leaves a tail of 2 rows a shard)."""
    port = SCDDataset(archive, None, test_set=4, seed=42, device="cpu")
    ref = JaxDataset(archive, None, test_set=4, seed=42)
    rows, local = port.device_shards(shards)
    want_rows, want_local = ref.device_shards(shards)
    assert [r.tolist() for r in rows] == [r.tolist() for r in want_rows]
    assert [t.tolist() for t in local] == [t.tolist() for t in want_local]
    steps = port.steps_per_epoch_resident(batch, shards, local)
    assert steps == ref.steps_per_epoch_resident(batch, shards, want_local)
    assert steps > 1
    for epoch, skip in ((0, 0), (3, 1)):
        got = list(port.epoch_local_indices(batch, epoch, skip,
                                            num_shards=shards,
                                            local_train=local))
        want = list(ref.epoch_local_indices(batch, shards, want_local,
                                            epoch, skip))
        assert len(got) == steps - skip
        assert [g.tolist() for g in got] == [w.tolist() for w in want]


GROUP_TIMEOUT_S = 5.0  # the launch's collective timeout, every group's


def test_a_skipped_all_reduce_raises_within_the_group_timeout(tmp_path):
    """Two gloo ranks, mesh ``[2]``, whose default group was started with
    a timeout of ``GROUP_TIMEOUT_S``: rank 1 leaves out one all-reduce on
    its data line and stays up, so rank 0's wait on that group ends by
    the timeout the group was made with (gloo's own default is 30 min,
    beyond the launch's wall limit). The slack covers the wait's own
    start and the error's unwinding."""
    t0 = time.perf_counter()
    got = run_ranks(2, [{"name": "skip", "kind": "skip", "skip_rank": 1}],
                    str(tmp_path), collective_timeout_s=GROUP_TIMEOUT_S,
                    timeout_s=30)["skip"]
    assert got["raised"], got
    assert "timed out" in got["raised"].lower() or \
        "timeout" in got["raised"].lower(), got["raised"]
    assert GROUP_TIMEOUT_S - 0.5 <= got["seconds"] <= GROUP_TIMEOUT_S + 2.0
    assert time.perf_counter() - t0 < 30
