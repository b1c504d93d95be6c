"""The trace arithmetic and the end-to-end statistics on hand-made
intervals and samples."""

import pytest

from portbench import harness, metrics_common
from portbench import trace as tracing


def events(device, window=(0.0, 100.0), host=(), spans=None):
    return {"window": window,
            "device": [(s, e, name, cat) for s, e, name, cat in device],
            "host": list(host), "spans": spans or {}}


def test_busy_is_the_union_of_overlapping_intervals():
    ev = events([(10, 30, "a", "kernel"), (20, 40, "b", "kernel"),
                 (35, 50, "c", "gpu_memcpy"), (90, 120, "d", "kernel")])
    # [10, 50] and [90, 100] inside the window: 50 us of 100
    record = {"events": ev}
    assert metrics_common.idle_share(record) == pytest.approx(50.0)
    assert tracing.busy([d[:2] for d in ev["device"]], 0, 100) == 50.0
    assert tracing.gaps(ev) == [(0.0, 10.0), (50.0, 90.0)]


def test_idle_share_of_an_untraced_run_is_absent():
    assert metrics_common.idle_share({"events": None}) is None


def test_breakdown_names_the_host_operation_under_each_gap():
    ev = events([(10, 30, "conv", "kernel"), (60, 70, "bn", "kernel"),
                 (75, 100, "conv", "kernel")],
                host=[(0, 100, "portbench.step"), (35, 55, "aten::item"),
                      (40, 50, "cudaStreamSynchronize")])
    out = tracing.breakdown(ev)
    assert out["device_ops"][0] == ["conv", pytest.approx(45e-6)]
    idle = dict((k, v) for k, v in out["idle_gaps"])
    # gap 30-60 (middle 45: the synchronise), gap 0-10 and 70-75 (step)
    assert idle["cudaStreamSynchronize"] == pytest.approx(30e-6)
    assert idle["portbench.step"] == pytest.approx(15e-6)


@pytest.mark.parametrize("values, q, expected", [
    (list(range(1, 11)), 0.9, 9), (list(range(1, 101)), 0.9, 90),
    ([5.0], 0.9, 5.0), ([3, 1, 2], 0.5, 2), (list(range(1, 12)), 0.9, 10)])
def test_nearest_rank(values, q, expected):
    assert harness.nearest_rank(values, q) == expected


def test_kernel_roofline_counts_bytes_per_launch():
    # two K2 launches on (48, 128, 128, 128) float32: 805 MB each, 0.2404
    # ms at 3.35 TB/s; measured 0.4808 ms in all -> 50 %
    record = {"shape": {"B": 48, "C": 128, "S": 128},
              "events": events([(0, 240.35, "pool_h_kernel(float const*)",
                                 "kernel"),
                                (300, 540.35, "void pool_w_kernel(float*)",
                                 "kernel"),
                                (600, 700, "other_kernel", "kernel")],
                               window=(0, 1000))}
    bound = 2 * 48 * 128 * 128 * 128 * 4 / 3.35e12
    assert metrics_common.kernel_roofline(record) == pytest.approx(
        100.0 * 2 * bound / 480.7e-6, rel=1e-6)


def test_kernel_roofline_is_absent_without_port_kernels():
    record = {"shape": {}, "events": events([(0, 5, "sgemm", "kernel")])}
    assert metrics_common.kernel_roofline(record) is None


def test_launches_and_host_time_readers():
    ev = events([(10, 30, "k", "kernel"), (40, 45, "copy", "gpu_memcpy"),
                 (50, 60, "k", "kernel")],
                spans={"portbench.request": [(0, 50), (50, 100)]})
    host = harness.reader("analyse_host_ms")(
        {"kind": "serve", "events": ev})
    # spans of 50 us with 25 and 10 us of device time: (25 + 40) / 2 us
    assert host == pytest.approx(32.5e-3)
    launches = harness.reader("launches_per_step")(
        {"kind": "train", "events": ev, "steps": 2})
    assert launches == 1.0


def test_a_detection_only_one_side_has_is_left_out_of_the_pairs():
    """Two detections on one pixel in the answer, one of them in the
    reference (the other fell under the threshold there): one unmatched,
    and the remaining pair compared with its true partner."""
    from portbench.compare import detections

    contract = {"key": [0, 1, 3], "value": 2}
    ours = [[10, 20, 0.35, "ct"], [10, 20, 0.51, "ct"], [5, 5, 0.9, "tl"]]
    theirs = [[10, 20, 0.51 + 1e-6, "ct"], [5, 5, 0.9, "tl"]]
    for a, b in ((ours, theirs), (theirs, ours)):
        numbers = detections(a, b, contract)
        assert numbers["unmatched"] == 1
        assert numbers["value_gap"] == pytest.approx(1e-6, abs=1e-9)
