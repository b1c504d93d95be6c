"""Nearest-rank 90th percentile of the wall time of every request of the
window, in ms, by the host's clock around ``analyse_raw``; a failed
request counts as the whole window."""

from portbench.harness import nearest_rank


def read(record):
    if record["kind"] != "serve" or not record["latencies_ms"]:
        return None
    return nearest_rank(record["latencies_ms"], 0.9)
