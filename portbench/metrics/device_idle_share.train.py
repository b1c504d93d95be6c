"""The share of the traced training window in which no device operation
ran, in % (as ``device_idle_share.serve``)."""

from portbench.metrics_common import idle_share


def read(record):
    return idle_share(record) if record["kind"] == "train" else None
