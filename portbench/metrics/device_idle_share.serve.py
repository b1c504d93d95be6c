"""The share of the traced serving window in which no device operation
ran: 1 - the union of kernel, copy and fill intervals over the window,
in %."""

from portbench.metrics_common import idle_share


def read(record):
    return idle_share(record) if record["kind"] == "serve" else None
