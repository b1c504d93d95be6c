"""The port's own kernels while serving: the sum of each launch's
roofline time (``kernels/*.json``) over the sum of their measured device
time in the traced window, in %; nothing where none ran."""

from portbench.metrics_common import kernel_roofline


def read(record):
    return kernel_roofline(record) if record["kind"] == "serve" else None
