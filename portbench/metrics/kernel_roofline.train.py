"""The port's own kernels while training, as ``kernel_roofline.serve``."""

from portbench.metrics_common import kernel_roofline


def read(record):
    return kernel_roofline(record) if record["kind"] == "train" else None
