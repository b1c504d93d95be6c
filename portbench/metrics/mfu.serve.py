"""The model's share of the card's float32 peak while serving: forward
operations a clip (``flops.py``) times the clips served in the traced
window, over its seconds and the float32 rate outside the tensor cores
(serving runs float32 with TF32 off), in %."""

from portbench.metrics_common import peak


def read(record):
    if record["kind"] != "serve" or not record["completed"]:
        return None
    rate = record["flops_per_clip"] * record["clips_per_request"] \
        * record["completed"] / record["window_s"]
    return 100.0 * rate / peak("float32")
