"""The model's share of the card's bfloat16 peak while training: three
times the forward operations a clip (forward and backward; recomputed
work is not counted) times the clips trained in the traced window, over
its seconds and the dense bfloat16 rate, in %."""

from portbench.metrics_common import peak


def read(record):
    if record["kind"] != "train" or not record["steps"]:
        return None
    rate = 3 * record["flops_per_clip"] * record["batch"] * record["steps"] \
        / record["window_s"]
    return 100.0 * rate / peak("bfloat16")
