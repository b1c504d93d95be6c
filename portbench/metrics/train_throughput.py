"""Clips trained per second: the batch times the steps of the window over
its seconds, the window ending in a synchronise (host clock)."""


def read(record):
    if record["kind"] != "train":
        return None
    return record["batch"] * record["steps"] / record["window_s"]
