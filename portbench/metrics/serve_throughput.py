"""Clips served per second: the clips of every slide completed in the
window over the window's seconds (host clock)."""


def read(record):
    if record["kind"] != "serve":
        return None
    return record["clips_per_request"] * record["completed"] \
        / record["window_s"]
