"""Device kernel launches a training step: kernels in the traced window
over its steps (copies and fills not counted)."""


def read(record):
    events = record["events"]
    if record["kind"] != "train" or events is None or not record["steps"]:
        return None
    return sum(1 for d in events["device"] if d[3] == "kernel") \
        / record["steps"]
