"""Set-up time: process start to the first timed request or step (host
clock); it holds loading, warming up and, in a run that builds, the
build."""


def read(record):
    return record["setup_s"]
