"""Device-idle ms a training step under the port's own Python: the idle
time of the traced window whose innermost open host event is one of the
step's ``scd.step.*`` spans (between operators, in no PyTorch call), by
``portbench.trace.breakdown``'s attribution, so that it agrees with the
result line's ``idle_gaps``; over the window's steps. Nothing where the
port has no such span."""

import sys

from portbench.trace import breakdown

STEP = "scd.step."


def read(record):
    events = record["events"]
    if record["kind"] != "train" or events is None or not record["steps"]:
        return None
    if not any(n.startswith(STEP) for _, _, n in events["host"]):
        return None
    idle = breakdown(events, top=sys.maxsize)["idle_gaps"]
    return 1e3 * sum(s for n, s in idle if n.startswith(STEP)) \
        / record["steps"]
