"""Device-idle ms a training step under the model's own Python: the idle
time of the traced window whose innermost open host event is one of the
model's ``scd.model.*`` spans (the stacked hourglass's recursion, the
corner branches; between operators, in no PyTorch call), by
``portbench.trace.breakdown``'s attribution, as ``step_python_idle_ms``
reads the step's spans; over the window's steps. Nothing where the port
has no such span."""

import sys

from portbench.trace import breakdown

MODEL = "scd.model."


def read(record):
    events = record["events"]
    if record["kind"] != "train" or events is None or not record["steps"]:
        return None
    if not any(n.startswith(MODEL) for _, _, n in events["host"]):
        return None
    idle = breakdown(events, top=sys.maxsize)["idle_gaps"]
    return 1e3 * sum(s for n, s in idle if n.startswith(MODEL)) \
        / record["steps"]
