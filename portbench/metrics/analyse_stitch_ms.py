"""Host time a request in the analyzer's stitch, in ms: the port's
``scd.analyse.stitch`` spans (detections to slide pixels, Rhr, dedupe)
that start inside a traced request, summed over the window's requests
and divided by their number; nothing where the port has no such span."""

from portbench.spans import ms_per_request


def read(record):
    return ms_per_request(record, "scd.analyse.stitch")
