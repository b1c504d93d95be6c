"""Host time a request in the analyzer's upload, in ms: the port's
``scd.analyse.upload`` spans (uint8 coercion, pinning, the non-blocking
copy) that start inside a traced request, summed over the window's
requests and divided by their number; nothing where the port has no such
span."""

from portbench.spans import ms_per_request


def read(record):
    return ms_per_request(record, "scd.analyse.upload")
