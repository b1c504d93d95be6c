"""Host time a request, in ms: each traced request's wall span less the
device-busy time inside it, summed over the window's requests and
divided by their number (the upload, tiling's host part, the stitch, Rhr
and the lock as the host sees them)."""

from portbench.trace import busy


def read(record):
    events = record["events"]
    if record["kind"] != "serve" or events is None:
        return None
    spans = events["spans"].get("portbench.request", [])
    if not spans:
        return None
    device = [d[:2] for d in events["device"]]
    host = sum((e - s) - busy(device, s, e) for s, e in spans)
    return host / len(spans) / 1e3
