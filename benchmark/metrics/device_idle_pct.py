"""``device_idle_pct.<split>``: the share of the traced time in which no
operation runs on the device, all on the trace's clock. Open loop
(``live``): the time is the union of the traced frames' service spans,
each from the frame's due time to its features' completion, since the
waits for the camera are not the program's. Closed loop: the traced
window, from the first traced unit's upload to the end of the last one's
device work. Device trace; the profiler's own cost on the host is in it."""

from benchmark.trace import union


def read(run):
    if not run.trace:
        return None
    traced = run.traced_units()
    if not traced:
        return None
    if "due" in traced[0]:
        spans = union([(run.to_trace(u["due"]), run.to_trace(u["done"])) for u in traced])
    else:
        spans = [run.trace_window]
    length = sum(b - a for a, b in spans)
    if length <= 0:
        return None
    busy = sum(run.trace.busy_us(a, b) for a, b in spans)
    return 100.0 * (1.0 - busy / length)
