"""``host_enqueue_ms.<split>``: host milliseconds a frame from the start of
its upload to the program's call returning, over the window's units that
ran outside the profiled slice (so the profiler's own cost is not in it).
Host clock."""


def read(run):
    units = [u for i, u in enumerate(run.units) if i not in run.traced]
    frames = sum(u["frames"] for u in units)
    return sum(u["returned"] - u["start"] for u in units) * 1e3 / frames if frames else None
