"""``detect_host_ms.<split>``: host milliseconds a frame in the program's
``sift.detect`` stage span, read from its host span ring over the window's
units outside the profiled slice (so the profiler's own cost is not in
it). Program span."""

from benchmark.metrics._spans import host_ms


def read(run):
    return host_ms(run, "sift.detect")
