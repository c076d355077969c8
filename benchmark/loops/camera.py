"""The open loop at the camera's rate (see :mod:`benchmark.loops`)."""

from __future__ import annotations

import time

from benchmark.loops._shared import _marker, _sleep_until, _span, _traced


def drive(upload, forward, keep, run, dev, args, profiler):
    """Open loop at the camera's rate (the configuration's ``camera_hz``):
    frame i is due at t0 + i / rate whatever became of the
    earlier frames, uploaded and run alone, and the host waits for its
    features before it takes the next (a tracker consuming features frame
    by frame). Every frame due in the window runs."""
    rate = float(run.cfg["camera_hz"])
    n = int(round(args.seconds * rate))
    traced = _traced(run, n) if profiler is not None else range(0)
    run.traced = traced
    units = []
    t0 = time.perf_counter() + 0.01
    base, i_base = t0, 0          # frame i is due at base + (i - i_base) / rate
    for i in range(n):
        on = i in traced
        if profiler is not None and len(traced) and i in (traced.start, traced.stop):
            # Starting or stopping the tracer holds the host for seconds; the
            # camera clock restarts when it returns, so that no frame, traced
            # or not, is served from the backlog it would leave.
            if i == traced.start:
                profiler.start()
            else:
                profiler.stop()
            base, i_base = time.perf_counter(), i
        due = base + (i - i_base) / rate
        with _span("bench.sleep", on):
            _sleep_until(due)
        start = time.perf_counter()
        with _span("bench.upload", on):
            x = upload(i)
        with _span("bench.forward", on):
            out = forward(x)
        ev = _marker(dev)
        returned = time.perf_counter()
        with _span("bench.sync", on):
            if ev is not None:
                ev.synchronize()
        done = time.perf_counter()
        keep(i, out)
        if on:
            run.traced_out[i] = out
        units.append({"due": due, "start": start, "returned": returned, "done": done,
                      "frames": run.mix["batch"]})
    if profiler is not None and len(traced) and traced.stop == n:
        profiler.stop()
    return t0, units
