"""The two ways traffic reaches the frontend, named by a mix's ``loop``.

Each loop runs the window and returns (t0, units): the window's start and
one record a unit (a frame, or a batch of frames), host ``perf_counter``
seconds: ``due`` (open loop only), ``start`` (upload begins), ``returned``
(the program's call returned), ``done`` (the unit's features complete on
the device) and ``frames``. With a profiler, the mix's ``trace_units``
units from ``trace_from`` on run under it, inside the harness's spans
``bench.sleep`` (waiting for the camera clock), ``bench.upload``,
``bench.forward`` and ``bench.sync`` (waiting for the device).
"""

from __future__ import annotations

import contextlib
import time

import torch

_SPIN_S = 0.0005


def _span(name: str, on: bool):
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


def _sleep_until(t: float) -> None:
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        if left > _SPIN_S:
            time.sleep(left - _SPIN_S)


def _marker(dev):
    """A timing event recorded on the device's stream after a unit's work
    (None on the CPU)."""
    if dev.type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _traced(run, n_units: int | None) -> range:
    a = int(run.mix["trace_from"])
    n = int(run.mix["trace_units"])
    return range(a, a + n if n_units is None else min(a + n, n_units))


def camera(upload, forward, keep, run, dev, args, profiler):
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


def batches(upload, forward, keep, run, dev, args, profiler):
    """Closed loop over batches, as a job reading a recorded sequence: the
    host uploads and enqueues batch i + 1 while the card runs batch i, and
    waits for batch i - 1 before it enqueues more (one batch in flight).
    Issues batches until the window's seconds have passed on the host
    clock; a batch is done when its marker completes on the device."""
    traced = _traced(run, None) if profiler is not None else range(0)
    run.traced = traced
    units, marks = [], []
    start_ev = _marker(dev)
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() < t0 + args.seconds:
        on = i in traced
        if i > 1 and marks[i - 2] is not None:
            with _span("bench.sync", on):
                marks[i - 2].synchronize()
        if profiler is not None and i == traced.start:
            profiler.start()
        start = time.perf_counter()
        with _span("bench.upload", on):
            x = upload(i)
        with _span("bench.forward", on):
            out = forward(x)
        marks.append(_marker(dev))
        returned = time.perf_counter()
        keep(i, out)
        if on:
            run.traced_out[i] = out
        units.append({"start": start, "returned": returned, "frames": run.mix["batch"]})
        if profiler is not None and i == traced.stop - 1:
            if marks[-1] is not None:
                with _span("bench.sync", on):
                    marks[-1].synchronize()
            profiler.stop()
        i += 1
    if profiler is not None and traced.start < i < traced.stop:
        profiler.stop()
    run.traced = range(traced.start, min(traced.stop, max(i, traced.start)))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        for u, ev in zip(units, marks):
            u["done"] = t0 + start_ev.elapsed_time(ev) / 1e3
    else:
        for u in units:
            u["done"] = u["returned"]
    return t0, units
