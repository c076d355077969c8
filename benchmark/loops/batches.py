"""The closed loop over batches (see :mod:`benchmark.loops`)."""

from __future__ import annotations

import time

import torch

from benchmark.loops._shared import _marker, _span, _traced


def drive(upload, forward, keep, run, dev, args, profiler):
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
