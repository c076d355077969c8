"""What the loops share: the harness's profiler spans, the camera clock's
wait, the device's completion markers and the traced slice."""

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
