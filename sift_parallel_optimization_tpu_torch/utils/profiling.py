"""Timing on the card: CUDA events per call, and device kernel time from
``torch.profiler``. Both raise when there is no card: a CPU time is never
reported as a device time."""

from __future__ import annotations

import statistics
from typing import Any, Callable

import torch


def _require_cuda(name: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(f"{name} needs a CUDA device")


def cuda_time_ms(fn: Callable[..., Any], *args, warmup: int = 3, iters: int = 20) -> float:
    """Median milliseconds of ``fn(*args)`` between two CUDA events on the
    current stream, over ``iters`` calls after ``warmup`` untimed ones.

    Where the host takes longer to enqueue a call than the device to run
    it, this is the host's time: what a caller of ``fn`` waits for.
    """
    _require_cuda("cuda_time_ms")
    for _ in range(warmup):
        fn(*args)
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


# A torch.profiler run can lose its FIRST device records while tracing
# starts up (seen on torch 2.11: now and then the first 20-70 launches of a
# run, about its first millisecond; the host-side launch records are all
# kept), and device and host records need not share a clock to the
# microsecond. So a run opens with launches nobody needs and a pause, the
# timed calls run last, inside a marked host range after a synchronize, and
# the device records that count are the last ones of the run, as many as
# the host launched inside the range. A run that kept too few is made again.
_SACRIFICED = 64
_SETTLE_S = 0.005
_ATTEMPTS = 3
_MARK = "sift.timed_calls"
_LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpy", "cudaMemset")


def profile_device(fn: Callable[..., Any], *args, warmup: int = 3, iters: int = 20):
    """(device ops per call, device ms per call, the finished profile) of
    ``fn(*args)``: the device activity (kernels, copies, sets) of ``iters``
    calls in one ``torch.profiler`` run, host enqueue time excluded. Raises
    if the profiler keeps losing records of the timed calls."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    _require_cuda("profile_device")
    spare = torch.zeros(1, device="cuda")
    for attempt in range(_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(_SACRIFICED):
                spare.zero_()
            torch.cuda.synchronize()
            time.sleep(_SETTLE_S)
            for _ in range(warmup):
                fn(*args)
            torch.cuda.synchronize()
            with record_function(_MARK):
                for _ in range(iters):
                    fn(*args)
                torch.cuda.synchronize()
        events = prof.events()
        mark = next(e for e in events if e.name == _MARK and e.device_type == DeviceType.CPU)
        t0, t1 = mark.time_range.start, mark.time_range.end
        launched = sum(1 for e in events if e.device_type == DeviceType.CPU
                       and e.name.startswith(_LAUNCHES) and t0 <= e.time_range.start <= t1)
        device = sorted((e for e in events
                         if e.device_type == DeviceType.CUDA and not e.is_user_annotation),
                        key=lambda e: e.time_range.start)
        if len(device) > launched:
            timed = device[len(device) - launched:]
            return launched / iters, sum(e.device_time_total for e in timed) / 1e3 / iters, prof
    raise RuntimeError(f"the profiler kept {len(device)} device records of a run whose "
                       f"{iters} timed calls alone launched {launched}, {_ATTEMPTS} times over")


def device_kernel_ms(fn: Callable[..., Any], *args, warmup: int = 3, iters: int = 20) -> float:
    """Device milliseconds per call of ``fn(*args)`` (see :func:`profile_device`)."""
    return profile_device(fn, *args, warmup=warmup, iters=iters)[1]
