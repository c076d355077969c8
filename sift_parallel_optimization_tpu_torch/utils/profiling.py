"""Timing and structured metrics (port of ``utils/profiling.py``).

On the card only: CUDA events per call (:func:`cuda_time_ms`) and device
kernel time from ``torch.profiler`` (:func:`profile_device`); both raise
when there is no card, so a CPU time is never reported as a device time.
On any device: the JAX package's wall-clock timers, :func:`steady_state_ms`
(mean wall ms of a call, synchronized) and :func:`chained_slope_ms` (the
slope between a short and a long chain of a step that feeds itself), a
``torch.profiler`` trace context (:func:`profiler_trace`) and a JSONL
metrics sink (:class:`MetricsWriter`). The wall-clock timers time what
they run on: a CPU run times the CPU.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import sys
import time
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
_GRAPH_LAUNCH = "cudaGraphLaunch"


def profile_device(fn: Callable[..., Any], *args, warmup: int = 3, iters: int = 20):
    """(device ops per call, device ms per call, the finished profile) of
    ``fn(*args)``: the device activity (kernels, copies, sets) of ``iters``
    calls in one ``torch.profiler`` run, host enqueue time excluded. Raises
    if the profiler keeps losing records of the timed calls.

    Where the timed calls replay CUDA graphs, one host launch stands for
    many device records, so they are not counted from the launches: the
    records that count are those that start less than half a settling pause
    before the marked host range (the timed calls start after such a pause)."""
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
            time.sleep(_SETTLE_S)
            with record_function(_MARK):
                for _ in range(iters):
                    fn(*args)
                torch.cuda.synchronize()
        events = prof.events()
        mark = next(e for e in events if e.name == _MARK and e.device_type == DeviceType.CPU)
        t0, t1 = mark.time_range.start, mark.time_range.end
        host = [e.name for e in events if e.device_type == DeviceType.CPU
                and t0 <= e.time_range.start <= t1]
        launched = sum(1 for name in host if name.startswith(_LAUNCHES))
        device = sorted((e for e in events
                         if e.device_type == DeviceType.CUDA and not e.is_user_annotation),
                        key=lambda e: e.time_range.start)
        if _GRAPH_LAUNCH in host:
            # time_range is in microseconds.
            timed = [e for e in device if e.time_range.start >= t0 - _SETTLE_S * 5e5]
            if len(timed) > launched:
                return (len(timed) / iters, sum(e.device_time_total for e in timed) / 1e3 / iters,
                        prof)
        elif len(device) > launched:
            timed = device[len(device) - launched:]
            return launched / iters, sum(e.device_time_total for e in timed) / 1e3 / iters, prof
    raise RuntimeError(f"the profiler kept {len(device)} device records of a run whose "
                       f"{iters} timed calls alone launched {launched}, {_ATTEMPTS} times over")


def device_kernel_ms(fn: Callable[..., Any], *args, warmup: int = 3, iters: int = 20) -> float:
    """Device milliseconds per call of ``fn(*args)`` (see :func:`profile_device`)."""
    return profile_device(fn, *args, warmup=warmup, iters=iters)[1]


def _synchronize() -> None:
    """Wait for the card's queued work, where the card is in use (the
    port's ``jax.block_until_ready``)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def steady_state_ms(fn: Callable[[], Any], min_seconds: float = 1.0, warmup: int = 2) -> float:
    """Mean wall ms per call of ``fn()``, repeated until ``min_seconds`` have
    passed, each call waited for (``torch.cuda.synchronize`` on the card):
    the latency a caller sees, host included."""
    for _ in range(warmup):
        fn()
    _synchronize()
    t0 = time.perf_counter()
    runs = 0
    while time.perf_counter() - t0 < min_seconds:
        fn()
        _synchronize()
        runs += 1
    return (time.perf_counter() - t0) / runs * 1e3


def chained_slope_ms(
    step: Callable[[torch.Tensor], torch.Tensor],
    example: torch.Tensor,
    chain_lo: int = 50,
    chain_hi: int = 400,
    repeats: int = 4,
    median_of: int = 1,
    min_hi_total_ms: float | None = None,
) -> float:
    """Per-iteration ms of ``step`` (a tensor -> scalar function) from the
    slope between two chain lengths.

    A chain runs ``c = c + 1e-30 * step(c)`` ``chain`` times from
    ``example`` (a data dependency no step can skip) and ends in a host read
    of ``c.sum()``; fixed costs per chain (launch, the read) cancel in the
    slope. On the card each chain length is one CUDA graph, captured once
    and replayed, so the slope is the device's time per step without the
    host's enqueue; on the CPU the chain runs eagerly. ``min_hi_total_ms``
    stretches both chains after a pilot run until the long one takes at
    least that long; ``median_of`` takes the median of that many slopes,
    each from the best of ``repeats`` runs of either chain.
    """
    x = example.clone()

    def chain_of(n: int) -> Callable[[], torch.Tensor]:
        def chained():
            c = x
            for _ in range(n):
                c = c + 1e-30 * step(c)
            return c.sum()

        if x.device.type != "cuda":
            return chained
        side = torch.cuda.Stream(x.device)
        side.wait_stream(torch.cuda.current_stream(x.device))
        with torch.cuda.stream(side):
            chained()                               # warm the libraries' handles
        torch.cuda.current_stream(x.device).wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = chained()

        def replay():
            g.replay()
            return out

        return replay

    def total_ms(run) -> float:
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            float(run())
            best = min(best, time.perf_counter() - t0)
        return best * 1e3

    if min_hi_total_ms is not None:
        t = total_ms(chain_of(chain_hi))
        if t < min_hi_total_ms:
            scale = int(min_hi_total_ms / max(t, 1e-3)) + 1
            chain_lo, chain_hi = chain_lo * scale, chain_hi * scale
    lo, hi = chain_of(chain_lo), chain_of(chain_hi)
    float(lo())
    float(hi())
    slopes = sorted(max((total_ms(hi) - total_ms(lo)) / (chain_hi - chain_lo), 0.0)
                    for _ in range(max(median_of, 1)))
    return slopes[len(slopes) // 2]


@contextlib.contextmanager
def profiler_trace(log_dir: str | None):
    """``torch.profiler`` over the block (host, and the card where there is
    one), written on exit as a Chrome/Perfetto trace into ``log_dir``; a
    no-op when ``log_dir`` is None. Yields the trace's path (None without
    ``log_dir``)."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{time.strftime('%Y%m%d-%H%M%S')}.{os.getpid()}.pt.trace.json")
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)


class MetricsWriter:
    """JSONL metrics sink (stdout by default, a file appended to if a path is
    given): one ``{"metric", "value", "unit", **extra}`` record a line."""

    def __init__(self, path: str | None = None):
        self._fh = open(path, "a") if path else sys.stdout
        self._owned = path is not None

    def write(self, metric: str, value: float, unit: str, **extra) -> None:
        rec = {"metric": metric, "value": value, "unit": unit, **extra}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._owned:
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
