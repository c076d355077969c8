"""Timing, spans and structured metrics (port of ``utils/profiling.py``).

On the card only: CUDA events per call (:func:`cuda_time_ms`) and device
kernel time from ``torch.profiler`` (:func:`profile_device`); both raise
when there is no card, so a CPU time is never reported as a device time.
On any device: the JAX package's wall-clock timer
:func:`chained_slope_ms` (the slope between a short and a long chain of a
step that feeds itself), the program's spans (:func:`span`,
:func:`stage_span`, :func:`setup_span`; read back by :func:`host_spans`
and :func:`setup_spans`) and a JSONL metrics sink (:class:`MetricsWriter`).
The wall-clock timers time what they run on: a CPU run times the CPU.
"""

from __future__ import annotations

import collections
import contextlib
import json
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


def _timed_device_events(fn: Callable[..., Any], *args, warmup: int, iters: int):
    """(the device records of ``iters`` timed calls of ``fn(*args)``, the
    finished profile), from one ``torch.profiler`` run (see
    :func:`profile_device`). Raises if the profiler keeps losing records."""
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
                return timed, prof
        elif len(device) > launched:
            return device[len(device) - launched:], prof
    raise RuntimeError(f"the profiler kept {len(device)} device records of a run whose "
                       f"{iters} timed calls alone launched {launched}, {_ATTEMPTS} times over")


def profile_device(fn: Callable[..., Any], *args, warmup: int = 3, iters: int = 20):
    """(device ops per call, device ms per call, the finished profile) of
    ``fn(*args)``: the device activity (kernels, copies, sets) of ``iters``
    calls in one ``torch.profiler`` run, host enqueue time excluded. Raises
    if the profiler keeps losing records of the timed calls.

    Where the timed calls replay CUDA graphs, one host launch stands for
    many device records, so they are not counted from the launches: the
    records that count are those that start less than half a settling pause
    before the marked host range (the timed calls start after such a pause)."""
    timed, prof = _timed_device_events(fn, *args, warmup=warmup, iters=iters)
    return len(timed) / iters, sum(e.device_time_total for e in timed) / 1e3 / iters, prof


def device_breakdown(fn: Callable[..., Any], *args, warmup: int = 1, iters: int = 3,
                     top: int = 8):
    """(device ms per call, [[kernel name, device ms per call, launches per
    call], ...] of the ``top`` names by device time) of ``fn(*args)``, from
    the same records :func:`profile_device` counts (those of replayed CUDA
    graphs included)."""
    timed, _prof = _timed_device_events(fn, *args, warmup=warmup, iters=iters)
    by_name: dict = {}
    for e in timed:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.device_time_total / 1e3, n + 1)
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return (sum(e.device_time_total for e in timed) / 1e3 / iters,
            [[name, ms / iters, n / iters] for name, (ms, n) in rows])


@contextlib.contextmanager
def sm_clock_samples(device, every_ms: int = 20):
    """Sample the card's SM clock (``nvidia-smi --query-gpu=clocks.sm``,
    every ``every_ms`` ms, in a process of its own) while the block runs.
    Yields a dict that gets ``"sm_mhz"``: [least, most] of the samples
    (None on the CPU, or where the block ended before the first sample)."""
    out: dict = {"sm_mhz": None}
    device = torch.device(device)
    if device.type != "cuda":
        yield out
        return
    import subprocess

    index = device.index if device.index is not None else torch.cuda.current_device()
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
         f"--id={index}", "-lms", str(every_ms)],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        yield out
    finally:
        proc.terminate()
        try:
            text, _ = proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            text, _ = proc.communicate()
    mhz = [int(v) for v in text.split() if v.isdigit()]
    out["sm_mhz"] = [min(mhz), max(mhz)] if mhz else None


def device_kernel_ms(fn: Callable[..., Any], *args, warmup: int = 3, iters: int = 20) -> float:
    """Device milliseconds per call of ``fn(*args)`` (see :func:`profile_device`)."""
    return profile_device(fn, *args, warmup=warmup, iters=iters)[1]


def chained_slope_ms(
    step: Callable[[torch.Tensor], torch.Tensor],
    example: torch.Tensor,
    chain_lo: int = 50,
    chain_hi: int = 400,
    repeats: int = 4,
    median_of: int = 1,
    min_hi_total_ms: float | None = None,
    info: dict | None = None,
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
    each from the best of ``repeats`` runs of either chain. ``info``, if
    given, receives the chain lengths used (``"chain"``: [lo, hi], after
    any stretch) and on the card the seconds spent capturing the graphs
    (``"capture_s"``) and the measurement's peak device memory above what
    was allocated when it began (``"peak_mib"``).
    """
    x = example.clone()
    on_card = x.device.type == "cuda"
    capture_s = 0.0
    if on_card:
        torch.cuda.synchronize(x.device)
        torch.cuda.reset_peak_memory_stats(x.device)
        base = torch.cuda.memory_allocated(x.device)

    def chain_of(n: int) -> Callable[[], torch.Tensor]:
        nonlocal capture_s

        def chained():
            c = x
            for _ in range(n):
                c = c + 1e-30 * step(c)
            return c.sum()

        if not on_card:
            return chained
        side = torch.cuda.Stream(x.device)
        side.wait_stream(torch.cuda.current_stream(x.device))
        with torch.cuda.stream(side):
            step(x)                                 # warm the libraries' handles
        torch.cuda.current_stream(x.device).wait_stream(side)
        t0 = time.perf_counter()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = chained()
        capture_s += time.perf_counter() - t0

        def replay():
            g.replay()
            return out

        return replay

    def run_of(n: int) -> Callable[[], None]:
        run = chain_of(n)
        return lambda: float(run())

    ms, chain = slope_ms(run_of, chain_lo, chain_hi, repeats=repeats, median_of=median_of,
                         min_hi_total_ms=min_hi_total_ms)
    if info is not None:
        info["chain"] = chain
        if on_card:
            info["capture_s"] = capture_s
            info["peak_mib"] = (torch.cuda.max_memory_allocated(x.device) - base) / 2**20
    return ms


def slope_ms(
    run_of: Callable[[int], Callable[[], None]],
    lo: int,
    hi: int,
    repeats: int = 4,
    median_of: int = 1,
    min_hi_total_ms: float | None = None,
    before: Callable[[], None] | None = None,
) -> tuple[float, list[int]]:
    """(ms a step, [lo, hi] as used) from the slope between a run of ``lo``
    and one of ``hi`` steps: ``run_of(n)`` gives a callable that runs ``n``
    steps and waits for them. Each run is the best of ``repeats``; the
    slope the median of ``median_of``; ``min_hi_total_ms`` stretches both
    lengths after a pilot run until the long one takes at least that long.
    ``before``, if given, runs (untimed) before every timed run: where the
    steps carry a state, it puts the state back."""

    def total_ms(run) -> float:
        best = float("inf")
        for _ in range(repeats):
            if before is not None:
                before()
            t0 = time.perf_counter()
            run()
            best = min(best, time.perf_counter() - t0)
        return best * 1e3

    if min_hi_total_ms is not None:
        t = total_ms(run_of(hi))
        if t < min_hi_total_ms:
            scale = int(min_hi_total_ms / max(t, 1e-3)) + 1
            lo, hi = lo * scale, hi * scale
    run_lo, run_hi = run_of(lo), run_of(hi)
    for run in (run_lo, run_hi):
        if before is not None:
            before()
        run()
    slopes = sorted(max((total_ms(run_hi) - total_ms(run_lo)) / (hi - lo), 0.0)
                    for _ in range(max(median_of, 1)))
    return slopes[len(slopes) // 2], [lo, hi]


# With no profiler running, an entered ``record_function`` still costs ~10 us
# of host time (torch 2.11, an H100 machine's host); the check in
# :func:`span` ~0.7 us.
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` while a
    profiler runs (on the trace's clock, so device work launched inside it
    is tied to it by correlation id), else a context that does nothing.
    Never synchronizes and launches no device work."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


# The stage spans' host record, kept with or without a profiler: (name,
# start, end) in ``time.perf_counter`` seconds, the newest
# HOST_SPAN_CAPACITY of them (a 51-s stream of 8-frame 640x480 batches, ~76
# a second, three stage spans each, makes ~12k).
HOST_SPAN_CAPACITY = 2**15
_HOST_SPANS: collections.deque = collections.deque(maxlen=HOST_SPAN_CAPACITY)
# Set-up spans, once a frontend (its construction, its first forward), kept
# apart so that no run of stages evicts them; the newest SETUP_SPAN_CAPACITY,
# so that a caller building a frontend a call does not grow it without end.
SETUP_SPAN_CAPACITY = 256
_SETUP_SPANS: collections.deque = collections.deque(maxlen=SETUP_SPAN_CAPACITY)


class _RecordedSpan:
    """:func:`span` ``name``, its host start and end appended to ``sink``
    when it closes (an exception included)."""

    __slots__ = ("_name", "_sink", "_inner", "_start")

    def __init__(self, name: str, sink: collections.deque):
        self._name, self._sink = name, sink

    def __enter__(self):
        self._inner = span(self._name)
        self._inner.__enter__()
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sink.append((self._name, self._start, time.perf_counter()))
        return self._inner.__exit__(*exc)


def stage_span(name: str) -> _RecordedSpan:
    """:func:`span` ``name``, also recorded in the host span ring."""
    return _RecordedSpan(name, _HOST_SPANS)


def setup_span(name: str) -> _RecordedSpan:
    """:func:`span` ``name``, also recorded in the set-up record."""
    return _RecordedSpan(name, _SETUP_SPANS)


def host_spans() -> list[tuple[str, float, float]]:
    """A copy of the host span ring, oldest first: (name, start, end),
    ``time.perf_counter`` seconds."""
    return list(_HOST_SPANS)


def setup_spans() -> list[tuple[str, float, float]]:
    """A copy of the set-up record, oldest first: (name, start, end),
    ``time.perf_counter`` seconds."""
    return list(_SETUP_SPANS)


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
