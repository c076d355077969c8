"""Readers of the program's own span records (``utils/profiling``): the
host span ring (``host_spans``) and the set-up record (``setup_spans``),
(name, start, end) in host ``perf_counter`` seconds, the clock of the
run's units. Each returns None where the program keeps no such record."""

import bisect


def _program_spans(record: str):
    """The program's record ``record`` (a function of its
    ``utils/profiling``), or None where the program has none."""
    try:
        from sift_parallel_optimization_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, record, None)
    return None if read is None else read()


def host_ms(run, span: str):
    """Host milliseconds a frame spent in the program's stage span
    ``span``, over the window's units outside the profiled slice (the
    spans whose start lies in a unit's [start, returned]; units the ring no
    longer holds are left out)."""
    spans = _program_spans("host_spans")
    if not spans:
        return None
    mine = sorted((s, e) for name, s, e in spans if name == span)
    starts = [s for s, _e in mine]
    total, frames = 0.0, 0
    for i, u in enumerate(run.units):
        if i in run.traced:
            continue
        lo = bisect.bisect_left(starts, u["start"])
        hi = bisect.bisect_right(starts, u["returned"])
        if hi > lo:
            total += sum(e - s for s, e in mine[lo:hi])
            frames += u["frames"]
    return total * 1e3 / frames if frames else None


def setup_s(run, span: str):
    """Seconds of the program's set-up span ``span``: the last one that
    ended before the window opened (the run's own frontend)."""
    spans = _program_spans("setup_spans")
    if not spans:
        return None
    mine = [e - s for name, s, e in spans if name == span and e <= run.t0]
    return mine[-1] if mine else None
