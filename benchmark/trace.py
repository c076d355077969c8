"""What a traced run reads from ``torch.profiler``'s trace.

The profiler's Chrome trace (``export_chrome_trace``) is reduced to three
lists, all times in microseconds on the trace's one clock:

* ``device``: the operations that ran on the card (kernels, copies, sets),
  each with the correlation id of the host call that launched it;
* ``host_calls``: the CUDA runtime and driver calls on the host
  (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...), with their ids;
* ``spans``: the named host ranges (``torch.profiler.record_function``):
  the program's own (``sift.pyramid``, ``sift.detect``, ``sift.describe``)
  and the harness's (``bench.*``).

A device operation belongs to a span when the host call that launched it
started inside that span (matched by correlation id). The launch counting
and the device-busy union are copies of the arithmetic in the program's
``utils/profiling.profile_device``: calls whose names start with
``cudaLaunchKernel``, ``cuLaunchKernel``, ``cudaMemcpy`` or ``cudaMemset``
count as launches, and busy time is the union of the device operations'
intervals.
"""

from __future__ import annotations

import bisect
import json
from dataclasses import dataclass

LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpy", "cudaMemset")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CALL_CATS = ("cuda_runtime", "cuda_driver")


@dataclass(frozen=True)
class Event:
    name: str
    ts: float          # start, us
    dur: float         # us
    corr: int = -1     # correlation id (-1: none)

    @property
    def end(self) -> float:
        return self.ts + self.dur


class Trace:
    def __init__(self, device: list[Event], host_calls: list[Event], spans: list[Event]):
        self.device = sorted(device, key=lambda e: e.ts)
        self.host_calls = sorted(host_calls, key=lambda e: e.ts)
        self.spans = sorted(spans, key=lambda e: e.ts)
        self._launch_ts = {e.corr: e.ts for e in self.host_calls if e.corr >= 0}

    @classmethod
    def from_chrome(cls, events: list[dict]) -> "Trace":
        """From the ``traceEvents`` of a Chrome trace."""
        device, calls, spans = [], [], []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            corr = int((e.get("args") or {}).get("correlation", -1))
            ev = Event(e["name"], float(e["ts"]), float(e.get("dur", 0.0)), corr)
            if cat in DEVICE_CATS:
                device.append(ev)
            elif cat in HOST_CALL_CATS:
                calls.append(ev)
            elif cat == "user_annotation":
                spans.append(ev)
        return cls(device, calls, spans)

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as fh:
            return cls.from_chrome(json.load(fh)["traceEvents"])

    def __bool__(self) -> bool:
        """Whether any operation ran on the device in the trace."""
        return bool(self.device)

    def spans_named(self, name: str) -> list[Event]:
        return [s for s in self.spans if s.name == name]

    def launch_ts(self, op: Event) -> float | None:
        """Host start of the call that launched a device operation."""
        return self._launch_ts.get(op.corr)

    def ops_in(self, spans: list[Event]) -> list[Event]:
        """Device operations launched from inside any of ``spans``."""
        inside = _Within(spans)
        return [op for op in self.device if inside(self.launch_ts(op))]

    def launches_in(self, spans: list[Event]) -> int:
        """Launch calls made inside any of ``spans``."""
        inside = _Within(spans)
        return sum(1 for c in self.host_calls if c.name.startswith(LAUNCHES) and inside(c.ts))

    def busy_us(self, lo: float, hi: float) -> float:
        """Microseconds of [lo, hi] in which some device operation ran."""
        return union_length([(max(op.ts, lo), min(op.end, hi)) for op in self.device
                             if op.end > lo and op.ts < hi])

    def idle_gaps(self, lo: float, hi: float) -> list[tuple[float, float]]:
        """The intervals of [lo, hi] in which no device operation ran."""
        gaps, at = [], lo
        for op in self.device:
            if op.end <= lo or op.ts >= hi:
                continue
            if op.ts > at:
                gaps.append((at, op.ts))
            at = max(at, op.end)
        if at < hi:
            gaps.append((at, hi))
        return gaps

    def innermost_span(self, t: float, prefixes=("bench.", "sift.")) -> str:
        """Name of the shortest span with one of ``prefixes`` holding host time ``t``."""
        best = None
        for s in self.spans:
            if s.ts <= t <= s.end and s.name.startswith(prefixes):
                if best is None or s.dur < best.dur:
                    best = s
        return best.name if best is not None else "outside spans"


class _Within:
    """Whether a time lies inside one of a set of spans (a union of them)."""

    def __init__(self, spans: list[Event]):
        self.iv = union([(s.ts, s.end) for s in spans]) if spans else []
        self.starts = [a for a, _b in self.iv]

    def __call__(self, t: float | None) -> bool:
        if t is None:
            return False
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.iv[i][1]


def union_length(intervals: list[tuple[float, float]]) -> float:
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(i for i in intervals if i[1] > i[0]):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out = []
    for s, e in sorted(i for i in intervals if i[1] > i[0]):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out
