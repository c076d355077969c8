"""The ``breakdown`` of a traced run: where the device's time went and
what the host was doing while the device sat idle."""

from __future__ import annotations

TOP = 10


def of(trace, lo: float, hi: float) -> dict:
    """``device_ops``: the device operations of the traced window (trace
    clock, us) with the most time, summed by name; ``idle_gaps``: the
    window's idle device time, summed by the innermost harness or program
    span the host was in halfway through each gap. Seconds, as measured."""
    ops: dict[str, float] = {}
    for op in trace.device:
        if op.end > lo and op.ts < hi:
            ops[op.name] = ops.get(op.name, 0.0) + (min(op.end, hi) - max(op.ts, lo)) / 1e6
    gaps: dict[str, float] = {}
    for a, b in trace.idle_gaps(lo, hi):
        name = trace.innermost_span(0.5 * (a + b))
        gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e6
    top = lambda d: [[k[:200], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"device_ops": top(ops), "idle_gaps": top(gaps)}
