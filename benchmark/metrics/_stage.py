"""Device milliseconds a frame of the operations launched inside one of
the program's spans, over the traced units."""


def device_ms(run, span: str):
    if not run.trace:
        return None
    ops = run.trace.ops_in(run.trace.spans_named(span))
    frames = run.frames(run.traced_units())
    if not ops or not frames:
        return None
    return sum(op.dur for op in ops) / 1e3 / frames
