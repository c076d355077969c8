"""``launches_per_frame.<split>``: host calls that put work on the device
(``cudaLaunchKernel``, ``cuLaunchKernel``, ``cudaMemcpy*``,
``cudaMemset*``) a frame, inside the traced units' upload and forward
spans. Device trace (its host side)."""


def read(run):
    if not run.trace:
        return None
    spans = run.trace.spans_named("bench.upload") + run.trace.spans_named("bench.forward")
    frames = run.frames(run.traced_units())
    n = run.trace.launches_in(spans)
    return n / frames if n and frames else None
