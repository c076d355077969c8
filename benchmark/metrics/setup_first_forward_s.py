"""``setup_first_forward_s``: seconds of the program's
``sift.setup.first_forward`` span, the frontend's first ``forward`` up to
its return (the kernels' build or load, lazy module loading, library
handles). Program span, from its set-up record."""

from benchmark.metrics._spans import setup_s


def read(run):
    return setup_s(run, "sift.setup.first_forward")
