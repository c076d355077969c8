"""``setup_frontend_s``: seconds of the program's ``sift.setup.frontend``
span, the whole of ``SiftFrontend.__init__`` (in a process's first
frontend the CUDA context too; the blur matrices built on the host and
uploaded). Program span, from its set-up record."""

from benchmark.metrics._spans import setup_s


def read(run):
    return setup_s(run, "sift.setup.frontend")
