"""``setup_s``: seconds from the process's start to the window's start
(loading, frame rendering, the frontend's set-up, warm-up; the first run
in a checkout also builds the kernels). Host clock."""


def read(run):
    return run.setup_s
