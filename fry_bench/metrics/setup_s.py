"""Process start to the window's start: imports, the kernels' load (and
build, in a fresh checkout), the data, the warm-up job."""


def read(run):
    return run.setup_s
