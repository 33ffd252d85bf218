"""100 x (1 - the union of the card's operation intervals / the jobs'
wall time) in the traced window."""


def read(run):
    if run.trace is None or not run.jobs:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.window_s)
