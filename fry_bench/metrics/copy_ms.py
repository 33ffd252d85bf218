"""Device milliseconds of copies and sets (the profiler's Memcpy and
Memset operations) a job."""


def read(run):
    if run.trace is None or not run.jobs:
        return None
    s = run.trace.op_seconds(lambda n: n.startswith(("Memcpy", "Memset")))
    return 1e3 * s / len(run.jobs)
