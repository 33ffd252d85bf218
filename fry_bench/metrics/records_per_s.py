"""RAD records of the job's input times the jobs the window ran, over
the time from the first job's start to the last job's end."""


def read(run):
    return run.records * len(run.jobs) / run.window_s if run.jobs else None
