"""Seconds of the Flex job's ``collate`` stage a job: the harness's span
around its ``cli.main`` call, closed by a synchronize, averaged over
the window's jobs."""


def read(run):
    return run.stage_s("collate")
