"""Seconds a job of the program's ``tier`` spans on the main thread: the
Flex collate's per-sample cell correction, the identity tier and the
1-edit tier with its K4 search, in the traced window's jobs; ``None``
where the program records no such span."""

from fry_bench.spans import named_seconds, trees


def read(run):
    # a program without the span (an older commit) reads as nothing
    if run.trace is None or not any(sp.name == "tier" for t in trees(run) for sp in t.main):
        return None
    return named_seconds(run, "tier")
