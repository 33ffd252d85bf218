"""Seconds a job of the program's ``sample_map`` spans on the main thread:
the Flex gpl's probe-barcode correction of each block (and the sample
map's build), in the traced window's jobs; ``None`` where the program
records no such span."""

from fry_bench.spans import named_seconds, trees


def read(run):
    # a program without the span (an older commit) reads as nothing
    if run.trace is None or not any(sp.name == "sample_map" for t in trees(run) for sp in t.main):
        return None
    return named_seconds(run, "sample_map")
