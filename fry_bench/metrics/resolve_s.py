"""Self seconds a job of the program's ``resolution`` spans on the main
thread: the stages' work between decode and write, on the host and
the card (histograms, rescue, map lookup, order, WTA, sort;
``fry_bench/spans.py``), in the traced window's jobs."""

from fry_bench.spans import layer_seconds


def read(run):
    return layer_seconds(run, "resolution")
