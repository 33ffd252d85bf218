"""Seconds a job the program's main thread waited on the prefetch queue
for the next block of the input (its ``wait`` spans,
``fry_bench/spans.py``), in the traced window's jobs."""

from fry_bench.spans import layer_seconds


def read(run):
    return layer_seconds(run, "wait")
