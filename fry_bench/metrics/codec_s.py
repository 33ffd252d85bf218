"""Self seconds a job of the program's ``codec`` spans on the main
thread: reading and decoding the RAD input, parsing lists and maps,
encoding and writing the outputs (``fry_bench/spans.py``), in the
traced window's jobs."""

from fry_bench.spans import layer_seconds


def read(run):
    return layer_seconds(run, "codec")
