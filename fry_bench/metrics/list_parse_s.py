"""Seconds a job of the program's ``list_parse`` spans on the main
thread: parsing a barcode list file into its sorted set (ATAC's
whitelist, RNA's permit list; ``fry_bench/spans.py``), in the traced
window's jobs."""

from fry_bench.spans import named_seconds


def read(run):
    return named_seconds(run, "list_parse")
