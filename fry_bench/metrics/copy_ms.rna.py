"""``copy_ms`` in the RNA cell, where it is read per layer and names
``peak_dev_mib`` as the end-to-end metric it moves: that cell's
``records_per_s`` spreads too widely between runs to hold a bound.
The same reader as ``metrics/copy_ms.py``."""

from fry_bench.harness import metric_reader

read = metric_reader("copy_ms")
