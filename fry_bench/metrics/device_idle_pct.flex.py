"""``device_idle_pct`` in the Flex cell, where it names ``setup_s`` as the
end-to-end metric it moves (the warm-up job's stages are set-up; the
cell's rate is read per layer).  The same reader as
``metrics/device_idle_pct.py``."""

from fry_bench.harness import metric_reader

read = metric_reader("device_idle_pct")
