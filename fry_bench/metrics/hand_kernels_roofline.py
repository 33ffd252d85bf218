"""The hand-written kernels' share of their byte roofline: the sum of
each operation's bound (its bytes, each input read once and each output
written once, over the H100's 3.35 TB/s) over the sum of the device
time of the launches it claims (``kernels/<operation>.json``: the kernel
names, and the stages their launches fall in).  The bytes are counted
from the cell's own work as the reference counts it (the rescue's
queries and cells, the WTA's pairs and groups, the sort's rows and
runs), so they do not depend on what implements the operation.  An
operation whose work the cell does not count, or that claims no launch,
is left out.  A launch that two counted operations claim gives no
reading rather than a double count; with no claimed time there is
nothing to read."""

from fry_bench.harness import kernel_ops
from fry_bench.trace import HBM_BYTES_PER_S


def read(run):
    if run.trace is None or not run.jobs:
        return None
    bound = spent = 0.0
    claimed = set()
    for op in kernel_ops():
        if not all(k in run.counts for k in op["bytes"]):
            continue
        launches = run.trace.claimed(op["kernels"], op.get("stages"))
        if not launches:
            continue
        if claimed.intersection(launches):
            return None
        claimed.update(launches)
        spent += sum(run.trace.ops[i][2] - run.trace.ops[i][1] for i in launches)
        nbytes = sum(run.counts[k] * w for k, w in op["bytes"].items())
        bound += len(run.jobs) * nbytes / HBM_BYTES_PER_S
    return 100.0 * bound / spent if spent > 0 else None
