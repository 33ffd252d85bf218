#!/usr/bin/env python3
"""Times kernel K7 (the UMI graphs' connected components) of
alevin_fry_tpu_torch on one GPU, at a seeded graph of the parsimony
quant's shape and on tests/pug_cases.py's graphs.

    python3 tools/k7_bench.py [--json FILE]

Shapes: ``replay``, 10,717 cells of up to 12,453 nodes (7.87M nodes in
all) whose edges form small components (paths over 2-4 nodes in random
order, some 1.08M adjacency entries), so about nine nodes in ten have
no edge, as in the graphs that the parsimony quant of a 20M-read run
gives K7; then each of tests/pug_cases.py's cases.  Every output is
first held to K7's twin (on the card) and the union-find of
tests/pug_cases.py.  Times per shape: the whole ``connected_components``
call (``ms``, the mean of CUDA events over several calls after a
warm-up); K7's launches alone, from a torch.profiler trace of as many
calls (``kernel_ms``, the time the card ran any K7 kernel, the union of
their intervals, since launches on side streams overlap;
``kernel_sum_ms``, the sum of their durations; both a call); and, where
the package has it, the host's launch planner alone (``host_plan_ms``).  The timing uses only the package's public
functions, so an older commit's package, unpacked with ``git archive``
and put first on PYTHONPATH, is timed on the same inputs in the same
call.  The script needs a CUDA device and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
CALLS = 10  # calls timed per shape, by events and by the profiler
# the replay graph: cells, nodes in all, the largest cell, components a
# node, and the components' sizes with their shares
REPLAY_CELLS, REPLAY_NODES, REPLAY_MAX_NODES = 10_717, 7_867_109, 12_453
COMPONENTS_PER_NODE = 0.0475
COMPONENT_SIZES, COMPONENT_SHARES = (2, 3, 4), (0.65, 0.25, 0.10)


def replay_graph(seed: int = 11):
    """(nodes per cell, degrees, neighbours) of the replay shape: cell
    sizes log-normal, clipped to REPLAY_MAX_NODES and scaled to sum to
    REPLAY_NODES;
    in each cell, Poisson-many components, each a path over distinct
    nodes of the cell in random order."""
    import numpy as np

    from pug_cases import csr_from_edges

    rng = np.random.RandomState(seed)
    raw = rng.lognormal(0.0, 1.0, REPLAY_CELLS)
    scale = REPLAY_NODES / raw.sum()
    for _ in range(20):  # the scale at which the clipped sizes sum to REPLAY_NODES
        n = np.clip(np.round(raw * scale), 1, REPLAY_MAX_NODES).astype(np.int64)
        scale *= REPLAY_NODES / n.sum()
    n[np.argmax(n)] = REPLAY_MAX_NODES
    # what rounding and the clip left over, one node a cell to random
    # cells below the largest
    short = REPLAY_NODES - int(n.sum())
    below = np.flatnonzero((n > 1) & (n < REPLAY_MAX_NODES - 1))
    n[rng.choice(below, abs(short), replace=False)] += np.sign(short)
    # each cell's nodes in random order: the components take them in turn
    start = np.concatenate(([0], np.cumsum(n)))[:-1]
    node_cell = np.repeat(np.arange(REPLAY_CELLS), n)
    order = np.lexsort((rng.rand(len(node_cell)), node_cell)) - start[node_cell]
    k = rng.poisson(COMPONENTS_PER_NODE * n)
    size = rng.choice(COMPONENT_SIZES, int(k.sum()), p=COMPONENT_SHARES)
    comp_cell = np.repeat(np.arange(REPLAY_CELLS), k)
    first = np.cumsum(size) - size  # in the concatenation of all cells' components
    cell_first = np.concatenate(([0], np.cumsum(np.bincount(comp_cell, size,
                                                            REPLAY_CELLS))))[:-1]
    pos = first - cell_first[comp_cell].astype(np.int64)
    fits = pos + size <= n[comp_cell]
    comp_cell, size, pos = comp_cell[fits], size[fits], pos[fits]
    step = np.arange(int(size.sum())) - np.repeat(np.cumsum(size) - size, size)
    at = np.repeat(start[comp_cell] + pos, size) + step
    edge = step < np.repeat(size, size) - 1
    u = order[at[edge]]
    v = order[at[edge] + 1]
    return csr_from_edges(n, np.repeat(comp_cell, size)[edge], u, v)


def _event_ms(fn, reps: int) -> float:
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _kernel_ms(fn, reps: int) -> dict:
    """K7's device time a call in a torch.profiler trace of ``reps``
    calls: ``kernel_ms`` the time the card was running any K7 kernel (the
    union of their intervals: launches on side streams overlap),
    ``kernel_sum_ms`` the sum of their durations, ``by_kernel`` that sum
    by kernel name, ``launches`` a call."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA and "pug_cc" in e.name]
    if not evs:
        raise RuntimeError("the profiler saw no K7 kernel on the device")
    busy, last, by = 0.0, float("-inf"), {}
    for e in sorted(evs, key=lambda e: e.time_range.start):
        start, end = e.time_range.start, e.time_range.end
        busy += max(0.0, end - max(start, last))
        last = max(last, end)
        by[e.name] = by.get(e.name, 0.0) + (end - start) / 1e3 / reps
    return {"kernel_ms": busy / 1e3 / reps,
            "kernel_sum_ms": sum(e.time_range.end - e.time_range.start for e in evs) / 1e3 / reps,
            "by_kernel": by, "launches": len(evs) / reps}


def _host_plan_ms(t, reps: int):
    """Host milliseconds of K7's launch planner on the call's sizes, where
    the package has one (None for the older ones)."""
    import time

    from alevin_fry_tpu_torch.ops import pug_device

    if not hasattr(pug_device, "launch_plan"):
        return None
    start = time.perf_counter()
    for _ in range(reps):
        pug_device.launch_plan(t[0], t[1], 232_448)
    return (time.perf_counter() - start) / reps * 1e3


def time_shape(graph, dev) -> dict:
    import numpy as np

    from alevin_fry_tpu_torch.ops import pug_device
    from pug_cases import union_find_labels

    t = pug_device.upload_csr(*graph, dev)
    labels = pug_device.connected_components(*t)[0].cpu().numpy()
    twin, rounds = pug_device.connected_components_twin(t[0], t[-2], t[-1])
    if not np.array_equal(labels, twin.cpu().numpy()):
        raise AssertionError("K7 differs from its twin")
    if not np.array_equal(labels, union_find_labels(*graph)):
        raise AssertionError("K7 differs from the union-find")
    kernel = _kernel_ms(lambda: pug_device.connected_components(*t), CALLS)
    live = rounds.cpu().numpy()[graph[0] > 0]
    return {"cells": len(graph[0]), "nodes": len(graph[1]), "entries": len(graph[2]),
            "edged_nodes": int((graph[1] > 0).sum()), "max_nodes": int(graph[0].max()),
            "twin_rounds_median": float(np.median(live)), "twin_rounds_max": int(live.max()),
            "bound_ms": (12 * len(graph[1]) + 4 * len(graph[2])) / 3.35e12 * 1e3,
            "ms": _event_ms(lambda: pug_device.connected_components(*t), CALLS),
            "host_plan_ms": _host_plan_ms(t, CALLS), **kernel}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", type=Path, help="write the results to this file too")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.append(str(REPO))  # after PYTHONPATH, which may name another commit's package
    sys.path.insert(0, str(REPO / "tests"))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda")
    import alevin_fry_tpu_torch
    from pug_cases import PUG_CASES, pug_case

    res = {"package": str(Path(alevin_fry_tpu_torch.__file__).parent), "card": card,
           "shapes": {"replay": time_shape(replay_graph(), dev)}}
    for kind in PUG_CASES:
        res["shapes"][kind] = time_shape(pug_case(kind), dev)
    print(json.dumps(res), flush=True)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
