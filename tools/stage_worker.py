#!/usr/bin/env python3
"""One rank of a multi-process run of the port's CLI.

    AFT_NUM_PROCESSES=2 AFT_PROCESS_ID=R python3 tools/stage_worker.py SPEC

SPEC is a JSON object: ``stages``, a list of ``[name, coordinator,
argv]`` or ``[name, coordinator, argv, moves]`` run one after another
through ``alevin_fry_tpu_torch.cli.main`` (each stage joins the run at
its own coordinator ``host:port``, or, with ``null``, runs as one
process; after it, rank 0 renames each ``[source, target]`` path of
``moves``, such as the ATAC sort's BED), and optionally ``set``, a list
of ``[module, NAME, value]`` module constants set first (the quant spill
bound, for instance).  The last line of standard output is one JSON
object: the rank and per stage its device, its seconds, the peak
device memory (MiB, on the card), the bytes this rank sent through the
collectives, the kernels' launches (on the card), the calls of the
kernels' plain twins (on the CPU) and, for ``atac deduplicate``, its four
counters.  A stage that fails exits non-zero.
"""

from __future__ import annotations

import importlib
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# kernel -> (module of alevin_fry_tpu_torch.ops, its plain twin)
TWINS = {
    "K1": ("segscan", "scan_fwd_twin"), "K2": ("segscan", "scan_min_twin"),
    "K3": ("segscan", "scan_lex_twin"), "K4/K5": ("hamming", "neighbor_probe_twin"),
    "K6": ("em", "em_run_twin"), "K7": ("pug_device", "connected_components_twin"),
    "K8": ("mtrand", "random_init_twin"),
}


def count_twins(calls: dict) -> None:
    """Count every call of a kernel's twin into ``calls``."""
    for key, (mod, name) in TWINS.items():
        m = importlib.import_module(f"alevin_fry_tpu_torch.ops.{mod}")
        twin = getattr(m, name)

        def spy(*args, _twin=twin, _key=key, **kwargs):
            calls[_key] += 1
            return _twin(*args, **kwargs)

        setattr(m, name, spy)


def launches() -> dict:
    from alevin_fry_tpu_torch.ops import em, hamming, mtrand, pug_device, segscan

    return {**segscan.LAUNCHES, **hamming.LAUNCHES, **em.LAUNCHES, **pug_device.LAUNCHES,
            **mtrand.LAUNCHES}


def main() -> int:
    spec = json.loads(sys.argv[1])
    import torch

    from alevin_fry_tpu_torch.cli import main as port_main
    from alevin_fry_tpu_torch.parallel import dist

    from alevin_fry_tpu_torch.atac import dedup

    for mod, name, value in spec.get("set", []):
        setattr(importlib.import_module(mod), name, value)
    calls = dict.fromkeys(TWINS, 0)
    count_twins(calls)
    counters = {}
    real_dedup = dedup.deduplicate
    dedup.deduplicate = lambda *a, **k: counters.update(real_dedup(*a, **k)) or counters
    cuda = torch.cuda.is_available()
    rank = int(os.environ.get("AFT_PROCESS_ID", 0))
    out = {"rank": rank, "stages": {}}
    for name, coord, argv, *moves in spec["stages"]:
        if coord is None:
            os.environ.pop("AFT_COORDINATOR", None)
        else:
            os.environ["AFT_COORDINATOR"] = coord
        before_l, before_c, before_b = launches(), dict(calls), dist.SENT_BYTES
        counters.clear()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        if port_main(argv) != 0:
            raise SystemExit(f"stage {name} failed")
        if cuda:
            torch.cuda.synchronize()
        after = launches()
        dev = argv[argv.index("--device") + 1] if "--device" in argv else "cuda"
        out["stages"][name] = {
            "device": f"cuda:{torch.cuda.current_device()}" if dev == "cuda" else dev,
            "seconds": time.perf_counter() - t0,
            "peak_mib": torch.cuda.max_memory_allocated() / 2**20 if cuda else None,
            "gloo_bytes": dist.SENT_BYTES - before_b,
            "launches": {k: after[k] - before_l[k] for k in after},
            "twin_calls": {k: calls[k] - before_c[k] for k in calls},
        }
        if counters:
            out["stages"][name]["dedup"] = dict(counters)
        for src, dst in (moves[0] if moves and rank == 0 else ()):
            Path(dst).parent.mkdir(parents=True, exist_ok=True)
            os.replace(src, dst)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
