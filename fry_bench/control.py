"""The control of ``correct``: the plain reference put in the program's
place with one guarantee of the configuration broken (its ``control``,
``no_rescue``: no barcode is rescued), compared with the sound reference
by the same comparison the runs use, at the cell's own size.  Every
number it gives above 0 fails the cell's limit of 0.

    python3 fry_bench/control.py --workload rna_10xv3_usa.crlike --seeds 11 12 13

Prints one JSON line a seed: the seed and each number compared.  The
benchmark's own runs never run this.
"""

import argparse
import importlib
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cell, seed: int, work: Path) -> dict:
    """Each number the comparison gives the control, on the data of
    ``seed``."""
    from fry_bench import check, harness

    gen = importlib.import_module(f"fry_bench.gen.{cell.config['generator']}")
    data = gen.make(work, seed, **cell.config["sizes"])
    sound = harness.expected_artifacts(cell, data, {})
    broken = harness.expected_artifacts(cell, data, {}, control=cell.config["control"])
    return {f"{stage}:{art}": check.diff(kind, broken[stage][art][1], want)
            for stage, arts in sound.items() for art, (kind, want) in arts.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the control's readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from fry_bench import harness

    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        work = Path(tempfile.mkdtemp(prefix="fry_bench_control_"))
        t0 = time.perf_counter()
        try:
            found = readings(cell, seed, work)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": found,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
