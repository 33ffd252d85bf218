#!/usr/bin/env python3
"""Runs one of chip_smoke.py's self-contained phases alone on one GPU:
builds the kernels, starts the phase's data (and, for phase 10, the
reference's host path) in a thread, runs the phase, which compares every
artifact with the reference, and replays K4 and K1-K3 on the path's
largest inputs.

    python3 tools/run_phase.py 10 [--profile]   # the 16-plex Flex run
    python3 tools/run_phase.py 11 [--profile]   # convert, the RNA path on its RAD, view

Prints the phase's lines and the replay rows as one JSON line.  Work
files go to build/phase_<N>/ and are removed at the end.  The script
needs a CUDA device and exits non-zero without one, or when any check
of the phase fails.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
# phase -> (the function of chip_smoke.py that starts its thread, the phase)
PHASES = {10: ("flex_ref_chain", "flex_phase"), 11: ("bam_data_chain", "bam_phase")}


def main() -> int:
    ap = argparse.ArgumentParser(description="one of chip_smoke.py's phases alone")
    ap.add_argument("phase", type=int, choices=sorted(PHASES))
    ap.add_argument("--profile", action="store_true",
                    help="profile each stage (device busy time, host self time)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tests"))
    import chip_smoke
    from alevin_fry_tpu_torch import _kernels

    start, run = (getattr(chip_smoke, name) for name in PHASES[args.phase])
    card = chip_smoke.card_line()
    _kernels.build()
    print(f"build {_kernels.BuildInfo.seconds:.2f} s [{card}]", flush=True)
    work = REPO / "build" / f"phase_{args.phase}"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    chain = start(work)
    try:
        rows = run(work, chain, card, args.profile)
    finally:
        chip_smoke.ref_chain_stop(chain)
    shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"kernels": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
