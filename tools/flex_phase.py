#!/usr/bin/env python3
"""Runs chip_smoke.py's phase 10 alone on one GPU: builds the kernels,
makes the 16-plex Flex dataset and runs the reference's host path on it
in a thread, runs the port's Flex stages on the card and compares every
artifact, then replays K4 and K1-K3 on the path's largest inputs.

    python3 tools/flex_phase.py [--profile]

Prints phase 10's lines and the replay rows as one JSON line.  Work
files go to build/flex_phase/ and are removed at the end.  The script
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


def main() -> int:
    ap = argparse.ArgumentParser(description="chip_smoke.py's phase 10 alone")
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

    card = chip_smoke.card_line()
    _kernels.build()
    print(f"build {_kernels.BuildInfo.seconds:.2f} s [{card}]", flush=True)
    work = REPO / "build" / "flex_phase"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    chain = chip_smoke.flex_ref_chain(work)
    try:
        rows = chip_smoke.flex_phase(work, chain, card, args.profile)
    finally:
        chip_smoke.ref_chain_stop(chain)
    shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"kernels": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
