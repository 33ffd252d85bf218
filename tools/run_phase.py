#!/usr/bin/env python3
"""Runs one of chip_smoke.py's phases alone on one GPU.

    python3 tools/run_phase.py 10 [--profile]   # the 16-plex Flex run
    python3 tools/run_phase.py 11 [--profile]   # convert, the RNA path on its RAD, view
    python3 tools/run_phase.py 12               # two processes of each stage
    python3 tools/run_phase.py 13               # the device mesh of one process

Phases 10 and 11: builds the kernels, starts the phase's data (and, for
phase 10, the reference's host path) in a thread, runs the phase, which
compares every artifact with the reference, and replays K4 and K1-K3 on
the path's largest inputs; prints the phase's lines and the replay rows
as one JSON line.  Phase 12: makes the data of phases 3, 5 and 10 and
runs the port's one-process stages that phase 12 is held against (phase
3's gpl, collate and quant; phase 7's quant -r cr-like-em -d; phase 9
(b)'s subset and (c)'s -b 20 --summary-stat; phase 5's ATAC stages with
their counters; phase 10 (a)'s Flex stages), then phase 12.  Phase 13: makes the data of
phases 3 and 5 and runs the one-card stages phase 13 is held against
(phase 3's gpl, collate and quant; phase 7's quant -r cr-like-em -d and
infer --usa; phase 5's atac gpl), then phase 13.  Work files go to build/phase_<N>/ and are removed at the end.  The script needs a
CUDA device and exits non-zero without one, or when any check of the
phase fails.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
# phase -> (the function of chip_smoke.py that starts its thread, the phase)
PHASES = {10: ("flex_ref_chain", "flex_phase"), 11: ("bam_data_chain", "bam_phase"),
          12: (None, None), 13: (None, None)}


def phase12_inputs(cs, work: Path, card: str) -> tuple:
    """The data and one-process runs phase 12 is held against, as the
    whole script leaves them; returns (phase 3's data, the subset)."""
    import os

    from alevin_fry_tpu_torch.atac import dedup

    data = work / "data"
    cs.helper(["make", str(data), "--n-cells", str(cs.N_CELLS), "--n-reads", str(cs.N_READS),
               "--n-genes", str(cs.N_GENES)])
    secs, _ = cs.run_port(data, work / "port")
    secs.update(cs.run_stages({"em-usa": cs.em_port_argv(work, data)["em-usa"]}, "prep"))
    _, _, subset = cs.boot_full_width(work, data, card, False)
    secs.update(cs.run_stages(
        {"-b 20": cs.boot_port_argv(work, data, subset)["cr-like-em"]}, "prep"))
    adata, out = work / "atac_data", work / "atac_port"
    cs.helper(["make-atac", str(adata), "--seed", str(cs.ATAC_SEED), "--n-cells",
               str(cs.ATAC_CELLS), "--n-frags", str(cs.ATAC_FRAGS), "--n-chrs",
               str(cs.ATAC_CHRS), "--chr-len", str(cs.ATAC_CHR_LEN), "--ambient-factor",
               str(cs.ATAC_AMBIENT)])
    gpl, m = str(out / "gpl"), ["-m", str(cs.ATAC_MAX_RECORDS)]
    dev = ["-t", str(cs.THREADS), "--device", "cuda"]
    counters, real = {}, dedup.deduplicate
    dedup.deduplicate = lambda *a, **k: counters.update(real(*a, **k)) or counters
    os.environ["AFT_RESCUE_BACKEND"] = "pallas"
    try:
        secs.update(cs.run_stages({
            "atac gpl": ["atac", "generate-permit-list", "-i", str(adata / "rad"), "-o", gpl,
                         "-u", str(adata / "wl.txt"), "-m", "10", *dev],
            "atac sort": ["atac", "sort", "-i", gpl, "-r", str(adata / "rad"), *m, *dev],
        }, "prep"))
        (out / "sort").mkdir()
        (out / "gpl" / "map.bed").rename(out / "sort" / "map.bed")
        secs.update(cs.run_stages({
            "atac collate": ["atac", "collate", "-i", gpl, "-r", str(adata / "rad"), *m, *dev],
            "atac deduplicate": ["atac", "deduplicate", "-i", gpl, *dev],
        }, "prep"))
    finally:
        dedup.deduplicate = real
        os.environ.pop("AFT_RESCUE_BACKEND")
    (work / "atac_counters.json").write_text(json.dumps(counters))
    cs.helper(["make-flex", str(work / "flex"), "--n-samples", str(cs.FLEX_SAMPLES),
               "--n-cells-per-sample", str(cs.FLEX_CELLS), "--n-reads", str(cs.FLEX_READS),
               "--n-genes", str(cs.FLEX_GENES), "--seed", str(cs.FLEX_SEED),
               "--permit-size", str(cs.FLEX_PERMIT)])
    argv = cs.flex_argv(work)
    secs.update(cs.run_stages({f"flex {k}": argv[k] for k in ("gpl", "collate", "quant")},
                              "prep"))
    print("one process on cuda: " + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items())
          + f" [{card}]", flush=True)
    return data, subset


def phase13_inputs(cs, work: Path, card: str) -> Path:
    """The data and one-card runs phase 13 takes, as the whole script
    leaves them; returns phase 3's data."""
    import os

    data, adata = work / "data", work / "atac_data"
    cs.helper(["make", str(data), "--n-cells", str(cs.N_CELLS), "--n-reads", str(cs.N_READS),
               "--n-genes", str(cs.N_GENES)])
    secs, _ = cs.run_port(data, work / "port")
    em = cs.em_port_argv(work, data)
    secs.update(cs.run_stages({k: em[k] for k in ("em-usa", "infer-usa")}, "prep"))
    cs.helper(["make-atac", str(adata), "--seed", str(cs.ATAC_SEED), "--n-cells",
               str(cs.ATAC_CELLS), "--n-frags", str(cs.ATAC_FRAGS), "--n-chrs",
               str(cs.ATAC_CHRS), "--chr-len", str(cs.ATAC_CHR_LEN), "--ambient-factor",
               str(cs.ATAC_AMBIENT)])
    os.environ["AFT_RESCUE_BACKEND"] = "pallas"
    try:
        secs.update(cs.run_stages({"atac gpl": [
            "atac", "generate-permit-list", "-i", str(adata / "rad"), "-o",
            str(work / "atac_port" / "gpl"), "-u", str(adata / "wl.txt"), "-m", "10", "-t",
            str(cs.THREADS), "--device", "cuda"]}, "prep"))
    finally:
        os.environ.pop("AFT_RESCUE_BACKEND")
    print("one card: " + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items())
          + f" [{card}]", flush=True)
    return data


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

    card = chip_smoke.card_line()
    _kernels.build()
    print(f"build {_kernels.BuildInfo.seconds:.2f} s [{card}]", flush=True)
    work = REPO / "build" / f"phase_{args.phase}"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    if args.phase == 12:
        chip_smoke.multihost_phase(work, *phase12_inputs(chip_smoke, work, card), card)
        shutil.rmtree(work, ignore_errors=True)
        return 0
    if args.phase == 13:
        chip_smoke.mesh_phase(work, phase13_inputs(chip_smoke, work, card), card,
                              torch.device("cuda"))
        shutil.rmtree(work, ignore_errors=True)
        return 0
    start, run = (getattr(chip_smoke, name) for name in PHASES[args.phase])
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
