"""The reference package's host path, as an oracle for the port.

Runs ``alevin_fry_tpu``'s generate-permit-list (unfiltered) -> collate
-> quant (cr-like), or its ATAC stages (generate-permit-list -> sort,
collate -> deduplicate), through its Python API with every device
policy set to the host, so no JAX is needed: ``run`` and ``run-atac``
block the ``jax`` import outright.  The policies are set in the
environment only while the stages run.  The stage command lines are
given, so the stage JSONs can be compared with the port's field for
field.

As a script (this imports nothing of the port):

    python tests/reference_host_path.py make DIR --n-cells C --n-reads R --n-genes G [--seed S]
        writes tests/synth_hard.make_hard_dataset(DIR, RandomState(S), ...)
    python tests/reference_host_path.py run DIR OUT CMDLINES.json [--usa] [--min-reads M] [--threads T]
        runs the three stages on DIR/rad into OUT and prints their
        seconds as one JSON line
    python tests/reference_host_path.py make-atac DIR --n-cells C --n-frags F --n-chrs N
            --chr-len L --ambient-factor A [--seed S]
        writes tests/synth_hard.make_hard_atac_dataset(DIR, RandomState(S), ...)
        (16-base barcodes, a reverse-complement whitelist DIR/wl.txt)
    python tests/reference_host_path.py run-atac DIR OUT CMDLINES.json [--min-reads M]
            [--max-records R] [--threads T]
        runs the four ATAC stages on DIR/rad into OUT and prints their
        seconds and the deduplicate counters as one JSON line
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import time
from pathlib import Path

HOST_ENV = {
    "AFT_CRLIKE_BACKEND": "host",
    "AFT_RESCUE_BACKEND": "host",
    "AFT_COLLATE_BACKEND": "host",
    "AFT_ATAC_SORT_BACKEND": "host",
    "AFT_GPL_MESH": "0",
    "AFT_EM_MESH": "0",
}

# the artifacts both packages must write byte for byte, and the stage
# JSONs that must agree once their path-valued fields are dropped
DATA_ARTIFACTS = (
    "gpl/permit_freq.bin", "gpl/permit_map.bin", "gpl/map.collated.rad",
    "gpl/unmapped_bc_count_collated.bin", "quant/alevin/quants_mat.mtx",
    "quant/alevin/quants_mat_rows.txt", "quant/alevin/quants_mat_cols.txt",
    "quant/featureDump.txt",
)
STAGE_JSONS = (
    "gpl/generate_permit_list.json", "gpl/collate.json", "quant/quant.json",
)
PATH_FIELDS = ("input_dir", "output_dir", "tg_map")

# the ATAC run's artifacts: the sort's BED is moved to sort/map.bed
# before deduplicate writes gpl/map.bed
ATAC_DATA_ARTIFACTS = (
    "gpl/permit_freq.bin", "gpl/permit_map.bin", "gpl/bin_recs.bin",
    "gpl/bin_lens.bin", "sort/map.bed", "gpl/map.collated.rad",
    "gpl/unmapped_bc_count_collated.bin", "gpl/map.bed",
)
ATAC_STAGE_JSONS = (
    "gpl/generate_permit_list.json", "gpl/sort.json", "gpl/collate.json",
)


@contextlib.contextmanager
def host_policies():
    """Point every device policy of the reference at the host while the
    block runs, and restore the environment after it."""
    saved = {k: os.environ.get(k) for k in HOST_ENV}
    os.environ.update(HOST_ENV)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def move_sorted_bed(out: Path) -> None:
    """Keep the sort stage's BED: deduplicate writes the same path."""
    (out / "sort").mkdir(parents=True, exist_ok=True)
    shutil.move(str(out / "gpl" / "map.bed"), str(out / "sort" / "map.bed"))


def comparable_json(path: Path) -> dict:
    """A stage JSON without the fields that name a run's directories."""
    d = json.loads(Path(path).read_text())
    for key in ("gpl_options", "quant_options"):
        if key in d:
            d[key] = {k: v for k, v in d[key].items() if k not in PATH_FIELDS}
    return d


def artifact_mismatches(a: Path, b: Path, artifacts=DATA_ARTIFACTS,
                        jsons=STAGE_JSONS) -> list:
    """Names of the artifacts that differ between two run directories."""
    bad = [p for p in artifacts if (a / p).read_bytes() != (b / p).read_bytes()]
    bad += [p for p in jsons if comparable_json(a / p) != comparable_json(b / p)]
    return bad


def run_reference(d: Path, out: Path, cmdlines: dict, usa: bool,
                  min_reads: int = 10, threads: int = 4) -> dict:
    """Run the reference's three stages on ``d/rad`` into ``out/gpl`` and
    ``out/quant``; returns each stage's seconds.  ``cmdlines`` maps
    gpl / collate / quant to the command line each JSON records."""
    with host_policies():
        return _run_reference(d, out, cmdlines, usa, min_reads, threads)


def _run_reference(d, out, cmdlines, usa, min_reads, threads) -> dict:
    from alevin_fry_tpu.pipeline.collate import collate
    from alevin_fry_tpu.pipeline.gpl import (
        CellFilterMethod, GenPermitListOpts, generate_permit_list,
    )
    from alevin_fry_tpu.pipeline.quant import QuantOpts, quantify
    from alevin_fry_tpu.radz import _native

    _native.set_threads(threads)
    secs = {}
    t0 = time.perf_counter()
    generate_permit_list(GenPermitListOpts(
        input_dir=d / "rad", output_dir=out / "gpl",
        fmeth=CellFilterMethod("unfiltered", path=d / "permit.txt", min_reads=min_reads),
        expected_ori="fw", threads=threads, cmdline=cmdlines["gpl"],
    ))
    secs["gpl"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    collate(out / "gpl", d / "rad", threads, cmdline=cmdlines["collate"])
    secs["collate"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    quantify(QuantOpts(
        input_dir=out / "gpl", tg_map=d / ("t2g_3col.tsv" if usa else "t2g.tsv"),
        output_dir=out / "quant", num_threads=threads, resolution="cr-like",
        large_graph_thresh=0, cmdline=cmdlines["quant"],
    ))
    secs["quant"] = time.perf_counter() - t0
    return secs


def run_reference_atac(d: Path, out: Path, cmdlines: dict, min_reads: int = 10,
                       max_records: int = 30_000_000, threads: int = 4) -> tuple:
    """Run the reference's ATAC stages on ``d/rad`` with the whitelist
    ``d/wl.txt`` (reverse complement) into ``out``: generate-permit-list,
    sort (its BED moved to ``out/sort/map.bed``), collate, deduplicate.
    ``cmdlines`` maps gpl / sort / collate / deduplicate to the command
    line each records.  Returns (seconds per stage, deduplicate's
    counters)."""
    with host_policies():
        from alevin_fry_tpu.atac.collate import collate
        from alevin_fry_tpu.atac.dedup import deduplicate
        from alevin_fry_tpu.atac.gpl import AtacGplOpts, generate_permit_list
        from alevin_fry_tpu.atac.sort import sort
        from alevin_fry_tpu.radz import _native

        _native.set_threads(threads)
        gpl = out / "gpl"
        secs = {}
        t0 = time.perf_counter()
        generate_permit_list(AtacGplOpts(
            input_dir=d / "rad", output_dir=gpl, unfiltered_pl=d / "wl.txt",
            min_reads=min_reads, rc=True, threads=threads, cmdline=cmdlines["gpl"],
        ))
        secs["gpl"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        sort(gpl, d / "rad", threads, max_records, cmdline=cmdlines["sort"])
        secs["sort"] = time.perf_counter() - t0
        move_sorted_bed(out)
        t0 = time.perf_counter()
        collate(gpl, d / "rad", threads, max_records, cmdline=cmdlines["collate"])
        secs["collate"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        stats = deduplicate(gpl, threads, rev=True, cmdline=cmdlines["deduplicate"])
        secs["deduplicate"] = time.perf_counter() - t0
    return secs, stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    mk = sub.add_parser("make")
    mk.add_argument("dir", type=Path)
    mk.add_argument("--n-cells", type=int, required=True)
    mk.add_argument("--n-reads", type=int, required=True)
    mk.add_argument("--n-genes", type=int, required=True)
    mk.add_argument("--seed", type=int, default=7)
    rn = sub.add_parser("run")
    rn.add_argument("dir", type=Path)
    rn.add_argument("out", type=Path)
    rn.add_argument("cmdlines", type=Path)
    rn.add_argument("--usa", action="store_true")
    rn.add_argument("--min-reads", type=int, default=10)
    rn.add_argument("--threads", type=int, default=4)
    ma = sub.add_parser("make-atac")
    ma.add_argument("dir", type=Path)
    ma.add_argument("--n-cells", type=int, required=True)
    ma.add_argument("--n-frags", type=int, required=True)
    ma.add_argument("--n-chrs", type=int, required=True)
    ma.add_argument("--chr-len", type=int, required=True)
    ma.add_argument("--ambient-factor", type=int, required=True)
    ma.add_argument("--seed", type=int, default=11)
    ra = sub.add_parser("run-atac")
    ra.add_argument("dir", type=Path)
    ra.add_argument("out", type=Path)
    ra.add_argument("cmdlines", type=Path)
    ra.add_argument("--min-reads", type=int, default=10)
    ra.add_argument("--max-records", type=int, default=30_000_000)
    ra.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    if args.cmd == "make":
        import numpy as np
        from synth_hard import make_hard_dataset

        args.dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        stats = make_hard_dataset(
            args.dir, np.random.RandomState(args.seed), n_cells=args.n_cells,
            n_reads=args.n_reads, n_genes=args.n_genes,
        )
        print(json.dumps({"seconds": time.perf_counter() - t0, "n_reads": stats["n_reads"]}))
        return 0
    if args.cmd == "make-atac":
        import numpy as np
        from synth_hard import make_hard_atac_dataset

        args.dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        stats = make_hard_atac_dataset(
            args.dir, np.random.RandomState(args.seed), n_cells=args.n_cells,
            n_frags=args.n_frags, n_chrs=args.n_chrs, chr_len=args.chr_len,
            bc_len=16, ambient_factor=args.ambient_factor,
        )
        print(json.dumps({"seconds": time.perf_counter() - t0, **stats}))
        return 0
    # the host path must not need JAX: make any import of it fail
    sys.modules["jax"] = None
    if args.cmd == "run-atac":
        secs, stats = run_reference_atac(
            args.dir, args.out, json.loads(args.cmdlines.read_text()),
            args.min_reads, args.max_records, args.threads,
        )
        print(json.dumps({"seconds": secs, "dedup": stats}))
        return 0
    secs = run_reference(
        args.dir, args.out, json.loads(args.cmdlines.read_text()), args.usa,
        args.min_reads, args.threads,
    )
    print(json.dumps(secs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
